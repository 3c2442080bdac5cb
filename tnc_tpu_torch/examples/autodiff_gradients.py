"""Differentiable contraction: variational-gradient workflows.

The port of the reference's ``examples/autodiff_gradients.py``: gradients
of an expectation value with respect to gate parameters from one
reverse-mode sweep (``torch.autograd``) through the program the forward
pass runs — no parameter-shift re-contractions — in complex128 on the
card. Shown two ways: a whole program, and a batched amplitude sweep.

Run:  python -m tnc_tpu_torch.examples.autodiff_gradients
"""

import numpy as np

from tnc_tpu_torch.builders.circuit_builder import Circuit
from tnc_tpu_torch.contractionpath.paths import Greedy, OptMethod
from tnc_tpu_torch.gates import load_gate, load_gate_adjoint
from tnc_tpu_torch.ops.autodiff import contraction_value_and_grad
from tnc_tpu_torch.ops.program import flat_leaf_tensors
from tnc_tpu_torch.tensornetwork.sweep import amplitude_sweep_value_and_grad
from tnc_tpu_torch.tensornetwork.tensordata import DataKind, TensorData

THETA = 0.7
BITSTRINGS = ["000", "110", "111"]


def main() -> dict:
    # -- d<Z>/dθ of ⟨0|Rx(θ)† Z Rx(θ)|0⟩ = -sin(θ) -------------------------
    theta = THETA
    c = Circuit()
    reg = c.allocate_register(1)
    c.append_gate(TensorData.gate("rx", [theta]), [reg.qubit(0)])
    tn = c.into_expectation_value_network()
    path = Greedy(OptMethod.GREEDY).find_path(tn).replace_path()

    # the Rx gate leaves are the differentiable parameters
    leaves = flat_leaf_tensors(tn)
    slots = [
        i
        for i, leaf in enumerate(leaves)
        if leaf.data.kind is DataKind.GATE and leaf.data.payload[0] == "rx"
    ]
    value, grads = contraction_value_and_grad(tn, path, wrt=slots, dtype="complex128")
    z = value.reshape(-1)[0].real
    print(f"<Z> = {z:+.6f}   (cos θ = {np.cos(theta):+.6f})")

    # chain rule through the gate's θ-derivative gives d<Z>/dθ
    eps = 1e-7
    total = 0.0
    contributions = []
    for slot, g in zip(slots, grads):
        name, _angles, adj = leaves[slot].data.payload
        load = load_gate_adjoint if adj else load_gate
        dgate = (load(name, [theta + eps]) - load(name, [theta - eps])) / (2 * eps)
        contrib = np.sum(g * dgate.reshape(g.shape)).real
        print(f"  slot {slot}: dθ contribution {contrib:+.6f}")
        contributions.append(contrib)
        total += contrib
    print(f"d<Z>/dθ = {total:+.6f}   (-sin θ = {-np.sin(theta):+.6f})")
    assert abs(total + np.sin(theta)) < 1e-5

    # -- gradient of batch probability mass over an amplitude sweep --------
    c2 = Circuit()
    reg2 = c2.allocate_register(3)
    c2.append_gate(TensorData.gate("h"), [reg2.qubit(0)])
    c2.append_gate(TensorData.gate("cx"), [reg2.qubit(0), reg2.qubit(1)])
    c2.append_gate(TensorData.gate("ry", [0.3]), [reg2.qubit(2)])
    amps, sweep_grads = amplitude_sweep_value_and_grad(c2, BITSTRINGS, dtype="complex128")
    mass = float(np.sum(np.abs(amps) ** 2))
    print(f"sweep amplitudes: {np.round(amps, 4)}")
    print(f"sum |amp|^2 = {mass:.6f}; "
          f"{len(sweep_grads)} leaf gradients computed in one reverse sweep")
    return {"z": float(z), "slots": slots, "grads": grads,
            "contributions": contributions, "dz_dtheta": float(total),
            "sweep_amplitudes": np.asarray(amps), "sweep_grads": sweep_grads,
            "probability_mass": mass}


if __name__ == "__main__":
    main()
