"""Choosing a parallelism strategy: partitioning vs tree cut vs slices.

The port of the reference's ``examples/strategy_selection.py``: the same
network can be parallelized three ways, and which one wins is an
empirical question the planner should answer per instance.

1. SA-rebalanced hypergraph partitioning (the reference's shape);
2. tree-cut partitioning: contiguous frontier of one good serial tree,
   local paths preserved (:mod:`tnc_tpu_torch.contractionpath.treecut`);
3. slice-parallel: every device slot runs a share of the slices of the
   SAME serial plan, one reduction combines them
   (:mod:`tnc_tpu_torch.parallel.sliced_parallel`).

The reference's documented command gives it 8 devices; here the 8 slots
sit on the visible cards in turn (one card: ``[cuda:0] * 8``).

Run:  python -m tnc_tpu_torch.examples.strategy_selection
"""

import random as pyrandom

import numpy as np

from tnc_tpu_torch.builders.connectivity import ConnectivityLayout
from tnc_tpu_torch.builders.random_circuit import random_circuit
from tnc_tpu_torch.contractionpath.communication_schemes import CommunicationScheme
from tnc_tpu_torch.contractionpath.paths import Greedy, OptMethod
from tnc_tpu_torch.contractionpath.repartitioning import (
    compute_solution,
    compute_solution_with_paths,
)
from tnc_tpu_torch.contractionpath.slicing import find_parallel_slicing, sliced_flops
from tnc_tpu_torch.contractionpath.treecut import plan_treecut
from tnc_tpu_torch.parallel import distributed_sliced_contraction, make_mesh
from tnc_tpu_torch.parallel._devices import device_slots
from tnc_tpu_torch.tensornetwork.contraction import contract_tensor_network
from tnc_tpu_torch.tensornetwork.partitioning import find_partitioning
from tnc_tpu_torch.tensornetwork.simplify import simplify_network

SLOTS = 8


def main() -> dict:
    devices = device_slots(SLOTS)
    k = len(devices)
    rng = np.random.default_rng(7)
    tn = simplify_network(
        random_circuit(
            18, 12, 0.5, 0.5, rng, ConnectivityLayout.SYCAMORE,
            bitstring="0" * 18,
        )
    )
    serial = Greedy(OptMethod.GREEDY).find_path(tn)
    print(f"network: {len(tn.tensors)} cores, serial plan {serial.flops:.3g} flops")

    # 1. hypergraph partitioning (min-cut + greedy local paths)
    assignment = find_partitioning(tn, k)
    _, _, par1, ser1 = compute_solution(tn, assignment, rng=pyrandom.Random(0))
    print(f"partitioned : critical {par1:.3g}  (vs serial plan "
          f"{serial.flops / par1:.2f}x)")

    # 2. tree-cut: frontier of the serial tree, local paths preserved
    tc = plan_treecut(list(tn.tensors), serial.ssa_path.toplevel, k, steps=2000)
    _, _, par2, ser2 = compute_solution_with_paths(
        tn, tc.assignment, tc.local_paths,
        communication_scheme=CommunicationScheme.WEIGHTED_BRANCH_BOUND,
        rng=pyrandom.Random(0),
    )
    print(f"tree-cut    : critical {par2:.3g}  (vs serial plan "
          f"{serial.flops / par2:.2f}x)")

    # 3. slice-parallel: k-divisible slices of the serial plan
    replace = serial.replace_path()
    psl = find_parallel_slicing(list(tn.tensors), replace.toplevel, k)
    tot = sliced_flops(list(tn.tensors), replace.toplevel, psl)
    print(f"slice-SPMD  : critical {tot / k:.3g}  (overhead "
          f"{tot / serial.flops:.2f}x, vs serial plan "
          f"{serial.flops / (tot / k):.2f}x)")

    # execute the slice-parallel plan over the device slots and check it
    mesh = make_mesh(k, devices=devices)
    out = distributed_sliced_contraction(tn, replace, psl, mesh=mesh)
    got = complex(np.asarray(out.data.into_data()).reshape(-1)[0])
    want = complex(
        contract_tensor_network(tn, replace, backend="numpy").data.into_data()
    )
    err = abs(got - want) / max(1.0, abs(want))
    print(f"mesh run over {k} devices: amplitude {got:.6g} "
          f"(parity {err:.2e})")
    assert err <= 1e-5
    return {"serial_flops": serial.flops, "partitioned": (par1, ser1),
            "treecut": (par2, ser2), "sliced_flops": tot,
            "num_slices": psl.num_slices, "amplitude": got, "oracle": want,
            "parity": err}


if __name__ == "__main__":
    main()
