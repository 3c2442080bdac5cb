"""Approximate contraction: boundary-MPS over a PEPS sandwich.

The port of the reference's ``examples/approximate_peps.py``: a ``chi``
sweep shows the accuracy-for-cost dial against the exact contraction of a
4×4 PEPS ⟨ψ|O|ψ⟩ sandwich, then the serving tier's chi ladder answers the
same question with a per-answer error estimate, and a tolerant amplitude
request is served with an error bar through the service front end.

The exact value is the complex128 host oracle's, as in the reference; the
sweeps run on the card (``backend="torch"``) in complex128, the
reference's width, so that chi=64 reproduces the exact value to 1e-8.

Run:  python -m tnc_tpu_torch.examples.approximate_peps
"""

import numpy as np

from tnc_tpu_torch.approx import ApproxProgram, ChiLadder
from tnc_tpu_torch.builders.peps import peps
from tnc_tpu_torch.builders.random_circuit import brickwork_circuit
from tnc_tpu_torch.contractionpath.paths import Greedy, OptMethod
from tnc_tpu_torch.serve import ContractionService
from tnc_tpu_torch.tensornetwork.approximate import (
    attach_random_data,
    boundary_mps_contract,
    collapse_peps_sandwich,
)
from tnc_tpu_torch.tensornetwork.contraction import contract_tensor_network

LENGTH, DEPTH, LAYERS = 4, 4, 1
CHIS = (1, 2, 4, 8, 64)
SWEEP_DTYPE = "complex128"


def main() -> dict:
    rng = np.random.default_rng(11)
    tn = attach_random_data(peps(LENGTH, DEPTH, 2, 2, LAYERS), rng)

    result = Greedy(OptMethod.GREEDY).find_path(tn)
    exact = complex(
        np.asarray(
            contract_tensor_network(tn, result.replace_path(), backend="numpy")
            .data.into_data()
        ).reshape(-1)[0]
    )
    print(f"exact ⟨ψ|O|ψ⟩ = {exact:.6e}")

    grid = collapse_peps_sandwich(tn, LENGTH, DEPTH, LAYERS)
    print(f"{DEPTH}x{LENGTH} grid; boundary-MPS chi sweep:")
    sweep = {}
    for chi in CHIS:
        approx = boundary_mps_contract(grid, chi=chi, dtype=SWEEP_DTYPE)
        sweep[chi] = approx
        rel = abs(approx - exact) / abs(exact)
        print(f"  chi={chi:>3}: {approx:.6e}   rel err {rel:.2e}")

    assert abs(sweep[64] - exact) <= 1e-8 * abs(exact)
    print("chi=64 reproduces the exact value; smaller chi trades accuracy for cost")

    # -- the serving tier: chi-ladder with a per-answer error estimate ------
    program = ApproxProgram.from_peps_sandwich(tn, LENGTH, DEPTH, LAYERS)
    res = ChiLadder(chi_cap=64).run(program, rtol=1e-6, scale=abs(exact), dtype=SWEEP_DTYPE)
    true_err = abs(res.value - exact)
    print(
        f"chi-ladder: value {res.value:.6e} ± {res.err:.2e} at chi={res.chi_used} "
        f"after {res.sweeps} sweeps (true err {true_err:.2e})"
    )
    assert res.converged and res.err >= true_err

    # -- fidelity-routed serving: rtol= lands on the approx tier ------------
    circuit = brickwork_circuit(8, 5, np.random.default_rng(0))
    with ContractionService.from_circuit(circuit, approx=True) as svc:
        ans = svc.amplitude("10100110", rtol=1e-2)
        tiers = svc.stats()["by_tier"]
    served = tiers["approx"]["counts"]["completed"]
    print(
        f"service rtol=1e-2: |amp| {abs(ans.value):.6f} ± {ans.err:.1e} "
        f"(chi={ans.chi_used}, escalated={ans.escalated}; "
        f"approx tier served {served} request)"
    )
    return {
        "exact": exact,
        "sweep": sweep,
        "ladder": {"value": res.value, "err": res.err, "chi_used": res.chi_used,
                   "sweeps": res.sweeps, "converged": res.converged,
                   "true_err": true_err},
        "service": {"value": ans.value, "err": ans.err, "chi_used": ans.chi_used,
                    "escalated": ans.escalated, "approx_completed": served},
    }


if __name__ == "__main__":
    main()
