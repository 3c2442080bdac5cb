"""tnc_tpu_torch.approx — the fidelity-tiered approximate serving tier (the
port's counterpart of ``tnc_tpu.approx``).

Most traffic does not need an exact sycamore-class contraction; it
needs a cheap answer with an honest error bar. This package promotes
the boundary-MPS contractor
(:mod:`tnc_tpu_torch.tensornetwork.approximate`) into that serving tier:

- :class:`ApproxProgram` (``program.py``) — serving workloads mapped
  onto the boundary contractor: PEPS sandwiches via
  ``collapse_peps_sandwich``, nearest-neighbour circuit amplitudes and
  expectation/marginal sandwiches flattened into qubit×depth grids,
  all with rebindable leaf sites (per-request payloads swap leaf data
  without rebuilding the grid — the ``serve/rebind`` contract).
- :class:`ChiLadder` (``ladder.py``) — runs a request at ascending
  ``chi`` rungs, derives a per-answer error estimate from discarded
  SVD weight plus inter-rung deltas, and reports
  ``(value, err, chi_used)``; converged answers stop climbing,
  unconverged ones escalate.
- ``cost.py`` — closed-form flop/byte pricing of every rung through
  :class:`~tnc_tpu_torch.obs.calibrate.CalibratedCostModel`, so admission
  control quotes approximate-tier latency exactly like exact plans.

The service front end routes ``rtol=``-tolerant requests here and
escalates misses to the exact pipeline
(:class:`~tnc_tpu_torch.serve.service.FidelityRouter`). On the card,
``backend="torch"`` sweeps run ``torch.linalg`` on CUDA tensors
(:mod:`tnc_tpu_torch.tensornetwork.approximate`).
"""

from tnc_tpu_torch.approx.cost import (  # noqa: F401
    SweepCost,
    default_chis,
    exact_chi_bound,
    ladder_seconds,
    rung_seconds,
    sweep_cost,
)
from tnc_tpu_torch.approx.ladder import (  # noqa: F401
    ChiLadder,
    LadderResult,
    Rung,
)
from tnc_tpu_torch.approx.program import (  # noqa: F401
    ApproxProgram,
    circuit_to_grid,
    sandwich_to_grid,
)
