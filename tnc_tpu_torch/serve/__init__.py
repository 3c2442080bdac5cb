"""tnc_tpu_torch.serve — query serving (the port's counterpart of
``tnc_tpu.serve``): plan cache, bra rebinding, cross-request reuse and the
micro-batching front end.

The serving pipeline, front to back:

- :class:`ContractionService` (``service.py``) — a MIXED request queue
  (amplitudes + the :mod:`tnc_tpu_torch.queries` query types: sampling,
  Pauli expectation values, marginal sweeps, each with a per-type batching
  key), micro-batching window, deadlines, admission control, dedup,
  retry + batch→singleton degradation, per-type and per-tier accounting;
  on the card one ``TorchBackend`` for the service's life.
- :class:`FidelityRouter` (``service.py``) — fidelity tiers:
  ``submit*(..., rtol=)`` routes tolerant requests to the boundary-MPS
  chi-ladder tier (:mod:`tnc_tpu_torch.approx`) under its own batching
  key, returns :class:`ApproxAnswer` ``(value, err, chi_used)``, and
  escalates tolerance misses to the exact pipeline (counted, capped).
- :class:`BoundProgram` / :func:`bind_circuit` (``rebind.py``) — one
  planned program per circuit *structure*; per-request bra leaf data is
  rebound, and B requests batched into one dispatch, without replanning.
- :class:`PlanCache` (``plancache.py``) — persistent, LRU-bounded
  ``{path, slicing, hoist split}`` store keyed by a stable structure
  digest; repeat circuits skip the planner entirely.
- :class:`IntermediateStore` / :func:`compute_split` (``reuse.py``) —
  cross-request numeric reuse: every bound plan split into a
  content-addressed cached prefix plus a per-request residual.

The reference's background replanner, multi-host and elastic layers, the
planner fleet, and the SLO, cost-truth, telemetry and fleet planes of its
service are not ported (ROADMAP A10).
"""

from tnc_tpu_torch.serve.plancache import (  # noqa: F401
    PlanCache,
    network_structure_digest,
)
from tnc_tpu_torch.serve.rebind import (  # noqa: F401
    BoundProgram,
    bind_circuit,
    bind_template,
    plan_signature,
    plan_structure,
    pow2_bucket,
    stacked_bras,
    thread_batch,
)
from tnc_tpu_torch.serve.reuse import (  # noqa: F401
    IntermediateStore,
    ReuseBinding,
    compute_split,
)
from tnc_tpu_torch.serve.service import (  # noqa: F401
    ApproxAnswer,
    ContractionService,
    DeadlineExceededError,
    FidelityRouter,
    QueueFullError,
    ServeError,
    ServiceClosedError,
)
