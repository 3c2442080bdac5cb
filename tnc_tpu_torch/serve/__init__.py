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

- :class:`ClusterDispatcher` / :func:`serve_cluster` (``multihost.py``)
  — one queue served by every process of a ``torch.distributed`` group:
  bras or slice ranges sharded across processes, rows gathered at the
  root over the c10d store, a lost process's share recomputed there.
- :class:`ElasticController`, :class:`LocalAutoscaler`,
  :func:`weighted_fair_order` (``elastic.py``) — live membership, tenant
  quotas and weights, priorities, scale decisions.
- The background replanner and shared-cache watcher (``replan.py``), the
  planner pod (``plansvc.py``).
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
from tnc_tpu_torch.serve.elastic import (  # noqa: F401
    ElasticConfig,
    ElasticController,
    LocalAutoscaler,
    assign_ranges,
    live_processes,
    weighted_fair_order,
)
from tnc_tpu_torch.serve.multihost import (  # noqa: F401
    ClusterDispatcher,
    DispatcherStoppedError,
    cluster_amplitudes,
    cluster_amplitudes_sliced,
    serve_cluster,
    shard_ranges,
)
from tnc_tpu_torch.serve.replan import (  # noqa: F401
    BackgroundReplanner,
    SharedCacheWatcher,
)
from tnc_tpu_torch.serve.service import (  # noqa: F401
    ApproxAnswer,
    ContractionService,
    DeadlineExceededError,
    FidelityRouter,
    QueueFullError,
    ServeError,
    ServiceClosedError,
    TenantQuotaError,
)
