"""tnc_tpu_torch.resilience — fault-tolerant execution for long-running
jobs (the port's counterpart of ``tnc_tpu.resilience``).

Three pieces, threaded through the execution stack:

- :mod:`~tnc_tpu_torch.resilience.retry` — exception classification
  (TRANSIENT / RESOURCE / FATAL, sticky CUDA errors FATAL) + the shared
  bounded-backoff :class:`RetryPolicy` applied at every dispatch boundary
  (``TorchBackend``'s runs, the chunked executor's batches, the service's
  batches).
- :mod:`~tnc_tpu_torch.resilience.checkpoint` — atomic slice-range
  checkpoints (``TNC_TPU_CKPT``): the chunked and numpy sliced executors
  persist the partial accumulator + next-slice cursor and resume
  bit-identically after a crash.
- :mod:`~tnc_tpu_torch.resilience.faultinject` — deterministic scripted
  failures (``TNC_TPU_FAULTS``) at the same boundaries, so every recovery
  path is testable on the CPU.

The OOM degradation rung that halves the slice batch lives in
:mod:`tnc_tpu_torch.ops.chunked`; the wider ladder above it (finer
slicing, then a chunked fallback at batch 1) is
:func:`~tnc_tpu_torch.resilience.degrade.execute_sliced_resilient`.

Everything is env/arg-gated with a no-op fast path: with no resilience
env vars set the hot paths pay one bool/dict check.
"""

from tnc_tpu_torch.resilience.checkpoint import (  # noqa: F401
    SliceCheckpoint,
    arrays_digest,
    resolve_ckpt,
    signature_hash,
)
from tnc_tpu_torch.resilience.degrade import execute_sliced_resilient  # noqa: F401
from tnc_tpu_torch.resilience.faultinject import (  # noqa: F401
    InjectedFault,
    InjectedFatal,
    InjectedOOM,
    InjectedTransient,
    configure_faults,
    fault_point,
    faults,
    parse_spec,
)
from tnc_tpu_torch.resilience.retry import (  # noqa: F401
    FailureClass,
    RetryExhaustedError,
    RetryPolicy,
    buffers_alive,
    classify_exception,
    classify_pool_failure,
    configure_retry,
    default_policy,
    donation_guarded_classify,
    pool_map_with_retry,
    retry_call,
    sync_dispatch,
)
