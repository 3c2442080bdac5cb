"""Failure classification + bounded retry for device-dispatch boundaries
(the port's copy of ``tnc_tpu.resilience.retry``).

A long sliced contraction or a serving process should keep as much
finished work as it can when the runtime throws. Three classes
(:class:`FailureClass`):

- ``TRANSIENT`` — preemption notices, disconnects, deadline/timeout
  errors: safe to retry the same dispatch after a backoff (the work is
  deterministic and no state was consumed).
- ``RESOURCE`` — ``torch.cuda.OutOfMemoryError`` ("CUDA out of memory"),
  ``RESOURCE_EXHAUSTED``: retrying the identical work fails identically;
  the caller must *degrade* (a smaller slice batch — the ladder inside
  :mod:`tnc_tpu_torch.ops.chunked`).
- ``FATAL`` — everything else (shape errors, bugs), and above all a
  *sticky* CUDA error ("an illegal memory access was encountered",
  "unspecified launch failure", a device-side assert): after one the CUDA
  context is unusable, so no retry may spin on it — checked before the
  other classes, as is the port's own kernel build or launch
  ``RuntimeError`` (:mod:`tnc_tpu_torch.ops.cuda_complex`).

Classification is message/type-based; the injected faults
(:mod:`tnc_tpu_torch.resilience.faultinject`) carry the reference's
status prefixes, so every recovery path is exercisable on the CPU.

:class:`RetryPolicy` is the shared bounded-attempts/exponential-backoff
engine applied at the dispatch boundaries (``ops/backends.py``,
``ops/chunked.py``, the service's batch dispatch). Every retry is
visible as ``resilience.retry`` obs counters.

>>> classify_exception(RuntimeError("RESOURCE_EXHAUSTED: out of memory"))
<FailureClass.RESOURCE: 'resource'>
>>> classify_exception(ConnectionResetError("peer vanished"))
<FailureClass.TRANSIENT: 'transient'>
>>> classify_exception(RuntimeError("CUDA error: an illegal memory access was encountered"))
<FailureClass.FATAL: 'fatal'>
>>> classify_exception(ValueError("bad shape"))
<FailureClass.FATAL: 'fatal'>
"""

from __future__ import annotations

import enum
import logging
import os
import random
import re
import time
from dataclasses import dataclass, field
from typing import Any, Callable

from tnc_tpu_torch import obs

logger = logging.getLogger(__name__)


class FailureClass(enum.Enum):
    TRANSIENT = "transient"
    RESOURCE = "resource"
    FATAL = "fatal"


# Substrings matched (case-insensitively) against "TypeName: message".
_RESOURCE_PATTERNS = (
    "resource_exhausted",
    "resource exhausted",
    "out of memory",
    "failed to allocate",
    "allocation failure",
)
# "oom" needs word boundaries: a bare substring would classify any
# message containing "room"/"zoom"/"bloom" as RESOURCE and send a fatal
# bug through the degradation ladder
_OOM_RE = re.compile(r"\boom\b")
_TRANSIENT_PATTERNS = (
    "unavailable",
    "deadline_exceeded",
    "deadline exceeded",
    "aborted",
    "cancelled",
    "preempt",
    "disconnect",
    "connection reset",
    "connection refused",
    "connection closed",
    "socket closed",
    "broken pipe",
    "heartbeat",
)
_TRANSIENT_TYPES = (ConnectionError, TimeoutError, BrokenPipeError)
# Sticky CUDA errors poison the context (every later call fails the
# same way), and the port's own kernel build or launch failures are
# deterministic: both FATAL whatever else their text matches — a launch
# error reported as "CUDA error 2 (out of memory)" must not send the
# chunked executor down its batch-halving ladder on a dead context.
_FATAL_PATTERNS = (
    "illegal memory access",
    "unspecified launch failure",
    "misaligned address",
    "illegal instruction",
    "device-side assert",
    "uncorrectable ecc error",
    "hardware stack error",
    "launch timed out",
    "kernel failed: cuda error",
    "kernel build failed",
    "nvcc not found",
    "library and wrapper disagree",
)


def classify_exception(exc: BaseException) -> FailureClass:
    """Map an exception to the retry/degrade/re-raise decision.

    Checks the exception (and, for wrappers, its ``__cause__`` chain) by
    type and by its text. A sticky CUDA error or a kernel build or launch
    failure of the port is FATAL before anything else matches;
    ``torch.cuda.OutOfMemoryError`` is RESOURCE; RESOURCE beats TRANSIENT
    when both match — an OOM wrapped in an ABORTED status must degrade,
    not spin.

    :class:`RetryExhaustedError` is FATAL by definition: its retries are
    already spent, and letting an outer dispatch boundary classify the
    embedded transient text as TRANSIENT would stack retry ladders
    (``max_attempts²`` dispatches through nested boundaries).
    """
    seen = 0
    cur: BaseException | None = exc
    while cur is not None and seen < 4:  # short cause chains only
        if isinstance(cur, RetryExhaustedError):
            # checked anywhere in the chain: a wrapped exhausted ladder
            # (e.g. inside PartitionExecutionError) must not re-match
            # the transient text embedded in its message
            return FailureClass.FATAL
        text = f"{type(cur).__name__}: {cur}".lower()
        if any(p in text for p in _FATAL_PATTERNS):
            return FailureClass.FATAL
        if type(cur).__name__ == "OutOfMemoryError":
            return FailureClass.RESOURCE
        if any(p in text for p in _RESOURCE_PATTERNS) or _OOM_RE.search(text):
            return FailureClass.RESOURCE
        if isinstance(cur, _TRANSIENT_TYPES) or any(
            p in text for p in _TRANSIENT_PATTERNS
        ):
            return FailureClass.TRANSIENT
        # multiprocessing.TimeoutError does not subclass TimeoutError
        if type(cur).__name__ == "TimeoutError":
            return FailureClass.TRANSIENT
        cur = cur.__cause__
        seen += 1
    return FailureClass.FATAL


class RetryExhaustedError(RuntimeError):
    """All retry attempts failed; carries the attempt count and chains
    the original error (``__cause__``)."""

    def __init__(self, label: str, attempts: int, last: BaseException):
        super().__init__(
            f"{label}: retries exhausted after {attempts} attempt"
            f"{'s' if attempts != 1 else ''}; last error: "
            f"{type(last).__name__}: {last}"
        )
        self.label = label
        self.attempts = attempts
        self.last = last


@dataclass
class RetryPolicy:
    """Bounded attempts with exponential backoff + jitter.

    ``run(fn)`` retries TRANSIENT failures (and RESOURCE when
    ``retry_resource=True`` — off by default: an identical OOM repeats
    identically, degrading is the caller's job); FATAL and unreclassified
    errors re-raise immediately. Exhaustion raises
    :class:`RetryExhaustedError` chained to the original.

    >>> calls = []
    >>> def flaky():
    ...     calls.append(1)
    ...     if len(calls) < 3:
    ...         raise ConnectionResetError("blip")
    ...     return "ok"
    >>> RetryPolicy(max_attempts=3, base_delay_s=0.0).run(flaky)
    'ok'
    >>> len(calls)
    3
    """

    max_attempts: int = 3
    base_delay_s: float = 0.1
    max_delay_s: float = 5.0
    jitter: float = 0.25
    retry_resource: bool = False
    sleep: Callable[[float], None] = field(default=time.sleep, repr=False)

    def delay_s(self, attempt: int, rng: random.Random) -> float:
        """Backoff before retry number ``attempt`` (1-based)."""
        d = min(self.base_delay_s * (2.0 ** (attempt - 1)), self.max_delay_s)
        return d * (1.0 + self.jitter * rng.random())

    def run(
        self,
        fn: Callable[[], Any],
        label: str = "dispatch",
        classify: Callable[[BaseException], FailureClass] = classify_exception,
    ) -> Any:
        rng: random.Random | None = None  # seeded only if something fails
        last: BaseException | None = None
        for attempt in range(1, max(1, self.max_attempts) + 1):
            try:
                return fn()
            except Exception as exc:  # noqa: BLE001 — classified below
                cls = classify(exc)
                retryable = cls is FailureClass.TRANSIENT or (
                    cls is FailureClass.RESOURCE and self.retry_resource
                )
                obs.counter_add(
                    "resilience.retry.errors", site=label, cls=cls.value
                )
                if not retryable:
                    raise
                last = exc
                if attempt < max(1, self.max_attempts):
                    if rng is None:
                        rng = random.Random()
                    d = self.delay_s(attempt, rng)
                    obs.counter_add("resilience.retry.attempts", site=label)
                    logger.warning(
                        "%s failed (%s: %s; classified %s); retry %d/%d "
                        "in %.2fs",
                        label, type(exc).__name__, exc, cls.value,
                        attempt, self.max_attempts - 1, d,
                    )
                    self.sleep(d)
        assert last is not None
        obs.counter_add("resilience.retry.exhausted", site=label)
        raise RetryExhaustedError(label, max(1, self.max_attempts), last) from last


_DEFAULT_POLICY: RetryPolicy | None = None


def default_policy() -> RetryPolicy:
    """Process-wide policy for dispatch boundaries, built once from env:
    ``TNC_TPU_RETRY_ATTEMPTS`` (3), ``TNC_TPU_RETRY_BASE_S`` (0.1),
    ``TNC_TPU_RETRY_MAX_S`` (5.0)."""
    global _DEFAULT_POLICY
    if _DEFAULT_POLICY is None:
        _DEFAULT_POLICY = RetryPolicy(
            max_attempts=int(os.environ.get("TNC_TPU_RETRY_ATTEMPTS", "3")),
            base_delay_s=float(os.environ.get("TNC_TPU_RETRY_BASE_S", "0.1")),
            max_delay_s=float(os.environ.get("TNC_TPU_RETRY_MAX_S", "5.0")),
        )
    return _DEFAULT_POLICY


def configure_retry(policy: RetryPolicy | None) -> None:
    """Override (or, with None, re-derive from env) the default policy —
    tests use tiny backoffs."""
    global _DEFAULT_POLICY
    _DEFAULT_POLICY = policy


def retry_call(fn: Callable[[], Any], label: str = "dispatch") -> Any:
    """``default_policy().run(fn)`` — the one-liner the dispatch
    boundaries use. The fast path (no exception) costs one extra frame."""
    return default_policy().run(fn, label=label)


def sync_dispatch() -> bool:
    """``TNC_TPU_SYNC_DISPATCH=1``: dispatch boundaries call
    ``torch.cuda.synchronize(device)`` inside the guarded region, so
    asynchronously-surfacing CUDA failures (a kernel error normally raises
    at the NEXT synchronising call, outside the guarded region) land
    inside the retry/degradation scope. Off by default: the per-dispatch
    sync costs the host/device overlap, and without it a real async
    failure propagates and crashes (an armed checkpoint still resumes)."""
    return os.environ.get("TNC_TPU_SYNC_DISPATCH", "").lower() in (
        "1", "true", "yes", "on",
    )


def buffers_alive(buffers) -> bool:
    """True when no (possibly (re, im)-paired) device buffer has been
    deleted — e.g. consumed by a donating dispatch. Duck-typed on
    ``is_deleted``: host arrays and torch tensors have none, and a torch
    dispatch donates nothing, so for the port's buffers this is always
    True and :func:`donation_guarded_classify` downgrades nothing.

    >>> import numpy as np
    >>> buffers_alive([np.zeros(2), (np.zeros(1), np.zeros(1))])
    True
    """
    for buf in buffers:
        parts = buf if isinstance(buf, tuple) else (buf,)
        for part in parts:
            is_deleted = getattr(part, "is_deleted", None)
            if is_deleted is not None and is_deleted():
                return False
    return True


def donation_guarded_classify(buffers) -> Callable[[BaseException], FailureClass]:
    """Classifier for dispatch boundaries whose inputs may be donated:
    once a failed dispatch consumed them, a retry would re-dispatch
    deleted arrays and mask the original error — TRANSIENT downgrades to
    FATAL when any input buffer is gone. Kept for the reference's
    surface: a torch dispatch consumes no input, so on the port's buffers
    it classifies as :func:`classify_exception` does."""

    def _classify(exc: BaseException) -> FailureClass:
        cls = classify_exception(exc)
        if cls is FailureClass.TRANSIENT and not buffers_alive(buffers):
            return FailureClass.FATAL
        return cls

    return _classify


def classify_pool_failure(
    exc: BaseException, log: logging.Logger, what: str, can_retry: bool
) -> bool:
    """Shared handling for search-pool failures (genetic / simulated
    annealing): log the real worker error at warning level together with
    the fallback decision (the old ``except Exception: pool.terminate()``
    swallowed it), and return True when the caller should rebuild the
    pool and retry once (TRANSIENT only — and the caller must use a
    FRESH pool: the common transient is a hung worker timing out
    ``map_async().get``, and re-submitting to the wedged pool just burns
    a second timeout) before falling back to serial evaluation."""
    cls = classify_exception(exc)
    retry = can_retry and cls is FailureClass.TRANSIENT
    log.warning(
        "%s failed (%s: %s; classified %s); %s",
        what,
        type(exc).__name__,
        exc,
        cls.value,
        "recreating the pool and retrying once" if retry
        else "falling back to serial evaluation",
    )
    obs.counter_add("resilience.pool_failures", what=what, cls=cls.value)
    return retry


def pool_map_with_retry(pool, submit, rebuild, log: logging.Logger, what: str):
    """The one pool-failure loop shared by the repartitioning searches:
    run ``submit(pool)``; on a TRANSIENT failure terminate the (possibly
    wedged) pool, ``rebuild()`` a fresh one, and retry the same jobs
    once (results are pure functions of the jobs, so the retry is
    exact); anything else — or a second failure — terminates the pool
    and signals serial fallback.

    Returns ``(results, pool)``: ``results`` is None when the caller
    must evaluate serially, and ``pool`` is the surviving pool (None
    once failed over)."""
    attempt = 1
    while pool is not None:
        try:
            return submit(pool), pool
        except Exception as exc:  # noqa: BLE001 — classified below
            pool.terminate()
            if classify_pool_failure(exc, log, what, can_retry=attempt == 1):
                attempt += 1
                try:
                    pool = rebuild()
                except Exception as rexc:  # noqa: BLE001 — degrade, never crash
                    # respawning can fail under the same resource
                    # pressure that wedged the first pool (fork/fd
                    # exhaustion); the search must still complete
                    log.warning(
                        "%s rebuild failed (%s: %s); falling back to "
                        "serial evaluation",
                        what, type(rexc).__name__, rexc,
                    )
                    pool = None
                continue
            pool = None
    return None, None
