"""Env-gated span recording (the port's copy of the span part of
``tnc_tpu.obs.core``).

- :func:`span` — a context manager recording the wall time, nesting depth,
  process and thread id and attributes of one pipeline stage
  (``with obs.span("step[3] 4x8·8x2", flops=64): ...``). Completed spans
  land in the process-local :class:`MetricsRegistry`.

Everything is **disabled unless ``TNC_TPU_TRACE`` is set** (or
:func:`configure` is called): the disabled path is one module-level bool
check returning a shared no-op span. ``TNC_TPU_TRACE`` values: unset,
``0``, ``false``, ``off`` or ``no`` → off; anything else → record
in-process. The reference also exports a Chrome trace when the value is a
path; the port records and writes no file. ``TNC_TPU_STEP_TIME`` turns on
the per-step timing mode (:func:`step_timing_enabled`), read with the same
truthy rule.

>>> from tnc_tpu_torch import obs
>>> _ = obs.configure(enabled=True, registry=MetricsRegistry())
>>> with obs.span("compile", steps=3):
...     with obs.span("execute"):
...         pass
>>> [(r.name, r.depth, r.args) for r in obs.get_registry().span_records()]
[('execute', 1, {}), ('compile', 0, {'steps': 3})]
>>> _ = obs.configure(enabled=False)
"""

from __future__ import annotations

import os
import threading
import time
from dataclasses import dataclass, field
from typing import Any

_TRUTHY = ("1", "true", "yes", "on")

# Cap on retained span records: a runaway per-slice loop must not grow
# memory without bound; past the cap, spans are counted but dropped.
_MAX_SPANS_DEFAULT = 200_000


@dataclass(frozen=True)
class SpanRecord:
    """One completed (or still-open at read time) span."""

    name: str
    start_ns: int  # relative to the registry epoch
    dur_ns: int
    pid: int
    tid: int
    thread_name: str
    depth: int
    args: dict = field(default_factory=dict)


class MetricsRegistry:
    """Process-local span store. Thread-safe; one module-level instance
    serves the whole process (:func:`get_registry`), tests may swap in a
    fresh one via :func:`configure`."""

    def __init__(self, max_spans: int | None = None) -> None:
        self._lock = threading.Lock()
        self._spans: list[SpanRecord] = []
        self._active: dict[int, "Span"] = {}
        self._dropped = 0
        if max_spans is None:
            max_spans = int(
                os.environ.get("TNC_TPU_TRACE_MAX_SPANS", _MAX_SPANS_DEFAULT)
            )
        self._max_spans = max_spans
        self.epoch_ns = time.perf_counter_ns()

    def _span_opened(self, sp: "Span") -> None:
        with self._lock:
            self._active[id(sp)] = sp

    def _span_closed(self, sp: "Span", rec: SpanRecord) -> None:
        with self._lock:
            self._active.pop(id(sp), None)
            if len(self._spans) >= self._max_spans:
                self._dropped += 1
                return
            self._spans.append(rec)

    def span_records(self, include_open: bool = False) -> list[SpanRecord]:
        """Completed spans (chronological by end time). With
        ``include_open``, still-running spans are appended with their
        duration measured up to now."""
        now = time.perf_counter_ns()
        with self._lock:
            recs = list(self._spans)
            if include_open:
                recs.extend(sp._record(now) for sp in self._active.values())
        return recs

    def dropped_spans(self) -> int:
        with self._lock:
            return self._dropped


class _NullSpan:
    """Shared no-op span: the whole disabled-path cost of ``with
    obs.span(...)`` is returning this singleton."""

    __slots__ = ()

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc: Any) -> bool:
        return False

    def set(self, **args: Any) -> "_NullSpan":
        return self


NULL_SPAN = _NullSpan()

_TLS = threading.local()


def _stack() -> list:
    st = getattr(_TLS, "stack", None)
    if st is None:
        st = _TLS.stack = []
    return st


class Span:
    """A live span. Use via :func:`span`; not constructed directly."""

    __slots__ = ("name", "args", "_reg", "_start_ns", "_depth", "_tid",
                 "_tname")

    def __init__(self, name: str, registry: MetricsRegistry, args: dict):
        self.name = name
        self.args = args
        self._reg = registry

    def set(self, **args: Any) -> "Span":
        """Attach or overwrite span attributes."""
        self.args.update(args)
        return self

    def __enter__(self) -> "Span":
        st = _stack()
        self._depth = len(st)
        st.append(self)
        th = threading.current_thread()
        self._tid = th.ident or 0
        self._tname = th.name
        self._reg._span_opened(self)
        self._start_ns = time.perf_counter_ns()
        return self

    def _record(self, end_ns: int) -> SpanRecord:
        return SpanRecord(
            name=self.name,
            start_ns=self._start_ns - self._reg.epoch_ns,
            dur_ns=max(end_ns - self._start_ns, 0),
            pid=os.getpid(),
            tid=self._tid,
            thread_name=self._tname,
            depth=self._depth,
            args=dict(self.args),
        )

    def __exit__(self, *exc: Any) -> bool:
        end_ns = time.perf_counter_ns()
        st = _stack()
        if st and st[-1] is self:
            st.pop()
        elif self in st:  # out-of-order exit: drop up to this span
            del st[st.index(self):]
        self._reg._span_closed(self, self._record(end_ns))
        return False


# -- module-level state + API ------------------------------------------

_ENABLED = False
_STEP_TIME = False
_REGISTRY = MetricsRegistry()


def enabled() -> bool:
    """Is recording on? The one check every instrumented call site pays."""
    return _ENABLED


def step_timing_enabled() -> bool:
    """Is the opt-in per-step timing mode on (``TNC_TPU_STEP_TIME``)?

    When true *and* recording is on, :class:`~tnc_tpu_torch.ops.backends.
    TorchBackend` runs a whole program one launch unit at a time, each
    span closing after ``torch.cuda.synchronize()`` — so every step span
    carries a measured wall time next to its predicted flops and bytes (the
    calibration input, :mod:`tnc_tpu_torch.obs.calibrate`). The numpy
    oracle is synchronous anyway and records step spans whenever tracing
    is on. Off (the default): no per-step synchronisation."""
    return _STEP_TIME


def get_registry() -> MetricsRegistry:
    return _REGISTRY


def configure(
    enabled: bool | None = None,
    registry: MetricsRegistry | None = None,
    step_time: bool | None = None,
) -> MetricsRegistry:
    """Programmatic override of the env gates. Returns the active
    registry. ``step_time`` overrides the ``TNC_TPU_STEP_TIME`` mode."""
    global _ENABLED, _STEP_TIME, _REGISTRY
    if registry is not None:
        _REGISTRY = registry
    if enabled is not None:
        _ENABLED = bool(enabled)
    if step_time is not None:
        _STEP_TIME = bool(step_time)
    return _REGISTRY


def reset() -> MetricsRegistry:
    """Swap in a fresh registry (keeps the enabled flag)."""
    return configure(registry=MetricsRegistry())


def refresh_from_env() -> bool:
    """Re-read ``TNC_TPU_TRACE`` / ``TNC_TPU_STEP_TIME`` (import-time
    defaults; call after changing the env mid-process). Returns the new
    enabled state.

    >>> import os
    >>> old = os.environ.get("TNC_TPU_TRACE")
    >>> os.environ["TNC_TPU_TRACE"] = "Off"
    >>> refresh_from_env()
    False
    >>> os.environ["TNC_TPU_TRACE"] = "trace.json"  # records, writes no file
    >>> refresh_from_env()
    True
    >>> _ = os.environ.pop("TNC_TPU_TRACE") if old is None else os.environ.update(
    ...     TNC_TPU_TRACE=old)
    >>> _ = refresh_from_env()
    """
    global _ENABLED, _STEP_TIME
    _STEP_TIME = (
        os.environ.get("TNC_TPU_STEP_TIME", "").strip().lower() in _TRUTHY
    )
    raw = os.environ.get("TNC_TPU_TRACE", "").strip()
    _ENABLED = not (not raw or raw == "0" or raw.lower() in ("false", "off", "no"))
    return _ENABLED


def span(name: str, **args: Any):
    """Open a span for one pipeline stage. No-op singleton when disabled.
    Keyword arguments become span attributes."""
    if not _ENABLED:
        return NULL_SPAN
    return Span(name, _REGISTRY, args)


refresh_from_env()
