"""Env-gated spans and metrics (the port's copy of ``tnc_tpu.obs.core``).

- :func:`span` — a context manager recording the wall time, nesting depth,
  process and thread id and attributes of one pipeline stage
  (``with obs.span("step[3] 4x8·8x2", flops=64): ...``). Completed spans
  land in the process-local :class:`MetricsRegistry`.
- :func:`counter_add` / :func:`gauge_set` / :func:`observe` — named
  metrics with optional labels, aggregated in the same registry
  (histograms as bounded streaming :class:`QuantileSummary` blocks);
  :func:`counters_by_prefix` reads a subsystem's counters back (the
  resilience frames count retries, degradations, checkpoint saves and
  resumes and fired faults under ``resilience.``).

Everything is **disabled unless ``TNC_TPU_TRACE`` is set** (or
:func:`configure` is called): the disabled path is one module-level bool
check returning a shared no-op span. ``TNC_TPU_TRACE`` values: unset,
``0``, ``false``, ``off`` or ``no`` → off; ``1``, ``true``, ``yes`` or
``on`` → record in-process; any other value → record *and* export a
Chrome trace to that path at interpreter exit
(:mod:`tnc_tpu_torch.obs.export`; a process of a ``torch.distributed``
group of several writes its own :func:`process_trace_path`).
``TNC_TPU_STEP_TIME`` turns on the per-step timing mode
(:func:`step_timing_enabled`), read with the same truthy rule.
``TNC_TPU_TRACE_JAX=<dir>`` (the reference's name) makes
:func:`maybe_jax_profiler_trace` run a ``torch.profiler`` trace into that
directory.

>>> from tnc_tpu_torch import obs
>>> _ = obs.configure(enabled=True, registry=MetricsRegistry())
>>> with obs.span("compile", steps=3):
...     with obs.span("execute"):
...         pass
>>> [(r.name, r.depth, r.args) for r in obs.get_registry().span_records()]
[('execute', 1, {}), ('compile', 0, {'steps': 3})]
>>> with obs.span("compile") as sp:
...     _ = sp.add(flops=100)
>>> obs.get_registry().counters()[('compile.flops', ())]
100.0
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


class _P2Quantile:
    """One streaming quantile via the P² algorithm (Jain & Chlamtac
    1985): five markers tracked in O(1) memory per observation — no
    retained samples. Below 5 observations the estimate is the exact
    nearest-rank percentile of what was seen."""

    __slots__ = ("p", "_q", "_n", "_np", "_dn", "_count")

    def __init__(self, p: float):
        if not 0.0 < p < 1.0:
            raise ValueError("quantile must be in (0, 1)")
        self.p = float(p)
        self._q: list[float] = []  # marker heights (sorted samples < 5)
        self._n = [0.0, 1.0, 2.0, 3.0, 4.0]  # marker positions
        self._np = [0.0, 2 * p, 4 * p, 2 + 2 * p, 4.0]  # desired positions
        self._dn = [0.0, p / 2, p, (1 + p) / 2, 1.0]
        self._count = 0

    def observe(self, x: float) -> None:
        self._count += 1
        q = self._q
        if len(q) < 5:
            q.append(x)
            q.sort()
            return
        n = self._n
        if x < q[0]:
            q[0] = x
            k = 0
        elif x >= q[4]:
            q[4] = x
            k = 3
        else:
            k = 0
            for i in range(1, 5):
                if x < q[i]:
                    k = i - 1
                    break
        for i in range(k + 1, 5):
            n[i] += 1.0
        for i in range(5):
            self._np[i] += self._dn[i]
        for i in (1, 2, 3):
            d = self._np[i] - n[i]
            if (d >= 1.0 and n[i + 1] - n[i] > 1.0) or (
                d <= -1.0 and n[i - 1] - n[i] < -1.0
            ):
                sign = 1 if d > 0 else -1
                cand = self._parabolic(i, sign)
                if not (q[i - 1] < cand < q[i + 1]):
                    cand = self._linear(i, sign)
                q[i] = cand
                n[i] += sign

    def _parabolic(self, i: int, d: int) -> float:
        q, n = self._q, self._n
        return q[i] + d / (n[i + 1] - n[i - 1]) * (
            (n[i] - n[i - 1] + d) * (q[i + 1] - q[i]) / (n[i + 1] - n[i])
            + (n[i + 1] - n[i] - d) * (q[i] - q[i - 1]) / (n[i] - n[i - 1])
        )

    def _linear(self, i: int, d: int) -> float:
        q, n = self._q, self._n
        return q[i] + d * (q[i + d] - q[i]) / (n[i + d] - n[i])

    def value(self) -> float:
        if self._count == 0:
            return 0.0
        if self._count <= 5:
            s = self._q
            return float(s[min(len(s) - 1, int(self.p * (len(s) - 1)))])
        return float(self._q[2])


class QuantileSummary:
    """Bounded streaming distribution summary: count / sum / min / max
    plus P² estimates for a fixed quantile set — p50/p90/p99 without
    retaining raw samples, however long the stream runs. The percentile
    surface of :meth:`MetricsRegistry.observe` and of the serving
    ``stats()`` latency blocks.

    >>> s = QuantileSummary()
    >>> for v in range(1, 101):
    ...     s.observe(float(v))
    >>> snap = s.snapshot()
    >>> (snap["count"], snap["min"], snap["max"])
    (100, 1.0, 100.0)
    >>> 40.0 <= snap["p50"] <= 60.0
    True
    """

    QUANTILES = (0.5, 0.9, 0.99)
    __slots__ = ("count", "sum", "min", "max", "_estimators")

    def __init__(self, quantiles: tuple = QUANTILES):
        self.count = 0
        self.sum = 0.0
        self.min = 0.0
        self.max = 0.0
        self._estimators = {float(q): _P2Quantile(q) for q in quantiles}

    def observe(self, value: float) -> None:
        value = float(value)
        if self.count == 0:
            self.min = self.max = value
        else:
            self.min = min(self.min, value)
            self.max = max(self.max, value)
        self.count += 1
        self.sum += value
        for est in self._estimators.values():
            est.observe(value)

    def quantile(self, q: float) -> float:
        est = self._estimators.get(float(q))
        if est is None:
            raise KeyError(f"quantile {q} is not tracked")
        return est.value()

    def quantiles(self) -> dict[float, float]:
        return {q: est.value() for q, est in self._estimators.items()}

    def snapshot(self) -> dict:
        """Plain-data view; quantiles rendered as ``p50``-style keys."""
        out = {
            "count": self.count, "sum": self.sum,
            "min": self.min, "max": self.max,
        }
        for q, est in self._estimators.items():
            out[f"p{q * 100:g}".replace(".", "_")] = est.value()
        return out


class MetricsRegistry:
    """Process-local metric and span store. Thread-safe; one module-level
    instance serves the whole process (:func:`get_registry`), tests may
    swap in a fresh one via :func:`configure`.

    >>> reg = MetricsRegistry()
    >>> reg.counter_add("slices", 4)
    >>> reg.counter_add("slices", 2)
    >>> reg.counter_add("cache", 1, kind="hit")
    >>> reg.counters()[("slices", ())]
    6.0
    >>> reg.gauge_set("peak_bytes", 2.0**29)
    >>> reg.observe("step_ms", 1.5); reg.observe("step_ms", 2.5)
    >>> h = reg.histograms()[("step_ms", ())]
    >>> (h["count"], h["sum"], h["min"], h["max"])
    (2, 4.0, 1.5, 2.5)
    >>> sorted(k for k in h if k.startswith("p"))
    ['p50', 'p90', 'p99']
    """

    def __init__(self, max_spans: int | None = None) -> None:
        self._lock = threading.Lock()
        self._counters: dict[tuple, float] = {}
        self._gauges: dict[tuple, float] = {}
        self._hists: dict[tuple, QuantileSummary] = {}
        self._spans: list[SpanRecord] = []
        self._active: dict[int, "Span"] = {}
        self._dropped = 0
        if max_spans is None:
            max_spans = int(
                os.environ.get("TNC_TPU_TRACE_MAX_SPANS", _MAX_SPANS_DEFAULT)
            )
        self._max_spans = max_spans
        self.epoch_ns = time.perf_counter_ns()
        # wall-clock twin of the perf-counter epoch, captured at the same
        # instant: span timestamps are perf-counter-relative, so merging
        # traces of different processes needs this anchor
        # (tnc_tpu_torch.obs.export.merge_trace_files)
        self.epoch_unix_ns = time.time_ns()

    # -- metrics ---------------------------------------------------------
    @staticmethod
    def _key(name: str, labels: dict) -> tuple:
        return (name, tuple(sorted(labels.items())))

    def counter_add(self, name: str, value: float = 1.0, **labels) -> None:
        key = self._key(name, labels)
        with self._lock:
            self._counters[key] = self._counters.get(key, 0.0) + float(value)

    def gauge_set(self, name: str, value: float, **labels) -> None:
        with self._lock:
            self._gauges[self._key(name, labels)] = float(value)

    def observe(self, name: str, value: float, **labels) -> None:
        key = self._key(name, labels)
        with self._lock:
            h = self._hists.get(key)
            if h is None:
                h = self._hists[key] = QuantileSummary()
            h.observe(value)

    def counters(self) -> dict[tuple, float]:
        with self._lock:
            return dict(self._counters)

    def gauges(self) -> dict[tuple, float]:
        with self._lock:
            return dict(self._gauges)

    def histograms(self) -> dict[tuple, dict]:
        """Plain-data snapshots, each taken under the lock (so each block
        is internally consistent)."""
        with self._lock:
            return {k: v.snapshot() for k, v in self._hists.items()}

    # -- spans -----------------------------------------------------------
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

    def recent_spans(
        self, n: int, include_open: bool = False
    ) -> list[SpanRecord]:
        """The last ``n`` completed spans (optionally with still-open spans
        appended) — an O(n) slice under the lock, not a copy of the whole
        store; the flight recorder polls this on a cadence."""
        now = time.perf_counter_ns()
        with self._lock:
            recs = self._spans[-max(int(n), 0):]
            if include_open:
                recs = recs + [sp._record(now) for sp in self._active.values()]
        return recs

    def dropped_spans(self) -> int:
        with self._lock:
            return self._dropped

    def span_stats(
        self, max_depth: int | None = None, tid: int | None = None
    ) -> dict[str, dict]:
        """Aggregate wall time per span name: ``{name: {count, total_s,
        min_s, max_s}}``. ``max_depth`` keeps only spans at or above a
        nesting level (``0`` = top-level phases only); depth is **per
        thread**, so breakdowns over multi-threaded runs should also pin
        ``tid`` to the coordinating thread."""
        out: dict[str, dict] = {}
        for rec in self.span_records():
            if max_depth is not None and rec.depth > max_depth:
                continue
            if tid is not None and rec.tid != tid:
                continue
            s = out.get(rec.name)
            dur = rec.dur_ns / 1e9
            if s is None:
                out[rec.name] = {
                    "count": 1, "total_s": dur, "min_s": dur, "max_s": dur
                }
            else:
                s["count"] += 1
                s["total_s"] += dur
                s["min_s"] = min(s["min_s"], dur)
                s["max_s"] = max(s["max_s"], dur)
        return out

    def snapshot(self) -> dict:
        """Plain-data snapshot of every metric (JSON-ready; labels as
        ``name{k=v}`` strings)."""
        fmt = format_metric_key
        return {
            "counters": {fmt(k): v for k, v in self.counters().items()},
            "gauges": {fmt(k): v for k, v in self.gauges().items()},
            "histograms": {fmt(k): v for k, v in self.histograms().items()},
            "dropped_spans": self.dropped_spans(),
        }


def format_metric_key(key: tuple) -> str:
    """Registry metric key → ``name`` / ``name{k=v,...}`` string — the one
    rendering rule shared by :meth:`MetricsRegistry.snapshot` and
    :func:`counters_by_prefix`.

    >>> format_metric_key(("serve.requests", (("kind", "amplitude"),)))
    'serve.requests{kind=amplitude}'
    """
    name, labels = key
    if not labels:
        return name
    inner = ",".join(f"{k}={v}" for k, v in labels)
    return f"{name}{{{inner}}}"


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

    def add(self, **counters: Any) -> "_NullSpan":
        return self


NULL_SPAN = _NullSpan()

_TLS = threading.local()


def _stack() -> list:
    st = getattr(_TLS, "stack", None)
    if st is None:
        st = _TLS.stack = []
    return st


class _TraceArgsCtx:
    """Scope for :func:`trace_args`: while active, every span opened on
    this thread inherits the given args (explicit span args win)."""

    __slots__ = ("_args", "_prev")

    def __init__(self, args: dict):
        self._args = args

    def __enter__(self) -> "_TraceArgsCtx":
        self._prev = getattr(_TLS, "trace_extra", None)
        if self._args:
            merged = dict(self._prev) if self._prev else {}
            merged.update(self._args)
            _TLS.trace_extra = merged
        return self

    def __exit__(self, *exc: Any) -> bool:
        if self._args:
            _TLS.trace_extra = self._prev
        return False


def trace_args(**args: Any) -> _TraceArgsCtx:
    """Attach ambient args to every span this thread opens inside the
    context (request ids a dispatch carries, say). Nesting merges (inner
    wins); explicit span args always win over ambient ones.

    >>> _ = configure(enabled=True, registry=MetricsRegistry())
    >>> with trace_args(riders="r1,r2"):
    ...     with span("serve.dispatch") as sp:
    ...         pass
    >>> get_registry().span_records()[-1].args["riders"]
    'r1,r2'
    >>> _ = configure(enabled=False)
    """
    return _TraceArgsCtx(args)


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

    def add(self, **counters: Any) -> "Span":
        """Accumulate numeric counters onto the span *and* the registry
        (as ``<span name>.<counter>``)."""
        for key, value in counters.items():
            self.args[key] = self.args.get(key, 0) + value
            self._reg.counter_add(f"{self.name}.{key}", value)
        return self

    def __enter__(self) -> "Span":
        extra = getattr(_TLS, "trace_extra", None)
        if extra:
            self.args = {**extra, **self.args}
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
_TRACE_PATH: str | None = None
_REGISTRY = MetricsRegistry()
_ATEXIT_REGISTERED = False


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


def trace_path() -> str | None:
    """Chrome-trace export path at exit (from ``TNC_TPU_TRACE=<path>`` or
    ``configure(trace_path=...)``), or None."""
    return _TRACE_PATH


def configure(
    enabled: bool | None = None,
    registry: MetricsRegistry | None = None,
    trace_path: str | None = None,
    step_time: bool | None = None,
) -> MetricsRegistry:
    """Programmatic override of the env gates. Returns the active
    registry. ``trace_path`` arms the Chrome-trace export at exit;
    ``step_time`` overrides the ``TNC_TPU_STEP_TIME`` mode."""
    global _ENABLED, _STEP_TIME, _TRACE_PATH, _REGISTRY
    if registry is not None:
        _REGISTRY = registry
    if enabled is not None:
        _ENABLED = bool(enabled)
    if trace_path is not None:
        _TRACE_PATH = trace_path
        _register_atexit()
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
    >>> os.environ["TNC_TPU_TRACE"] = "on"  # records; a path also exports
    >>> refresh_from_env()
    True
    >>> _ = os.environ.pop("TNC_TPU_TRACE") if old is None else os.environ.update(
    ...     TNC_TPU_TRACE=old)
    >>> _ = refresh_from_env()
    """
    global _ENABLED, _STEP_TIME, _TRACE_PATH
    _STEP_TIME = (
        os.environ.get("TNC_TPU_STEP_TIME", "").strip().lower() in _TRUTHY
    )
    raw = os.environ.get("TNC_TPU_TRACE", "").strip()
    if not raw or raw == "0" or raw.lower() in ("false", "off", "no"):
        _ENABLED = False
        # the flight recorder needs span recording: arming it (env
        # TNC_TPU_FLIGHT_RECORDER) turns the registry back on
        _maybe_arm_flight_recorder()
        return _ENABLED
    _ENABLED = True
    if raw.lower() not in _TRUTHY:
        _TRACE_PATH = raw
        _register_atexit()
    _maybe_arm_flight_recorder()
    return True


def process_identity() -> tuple[int, int]:
    """``(process count, process index)`` of this process: from
    ``torch.distributed`` when a process group is up
    (``get_world_size()``, ``get_rank()``), else ``(1, 0)``; a process
    that never imported ``torch.distributed`` has no group. The reference
    asks ``jax.process_count()`` / ``jax.process_index()``."""
    import sys

    # a process group needs torch.distributed imported; importing it here
    # (at interpreter exit, say) to learn that none is up is not safe
    dist = sys.modules.get("torch.distributed")
    try:
        if dist is not None and dist.is_available() and dist.is_initialized():
            return int(dist.get_world_size()), int(dist.get_rank())
    except Exception:  # noqa: BLE001 — a torn-down group: one process
        pass
    return 1, 0


def process_trace_path(
    path: str,
    process_index: int | None = None,
    process_count: int | None = None,
) -> str:
    """Per-process variant of a trace export path: in a group of several
    processes each suffixes its index (``trace.json`` → ``trace.p1.json``)
    so no process clobbers another's export. One process (and a process
    with no process group up) keeps the path unchanged. Explicit index and
    count override the :func:`process_identity` probe.

    >>> process_trace_path("/tmp/t.json", process_index=2,
    ...                    process_count=4)
    '/tmp/t.p2.json'
    >>> process_trace_path("/tmp/t.json", process_index=0,
    ...                    process_count=1)
    '/tmp/t.json'
    """
    if process_index is None or process_count is None:
        process_count, process_index = process_identity()
    if process_count <= 1:
        return path
    root, ext = os.path.splitext(path)
    return f"{root}.p{process_index}{ext or '.json'}"


def _maybe_arm_flight_recorder() -> None:
    """Arm the crash flight recorder when ``TNC_TPU_FLIGHT_RECORDER`` names
    a directory (lazy import — the fleet module loads only when the
    feature is on). The recorder needs span recording, so arming it also
    enables the registry."""
    global _ENABLED
    if not os.environ.get("TNC_TPU_FLIGHT_RECORDER", "").strip():
        return
    try:
        from tnc_tpu_torch.obs import fleet as _fleet

        if _fleet.maybe_flight_recorder() is not None:
            _ENABLED = True
    except Exception:  # noqa: BLE001 — observability must not break import
        import logging

        logging.getLogger(__name__).warning(
            "obs: flight-recorder arming failed", exc_info=True
        )


def _register_atexit() -> None:
    global _ATEXIT_REGISTERED
    if _ATEXIT_REGISTERED:
        return
    _ATEXIT_REGISTERED = True
    import atexit

    def _dump() -> None:
        if _TRACE_PATH and (_REGISTRY.span_records() or _REGISTRY.counters()):
            from tnc_tpu_torch.obs.export import export_chrome_trace

            try:
                # each process of a group exports to its own
                # process-suffixed file (trace.json -> trace.p1.json)
                export_chrome_trace(process_trace_path(_TRACE_PATH), _REGISTRY)
            except OSError:  # pragma: no cover - unwritable path at exit
                pass

    atexit.register(_dump)


def span(name: str, **args: Any):
    """Open a span for one pipeline stage. No-op singleton when disabled.
    Keyword arguments become span attributes."""
    if not _ENABLED:
        return NULL_SPAN
    return Span(name, _REGISTRY, args)


def traced(name: str, **static_args: Any):
    """Decorator form of :func:`span` for whole-function stages. Disabled
    path: one bool check.

    >>> @traced("plan.demo", kind="test")
    ... def plan():
    ...     return 7
    >>> plan()   # disabled by default: plain call
    7
    """

    def deco(fn):
        import functools

        @functools.wraps(fn)
        def wrapper(*args: Any, **kwargs: Any):
            if not _ENABLED:
                return fn(*args, **kwargs)
            with Span(name, _REGISTRY, dict(static_args)):
                return fn(*args, **kwargs)

        return wrapper

    return deco


def counter_add(name: str, value: float = 1.0, **labels) -> None:
    if _ENABLED:
        _REGISTRY.counter_add(name, value, **labels)


def gauge_set(name: str, value: float, **labels) -> None:
    if _ENABLED:
        _REGISTRY.gauge_set(name, value, **labels)


def observe(name: str, value: float, **labels) -> None:
    if _ENABLED:
        _REGISTRY.observe(name, value, **labels)


def counters_by_prefix(prefix: str) -> dict[str, float]:
    """Flattened view of every counter under a name prefix, labels
    rendered as ``name{k=v}`` strings — how a caller reads out a
    subsystem's activity (``resilience.`` for retries, degradation rungs,
    checkpoint saves and resumes, fired faults).

    >>> _ = configure(enabled=True, registry=MetricsRegistry())
    >>> counter_add("resilience.retry.attempts", 2, site="backend.dispatch")
    >>> counter_add("other.thing", 1)
    >>> counters_by_prefix("resilience.")
    {'resilience.retry.attempts{site=backend.dispatch}': 2.0}
    >>> _ = configure(enabled=False, registry=MetricsRegistry())
    """
    out: dict[str, float] = {}
    for key, value in sorted(_REGISTRY.counters().items()):
        if key[0].startswith(prefix):
            out[format_metric_key(key)] = value
    return out


_PROFILER_ACTIVE = False
_PROFILER_SEQ = 0


class _ProfilerTraceCtx:
    """Context manager running a ``torch.profiler`` trace (host, and the
    card's kernels where CUDA is up) when ``TNC_TPU_TRACE_JAX=<dir>`` is
    set, and writing it as ``<dir>/torch_trace.<pid>.<n>.json`` on exit;
    identity otherwise. Never nests (an inner one is a no-op) and degrades
    to a no-op if the profiler cannot start. ``path`` names the file
    written (None until one is)."""

    __slots__ = ("_prof", "_dir", "path")

    def __enter__(self):
        global _PROFILER_ACTIVE
        self._prof = None
        self.path = None
        self._dir = os.environ.get("TNC_TPU_TRACE_JAX")
        if not self._dir or _PROFILER_ACTIVE:
            return self
        try:
            import torch
            from torch.profiler import ProfilerActivity, profile

            activities = [ProfilerActivity.CPU]
            if torch.cuda.is_available():
                activities.append(ProfilerActivity.CUDA)
            self._prof = profile(activities=activities)
            self._prof.__enter__()
            _PROFILER_ACTIVE = True
        except Exception:  # noqa: BLE001 - profiler support is optional
            self._prof = None
        return self

    def __exit__(self, *exc: Any) -> bool:
        global _PROFILER_ACTIVE, _PROFILER_SEQ
        if self._prof is not None:
            _PROFILER_ACTIVE = False
            try:
                self._prof.__exit__(*exc)
                os.makedirs(self._dir, exist_ok=True)
                _PROFILER_SEQ += 1
                path = os.path.join(
                    self._dir, f"torch_trace.{os.getpid()}.{_PROFILER_SEQ}.json")
                self._prof.export_chrome_trace(path)
                self.path = path
            except Exception:  # noqa: BLE001 - see __enter__
                pass
        return False


def maybe_jax_profiler_trace() -> _ProfilerTraceCtx:
    """The one knob for device-level profiling, under the reference's name:
    a context manager that runs a ``torch.profiler`` trace into
    ``$TNC_TPU_TRACE_JAX`` when that variable names a directory and is a
    transparent no-op otherwise (the reference runs ``jax.profiler.trace``
    there).

    >>> import os
    >>> os.environ.pop("TNC_TPU_TRACE_JAX", None) and None
    >>> with maybe_jax_profiler_trace() as prof:  # unset: no-op
    ...     x = 1
    >>> x, prof.path
    (1, None)
    """
    return _ProfilerTraceCtx()


refresh_from_env()
