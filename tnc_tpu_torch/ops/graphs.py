"""CUDA graphs of the port's executors: the counterpart of the reference's
compile step (``jax.jit`` of each chunk in ``tnc_tpu.ops.chunked``, of the
slice loop in ``tnc_tpu.ops.sliced`` and of a bound program in
``JaxBackend.bind_resident``).

A unit of work that an executor runs many times within one call (a chunk
of the chunked executor, the per-slice body of the loop, a bound program)
is captured once as a ``torch.cuda.CUDAGraph`` and replayed: the host
issues one graph launch where it issued every step, copy and kernel.

- :class:`GraphSet` holds the graphs of one call: one per unit, captured
  in the order they run into one memory pool (the first graph's), and
  replayed in that order, so an intermediate one unit hands the next
  stays at the address both were captured with. It keeps each unit's
  output alive as long as the graphs live.
- :class:`BatchRunner` runs one batch shape's units as every sliced
  executor runs a batch: the first time eagerly (it builds the kernels,
  plans the chains' calls and makes the kernels' one-time attribute
  calls, none of which a capture may do), the second time captured once
  and replayed, then replayed. :func:`run_batches` is the loop's batch
  loop over one runner; the chunked executor keeps a runner per batch
  shape (a halved batch or an unaligned resume adds one). A batch's
  inputs go into static buffers before it runs (``prepare``); a body
  reads nothing else that changes between batches.
- :class:`BoundProgram` is ``TorchBackend.bind_resident``'s callable: the
  first call eager, the second captures and replays, every later call
  replays; each call returns a fresh copy of the output.

Counters. The kernel wrappers and the step glue count on the host as a
unit is issued (``cuda_complex.LAUNCHES``, ``CHAIN_FORMS``, ``RUNG_LAUNCHES``,
``TILE_LAUNCHES``, ``split_complex.FUSED_ROUTED``, ``FUSED_TRANSPOSE_ROUTED``):
under a graph they would count at capture only. A capture records what it added and
takes it back; each replay adds it again. :data:`STATS` counts the graphs
captured, their capture time and their replays.

Graphs exist only on the card (:func:`graph_class`); on the CPU the
executors run every batch eagerly, which is the CPU implementation. A
capture that fails raises :class:`CaptureError` naming the unit (the
``graphs.capture`` fault point fires inside each capture); nothing falls
back to running it eagerly. Captures run in thread-local mode
(:class:`_CudaGraph`).
"""

from __future__ import annotations

import time

#: graphs captured, host milliseconds spent capturing them, and graph
#: replays since :func:`reset_stats`
STATS: dict = {"graphs": 0, "capture_ms": 0.0, "replays": 0}

#: when a list, :func:`run_batches` appends ``(kind, start, end)`` for every
#: batch it runs on the card: ``kind`` is ``"eager"``, ``"capture"`` (the
#: batch whose units were captured, then replayed) or ``"replay"``, and
#: ``start`` / ``end`` are CUDA events recorded on the current stream
#: before the batch's inputs are filled and after its last unit. ``None``:
#: nothing is recorded.
BATCH_EVENTS: list | None = None


class CaptureError(RuntimeError):
    """A unit could not be captured as a CUDA graph."""


def reset_stats() -> None:
    """Set every count of :data:`STATS` to 0."""
    STATS.update(graphs=0, capture_ms=0.0, replays=0)


def _counters() -> tuple[dict, ...]:
    from tnc_tpu_torch.ops import cuda_complex, split_complex

    return (cuda_complex.LAUNCHES, cuda_complex.CHAIN_FORMS, cuda_complex.RUNG_LAUNCHES,
            cuda_complex.TILE_LAUNCHES, split_complex.FUSED_ROUTED,
            split_complex.FUSED_TRANSPOSE_ROUTED)


def _snapshot() -> tuple[dict, ...]:
    return tuple(dict(c) for c in _counters())


def _set_counters(values: tuple[dict, ...]) -> None:
    """Every counter set, in place, to ``values`` (a :func:`_snapshot`)."""
    for counter, value in zip(_counters(), values):
        counter.clear()
        counter.update(value)


def _added(before: tuple[dict, ...]) -> tuple[dict, ...]:
    """What each counter gained since ``before``."""
    out = []
    for counter, old in zip(_counters(), before):
        out.append({key: n - old.get(key, 0) for key, n in counter.items()
                    if n != old.get(key, 0)})
    return tuple(out)


def _add(added: tuple[dict, ...]) -> None:
    """Every counter gains ``added`` (an :func:`_added`)."""
    for counter, gained in zip(_counters(), added):
        for key, n in gained.items():
            counter[key] = counter.get(key, 0) + n


class _CudaGraph:
    """One ``torch.cuda.CUDAGraph``, captured through ``torch.cuda.graph``
    (on its side stream) into the pool it is given, in thread-local
    capture mode: another thread's CUDA work during the capture (a serving
    thread beside the dispatcher, a test's main thread) does not
    invalidate it. The capturing thread's current stream is restored
    however the capture ends, so a unit that raises leaves no stream in
    capture mode and no side stream current."""

    def __init__(self):
        import torch

        self.graph = torch.cuda.CUDAGraph()

    def capture(self, fn, pool):
        import torch

        prev = torch.cuda.current_stream()
        try:
            with torch.cuda.graph(self.graph, pool=pool, capture_error_mode="thread_local"):
                return fn()
        finally:
            if torch.cuda.current_stream() != prev:
                torch.cuda.set_stream(prev)

    def replay(self) -> None:
        self.graph.replay()

    def pool(self):
        return self.graph.pool()


def graph_class(device):
    """The graph type of units whose tensors lie on ``device``: CUDA graphs
    on the card, ``None`` elsewhere (the executors then run eagerly)."""
    import torch

    return _CudaGraph if torch.device(device).type == "cuda" else None


class GraphSet:
    """The graphs of one call, captured in the order they run into one
    memory pool and replayed in that order. ``kind`` is the graph type
    (:func:`graph_class`). The set keeps every unit's output alive until
    it is dropped."""

    def __init__(self, kind):
        self.kind = kind
        self.units: list = []  # (graph, the counts its capture added)
        self.keep: list = []
        self.pool = None

    def capture(self, name: str, fn):
        """Capture ``fn()`` as one graph and return its output (the static
        tensors every replay writes). The capture runs the unit's Python,
        which counts its launches on the host, but no kernel: the counts it
        added are taken back and recorded for :meth:`replay`."""
        from tnc_tpu_torch.resilience.faultinject import fault_point

        def captured():
            fault_point("graphs.capture", unit=name)  # inside the capture
            return fn()

        before = _snapshot()
        graph = self.kind()
        t0 = time.perf_counter()
        try:
            out = graph.capture(captured, self.pool)
        except Exception as e:
            _set_counters(before)
            raise CaptureError(f"CUDA graph capture of {name} failed: {e}") from e
        STATS["capture_ms"] += (time.perf_counter() - t0) * 1e3
        STATS["graphs"] += 1
        added = _added(before)
        _set_counters(before)
        if self.pool is None:
            self.pool = graph.pool()
        self.units.append((graph, added))
        self.keep.append(out)
        return out

    def replay(self) -> None:
        """Replay every graph in capture order; the counters gain what each
        capture recorded."""
        for graph, added in self.units:
            graph.replay()
            _add(added)
        STATS["replays"] += len(self.units)


def mark(device):
    """A CUDA event recorded now on the current stream when
    :data:`BATCH_EVENTS` is a list and ``device`` is a CUDA device, else
    ``None``."""
    if BATCH_EVENTS is None or device.type != "cuda":
        return None
    import torch

    event = torch.cuda.Event(enable_timing=True)
    event.record()
    return event


class BatchRunner:
    """The units of one batch shape (``(name, fn)`` pairs, in order), run
    the way every sliced executor runs a batch: the first :meth:`run`
    eagerly (it builds the kernels, plans the chains' calls and makes the
    kernels' one-time attribute calls, none of which a capture may do);
    with ``graphs`` on a device that has them (:func:`graph_class`), the
    second captures each unit once and replays the set, every later one
    replays. A capture that fails drops the graphs captured so far (the
    next :meth:`run` captures afresh); :meth:`release` drops them and
    their pool."""

    def __init__(self, device, units, graphs: bool = True):
        import torch

        self.units = list(units)
        self.kind = graph_class(torch.device(device)) if graphs else None
        self.runs = 0
        self.graph_set: GraphSet | None = None

    def run(self) -> str:
        """Run the units once; returns ``"eager"``, ``"capture"`` (the run
        that captured, then replayed) or ``"replay"``."""
        if self.kind is None or self.runs == 0:
            for _, fn in self.units:
                fn()
            self.runs += 1
            return "eager"
        tag = "replay"
        if self.graph_set is None:
            tag = "capture"
            graph_set = GraphSet(self.kind)
            for name, fn in self.units:
                graph_set.capture(name, fn)
            self.graph_set = graph_set
        self.graph_set.replay()
        self.runs += 1
        return tag

    def release(self) -> None:
        self.graph_set = None


def run_batches(device, units, batches: int, prepare, graphs: bool = True) -> None:
    """Run ``units`` (``(name, fn)`` pairs: one batch's work, in order) for
    each of ``batches`` batches, ``prepare(i)`` first filling batch ``i``'s
    static inputs (run eagerly, never captured), through one
    :class:`BatchRunner`: batch 0 eagerly, then with ``graphs`` on a device
    that has them each unit captured once and the set replayed for batches
    1 to ``batches - 1``. The graphs and their pool are released on
    return."""
    import torch

    device = torch.device(device)
    runner = BatchRunner(device, units, graphs)
    for i in range(batches):
        start = mark(device)
        prepare(i)
        tag = runner.run()
        if start is not None:
            BATCH_EVENTS.append((tag, start, mark(device)))


class BoundProgram:
    """A program bound to resident inputs (``TorchBackend.bind_resident``):
    ``run()`` runs it once and returns its output. With graphs on a device
    that has them, the first call runs eagerly, the second captures one
    graph and replays it, and every later call replays; each of those
    calls returns a fresh copy of the output, which the next replay
    overwrites. The graph lives as long as this callable."""

    def __init__(self, run, device, graphs: bool = True):
        self.run = run
        self.kind = graph_class(device) if graphs else None
        self.calls = 0
        self.graph_set: GraphSet | None = None
        self.out = None

    def __call__(self):
        self.calls += 1
        if self.kind is None or self.calls == 1:
            return self.run()
        if self.graph_set is None:
            self.graph_set = GraphSet(self.kind)
            self.out = self.graph_set.capture("the bound program", self.run)
        self.graph_set.replay()
        if isinstance(self.out, tuple):
            return tuple(t.clone() for t in self.out)
        return self.out.clone()
