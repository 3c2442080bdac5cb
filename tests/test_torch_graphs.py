"""The port's CUDA-graph executors (``tnc_tpu_torch.ops.graphs``) on the
CPU, through a stand-in for the graph.

A CUDA graph exists only on the card. Here ``graphs.graph_class`` is
patched to :class:`ReplayedClosure`, whose capture runs the unit's closure
once (as a real capture runs the Python that issues the work) and whose
``replay()`` calls that same closure again with no new arguments. So the
graphed executors run on the CPU, and a body that reads anything but its
static buffers (a row view or a host slice index baked in at capture)
sums the wrong slices.

- The chunked executor and the per-slice loop, graphed, give the same
  bits as the eager executor on ``sycamore_circuit(20, 6, rng 7)`` (4
  slices: batches 4 and 2) and ``(20, 8, rng 7)`` (16 slices: batches 8
  and 2), under ``max_slices`` and ``slice_range``, hoisted or not; and
  agree with the reference's ``JaxBackend(split_complex=True)`` (Pallas in
  interpret mode) within the sliced tests' 1e-5 relative.
- The host counters after the replays equal the eager run's; the graph
  and replay counts follow the batches.
- ``bind_resident`` hands out distinct tensors of equal values.
- A failed capture raises and names its unit; an offset table first
  needed under a capture is refused.
"""

import doctest

import pytest
import torch

import tnc_tpu_torch.ops.chunked as port_chunked
import tnc_tpu_torch.ops.cuda_complex as port_cuda
import tnc_tpu_torch.ops.graphs as port_graphs
import tnc_tpu_torch.ops.sliced as port_sliced
import tnc_tpu_torch.ops.split_complex as port_sc
from tests._torch_chain_cases import PATH_CHAINS, make_chain
from tests._torch_sliced_cases import SIXTEEN, SMALL, _both, _ids, _scalar
from tnc_tpu.ops.backends import JaxBackend
from tnc_tpu_torch.ops.backends import TorchBackend
from tnc_tpu_torch.ops.chunked import chunk_plan, execute_sliced_batched, resolve_batch
from tnc_tpu_torch.ops.hoist import hoist_sliced_program
from tnc_tpu_torch.ops.program import build_program, flat_leaf_tensors


class ReplayedClosure:
    """Test-only stand-in for ``torch.cuda.CUDAGraph``: ``capture`` keeps
    the closure and runs it once, ``replay`` runs it again, unchanged.

    The closure runs for real here, where a CUDA graph's capture runs no
    kernel and its replay no Python. So ``capture`` puts back the Kahan
    accumulators the closure stepped (the ``graphed`` fixture records them
    in :attr:`stepped`), and ``replay`` puts back the host counters the
    closure bumped, which ``GraphSet.replay`` adds itself."""

    #: while a capture runs: id -> (accumulator, its value before it)
    stepped: dict | None = None

    def __init__(self):
        self.fn = None

    def capture(self, fn, pool):
        self.fn = fn
        ReplayedClosure.stepped = {}
        try:
            return fn()
        finally:
            for t, before in ReplayedClosure.stepped.values():
                t.copy_(before)
            ReplayedClosure.stepped = None

    def replay(self):
        before = port_graphs._snapshot()
        self.fn()
        port_graphs._set_counters(before)

    def pool(self):
        return None


@pytest.fixture
def graphed(monkeypatch):
    """Graphs on the CPU, through the stand-in, with every Kahan step seen
    by it; the graph counts zeroed."""
    real = port_sliced.kahan_step

    def kahan_step(s, c, x):
        if ReplayedClosure.stepped is not None:
            for t in (s, c):
                ReplayedClosure.stepped.setdefault(id(t), (t, t.clone()))
        real(s, c, x)

    for module in (port_sliced, port_chunked):
        monkeypatch.setattr(module, "kahan_step", kahan_step)
    monkeypatch.setattr(port_graphs, "graph_class", lambda device: ReplayedClosure)
    port_graphs.reset_stats()
    yield port_graphs.STATS
    port_graphs.reset_stats()


def _bits(result) -> tuple:
    parts = result if isinstance(result, tuple) else (result,)
    return tuple(p.numpy().tobytes() for p in parts)


def _backend(**kw):
    return TorchBackend(device="cpu", split_complex=True, **kw)


def _sliced(backend, cfg, graphs, **kw):
    port = _both(cfg)["port"]
    return backend.execute_sliced(port["sp"], port["arrays"], host=False, graphs=graphs, **kw)


# (configuration, backend settings, execute_sliced arguments)
CHUNKED = [
    (SMALL, {"slice_batch": 4}, {}),
    (SMALL, {"slice_batch": 2}, {}),
    (SMALL, {"slice_batch": 2, "hoist": False, "chunk_steps": 16}, {}),
    (SIXTEEN, {"slice_batch": 8}, {}),
    (SIXTEEN, {"slice_batch": 2}, {}),
    (SIXTEEN, {"slice_batch": 4, "hoist": False, "chunk_steps": 8}, {}),
    (SIXTEEN, {"slice_batch": 3}, {"max_slices": 12}),
    (SIXTEEN, {"slice_batch": 2}, {"slice_range": (3, 11)}),
]
CHUNKED_IDS = ["m6-b4", "m6-b2", "m6-b2-unhoisted", "t17-b8", "t17-b2",
               "t17-b4-unhoisted", "t17-max12", "t17-range3-11"]


@pytest.mark.parametrize("cfg,settings,kw", CHUNKED, ids=CHUNKED_IDS)
def test_graphed_chunked_equals_eager(graphed, cfg, settings, kw):
    """Every batch after the first replays one graph per chunk, and the sum
    has the eager executor's bits."""
    backend = _backend(**settings)
    eager = _sliced(backend, cfg, False, **kw)
    assert graphed["graphs"] == 0
    got = _sliced(backend, cfg, True, **kw)
    assert _bits(got) == _bits(eager)
    sp = _both(cfg)["port"]["sp"]
    if backend.hoist:
        sp = hoist_sliced_program(sp).residual
    batch, lo, hi = resolve_batch(sp, backend.slice_batch, device="cpu", **kw)
    chunks = len(chunk_plan(sp, batch, backend.chunk_steps, True, backend.precision))
    batches = (hi - lo) // batch
    assert graphed["graphs"] == (chunks if batches > 1 else 0)
    assert graphed["replays"] == chunks * (batches - 1)


LOOPED = [(SMALL, {}, {}), (SMALL, {"hoist": True}, {}), (SIXTEEN, {}, {}),
          (SIXTEEN, {}, {"max_slices": 5}), (SIXTEEN, {"hoist": True}, {"slice_range": (2, 9)})]


@pytest.mark.parametrize("cfg,settings,kw", LOOPED,
                         ids=["m6", "m6-hoisted", "t17", "t17-max5", "t17-range2-9"])
def test_graphed_loop_equals_eager(graphed, cfg, settings, kw):
    """The per-slice loop replays one graph of its body for every slice
    after the first, with the eager loop's bits."""
    backend = _backend(sliced_strategy="loop", **{"hoist": False, **settings})
    eager = _sliced(backend, cfg, False, **kw)
    got = _sliced(backend, cfg, True, **kw)
    assert _bits(got) == _bits(eager)
    n = _both(cfg)["port"]["slicing"].num_slices
    lo, hi = port_sliced.slice_bounds(n, kw.get("max_slices"), kw.get("slice_range"))
    assert (graphed["graphs"], graphed["replays"]) == (1, hi - lo - 1)


@pytest.mark.parametrize("cfg", [SMALL, SIXTEEN], ids=_ids([SMALL, SIXTEEN]))
def test_graphed_paths_match_reference(graphed, cfg):
    """The graphed chunked default (batches of 2, so most batches replay)
    and the graphed loop against the reference's default ``JaxBackend``
    within 1e-5 relative."""
    ref = _both(cfg)["ref"]
    want = _scalar(JaxBackend(split_complex=True).execute_sliced(ref["sp"], ref["arrays"]))
    port = _both(cfg)["port"]
    for backend in (_backend(slice_batch=2), _backend(sliced_strategy="loop", hoist=False)):
        got = _scalar(backend.execute_sliced(port["sp"], port["arrays"]))
        assert abs(got - want) <= 1e-5 * abs(want)
    assert graphed["replays"] > 0


@pytest.mark.parametrize("force", ["fused", "fused_transpose"])
def test_counters_after_replays_equal_eager(graphed, force, monkeypatch):
    """Under a forced rung the routing counters count each step once per
    slice, eagerly or replayed: a capture takes back what it counted and
    each replay adds it again."""
    monkeypatch.setenv("TNC_TPU_COMPLEX_MULT", force)
    counts = []
    for graphs in (False, True):
        for backend in (_backend(slice_batch=2), _backend(sliced_strategy="loop")):
            port_sc.reset_routed()
            port_cuda.reset_launches()
            _sliced(backend, SIXTEEN, graphs)
            counts.append((dict(port_sc.FUSED_ROUTED), dict(port_sc.FUSED_TRANSPOSE_ROUTED),
                           dict(port_cuda.LAUNCHES)))
    assert counts[:2] == counts[2:]
    assert any(c[0] or c[1] for c in counts)
    assert graphed["replays"] > 0


def test_graph_set_replays_what_its_capture_counted(graphed):
    """A unit that counts on the host: its capture leaves the counters as
    they were, each replay adds what the capture counted."""
    port_sc.reset_routed()
    graph_set = port_graphs.GraphSet(ReplayedClosure)
    graph_set.capture("a counting unit", lambda: port_sc._note_fused_routed("x", 1, 1, 1, 3))
    assert port_sc.FUSED_ROUTED == {}
    for n in range(1, 4):
        graph_set.replay()
        assert port_sc.FUSED_ROUTED == {"x": 3 * n}
    assert (graphed["graphs"], graphed["replays"]) == (1, 3)


def test_a_baked_input_shows_in_the_sum(graphed):
    """The stand-in replays what was captured: a body reading the static
    buffer ``prepare`` fills sums every batch, while a body built for one
    batch (a row view cut from the host's rows, a host slice index) repeats
    the captured batch at every replay."""
    static, good, good_c = torch.zeros(()), torch.zeros(()), torch.zeros(())
    port_graphs.run_batches("cpu", [("good", lambda: port_sliced.kahan_step(
        good, good_c, static))], 5, lambda i: static.fill_(float(i)))
    assert float(good) == 0 + 1 + 2 + 3 + 4
    baked, baked_c, graph_set = torch.zeros(()), torch.zeros(()), None
    for i in range(5):
        def unit(v=torch.tensor(float(i))):
            port_sliced.kahan_step(baked, baked_c, v)

        if i == 0:
            unit()
            continue
        if graph_set is None:
            graph_set = port_graphs.GraphSet(ReplayedClosure)
            graph_set.capture("baked", unit)
        graph_set.replay()
    assert float(baked) == 0 + 1 + 1 + 1 + 1


def test_bind_resident_returns_fresh_copies(graphed):
    """Three calls: eager, captured and replayed, replayed; distinct
    tensors of equal values, the resident inputs untouched."""
    port = _both(SMALL)["port"]
    tn = port["tn"]  # the 20-qubit depth-6 amplitude network, unsliced
    program = build_program(tn, port["path"])
    arrays = [leaf.data.into_data() for leaf in flat_leaf_tensors(tn)]
    for graphs in (True, False):
        bound = _backend().bind_resident(program, arrays, graphs=graphs)
        outs = [bound() for _ in range(3)]
        for a, b in zip(outs, outs[1:]):
            assert all(x is not y and x.data_ptr() != y.data_ptr() for x, y in zip(a, b))
            assert _bits(a) == _bits(b)
        if graphs:
            assert len(bound.graph_set.units) == 1
            assert graphed["replays"] == 2
    eager = TorchBackend(device="cpu", split_complex=True).execute_on_device(program, arrays)
    assert _bits(outs[0]) == _bits(eager)


def test_capture_failure_raises_and_names_the_unit(graphed):
    """A unit that fails under capture raises ``CaptureError`` naming it,
    its counts taken back; the executor does not run it eagerly instead."""

    def failing():
        port_sc._note_fused_routed("y", 1, 1, 1)
        raise RuntimeError("operation not permitted when stream is capturing")

    port_sc.reset_routed()
    with pytest.raises(port_graphs.CaptureError, match="capture of chunk 7 failed"):
        port_graphs.GraphSet(ReplayedClosure).capture("chunk 7", failing)
    assert port_sc.FUSED_ROUTED == {}
    ran = []
    with pytest.raises(port_graphs.CaptureError, match="capture of chunk 0 failed"):
        port_graphs.run_batches("cpu", [("chunk 0", lambda: ran.append(1) or (
            len(ran) > 1 and failing()))], 3, lambda i: None)
    assert ran == [1, 1]


@pytest.fixture
def offset_tables(monkeypatch):
    """An empty offset-table cache of two entries, and a switch that makes
    the wrapper see a CUDA graph capture on the current stream."""
    monkeypatch.setattr(port_cuda, "_OFFSET_TABLES", {})
    monkeypatch.setattr(port_cuda, "_CAPTURED_TABLES", set())
    monkeypatch.setattr(port_cuda, "_OFFSET_TABLES_MAX", 2)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)

    def capturing(on: bool) -> None:
        monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: on)

    capturing(False)
    return capturing


def test_offset_table_first_needed_under_capture_is_refused(graphed, offset_tables):
    """A transpose offset table built inside a capture would be filled only
    by a replay: the wrapper refuses it, under any capture."""
    offset_tables(True)
    with pytest.raises(port_graphs.CaptureError, match="offset table"):
        port_graphs.GraphSet(ReplayedClosure).capture(
            "a transpose step", lambda: port_cuda._digit_offsets((3, 5), (7, 1), "cpu"))


def test_offset_table_read_under_capture_is_never_evicted(offset_tables):
    """A table a capture read stays in the cache when it is full: the graph
    reads it by address at every replay. The others are evicted."""
    read = port_cuda._digit_offsets((3, 5), (7, 1), "cpu")
    other = port_cuda._digit_offsets((4,), (1,), "cpu")
    offset_tables(True)
    assert port_cuda._digit_offsets((3, 5), (7, 1), "cpu") is read
    offset_tables(False)
    for n in range(5, 9):
        port_cuda._digit_offsets((n,), (1,), "cpu")
    assert port_cuda._digit_offsets((3, 5), (7, 1), "cpu") is read
    assert port_cuda._digit_offsets((4,), (1,), "cpu") is not other


@pytest.mark.parametrize("name", list(PATH_CHAINS))
def test_captured_chain_reads_its_operands_at_replay(graphed, name):
    """Each chain the paths launch, batched, captured once and replayed after
    its operands were refilled in place: the replay's result is the chain
    of the new operands."""
    first, link_ops, links = make_chain(PATH_CHAINS[name], torch.float32, batch=3, seed=1)
    flat = list(first) + [t for pair in link_ops for t in pair]
    out = []
    graph_set = port_graphs.GraphSet(ReplayedClosure)
    graph_set.capture(name, lambda: out.append(port_cuda.fused_chain(first, link_ops, links)))
    new_first, new_links, _ = make_chain(PATH_CHAINS[name], torch.float32, batch=3, seed=2)
    for t, v in zip(flat, list(new_first) + [x for pair in new_links for x in pair]):
        t.copy_(v)
    graph_set.replay()
    want = port_cuda.fused_chain_reference(new_first, new_links, links)
    assert _bits(out[-1]) == _bits(want)


def test_graphs_need_a_card():
    """Without the stand-in a CPU device has no graphs: every batch runs
    eagerly and nothing is captured."""
    port_graphs.reset_stats()
    assert port_graphs.graph_class("cpu") is None
    _sliced(_backend(slice_batch=2), SMALL, True)
    assert port_graphs.STATS == {"graphs": 0, "capture_ms": 0.0, "replays": 0}


def test_execute_sliced_batched_takes_graphs(graphed):
    port = _both(SIXTEEN)["port"]
    kw = dict(batch=4, device="cpu", hoist=True, host=False)
    eager = execute_sliced_batched(port["sp"], port["arrays"], graphs=False, **kw)
    got = execute_sliced_batched(port["sp"], port["arrays"], **kw)
    assert _bits(got) == _bits(eager) and graphed["replays"] > 0


def test_kahan_step_doctest():
    finder = doctest.DocTestFinder()
    runner = doctest.DocTestRunner()
    for test in finder.find(port_sliced.kahan_step, "kahan_step",
                            globs=dict(vars(port_sliced))):
        runner.run(test)
    assert runner.failures == 0 and runner.tries >= 4
