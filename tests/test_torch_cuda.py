"""The port's CUDA kernels against their plain versions on a GPU.

Marked ``cuda``: each test skips where there is no CUDA device. The file
imports only ``torch`` and the port, so it runs on a GPU machine that has
no JAX::

    python -m pytest tests/test_torch_cuda.py -m cuda -q --noconftest
"""

import pytest
import torch

from tnc_tpu_torch.ops import cuda_complex as cc


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")


def _max_rel_err(got, want) -> float:
    scale = max(float(w.abs().max()) for w in want)
    return max(float((a - b).abs().max()) for a, b in zip(got, want)) / scale


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_kernels_on_the_card(dtype):
    """Both kernels on ragged shapes and strided operands, each launch
    counted once."""
    _card()
    g = torch.Generator(device="cuda").manual_seed(0)
    tol = 1e-5 if dtype == torch.float32 else 1e-12

    def rnd(*shape):
        return torch.randn(*shape, generator=g, device="cuda", dtype=dtype)

    cc.reset_launches()
    ops = (rnd(37, 101), rnd(37, 101), rnd(37, 203), rnd(37, 203))
    got = cc.fused_complex_dot(*ops)
    assert _max_rel_err(got, cc.fused_complex_dot_reference(*ops)) <= tol
    first = (rnd(8, 16), rnd(8, 16), rnd(8, 4), rnd(8, 4))
    # the second link operand as transposed views: strides (1, 4)
    link_ops = [(rnd(8, 4), rnd(8, 4)), (rnd(16, 4).T, rnd(16, 4).T)]
    links = [cc.ChainLink(True, (8, 8), 0), cc.ChainLink(False, (4, 8), 0)]
    got = cc.fused_chain(first, link_ops, links)
    assert _max_rel_err(got, cc.fused_chain_reference(first, link_ops, links)) <= tol
    assert cc.LAUNCHES == {
        "fused_chain": 1, "fused_complex_dot": 1, "fused_transpose_dot": 0,
    }


# (first, second, reason the gate gives): the layouts of steps 0 and 4 of
# the ``peps(4, 4, 2, 32, 0)`` plan, which the gate admits; and those of its
# steps 11 and 15 (two permuted axes on each side) with the contract dim
# cut to 32 x 8 and a ragged free dim 37, off the reference's TPU tiles
# (the kernel takes it all the same)
PEPS_LAYOUTS = [
    (((2, 32, 32), (1,), (0, 2)), ((2, 32, 1024), (1,), (0, 2)), None),
    (((2, 32, 32, 8, 32), (1, 3), (0, 2, 4)), ((64, 32, 37, 8), (1, 3), (0, 2)),
     "tile_floor"),
]


@pytest.mark.cuda
@pytest.mark.parametrize("layouts", PEPS_LAYOUTS, ids=["steps0_4", "steps11_15_cut"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_transpose_kernel_on_a_peps_layout(dtype, layouts):
    """``fused_transpose_dot`` on PEPS operand layouts against its plain
    version, twice (the second call reads the cached offset tables); one
    launch per call."""
    _card()
    g = torch.Generator(device="cuda").manual_seed(1)
    tol = 1e-5 if dtype == torch.float32 else 1e-12
    a_lay, b_lay = cc.OperandLayout(*layouts[0]), cc.OperandLayout(*layouts[1])
    k, m, n = a_lay.k_size, a_lay.f_size, b_lay.f_size
    assert cc.transpose_dot_ineligible_reason(a_lay, b_lay, k, m, n) == layouts[2]

    def rnd(shape):
        return torch.randn(shape, generator=g, device="cuda", dtype=dtype)

    cc.reset_launches()
    for _ in range(2):
        ops = (rnd(a_lay.view), rnd(a_lay.view), rnd(b_lay.view), rnd(b_lay.view))
        got = cc.fused_transpose_dot(*ops, a_lay, b_lay)
        torch.cuda.synchronize()
        assert got[0].shape == (m, n)
        want = cc.fused_transpose_reference(*ops, a_lay, b_lay)
        assert _max_rel_err(got, want) <= tol
    assert cc.LAUNCHES["fused_transpose_dot"] == 2


def _operand(rows, cols, dtype, g, offset=0):
    """A (rows, cols) matrix whose storage starts ``offset`` elements into
    its buffer."""
    buf = torch.randn(rows * cols + offset, generator=g, device="cuda", dtype=dtype)
    return buf[offset:].view(rows, cols)


# (K, M, N, storage offset of every operand): the engine's edges
ENGINE_EDGES = {
    "offset1": (96, 200, 300, 1),   # misaligned: no 16-byte copies
    "short_k": (5, 200, 300, 0),    # K under one stage
    "ragged_k": (100, 130, 70, 0),  # K not a multiple of any stage depth
    "small_mn": (64, 3, 17, 0),     # M and N under every tile
    "wide": (1100, 1024, 4096, 0),  # 128 x 64 tiles
    "deep_k": (700, 130, 70, 0),    # 6 tiles of 64 x 64, 44 stages, ragged K
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(ENGINE_EDGES))
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_engine_edges_on_the_card(dtype, case):
    """``fused_complex_dot`` at the shapes and alignments the pipelined
    engine treats specially, against its plain version."""
    _card()
    g = torch.Generator(device="cuda").manual_seed(2)
    tol = 1e-5 if dtype == torch.float32 else 1e-12
    k, m, n, offset = ENGINE_EDGES[case]
    ops = (_operand(k, m, dtype, g, offset), _operand(k, m, dtype, g, offset),
           _operand(k, n, dtype, g, offset), _operand(k, n, dtype, g, offset))
    if offset:
        assert cc.strided_copy_mode(ops[0], ops[1]) != cc.COPY_VEC
    cc.reset_launches()
    got = cc.fused_complex_dot(*ops)
    torch.cuda.synchronize()
    assert got[0].shape == (m, n)
    assert _max_rel_err(got, cc.fused_complex_dot_reference(*ops)) <= tol
    assert cc.LAUNCHES["fused_complex_dot"] == 1


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_long_contraction_against_float64(dtype):
    """The stem's contract length (K = 16384) at a narrow output: in
    float32 the kernel's error against a float64 product is at most twice
    cuBLAS's (chip_smoke.py holds the stem's full width to the same)."""
    _card()
    g = torch.Generator(device="cuda").manual_seed(3)
    k, m, n = 16384, 96, 200
    ops = [torch.randn(k, f, generator=g, device="cuda", dtype=dtype)
           for f in (m, m, n, n)]
    got = cc.fused_complex_dot(*ops)
    want = cc.fused_complex_dot_reference(*ops)
    if dtype == torch.float64:
        assert _max_rel_err(got, want) <= 1e-12
        return
    exact = cc.fused_complex_dot_reference(*(t.double() for t in ops))
    k_err = _max_rel_err([t.double() for t in got], exact)
    p_err = _max_rel_err([t.double() for t in want], exact)
    assert _max_rel_err(got, want) <= 1e-5
    assert k_err <= 2 * p_err


# (first, second): the contract index stride 1 on both (the staged
# pipeline, 16-byte copies), on one, on neither (16-byte copies along the
# free index), and a digit of 6 that allows only element copies in float32
TRANSPOSE_UNITS = {
    "k_unit_both": (((2, 16, 48, 32), (1, 3), (0, 2)), ((2, 16, 40, 32), (1, 3), (0, 2))),
    "k_unit_second": (((2, 32, 8, 24), (1, 2), (0, 3)), ((40, 32, 8), (1, 2), (0,))),
    "k_unit_none": (((2, 32, 36), (1,), (0, 2)), ((2, 32, 72), (1,), (0, 2))),
    "k_digit_6": (((36, 6), (1,), (0,)), ((70, 6), (1,), (0,))),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(TRANSPOSE_UNITS))
@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_transpose_kernel_copy_modes(dtype, offset, case):
    """``fused_transpose_dot`` through each copy mode and both pipelines
    (``offset`` 1 leaves the 16-byte copies), against its plain version."""
    _card()
    g = torch.Generator(device="cuda").manual_seed(4)
    tol = 1e-5 if dtype == torch.float32 else 1e-12
    a_lay, b_lay = (cc.OperandLayout(*lay) for lay in TRANSPOSE_UNITS[case])

    def rnd(lay):
        n = lay.k_size * lay.f_size
        buf = torch.randn(n + offset, generator=g, device="cuda", dtype=dtype)
        return buf[offset:].view(lay.view)

    ops = (rnd(a_lay), rnd(a_lay), rnd(b_lay), rnd(b_lay))
    modes = (cc.gather_copy_mode(ops[0], ops[1], a_lay),
             cc.gather_copy_mode(ops[2], ops[3], b_lay))
    if offset:
        assert not {cc.COPY_VEC, cc.COPY_VEC_K} & set(modes)
    elif case == "k_unit_both":
        assert modes == (cc.COPY_VEC_K, cc.COPY_VEC_K)
    got = cc.fused_transpose_dot(*ops, a_lay, b_lay)
    torch.cuda.synchronize()
    assert got[0].shape == (a_lay.f_size, b_lay.f_size)
    assert _max_rel_err(got, cc.fused_transpose_reference(*ops, a_lay, b_lay)) <= tol


@pytest.mark.cuda
def test_wrapper_rejects_mixed_devices():
    """A CUDA operand beside a CPU one is refused before any launch."""
    _card()
    a = torch.zeros(4, 4, device="cuda")
    with pytest.raises(ValueError, match="different devices"):
        cc.fused_complex_dot(a, a, a.cpu(), a.cpu())


@pytest.mark.cuda
def test_sliced_amplitude_on_the_card():
    """A Sycamore amplitude over 4 slices: the slice loop on the card
    against the complex128 numpy oracle, each of the plan's 2 chains
    launched once a slice, the resident leaves left as they were."""
    _card()
    import numpy as np

    from tnc_tpu_torch.builders.sycamore_circuit import sycamore_circuit
    from tnc_tpu_torch.contractionpath.paths import Greedy, OptMethod
    from tnc_tpu_torch.contractionpath.slicing import find_slicing
    from tnc_tpu_torch.ops.backends import NumpyBackend, TorchBackend
    from tnc_tpu_torch.ops.program import flat_leaf_tensors
    from tnc_tpu_torch.ops.sliced import build_sliced_program
    from tnc_tpu_torch.tensornetwork.simplify import simplify_network

    tn, _ = sycamore_circuit(20, 6, np.random.default_rng(7)).into_amplitude_network("0" * 20)
    tn = simplify_network(tn)
    path = Greedy(OptMethod.GREEDY).find_path(tn).replace_path()
    sp = build_sliced_program(tn, path, find_slicing(tn.tensors, path.toplevel, 2.0 ** 7))
    arrays = [leaf.data.into_data() for leaf in flat_leaf_tensors(tn)]
    backend = TorchBackend()
    full = backend._device_buffers(arrays)
    kept = [tuple(p.clone() for p in pair) for pair in full]
    cc.reset_launches()
    re, im = backend._run_sliced(sp, full, 0, sp.slicing.num_slices)
    torch.cuda.synchronize()
    assert cc.LAUNCHES["fused_chain"] == 2 * sp.slicing.num_slices == 8
    assert all(torch.equal(p, k) for pair, kpair in zip(full, kept) for p, k in zip(pair, kpair))
    got = complex(torch.complex(re, im).cpu().numpy().reshape(()))
    want = complex(np.asarray(NumpyBackend().execute_sliced(sp, arrays)).reshape(()))
    assert abs(got - want) <= 1e-5 * abs(want)


# (K, M, N, batch, which side carries the batch axis): a slice batch on both
# operands, on one (the other shared by every row, batch stride 0), a
# ragged shape, and rows whose batch stride leaves the 16-byte copies
BATCHED_DOTS = {
    "both": (96, 200, 300, 3, "both"),
    "first": (128, 256, 192, 4, "first"),
    "second": (64, 3, 517, 2, "second"),
    "odd_rows": (37, 101, 203, 3, "both"),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(BATCHED_DOTS))
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_batched_complex_dot_on_the_card(dtype, case):
    """``fused_complex_dot`` over a slice batch in one launch: against its
    plain version, and every batch row against the unbatched kernel on that
    row's operands."""
    _card()
    g = torch.Generator(device="cuda").manual_seed(5)
    tol = 1e-5 if dtype == torch.float32 else 1e-12
    k, m, n, batch, side = BATCHED_DOTS[case]

    def rnd(rows, cols, batched):
        shape = (batch, rows, cols) if batched else (rows, cols)
        return torch.randn(*shape, generator=g, device="cuda", dtype=dtype)

    a_b, b_b = side in ("both", "first"), side in ("both", "second")
    ops = (rnd(k, m, a_b), rnd(k, m, a_b), rnd(k, n, b_b), rnd(k, n, b_b))
    if case == "odd_rows" and dtype == torch.float32:
        assert cc.strided_copy_mode(ops[0], ops[1]) != cc.COPY_VEC
    cc.reset_launches()
    got = cc.fused_complex_dot(*ops)
    torch.cuda.synchronize()
    assert got[0].shape == (batch, m, n)
    assert cc.LAUNCHES["fused_complex_dot"] == 1
    assert _max_rel_err(got, cc.fused_complex_dot_reference(*ops)) <= tol
    for z in range(batch):
        row = cc.fused_complex_dot(*(t[z] if t.dim() == 3 else t for t in ops))
        assert _max_rel_err([g_[z] for g_ in got], row) <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("which", ["head", "links", "all"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_batched_chain_on_the_card(dtype, which):
    """``fused_chain`` over a slice batch in one launch, with the batch axis
    on the head's operands, on the link operands (a 2-D head shared by every
    row), or on all of them, against its plain version."""
    _card()
    g = torch.Generator(device="cuda").manual_seed(6)
    tol = 1e-5 if dtype == torch.float32 else 1e-12
    batch = 3

    def rnd(rows, cols, batched):
        shape = (batch, rows, cols) if batched else (rows, cols)
        return torch.randn(*shape, generator=g, device="cuda", dtype=dtype)

    head, link = which in ("head", "all"), which in ("links", "all")
    first = (rnd(8, 16, head), rnd(8, 16, head), rnd(8, 4, head), rnd(8, 4, head))
    link_ops = [(rnd(8, 4, link), rnd(8, 4, link)),
                (rnd(16, 4, link).mT, rnd(16, 4, link).mT)]
    links = [cc.ChainLink(True, (8, 8), 0), cc.ChainLink(False, (4, 8), 0)]
    cc.reset_launches()
    got = cc.fused_chain(first, link_ops, links)
    torch.cuda.synchronize()
    assert cc.LAUNCHES["fused_chain"] == 1
    assert got[0].shape == (batch, 16, 8)
    assert _max_rel_err(got, cc.fused_chain_reference(first, link_ops, links)) <= tol


@pytest.mark.cuda
def test_chunked_sliced_amplitude_on_the_card():
    """The default sliced path — the stem hoisted, the residual batched over
    the 4 slices — on the card against the complex128 numpy oracle: the
    residual's 2 chains each launched once for the whole batch."""
    _card()
    import numpy as np

    from tnc_tpu_torch.builders.sycamore_circuit import sycamore_circuit
    from tnc_tpu_torch.contractionpath.paths import Greedy, OptMethod
    from tnc_tpu_torch.contractionpath.slicing import find_slicing
    from tnc_tpu_torch.ops.backends import NumpyBackend, TorchBackend
    from tnc_tpu_torch.ops.program import flat_leaf_tensors
    from tnc_tpu_torch.ops.sliced import build_sliced_program
    from tnc_tpu_torch.tensornetwork.simplify import simplify_network

    tn, _ = sycamore_circuit(20, 6, np.random.default_rng(7)).into_amplitude_network("0" * 20)
    tn = simplify_network(tn)
    path = Greedy(OptMethod.GREEDY).find_path(tn).replace_path()
    sp = build_sliced_program(tn, path, find_slicing(tn.tensors, path.toplevel, 2.0 ** 7))
    arrays = [leaf.data.into_data() for leaf in flat_leaf_tensors(tn)]
    cc.reset_launches()
    got = complex(np.asarray(TorchBackend().execute_sliced(sp, arrays)).reshape(()))
    torch.cuda.synchronize()
    assert cc.LAUNCHES["fused_chain"] == 2
    want = complex(np.asarray(NumpyBackend().execute_sliced(sp, arrays)).reshape(()))
    assert abs(got - want) <= 1e-5 * abs(want)


@pytest.mark.cuda
def test_northstar_small_on_the_card():
    """The north-star slice at small size on the card: sycamore(20, 8, rng
    7) planned by the port's ``Hyperoptimizer`` (small settings, budgets
    off) and ``slice_and_reconfigure`` to 2^12 (16 slices), contracted on
    the default ``TorchBackend()`` against the complex128 numpy oracle."""
    _card()
    import numpy as np

    from tnc_tpu_torch.benchmark.northstar import plan_northstar
    from tnc_tpu_torch.ops.backends import NumpyBackend, TorchBackend
    from tnc_tpu_torch.tensornetwork.contraction import contract_tensor_network_sliced

    plan = plan_northstar(
        20, 8, 7, 4, 12.0,
        hyper_options=dict(polish_rounds=1, polish_steps=400, reconfigure_budget=None,
                           joint_sa_steps=300, joint_sa_rounds=1),
        slice_options=dict(step_budget=None, final_budget=None))
    assert plan.slicing.num_slices == 16
    got = complex(contract_tensor_network_sliced(
        plan.tn, plan.path, plan.slicing, TorchBackend()).data.into_data())
    want = complex(contract_tensor_network_sliced(
        plan.tn, plan.path, plan.slicing, NumpyBackend()).data.into_data())
    assert np.isfinite(got.real) and np.isfinite(got.imag)
    assert abs(got - want) <= 1e-5 * abs(want)


def _chain_forms_case(stages, dtype, batch, grid):
    from _torch_chain_cases import make_chain

    first, link_ops, links = make_chain(stages, dtype, batch, device="cuda")
    if grid:  # a block with too little shared memory for the carried value
        plan = cc._ChainPlan(first, link_ops, links, smem=256,
                             sms=torch.cuda.get_device_properties(0).multi_processor_count)
    else:
        plan = cc.chain_plan(first, link_ops, links)
    return first, link_ops, links, plan


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [None, 3])
@pytest.mark.parametrize("form", ["resident", "grid"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_chain_forms_on_the_card(dtype, form, batch):
    """Every chain shape the paths launch, and the synthetic chain beyond
    shared memory, in the resident form (where the carried values fit) and
    in the grid form (forced by a small shared-memory budget): against the
    plain version, one launch each of the planned form, and two launches
    bitwise equal."""
    _card()
    # the helper beside this file (pytest puts tests/ on the path)
    from _torch_chain_cases import GRID_CHAIN, PATH_CHAINS

    tol = 1e-5 if dtype == torch.float32 else 1e-12
    cases = list(PATH_CHAINS.values()) + ([GRID_CHAIN] if form == "grid" else [])
    for stages in cases:
        first, link_ops, links, plan = _chain_forms_case(stages, dtype, batch, form == "grid")
        assert plan.forms == (form,)
        cc.reset_launches()
        got = cc.fused_chain(first, link_ops, links, plan)
        again = cc.fused_chain(first, link_ops, links, plan)
        torch.cuda.synchronize()
        assert cc.LAUNCHES["fused_chain"] == 2 and cc.CHAIN_FORMS[form] == 2
        assert all(torch.equal(a, b) for a, b in zip(got, again)), stages
        assert _max_rel_err(got, cc.fused_chain_reference(first, link_ops, links)) <= tol, stages


# -- CUDA graphs -------------------------------------------------------------------


def _sliced_case(q, m, seed, target):
    """``(sp, arrays)`` of a Sycamore amplitude: simplified, ``Greedy``
    path, ``find_slicing`` to 2^target elements."""
    import numpy as np

    from tnc_tpu_torch.builders.sycamore_circuit import sycamore_circuit
    from tnc_tpu_torch.contractionpath.paths import Greedy, OptMethod
    from tnc_tpu_torch.contractionpath.slicing import find_slicing
    from tnc_tpu_torch.ops.program import flat_leaf_tensors
    from tnc_tpu_torch.ops.sliced import build_sliced_program
    from tnc_tpu_torch.tensornetwork.simplify import simplify_network

    tn, _ = sycamore_circuit(q, m, np.random.default_rng(seed)).into_amplitude_network("0" * q)
    tn = simplify_network(tn)
    path = Greedy(OptMethod.GREEDY).find_path(tn).replace_path()
    sp = build_sliced_program(tn, path, find_slicing(tn.tensors, path.toplevel, 2.0 ** target))
    return sp, [leaf.data.into_data() for leaf in flat_leaf_tensors(tn)]


def _counted(fn):
    """``fn()``'s result, synchronised, with the host counters it left."""
    from tnc_tpu_torch.ops import split_complex

    cc.reset_launches()
    split_complex.reset_routed()
    out = fn()
    torch.cuda.synchronize()
    return out, (dict(cc.LAUNCHES), dict(cc.CHAIN_FORMS), dict(split_complex.FUSED_ROUTED))


# (configuration, strategy, slice batch, graphs captured, replays): the two
# sycamore20 amplitudes whose residuals keep chains, chunked with at least
# two batches, and the per-slice loop
GRAPHED_CELLS = {
    "m6-chunked-b2": ((20, 6, 7, 7), "chunked", 2, 1, 1),
    "m8_t17-chunked-b8": ((20, 8, 7, 17), "chunked", 8, 1, 1),
    "m8_t17-chunked-b2": ((20, 8, 7, 17), "chunked", 2, 1, 7),
    "m6-loop": ((20, 6, 7, 7), "loop", 8, 1, 3),
}


@pytest.mark.cuda
@pytest.mark.parametrize("cell", list(GRAPHED_CELLS))
def test_graphed_sliced_equals_eager_on_the_card(cell):
    """The sliced executors replaying one CUDA graph per chunk (or of the
    loop's body) give the eager run's bits and counts, with the expected
    graphs and replays, and agree with the complex128 numpy oracle."""
    _card()
    import numpy as np

    from tnc_tpu_torch.ops import graphs
    from tnc_tpu_torch.ops.backends import NumpyBackend, TorchBackend

    cfg, strategy, batch, captured, replays = GRAPHED_CELLS[cell]
    sp, arrays = _sliced_case(*cfg)
    backend = TorchBackend(sliced_strategy=strategy, slice_batch=batch,
                           hoist=strategy == "chunked")
    eager, eager_counts = _counted(
        lambda: backend.execute_sliced(sp, arrays, host=False, graphs=False))
    graphs.reset_stats()
    got, counts = _counted(lambda: backend.execute_sliced(sp, arrays, host=False))
    assert (graphs.STATS["graphs"], graphs.STATS["replays"]) == (captured, replays)
    assert counts == eager_counts
    assert all(torch.equal(a, b) for a, b in zip(got, eager))
    want = complex(np.asarray(NumpyBackend().execute_sliced(sp, arrays)).reshape(()))
    z = complex(torch.complex(*got).cpu().numpy().reshape(()))
    assert abs(z - want) <= 1e-5 * abs(want)


@pytest.mark.cuda
def test_graphed_bind_resident_peps_on_the_card(monkeypatch):
    """``bind_resident`` on a PEPS norm under the forced ``fused_transpose``
    rung: the first call eager, the second captured and replayed, the rest
    replayed; every call the same bits, a fresh tensor, and the eager
    call's launches (the transpose kernel inside the graph)."""
    _card()
    import numpy as np

    from tnc_tpu_torch.builders.peps import peps
    from tnc_tpu_torch.contractionpath.paths import Greedy, OptMethod
    from tnc_tpu_torch.ops import graphs
    from tnc_tpu_torch.ops.backends import TorchBackend
    from tnc_tpu_torch.ops.program import build_program, flat_leaf_tensors
    from tnc_tpu_torch.tensornetwork.approximate import attach_random_data, unit_scale

    monkeypatch.setenv("TNC_TPU_COMPLEX_MULT", "fused_transpose")
    tn = peps(3, 3, 2, 16, 0)
    attach_random_data(tn, np.random.default_rng(42), scale=unit_scale(tn))
    program = build_program(tn, Greedy(OptMethod.GREEDY).find_path(tn).replace_path())
    arrays = [leaf.data.into_data() for leaf in flat_leaf_tensors(tn)]
    bound = TorchBackend().bind_resident(program, arrays)
    graphs.reset_stats()
    outs = [_counted(bound) for _ in range(4)]
    assert outs[0][1][0]["fused_transpose_dot"] == 2
    assert all(counts == outs[0][1] for _, counts in outs)
    assert len(bound.graph_set.units) == 1 and graphs.STATS["replays"] == 3
    for (a, _), (b, _) in zip(outs, outs[1:]):
        assert all(torch.equal(x, y) and x.data_ptr() != y.data_ptr() for x, y in zip(a, b))


@pytest.mark.cuda
@pytest.mark.parametrize("form", ["resident", "grid"])
def test_chain_forms_in_a_graph_on_the_card(form):
    """Every chain shape the paths launch (and the synthetic chain beyond
    shared memory, in the grid form) captured in a CUDA graph and replayed
    after its operands were refilled in place: the eager launch's bits on
    the new operands."""
    _card()
    from _torch_chain_cases import GRID_CHAIN, PATH_CHAINS, make_chain

    from tnc_tpu_torch.ops import graphs

    cases = list(PATH_CHAINS.values()) + ([GRID_CHAIN] if form == "grid" else [])
    for stages in cases:
        first, link_ops, links, plan = _chain_forms_case(stages, torch.float32, 3,
                                                         form == "grid")
        flat = list(first) + [t for pair in link_ops for t in pair]
        cc.fused_chain(first, link_ops, links, plan)  # eager first, as the executors do
        graph_set = graphs.GraphSet(graphs.graph_class("cuda"))
        out = graph_set.capture(f"chain {stages}",
                                lambda: cc.fused_chain(first, link_ops, links, plan))
        new_first, new_links, _ = make_chain(stages, torch.float32, 3, seed=9, device="cuda")
        for t, v in zip(flat, list(new_first) + [x for pair in new_links for x in pair]):
            t.copy_(v)
        cc.reset_launches()
        graph_set.replay()
        want = cc.fused_chain(first, link_ops, links, plan)
        torch.cuda.synchronize()
        assert cc.LAUNCHES["fused_chain"] == 2 * len(plan.forms)
        assert all(torch.equal(a, b) for a, b in zip(out, want)), stages


def _hbm_scale_program():
    """The reference device tier's memory-scale network
    (``tests/test_tpu_hardware.py``, ``_hbm_scale_program``) built with the
    port's builders: a simplified 32-qubit depth-10 random circuit on the
    Sycamore layout (p1 = p2 = 0.5, rng 4) closed on zeros, ``Greedy``;
    its split-complex model peaks near 2^29 bytes."""
    import numpy as np

    from tnc_tpu_torch.builders.connectivity import ConnectivityLayout
    from tnc_tpu_torch.builders.random_circuit import random_circuit
    from tnc_tpu_torch.contractionpath.paths import Greedy, OptMethod
    from tnc_tpu_torch.ops.program import build_program
    from tnc_tpu_torch.tensornetwork.simplify import simplify_network

    tn = simplify_network(random_circuit(32, 10, 0.5, 0.5, np.random.default_rng(4),
                                         ConnectivityLayout.SYCAMORE, bitstring="0" * 32))
    return tn, build_program(tn, Greedy(OptMethod.GREEDY).find_path(tn).replace_path())


@pytest.mark.cuda
def test_measured_peak_within_the_budget_model():
    """The whole program on the card peaks at most 1.5x the budget model's
    prediction (``torch.cuda.max_memory_allocated`` against
    ``program_peak_bytes``)."""
    _card()
    from tnc_tpu_torch.ops.backends import TorchBackend
    from tnc_tpu_torch.ops.budget import program_peak_bytes
    from tnc_tpu_torch.ops.program import flat_leaf_tensors

    tn, program = _hbm_scale_program()
    est = program_peak_bytes(program, split_complex=True, batch=1)
    assert est.peak_bytes > 1 << 28, "network too small to be meaningful"
    arrays = [leaf.data.into_data() for leaf in flat_leaf_tensors(tn)]
    backend = TorchBackend()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    out = backend.execute_on_device(program, arrays)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    del out
    print(f"max_memory_allocated {peak} bytes, modeled {est.peak_bytes} "
          f"({peak / est.peak_bytes:.4f}x)")
    assert peak <= 1.5 * est.peak_bytes, (peak, est.peak_bytes)


@pytest.mark.cuda
def test_budget_clamp_prevents_oom_scale_batches():
    """An oversized slice batch is clamped to one that fits the card."""
    _card()
    from tnc_tpu_torch.ops.budget import clamp_slice_batch, fits_hbm

    _, program = _hbm_scale_program()
    clamped = clamp_slice_batch(program, 4096, device="cuda")
    assert clamped < 4096
    assert fits_hbm(program, batch=clamped, device="cuda")


@pytest.mark.cuda
def test_naive_rung_kahan_parity_on_the_card(monkeypatch):
    """The naive 4-dot complex product and the Kahan-compensated slice sum
    at FP32, chunked (batches of 4, chunks of 16) and graphed, against
    complex128 on a ``slice_and_reconfigure`` plan of a 14-qubit circuit."""
    _card()
    import numpy as np

    from tnc_tpu_torch.builders.connectivity import ConnectivityLayout
    from tnc_tpu_torch.builders.random_circuit import random_circuit
    from tnc_tpu_torch.contractionpath.contraction_path import ContractionPath
    from tnc_tpu_torch.contractionpath.paths import Greedy, OptMethod
    from tnc_tpu_torch.contractionpath.slicing import slice_and_reconfigure
    from tnc_tpu_torch.ops.backends import TorchBackend
    from tnc_tpu_torch.ops.program import flat_leaf_tensors
    from tnc_tpu_torch.ops.sliced import build_sliced_program, execute_sliced_numpy

    tn = random_circuit(14, 8, 0.5, 0.4, np.random.default_rng(11), ConnectivityLayout.LINE,
                        bitstring="0" * 14)
    result = Greedy(OptMethod.GREEDY).find_path(tn)
    for divisor in (16.0, 8.0, 4.0, 2.0):
        try:
            pairs, slicing = slice_and_reconfigure(
                list(tn.tensors), result.ssa_path.toplevel, max(result.size / divisor, 2.0))
            break
        except ValueError:
            continue
    assert slicing.num_slices >= 4
    sp = build_sliced_program(tn, ContractionPath.simple(pairs), slicing)
    arrays = [leaf.data.into_data() for leaf in flat_leaf_tensors(tn)]
    want = execute_sliced_numpy(sp, arrays)
    monkeypatch.setenv("TNC_TPU_COMPLEX_MULT", "naive")
    got = np.asarray(TorchBackend(precision="float32", slice_batch=4, chunk_steps=16)
                     .execute_sliced(sp, arrays))
    denom = max(float(np.max(np.abs(want))), 1e-30)
    assert float(np.max(np.abs(got - want))) / denom <= 1e-5


@pytest.mark.cuda
def test_capture_with_a_host_sync_raises():
    """A unit that waits on the card inside its capture raises and names
    the unit; the card goes on working."""
    _card()
    from tnc_tpu_torch.ops import graphs

    x = torch.ones(4, device="cuda")
    with pytest.raises(graphs.CaptureError, match="capture of the syncing unit failed"):
        graphs.GraphSet(graphs.graph_class("cuda")).capture("the syncing unit",
                                                            lambda: float(x.sum()))
    assert float((x * 2).sum()) == 8.0


@pytest.mark.cuda
def test_batched_sweep_on_the_card():
    """Eight amplitudes of ``sycamore_circuit(20, 8)`` through one
    ``amplitude_sweep`` on the card: within 1e-4 of max|ref| of complex128 per
    bitstring on the card, one ``fused_chain`` launch per chain of the
    policy (the chains on the bras batched), and ``BoundProgram.amplitudes``
    of the same bitstrings bitwise equal."""
    _card()
    import numpy as np

    from tnc_tpu_torch.builders.sycamore_circuit import sycamore_circuit
    from tnc_tpu_torch.ops.backends import TorchBackend
    from tnc_tpu_torch.serve import bind_template
    from tnc_tpu_torch.tensornetwork.sweep import _sweep_program, amplitude_sweep

    rows = np.random.default_rng(7).integers(0, 2, (7, 20))
    bits = ["0" * 20] + ["".join(str(int(b)) for b in r) for r in rows]
    program, arrays, bras = _sweep_program(
        sycamore_circuit(20, 8, np.random.default_rng(42)), bits, None)
    backend = TorchBackend()
    chains = len(backend.kernel_policy(program).chains)
    assert chains > 0
    cc.reset_launches()
    got = amplitude_sweep(sycamore_circuit(20, 8, np.random.default_rng(42)), bits,
                          backend=backend)
    assert cc.LAUNCHES["fused_chain"] == chains
    oracle = TorchBackend(dtype="complex128", split_complex=False)
    want = np.array([
        complex(np.asarray(oracle.execute(
            program, [a[i] if s in bras else a for s, a in enumerate(arrays)])).reshape(()))
        for i in range(len(bits))])
    assert float(np.max(np.abs(got - want))) <= 1e-4 * float(np.max(np.abs(want)))
    bound = bind_template(sycamore_circuit(20, 8, np.random.default_rng(42))
                          .into_amplitude_template("0" * 20))
    assert bound.amplitudes(bits, backend).tobytes() == got.tobytes()


@pytest.mark.cuda
def test_chain_sampler_on_the_card():
    """``ChainSampler(sycamore_circuit(20, 8)).sample(32, seed=0)`` on the
    card: each step's conditionals within 1e-5 of complex128 on the card,
    the samples those of the complex128 sampler unless a uniform lies within
    1e-4 of its threshold."""
    _card()
    import numpy as np

    from tnc_tpu_torch.builders.sycamore_circuit import sycamore_circuit
    from tnc_tpu_torch.ops.backends import TorchBackend
    from tnc_tpu_torch.queries import ChainSampler

    def circuit():
        return sycamore_circuit(20, 8, np.random.default_rng(42))

    oracle = TorchBackend(dtype="complex128", split_complex=False)
    sampler = ChainSampler(circuit(), backend=TorchBackend())
    steps = []
    real = sampler.conditionals

    def conditionals(prefixes, backend=None):
        out = real(prefixes, backend)
        steps.append((list(prefixes), out))
        return out

    sampler.conditionals = conditionals
    got = sampler.sample(32, seed=0)
    assert len(steps) == 20
    near = set()
    rng = np.random.default_rng(0)
    for k, (prefixes, p32) in enumerate(steps):
        p128 = ChainSampler.conditionals(sampler, prefixes, oracle)
        assert float(np.max(np.abs(p32 - p128))) <= 1e-5
        draws = rng.random(32)
        index = {p: i for i, p in enumerate(prefixes)}
        near |= {(i, k) for i, s in enumerate(got)
                 if abs(draws[i] - p32[index[s[:k]]][1]) <= 1e-4}
    want = ChainSampler(circuit(), backend=oracle).sample(32, seed=0)
    for i, (a, b) in enumerate(zip(got, want)):
        if a != b:
            assert (i, next(k for k in range(20) if a[k] != b[k])) in near


def _maxcut_terms(n):
    return [(-0.5, "i" * u + "zz" + "i" * (n - u - 2)) for u in range(n - 1)]


@pytest.mark.cuda
def test_expectation_gradient_on_the_card():
    """BASELINE config #4's circuit, ``qaoa_circuit(30, 2, default_rng(42))``:
    the MaxCut energy's gradient over every gate leaf of both layers on the
    card in complex64 (the default device) equals the host's complex128
    gradient to 1e-4·max|g|, and its value the host's to 1e-5·29."""
    _card()
    import numpy as np

    from tnc_tpu_torch.builders.qaoa_circuit import qaoa_circuit
    from tnc_tpu_torch.queries import pauli_expectation_value_and_grad

    def circuit():
        return qaoa_circuit(30, 2, np.random.default_rng(42))

    terms = _maxcut_terms(30)
    val, vals, grads = pauli_expectation_value_and_grad(circuit(), terms)
    want, want_vals, want_grads = pauli_expectation_value_and_grad(
        circuit(), terms, dtype="complex128", device="cpu")
    assert abs(val - want) <= 1e-5 * len(terms)
    assert float(np.max(np.abs(vals - want_vals))) <= 1e-5
    scale = max(float(np.max(np.abs(g))) for g in want_grads)
    assert len(grads) == len(want_grads)
    for got, ref in zip(grads, want_grads):
        assert got.dtype == np.complex64 and got.shape == ref.shape
        assert float(np.max(np.abs(got - ref))) <= 1e-4 * scale


@pytest.mark.cuda
def test_gradients_on_the_card():
    """The sliced gradient of a 20-qubit Sycamore amplitude (4 slices) and
    the sweep gradient of 8 bitstrings on the card in complex64 against the
    host's complex128 ones, to 1e-4·max|g|; the sliced gradient equals the
    unsliced one there."""
    _card()
    import numpy as np

    from tnc_tpu_torch.builders.sycamore_circuit import sycamore_circuit
    from tnc_tpu_torch.contractionpath.paths import Greedy, OptMethod
    from tnc_tpu_torch.contractionpath.slicing import find_slicing
    from tnc_tpu_torch.ops.autodiff import (
        contraction_value_and_grad,
        sliced_contraction_value_and_grad,
    )
    from tnc_tpu_torch.tensornetwork.simplify import simplify_network
    from tnc_tpu_torch.tensornetwork.sweep import amplitude_sweep_value_and_grad

    def close(got, want):
        scale = max(float(np.max(np.abs(g))) for g in want[1])
        assert float(np.max(np.abs(got[0] - want[0]))) <= 1e-4 * max(
            float(np.max(np.abs(want[0]))), 1e-30)
        for a, b in zip(got[1], want[1]):
            assert float(np.max(np.abs(a - b))) <= 1e-4 * scale

    tn, _ = sycamore_circuit(20, 6, np.random.default_rng(7)).into_amplitude_network("0" * 20)
    tn = simplify_network(tn)
    path = Greedy(OptMethod.GREEDY).find_path(tn).replace_path()
    slicing = find_slicing(tn.tensors, path.toplevel, 2.0 ** 7)
    assert slicing.num_slices == 4
    wrt = list(range(0, 28, 3))
    card = sliced_contraction_value_and_grad(tn, path, slicing, wrt=wrt)
    host = sliced_contraction_value_and_grad(tn, path, slicing, wrt=wrt, dtype="complex128",
                                             device="cpu")
    close(card, host)
    close(contraction_value_and_grad(tn, path, wrt=wrt), host)

    def circuit():
        return sycamore_circuit(12, 6, np.random.default_rng(42))

    bits = ["".join(str(int(b)) for b in row)
            for row in np.random.default_rng(3).integers(0, 2, (8, 12))]
    close(amplitude_sweep_value_and_grad(circuit(), bits),
          amplitude_sweep_value_and_grad(circuit(), bits, dtype="complex128", device="cpu"))


@pytest.mark.cuda
def test_approximate_sweep_on_the_card():
    """The boundary-MPS sweep of a ``peps(4, 4, 2, 2, 1)`` sandwich on the
    card (the default ``backend="torch"``, no device given): complex128 within 1e-10
    of the host's numpy sweep at every chi, value and weight; complex64
    within 1e-4; and the chi ladder's error bounds the true error."""
    _card()
    import numpy as np

    from tnc_tpu_torch.approx import ApproxProgram, ChiLadder
    from tnc_tpu_torch.builders.peps import peps
    from tnc_tpu_torch.tensornetwork.approximate import attach_random_data

    tn = attach_random_data(peps(4, 4, 2, 2, 1), np.random.default_rng(3))
    prog = ApproxProgram.from_peps_sandwich(tn, 4, 4, 1)
    exact = prog.contract(4096, backend="numpy")[0]
    for chi in (2, 8, 32):
        want, want_w = prog.contract(chi, backend="numpy")
        got, got_w = prog.contract(chi, dtype="complex128")
        assert abs(got - want) <= 1e-10 * abs(exact)
        assert abs(got_w - want_w) <= 1e-10 * max(want_w, 1.0)
        got32, _ = prog.contract(chi)
        assert abs(got32 - want) <= 1e-4 * abs(exact)
    res = ChiLadder(chi_cap=256).run(prog, rtol=1e-8, scale=abs(exact), dtype="complex128")
    assert res.converged
    for rung in res.rungs:
        assert rung.err >= abs(rung.value - exact)


@pytest.mark.cuda
def test_service_on_the_card():
    """A ``ContractionService`` of ``sycamore_circuit(20, 8)`` on its own
    ``TorchBackend()``: 16 amplitude requests from 2 threads, each within
    1e-4 of max|ref| of complex128 on the card (the references made after
    the service stopped, so no other thread works on the card meanwhile)."""
    _card()
    import threading

    import numpy as np

    from tnc_tpu_torch.builders.sycamore_circuit import sycamore_circuit
    from tnc_tpu_torch.ops.backends import TorchBackend
    from tnc_tpu_torch.serve import ContractionService, bind_template

    rows = np.random.default_rng(7).integers(0, 2, (16, 20))
    bits = ["".join(str(int(b)) for b in r) for r in rows]
    futures = [None] * len(bits)
    with ContractionService.from_circuit(sycamore_circuit(20, 8, np.random.default_rng(42)),
                                         max_batch=8, max_wait_ms=20) as svc:
        assert isinstance(svc.backend, TorchBackend)

        def submit(k):
            for i in range(k, len(bits), 2):
                futures[i] = svc.submit(bits[i])

        threads = [threading.Thread(target=submit, args=(k,)) for k in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        got = np.array([f.result(timeout=120) for f in futures])
        counts = svc.stats()["counts"]
    assert counts["completed"] == len(bits) and counts["failed"] == 0
    bound = bind_template(sycamore_circuit(20, 8, np.random.default_rng(42))
                          .into_amplitude_template("0" * 20))
    want = bound.amplitudes(bits, TorchBackend(dtype="complex128", split_complex=False))
    assert float(np.max(np.abs(got - want))) <= 1e-4 * float(np.max(np.abs(want)))


@pytest.mark.cuda
def test_chunked_checkpoint_resume_on_the_card(tmp_path, monkeypatch):
    """The chunked executor on the card (graphed, batch 4) over the 16 slices
    of ``sycamore_circuit(20, 8, rng 7)``: interrupted by a fault at the
    batch starting at slice 8 and called again, it resumes at cursor 8 and
    gives the uninterrupted run's bits."""
    _card()
    import glob
    import json

    import numpy as np

    from tnc_tpu_torch.builders.sycamore_circuit import sycamore_circuit
    from tnc_tpu_torch.contractionpath.paths import Greedy, OptMethod
    from tnc_tpu_torch.contractionpath.slicing import find_slicing
    from tnc_tpu_torch.ops.backends import TorchBackend
    from tnc_tpu_torch.ops.program import flat_leaf_tensors
    from tnc_tpu_torch.ops.sliced import build_sliced_program
    from tnc_tpu_torch.resilience import faults
    from tnc_tpu_torch.resilience.faultinject import InjectedFatal
    from tnc_tpu_torch.tensornetwork.simplify import simplify_network

    tn, _ = sycamore_circuit(20, 8, np.random.default_rng(7)).into_amplitude_network("0" * 20)
    tn = simplify_network(tn)
    path = Greedy(OptMethod.GREEDY).find_path(tn).replace_path()
    sp = build_sliced_program(tn, path, find_slicing(tn.tensors, path.toplevel, 2.0 ** 17))
    arrays = [leaf.data.into_data() for leaf in flat_leaf_tensors(tn)]
    assert sp.slicing.num_slices == 16
    backend = TorchBackend(slice_batch=4)
    want = backend.execute_sliced(sp, arrays)
    monkeypatch.setenv("TNC_TPU_CKPT", str(tmp_path))
    monkeypatch.setenv("TNC_TPU_CKPT_EVERY", "4")
    with faults("chunked.batch(start=8)=fatal*1"):
        with pytest.raises(InjectedFatal):
            backend.execute_sliced(sp, arrays)
    (file,) = glob.glob(str(tmp_path / "*.npz"))
    with np.load(file) as z:
        assert json.loads(str(z["meta"]))["cursor"] == 8
    got = backend.execute_sliced(sp, arrays)
    assert np.asarray(got).tobytes() == np.asarray(want).tobytes()
    assert not glob.glob(str(tmp_path / "*.npz"))
    assert not torch.cuda.is_current_stream_capturing()


@pytest.mark.cuda
def test_degrade_ladder_releases_memory_on_the_card():
    """``execute_sliced_resilient`` on the per-slice loop under a memory cap
    below the program's modeled peak: a real ``torch.cuda.OutOfMemoryError``
    reaches the ladder, which replans to a slicing that fits; the cap is
    restored, the memory the call allocated is given back (within 64 MiB)
    and the amplitude "0"x53 of ``sycamore_circuit(53, 8, rng 42)`` is
    within 1e-5 of complex128 on the card."""
    _card()
    import numpy as np

    from tnc_tpu_torch import obs
    from tnc_tpu_torch.builders.sycamore_circuit import sycamore_circuit
    from tnc_tpu_torch.contractionpath.paths import Greedy, OptMethod
    from tnc_tpu_torch.contractionpath.slicing import find_slicing
    from tnc_tpu_torch.ops.backends import TorchBackend
    from tnc_tpu_torch.ops.budget import program_peak_bytes
    from tnc_tpu_torch.ops.program import flat_leaf_tensors
    from tnc_tpu_torch.ops.sliced import build_sliced_program
    from tnc_tpu_torch.resilience import execute_sliced_resilient
    from tnc_tpu_torch.tensornetwork.contraction import contract_tensor_network

    tn, _ = sycamore_circuit(53, 8, np.random.default_rng(42)).into_amplitude_network("0" * 53)
    path = Greedy(OptMethod.GREEDY).find_path(tn).replace_path()
    slicing = find_slicing(tn.tensors, path.toplevel, 2.0 ** 26)
    modeled = program_peak_bytes(build_sliced_program(tn, path, slicing).program).peak_bytes
    arrays = [np.asarray(leaf.data.into_data()) for leaf in flat_leaf_tensors(tn)]
    backend = TorchBackend(sliced_strategy="loop", hoist=False)
    saved = (obs.enabled(), obs.get_registry())
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    before = torch.cuda.memory_allocated()
    cap = torch.cuda.memory_reserved() + 0.9 * modeled
    torch.cuda.set_per_process_memory_fraction(
        cap / torch.cuda.get_device_properties(0).total_memory)
    try:
        reg = obs.configure(enabled=True, registry=obs.MetricsRegistry())
        out, used = execute_sliced_resilient(tn, path, slicing, arrays=arrays, backend=backend)
    finally:
        torch.cuda.set_per_process_memory_fraction(1.0)
        obs.configure(enabled=saved[0], registry=saved[1])
    torch.cuda.synchronize()
    after = torch.cuda.memory_allocated()
    assert reg.counters()[("resilience.ladder.replans", ())] >= 1.0
    assert used.num_slices != slicing.num_slices
    assert abs(after - before) <= 64 << 20
    oracle = TorchBackend(dtype="complex128", split_complex=False)
    want = complex(contract_tensor_network(tn, path, oracle).data.into_data())
    got = complex(np.asarray(out).reshape(-1)[0])
    assert abs(got - want) <= 1e-5 * abs(want)


@pytest.mark.cuda
def test_cost_truth_adoption_keeps_the_policy_key_on_the_card():
    """A ``TorchBackend()`` fitted to step spans the card recorded serves a
    ``ContractionService`` with the cost-truth loop on; a manual refit is
    adopted at the next batch boundary, and the backend's fit — what its
    kernel policies were planned from — and its ``policy_key()`` stay as
    they were."""
    _card()
    import numpy as np

    from tnc_tpu_torch import obs
    from tnc_tpu_torch.builders.sycamore_circuit import sycamore_circuit
    from tnc_tpu_torch.contractionpath.paths import Greedy, OptMethod
    from tnc_tpu_torch.obs import core
    from tnc_tpu_torch.obs.cost_truth import CostTruthConfig
    from tnc_tpu_torch.ops.backends import TorchBackend
    from tnc_tpu_torch.serve import ContractionService
    from tnc_tpu_torch.tensornetwork.contraction import contract_tensor_network

    saved = (core._ENABLED, core._STEP_TIME, core._REGISTRY)
    try:
        obs.configure(enabled=True, step_time=True, registry=obs.MetricsRegistry())
        for qubits, depth in ((20, 8), (24, 8)):
            tn, _ = sycamore_circuit(qubits, depth, np.random.default_rng(42)) \
                .into_amplitude_network("0" * qubits)
            contract_tensor_network(tn, Greedy(OptMethod.GREEDY).find_path(tn).replace_path(),
                                    TorchBackend())
        obs.configure(enabled=False, step_time=False)
        backend = TorchBackend()
        key = backend.policy_key()
        assert key[2] is not None, "no fit from the card's step spans"
        bits = ["".join(str(int(b)) for b in r)
                for r in np.random.default_rng(7).integers(0, 2, (8, 20))]
        with ContractionService.from_circuit(
                sycamore_circuit(20, 8, np.random.default_rng(42)), backend=backend,
                max_batch=4, max_wait_ms=0, cost_truth=True, cost_truth_options={
                    "config": CostTruthConfig(refit_min_samples=2, refit_cooldown_s=0.0,
                                              use_step_spans=False)}) as svc:
            for b in bits:
                svc.amplitude(b, timeout_s=120)
            ct = svc._cost_truth
            assert ct.maybe_refit(trigger="manual")
            svc.amplitude(bits[0], timeout_s=120)
            assert svc.stats()["calibration"]["model_version"] == ct.model_version >= 1
            assert svc.cost_model is ct.model and backend.cost_model() is not ct.model
        assert backend.policy_key() == key
    finally:
        core._ENABLED, core._STEP_TIME, core._REGISTRY = saved


@pytest.mark.cuda
def test_partitioned_treecut_amplitude_on_the_card():
    """A ``sycamore_circuit(20, 8)`` amplitude cut into 4 blocks from its
    ``Greedy`` tree (``plan_treecut(..., seed=3)``, the GREEDY fan-in of
    ``compute_solution_with_paths``): the nested program on the card, one
    ``fused_chain`` launch per chain of its policy, equals the same program
    on the host's plain chain (``TorchBackend(device="cpu",
    split_complex=True)``) and complex128 to 1e-5·max(|ref|, 2^-14)."""
    _card()
    import random

    import numpy as np

    from tnc_tpu_torch.builders.sycamore_circuit import sycamore_circuit
    from tnc_tpu_torch.contractionpath.paths import Greedy, OptMethod
    from tnc_tpu_torch.contractionpath.repartitioning import compute_solution_with_paths
    from tnc_tpu_torch.contractionpath.treecut import plan_treecut
    from tnc_tpu_torch.ops.backends import NumpyBackend, TorchBackend
    from tnc_tpu_torch.ops.program import build_program
    from tnc_tpu_torch.tensornetwork.contraction import contract_tensor_network

    tn, _ = sycamore_circuit(20, 8, np.random.default_rng(42)).into_amplitude_network("0" * 20)
    ssa = Greedy(OptMethod.GREEDY).find_path(tn).ssa_path.toplevel
    cut = plan_treecut(list(tn.tensors), ssa, 4, seed=3)
    ptn, path, _, _ = compute_solution_with_paths(tn, cut.assignment, cut.local_paths,
                                                  rng=random.Random(0))
    assert len(ptn) == 4 and path.nested
    backend = TorchBackend()
    chains = len(backend.kernel_policy(build_program(ptn, path)).chains)
    assert chains > 0
    cc.reset_launches()
    got = complex(contract_tensor_network(ptn, path, backend).data.into_data())
    torch.cuda.synchronize()
    assert cc.LAUNCHES["fused_chain"] == chains
    plain = complex(contract_tensor_network(
        ptn, path, TorchBackend(device="cpu", split_complex=True)).data.into_data())
    want = complex(contract_tensor_network(ptn, path, NumpyBackend()).data.into_data())
    tol = 1e-5 * max(abs(want), 2.0 ** -14)
    assert abs(got - plain) <= tol
    assert abs(got - want) <= tol


def _cluster_chain(k: int, m: int, seed: int = 0):
    """``tests/_cluster_fixture.cluster_chain`` in the port's classes (this
    file imports no JAX): k dense clusters K_m over bond-2 legs joined by
    one bond each, seeded complex Gaussian leaves."""
    import itertools

    import numpy as np

    from tnc_tpu_torch.tensornetwork.tensor import CompositeTensor, LeafTensor
    from tnc_tpu_torch.tensornetwork.tensordata import TensorData

    rng = np.random.default_rng(seed)
    next_leg = itertools.count()
    members = []
    for _ in range(k):
        legs_per = [[] for _ in range(m)]
        for i in range(m):
            for j in range(i + 1, m):
                leg = next(next_leg)
                legs_per[i].append(leg)
                legs_per[j].append(leg)
        members.append(legs_per)
    for c in range(k - 1):
        leg = next(next_leg)
        members[c][-1].append(leg)
        members[c + 1][0].append(leg)
    tensors = []
    for legs_per in members:
        for legs in legs_per:
            shape = (2,) * len(legs)
            data = (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)) / np.sqrt(
                float(np.prod(shape)))
            tensors.append(LeafTensor(legs, [2] * len(legs), TensorData.matrix(data)))
    return CompositeTensor(tensors)


def _partitioned(tn, k: int):
    from tnc_tpu_torch.contractionpath.paths import Greedy, OptMethod
    from tnc_tpu_torch.tensornetwork.partitioning import (
        find_partitioning,
        partition_tensor_network,
    )
    from tnc_tpu_torch.tensornetwork.tensor import CompositeTensor

    grouped = partition_tensor_network(CompositeTensor(list(tn.tensors)),
                                       find_partitioning(tn, k))
    return grouped, Greedy(OptMethod.GREEDY).find_path(grouped).replace_path()


@pytest.mark.cuda
def test_mesh_strategy_on_the_card():
    """``local_sliced_strategy="mesh"`` with ``[cuda:0] * 4`` on a two-cluster
    chain under a budget that slices both partitions: each partition's
    slices split over its own slot and a spare one, each share on a stream
    of its own, the partials summed on the partition's device; equal within
    1e-5·max(|ref|, 2^-14) to the same plan on the host's plain kernels and
    to complex128."""
    _card()
    import numpy as np

    from tnc_tpu_torch.contractionpath.paths import Greedy, OptMethod
    from tnc_tpu_torch.ops.sliced import SlicedProgram
    from tnc_tpu_torch.parallel.partitioned import (
        distributed_partitioned_contraction,
        scatter_partitions,
    )
    from tnc_tpu_torch.tensornetwork.contraction import contract_tensor_network

    tn = _cluster_chain(2, 6)
    grouped, path = _partitioned(tn, 2)
    devices = [torch.device("cuda:0")] * 4
    hbm = 1 << 13  # under the partitions' modeled peaks (12672 bytes)
    comm, _ = scatter_partitions(grouped, path, devices, "complex64", True, hbm_bytes=hbm)
    assert all(isinstance(p, SlicedProgram) and p.slicing.num_slices % 2 == 0
               for p in comm.programs)
    got = complex(distributed_partitioned_contraction(
        grouped, path, devices=devices, hbm_bytes=hbm,
        local_sliced_strategy="mesh").data.into_data())
    host = complex(distributed_partitioned_contraction(
        grouped, path, devices=[torch.device("cpu")] * 4, split_complex=True,
        hbm_bytes=hbm, local_sliced_strategy="mesh").data.into_data())
    want = complex(contract_tensor_network(
        tn, Greedy(OptMethod.GREEDY).find_path(tn).replace_path(), "numpy").data.into_data())
    tol = 1e-5 * max(abs(want), 2.0 ** -14)
    assert np.isfinite(got) and abs(got - host) <= tol and abs(got - want) <= tol


@pytest.mark.cuda
def test_fanin_between_repeated_devices_is_bitwise_a_one_device_run():
    """Four partitions on ``[cuda:0] * 4``: the local phases on streams of
    their own, the fan-in's ``.to()`` a no-op on the repeated device — the
    bits of the same partition programs and pair programs run one after
    another on the current stream of one device."""
    _card()
    import numpy as np

    from tnc_tpu_torch.builders.connectivity import ConnectivityLayout
    from tnc_tpu_torch.builders.random_circuit import random_circuit
    from tnc_tpu_torch.ops.backends import TorchBackend
    from tnc_tpu_torch.parallel.partitioned import (
        distributed_partitioned_contraction,
        plan_fanin_pairs,
        scatter_partitions,
    )
    from tnc_tpu_torch.contractionpath.communication_schemes import fanin_levels

    tn = random_circuit(16, 6, 0.9, 0.8, np.random.default_rng(5), ConnectivityLayout.LINE)
    grouped, path = _partitioned(tn, 4)
    devices = [torch.device("cuda:0")] * 4
    got = distributed_partitioned_contraction(grouped, path, devices=devices)

    comm, buffers = scatter_partitions(grouped, path, devices, "complex64", True)
    backend = TorchBackend()
    held = [backend._run(program, bufs) for program, bufs in zip(comm.programs, buffers)]
    flat = [pair for level in fanin_levels(path.toplevel) for pair in level]
    programs, _, _, meta = plan_fanin_pairs(comm.results_meta, flat)
    for program, (x, y) in zip(programs, flat):
        held[x] = backend._run(program, [held[x], held[y]])
        held[y] = None
    root = next(h for h in held if h is not None)
    want = torch.complex(*root).cpu().numpy().reshape(meta.bond_dims)
    assert np.array_equal(got.data.into_data(), want)


# -- the dot-precision rungs ----------------------------------------------------

RUNG_SHAPES = {
    # (K, M, N, batch): each float tile variant, ragged edges, a batch, a
    # long contraction
    "wide": (1024, 2048, 2048, None), "narrow_ragged": (300, 100, 200, None),
    "flat": (512, 4, 4096, None), "batched": (256, 128, 192, 3),
    "long": (16384, 1024, 1024, None),
}


def _frob(got, exact) -> float:
    num = sum(float(((g.double() - e) ** 2).sum()) for g, e in zip(got, exact))
    return (num / sum(float((e ** 2).sum()) for e in exact)) ** 0.5


#: hi = rna_tf32 = 1, lo = 2^-11 - 2^-21: one product is 1 + 2^-10 - 2^-20
#: at ``high`` (every sum exact), 1 at ``default``, FP32's 2^-22 above ``high``
PROBE_VALUE = 1.0 + 2.0 ** -11 - 2.0 ** -21


def _probe(parts, first=4, to_kf=None):
    """Zero operands shaped as ``parts`` ((real, imag) pairs of ``(..., K,
    F)`` matrices, or stored as ``to_kf(i, t)`` reads them) but for contract
    index 0 of the real parts: ``PROBE_VALUE`` on the first ``first``, 1 on
    a chain's links."""
    out = []
    for i, t in enumerate(parts):
        z = torch.zeros(t.shape, dtype=t.dtype, device=t.device)
        if i % 2 == 0:
            value = PROBE_VALUE if i < first else 1.0
            if to_kf is None:
                z[..., 0, :] = value
            else:
                idx = torch.arange(z.numel(), device=z.device).reshape(z.shape)
                z.view(-1)[to_kf(i, idx)[0]] = value
        out.append(z)
    return out


def _ran_the_rung(got, float32, rung, probe) -> None:
    """A TF32 rung's kernel output is not the float32 kernel's bit for bit,
    and on the probe (``probe(rung)`` = kernel and plain outputs) the rung
    gives its plain version's bits where the float32 kernel does not: the
    rung's own arithmetic ran, not an FP32 one."""
    assert not all(torch.equal(a, b) for a, b in zip(got, float32))
    kernel, plain = probe(rung)
    assert all(torch.equal(a, b) for a, b in zip(kernel, plain))
    f32, _ = probe("float32")
    assert not all(torch.equal(a, b) for a, b in zip(f32, plain))


@pytest.mark.cuda
@pytest.mark.parametrize("rung", ["high", "default"])
@pytest.mark.parametrize("case", list(RUNG_SHAPES))
def test_complex_dot_rungs_on_the_card(case, rung):
    """``fused_complex_dot`` at a TF32 rung against its plain version at
    that rung (1e-5·max|plain|) and against float64 (``high`` within 2^-20
    relative Frobenius, ``default`` at least ten times that), counted by
    rung."""
    _card()
    k, m, n, batch = RUNG_SHAPES[case]
    g = torch.Generator(device="cuda").manual_seed(2)
    lead = () if batch is None else (batch,)
    ops = [torch.randn(*lead, k, m, generator=g, device="cuda") for _ in range(2)]
    ops += [torch.randn(k, n, generator=g, device="cuda") for _ in range(2)]
    cc.reset_launches()
    got = cc.fused_complex_dot(*ops, precision=rung)
    assert cc.RUNG_LAUNCHES == {f"fused_complex_dot {rung}": 1}
    plain = cc.fused_complex_dot_reference(*ops, rung)
    assert _max_rel_err(got, plain) <= 1e-5
    probe = _probe(ops)
    _ran_the_rung(got, cc.fused_complex_dot(*ops), rung,
                  lambda r: (cc.fused_complex_dot(*probe, precision=r),
                             cc.fused_complex_dot_reference(*probe, r)))
    err = _frob(got, cc.fused_complex_dot_reference(*(t.double() for t in ops)))
    if rung == "high":
        assert err <= 2.0 ** -20
    else:
        assert err >= 10 * 2.0 ** -22


@pytest.mark.cuda
@pytest.mark.parametrize("rung", ["high", "default"])
@pytest.mark.parametrize("layouts", PEPS_LAYOUTS, ids=["steps0_4", "steps11_15_cut"])
def test_transpose_kernel_rungs_on_the_card(layouts, rung):
    """``fused_transpose_dot`` at a TF32 rung on the PEPS layouts (the
    direct and staged pipelines) against its plain version at that rung
    and against float64."""
    _card()
    g = torch.Generator(device="cuda").manual_seed(3)
    a_lay, b_lay = cc.OperandLayout(*layouts[0]), cc.OperandLayout(*layouts[1])
    ops = [torch.randn(v, generator=g, device="cuda")
           for v in (a_lay.view, a_lay.view, b_lay.view, b_lay.view)]
    got = cc.fused_transpose_dot(*ops, a_lay, b_lay, rung)
    plain = cc.fused_transpose_reference(*ops, a_lay, b_lay, rung)
    assert _max_rel_err(got, plain) <= 1e-5
    probe = _probe(ops, to_kf=lambda i, t: cc._as_kf(t, a_lay if i < 2 else b_lay))
    _ran_the_rung(got, cc.fused_transpose_dot(*ops, a_lay, b_lay), rung,
                  lambda r: (cc.fused_transpose_dot(*probe, a_lay, b_lay, r),
                             cc.fused_transpose_reference(*probe, a_lay, b_lay, r)))
    err = _frob(got, cc.fused_transpose_reference(*(t.double() for t in ops), a_lay, b_lay))
    assert err <= 2.0 ** -20 if rung == "high" else err >= 10 * 2.0 ** -22


@pytest.mark.cuda
@pytest.mark.parametrize("rung", ["high", "default"])
@pytest.mark.parametrize("form", ["resident", "grid"])
def test_chain_rungs_on_the_card(form, rung):
    """``fused_chain`` at a TF32 rung in each form: two launches bitwise
    equal, against the plain chain at that rung; a plan keeps its rung."""
    _card()
    g = torch.Generator(device="cuda").manual_seed(4)

    def rnd(*shape):
        return torch.randn(*shape, generator=g, device="cuda")

    if form == "resident":
        first = (rnd(16, 8), rnd(16, 8), rnd(16, 32), rnd(16, 32))
        link_ops = [(rnd(32, 4), rnd(32, 4))]
        links = [cc.ChainLink(True, (8, 32), 1)]
    else:
        first = (rnd(16, 256), rnd(16, 256), rnd(16, 256), rnd(16, 256))
        link_ops = [(rnd(65536, 1), rnd(65536, 1))]
        links = [cc.ChainLink(True, (65536, 1), 0)]
    plan = cc.chain_plan(first, link_ops, links, precision=rung)
    assert plan.forms == (form,) and plan.rung == rung
    got = cc.fused_chain(first, link_ops, links, plan, rung)
    again = cc.fused_chain(first, link_ops, links, plan, rung)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    want = cc.fused_chain_reference(first, link_ops, links, rung)
    # a chain rounds each carried value again for its next product, so at
    # default an FP32 sum order that differs by an ulp can move a carried
    # value a whole TF32 step: the grid form's 65536-long link read 1.1e-5
    # on an H100, and the host tests hold a chain to two products' error
    tol = 2 * 2.0 ** -10 if (form, rung) == ("grid", "default") else 1e-5
    assert _max_rel_err(got, want) <= tol
    f32 = cc.fused_chain(first, link_ops, links, cc.chain_plan(first, link_ops, links))
    flat = _probe(list(first) + [t for pair in link_ops for t in pair])
    p_first, p_links = tuple(flat[:4]), [tuple(flat[i:i + 2]) for i in range(4, len(flat), 2)]

    def probe(r):
        p_plan = cc.chain_plan(p_first, p_links, links, precision=r)
        return (cc.fused_chain(p_first, p_links, links, p_plan, r),
                cc.fused_chain_reference(p_first, p_links, links, r))

    _ran_the_rung(got, f32, rung, probe)
    with pytest.raises(ValueError, match="rung"):
        cc.fused_chain(first, link_ops, links, plan)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["gauss", "naive", "strassen", "fused"])
def test_tf32_steps_run_the_tile_and_leave_cublas_alone_on_the_card(mode):
    """At ``high`` a step of every mode launches ``fused_complex_dot`` at
    the rung, once, and matches its plain version; cuBLAS's TF32 switch
    stays off, and a float32 product keeps its bits."""
    _card()
    from tnc_tpu_torch.ops import split_complex as sc
    from tnc_tpu_torch.ops.backends import TorchBackend
    from tnc_tpu_torch.ops.program import PairStep

    TorchBackend()
    g = torch.Generator(device="cuda").manual_seed(5)
    k, m, n = 512, 256, 384
    step = PairStep(lhs=0, rhs=1, a_view=(k, m), a_perm=None, a_dot=(k, m),
                    a_cfirst=True, b_view=(k, n), b_perm=None, b_dot=(k, n),
                    b_cfirst=True, swap=False, out_store=(m, n))
    a = tuple(torch.randn(k, m, generator=g, device="cuda") for _ in range(2))
    b = tuple(torch.randn(k, n, generator=g, device="cuda") for _ in range(2))
    before = a[0].mT @ b[0]
    cc.reset_launches()
    got = sc.apply_step_split(a, b, step, precision="high", mode=mode)
    assert cc.RUNG_LAUNCHES == {"fused_complex_dot high": 1}
    assert _max_rel_err(got, cc.fused_complex_dot_reference(*a, *b, "high")) <= 1e-5
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.equal(a[0].mT @ b[0], before)
