"""The names and parameters the port took over last from the reference,
each against the reference on the CPU: ``KERNEL_MODES``, ``dtype_width``,
the tensor and data queries, ``UnionFind.num_sets``, ``Greedy(objective=)``,
``NumpyBackend(dtype=)``, ``execute_sliced_numpy(dtype=, step_spans=)``,
``run_sliced_chunked_placed(enforce_budget=)``, ``run_steps_timed(
dtype_bytes=, split_complex=)``, ``strassen_dot_kl(dot=)`` and
``ClusterDispatcher(mode=, stale_after_s=)``."""

import random

import numpy as np
import pytest
import torch

import tnc_tpu.obs.core as ref_core
import tnc_tpu.ops.budget as ref_budget
import tnc_tpu_torch.obs.core as port_core
import tnc_tpu_torch.ops.budget as port_budget
from _torch_partition_cases import MODEL, circuits, random_network
from _torch_sliced_cases import SIXTEEN, SMALL, _both, _scalar
from tnc_tpu.contractionpath.contraction_cost import CalibratedObjective as RefCalibrated
from tnc_tpu.contractionpath.contraction_cost import SizeObjective as RefSize
from tnc_tpu.contractionpath.paths import Greedy as RefGreedy
from tnc_tpu.contractionpath.paths import OptMethod as RefOptMethod
from tnc_tpu.obs.calibrate import CalibratedCostModel as RefModel
from tnc_tpu.ops import backends as ref_backends
from tnc_tpu.ops import split_complex as ref_split
from tnc_tpu.ops import strassen as ref_strassen
from tnc_tpu.ops.chunked import run_sliced_chunked_placed as ref_placed
from tnc_tpu.ops.program import build_program as ref_build_program
from tnc_tpu.ops.sliced import execute_sliced_numpy as ref_sliced_numpy
from tnc_tpu.tensornetwork.tensor import CompositeTensor as RefComposite
from tnc_tpu.tensornetwork.tensor import LeafTensor as RefLeaf
from tnc_tpu.tensornetwork.tensordata import TensorData as RefData
from tnc_tpu.utils.datastructures import UnionFind as RefUnionFind
from tnc_tpu_torch import obs
from tnc_tpu_torch.contractionpath.contraction_cost import CalibratedObjective, SizeObjective
from tnc_tpu_torch.contractionpath.paths import Greedy, OptMethod
from tnc_tpu_torch.obs.calibrate import CalibratedCostModel
from tnc_tpu_torch.ops import backends, split_complex, strassen
from tnc_tpu_torch.ops.chunked import resolve_batch, run_sliced_chunked_placed
from tnc_tpu_torch.ops.program import build_program
from tnc_tpu_torch.ops.sliced import execute_sliced_numpy
from tnc_tpu_torch.serve.multihost import ClusterDispatcher
from tnc_tpu_torch.tensornetwork.tensor import CompositeTensor, LeafTensor
from tnc_tpu_torch.tensornetwork.tensordata import TensorData
from tnc_tpu_torch.utils.datastructures import UnionFind


def test_kernel_modes_are_the_references():
    assert split_complex.KERNEL_MODES == ref_split.KERNEL_MODES


@pytest.mark.parametrize("dtype", ["complex64", "complex128", np.complex64, np.complex128,
                                   "float32", np.float64, torch.complex64, torch.complex128,
                                   "torch.complex128"], ids=str)
def test_dtype_width_is_the_references(dtype):
    assert backends.dtype_width(dtype) == ref_backends.dtype_width(dtype)


def test_tensor_and_data_queries_are_the_references():
    port_leaf, ref_leaf = LeafTensor([0, 1], [2, 2]), RefLeaf([0, 1], [2, 2])
    port_comp, ref_comp = CompositeTensor([port_leaf]), RefComposite([ref_leaf])
    for port, ref in ((port_leaf, ref_leaf), (port_comp, ref_comp)):
        assert (port.is_leaf(), port.is_composite()) == (ref.is_leaf(), ref.is_composite())
    values = [1, 2j, -3, 0.5 + 0.5j, 0, 1, 1, 1]
    got = TensorData.from_values((2, 2, 2), values)
    want = RefData.from_values((2, 2, 2), values)
    assert np.array_equal(got.into_data(), want.into_data())
    assert got.into_data().dtype == want.into_data().dtype
    for port, ref in ((TensorData.none(), RefData.none()), (got, want),
                      (TensorData.gate("h"), RefData.gate("h"))):
        assert port.is_none() == ref.is_none()


@pytest.mark.parametrize("seed", range(4))
def test_union_find_num_sets_is_the_references(seed):
    rng = random.Random(seed)
    port, ref = UnionFind(20), RefUnionFind(20)
    assert port.num_sets() == ref.num_sets() == 20
    for _ in range(12):
        a, b = rng.randrange(20), rng.randrange(20)
        assert port.union(a, b) == ref.union(a, b)
        assert port.num_sets() == ref.num_sets()


def _objectives():
    return {
        "size": (SizeObjective(), RefSize()),
        "calibrated": (CalibratedObjective(CalibratedCostModel(*MODEL)),
                       RefCalibrated(RefModel(*MODEL))),
    }


@pytest.mark.parametrize("objective", ["size", "calibrated"])
@pytest.mark.parametrize("case", ["circuit", "network"])
def test_random_greedy_objective_keeps_the_references_path(objective, case):
    port_tn, ref_tn = circuits(10, 5, 8) if case == "circuit" else random_network(14, 5)
    port_obj, ref_obj = _objectives()[objective]
    got = Greedy(OptMethod.RANDOM_GREEDY, ntrials=8, objective=port_obj).find_path(port_tn)
    want = RefGreedy(RefOptMethod.RANDOM_GREEDY, ntrials=8, objective=ref_obj).find_path(ref_tn)
    assert got.replace_path().toplevel == want.replace_path().toplevel
    assert (got.flops, got.size) == (want.flops, want.size)


def test_random_greedy_without_objective_ranks_by_flops():
    """The default stays naive-op flops: the same path as before, which a
    size objective may beat on peak but never on flops."""
    port_tn, ref_tn = circuits(10, 5, 8)
    flops = Greedy(OptMethod.RANDOM_GREEDY, ntrials=8).find_path(port_tn)
    want = RefGreedy(RefOptMethod.RANDOM_GREEDY, ntrials=8).find_path(ref_tn)
    assert flops.replace_path().toplevel == want.replace_path().toplevel
    size = Greedy(OptMethod.RANDOM_GREEDY, ntrials=8,
                  objective=SizeObjective()).find_path(port_tn)
    assert size.size <= flops.size and flops.flops <= size.flops


REL = {np.complex64: 1e-6, np.complex128: 1e-13}


def _sycamore_program(cfg=SMALL):
    both = _both(cfg)
    port = build_program(both["port"]["tn"], both["port"]["path"])
    ref = ref_build_program(both["ref"]["tn"], both["ref"]["path"])
    return port, ref, both["port"]["arrays"], both["ref"]["arrays"]


@pytest.mark.parametrize("dtype", [np.complex64, np.complex128], ids=["c64", "c128"])
def test_numpy_backend_dtype_is_the_references(dtype):
    port, ref, port_arrays, ref_arrays = _sycamore_program()
    got = backends.NumpyBackend(dtype=dtype).execute(port, port_arrays)
    want = ref_backends.NumpyBackend(dtype=dtype).execute(ref, ref_arrays)
    assert got.dtype == want.dtype == np.dtype(dtype)
    assert np.array_equal(got, want)
    assert backends.NumpyBackend().dtype == ref_backends.NumpyBackend().dtype


@pytest.mark.parametrize("dtype", [np.complex64, np.complex128], ids=["c64", "c128"])
def test_numpy_backend_sliced_dtype_is_the_references(dtype):
    both = _both(SMALL)
    got = backends.NumpyBackend(dtype=dtype).execute_sliced(both["port"]["sp"],
                                                            both["port"]["arrays"])
    want = ref_backends.NumpyBackend(dtype=dtype).execute_sliced(both["ref"]["sp"],
                                                                 both["ref"]["arrays"])
    assert got.dtype == want.dtype == np.dtype(dtype)
    assert np.array_equal(got, want)


@pytest.mark.parametrize("kw", [{}, {"max_slices": 2}, {"hoist": True}], ids=str)
@pytest.mark.parametrize("dtype", [np.complex64, np.complex128], ids=["c64", "c128"])
def test_execute_sliced_numpy_dtype_is_the_references(dtype, kw):
    both = _both(SIXTEEN)
    got = execute_sliced_numpy(both["port"]["sp"], both["port"]["arrays"], dtype=dtype, **kw)
    want = ref_sliced_numpy(both["ref"]["sp"], both["ref"]["arrays"], dtype=dtype, **kw)
    assert got.dtype == want.dtype == np.dtype(dtype)
    # the same steps in the same order; BLAS may sum a product in another
    # order for another operand layout
    assert abs(_scalar(got) - _scalar(want)) <= REL[dtype] * abs(_scalar(want))


@pytest.fixture
def traced(monkeypatch):
    """Both packages' span registries fresh and on, restored after the test."""
    for module in (port_core, ref_core):
        for name in ("_ENABLED", "_STEP_TIME", "_REGISTRY"):
            monkeypatch.setattr(module, name, getattr(module, name))
    port = obs.configure(enabled=True, registry=obs.MetricsRegistry())
    import tnc_tpu.obs as ref_obs

    ref = ref_obs.configure(enabled=True, registry=ref_obs.MetricsRegistry())
    return port, ref


def _step_spans(registry) -> list:
    return [(r.name, r.args.get("bytes_in"), r.args.get("bytes_out"))
            for r in registry.span_records() if r.name.startswith("step[")]


@pytest.mark.parametrize("step_spans", [None, False])
def test_execute_sliced_numpy_step_spans_are_the_references(traced, step_spans):
    port_reg, ref_reg = traced
    both = _both(SMALL)
    execute_sliced_numpy(both["port"]["sp"], both["port"]["arrays"], dtype=np.complex64,
                         step_spans=step_spans)
    ref_sliced_numpy(both["ref"]["sp"], both["ref"]["arrays"], dtype=np.complex64,
                     step_spans=step_spans)
    got, want = _step_spans(port_reg), _step_spans(ref_reg)
    assert got == want
    assert bool(got) == (step_spans is None)


@pytest.mark.parametrize("dtype_bytes", [8.0, 16.0])
def test_run_steps_timed_dtype_bytes_is_the_references(traced, dtype_bytes):
    port_reg, ref_reg = traced
    port, ref, port_arrays, ref_arrays = _sycamore_program()
    _, records = backends.run_steps_timed(
        port, [np.asarray(a, dtype=np.complex64) for a in port_arrays],
        dtype_bytes=dtype_bytes, split_complex=False)
    ref_backends.run_steps_timed(np, ref, [np.asarray(a, dtype=np.complex64)
                                           for a in ref_arrays], dtype_bytes=dtype_bytes)
    assert _step_spans(port_reg) == _step_spans(ref_reg)
    assert [(r["bytes_in"], r["bytes_out"]) for r in records] == [
        (b_in, b_out) for _, b_in, b_out in _step_spans(ref_reg)]


def test_run_steps_timed_split_complex_must_match_the_buffers():
    port, _, port_arrays, _ = _sycamore_program()
    native = [torch.from_numpy(np.asarray(a, dtype=np.complex64)) for a in port_arrays]
    default, _ = backends.run_steps_timed(port, list(native))
    named, _ = backends.run_steps_timed(port, list(native), split_complex=False)
    assert torch.equal(default, named)
    with pytest.raises(ValueError, match="split_complex=True"):
        backends.run_steps_timed(port, list(native), split_complex=True)
    split = backends.place_buffers(port_arrays, "complex64", True, "cpu")
    with pytest.raises(ValueError, match="split_complex=False"):
        backends.run_steps_timed(port, list(split), split_complex=False)


@pytest.mark.parametrize("enforce_budget", [True, False])
def test_chunked_enforce_budget_is_the_references(enforce_budget, monkeypatch):
    """Under a budget that fits one slice a batch, the clamp cuts the batch
    to 1 unless ``enforce_budget=False``; either way the sum is the
    reference's executor's."""
    import jax.numpy as jnp

    monkeypatch.setattr(port_budget, "device_hbm_bytes", lambda device=None: 1)
    monkeypatch.setattr(ref_budget, "device_hbm_bytes", lambda device=None: 1)
    both = _both(SIXTEEN)
    sp = both["port"]["sp"]
    batch = resolve_batch(sp, 8, split_complex=False, device="cpu",
                          enforce_budget=enforce_budget)[0]
    assert batch == (1 if enforce_budget else 8)
    placed = backends.place_buffers(both["port"]["arrays"], "complex64", False, "cpu")
    got = run_sliced_chunked_placed(sp, placed, batch=8, split_complex=False, device="cpu",
                                    enforce_budget=enforce_budget)
    want = ref_placed(both["ref"]["sp"],
                      [jnp.asarray(a, dtype=jnp.complex64) for a in both["ref"]["arrays"]],
                      batch=8, split_complex=False, enforce_budget=enforce_budget)
    ref_scalar = _scalar(np.asarray(want))
    assert abs(_scalar(got.numpy()) - ref_scalar) <= 1e-5 * abs(ref_scalar)


def test_strassen_dot_override_is_the_references():
    rng = np.random.default_rng(3)
    a, b = rng.standard_normal((8, 6)), rng.standard_normal((8, 4))
    calls = []

    def port_dot(x, y):
        calls.append("port")
        return x.mT @ y

    def ref_dot(x, y):
        calls.append("ref")
        return x.T @ y

    got = strassen.strassen_dot_kl(torch.from_numpy(a), torch.from_numpy(b), dot=port_dot)
    want = ref_strassen.strassen_dot_kl(np, a, b, dot=ref_dot)
    assert calls.count("port") == calls.count("ref") == 7
    assert np.allclose(got.numpy(), want, rtol=0, atol=1e-12)
    assert np.allclose(got.numpy(), a.T @ b, rtol=0, atol=1e-12)


def test_cluster_dispatcher_mode_and_staleness_are_the_references(tmp_path):
    from tnc_tpu.serve.multihost import ClusterDispatcher as RefDispatcher

    for mode in ("auto", "bras", "slices"):
        assert ClusterDispatcher(mode=mode).mode == RefDispatcher(mode=mode).mode
    for cls in (ClusterDispatcher, RefDispatcher):
        with pytest.raises(ValueError, match="unknown dispatch mode"):
            cls(mode="rows")

    class Bound:
        sliced = object()

    class Unsliced:
        sliced = None

    for mode, bound, want in (("auto", Bound, "slices"), ("auto", Unsliced, "bras"),
                              ("bras", Bound, "bras"), ("slices", Unsliced, "slices")):
        got = ClusterDispatcher(mode=mode)._resolve(Bound() if bound is Bound else Unsliced())
        ref = RefDispatcher(mode=mode)._resolve(Bound() if bound is Bound else Unsliced())
        assert got == ref == want
    assert ClusterDispatcher(stale_after_s=0.5).stale_after_s == 0.5

