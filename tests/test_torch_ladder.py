"""The port's calibrated kernel ladder, its step spans and the planner's
cost-model arguments against the JAX package's, on the CPU.

- The ladder's rules (``_chain_pays``, ``_strassen_saving_s``,
  ``_fused_transpose_saving_s``, ``chain_flop_ceiling``,
  ``plan_precision_modes``) and whole policies (``plan_kernel_steps``:
  modes, chains and precision rungs) equal the reference's for a grid of
  fitted constants (flops/s x launch overhead x bytes/s, and no model) on
  the programs of a 16-qubit random circuit, ``peps(3, 3, 2, 16, 0)``,
  ``sycamore_circuit(20, 6, rng 7)`` and its chunks, and synthetic step
  lists under which every rung is chosen (chain, strassen,
  fused_transpose, gauss and ``high``, and the rule that never stacks an
  automatic ``high`` on a Strassen step).
- With tracing and step time on, ``TorchBackend.execute`` records one
  ``torch`` span per launch unit, with the reference's names and
  arguments; a fresh backend plans from them, once, the policy the
  reference plans from the same samples. The numpy oracle records spans
  whenever tracing is on, as the reference's does.
- A calibrated policy that promotes chains (a random circuit) or
  ``fused_transpose`` (a PEPS norm) gives the reference's result under the
  same policy (``jit_program`` with Pallas in interpret mode) within 1e-4
  relative, and the complex128 oracle's.
- With tracing off the policies are the no-model ones; the chunked
  executor and the per-slice loop plan without a model even when the
  registry holds samples.
- ``CalibratedObjective``, ``SizeObjective`` and ``resolve_objective``
  price as the reference does, and ``slice_and_reconfigure(cost_model=)``
  and ``Hyperoptimizer(objective=CalibratedObjective(m))`` plan the
  reference's plan on a 20-qubit Sycamore network with the clock budgets
  off.
"""

import collections
import functools
import importlib
import itertools
import math

import numpy as np
import pytest

import tnc_tpu.contractionpath.contraction_cost as ref_cost
import tnc_tpu.contractionpath.paths.hyper as ref_hyper
import tnc_tpu.contractionpath.slicing as ref_slicing
import tnc_tpu.obs.calibrate as ref_cal
import tnc_tpu.obs.core as ref_core
import tnc_tpu.ops.chunked as ref_chunked
import tnc_tpu.ops.program as ref_prog
import tnc_tpu.ops.split_complex as ref_sc
import tnc_tpu_torch.contractionpath.contraction_cost as port_cost
import tnc_tpu_torch.contractionpath.paths.hyper as port_hyper
import tnc_tpu_torch.contractionpath.slicing as port_slicing
import tnc_tpu_torch.obs.calibrate as port_cal
import tnc_tpu_torch.obs.core as port_core
import tnc_tpu_torch.ops.chunked as port_chunked
import tnc_tpu_torch.ops.program as port_prog
import tnc_tpu_torch.ops.split_complex as port_sc
from tnc_tpu.builders.connectivity import ConnectivityLayout as RefLayout
from tnc_tpu.builders.peps import peps as ref_peps
from tnc_tpu.builders.sycamore_circuit import sycamore_circuit as ref_sycamore
from tnc_tpu.contractionpath.contraction_path import ContractionPath as RefPath
from tnc_tpu.contractionpath.paths import Greedy as RefGreedy
from tnc_tpu.contractionpath.paths import OptMethod as RefOptMethod
from tnc_tpu.contractionpath.paths.greedy import _ssa_greedy as ref_ssa_greedy
from tnc_tpu.ops.backends import JaxBackend, jit_program
from tnc_tpu.ops.backends import NumpyBackend as RefNumpyBackend
from tnc_tpu.ops.backends import place_buffers as ref_place_buffers
from tnc_tpu.tensornetwork.approximate import attach_random_data as ref_attach
from tnc_tpu.tensornetwork.simplify import simplify_network as ref_simplify
from tnc_tpu.tensornetwork.tensor import CompositeTensor as RefComposite
from tnc_tpu.tensornetwork.tensor import LeafTensor as RefLeaf
from tnc_tpu_torch import obs
from tnc_tpu_torch.builders.connectivity import ConnectivityLayout
from tnc_tpu_torch.builders.peps import peps as port_peps
from tnc_tpu_torch.builders.sycamore_circuit import sycamore_circuit
from tnc_tpu_torch.contractionpath.contraction_path import (
    ContractionPath,
    ssa_replace_ordering,
)
from tnc_tpu_torch.contractionpath.paths import Greedy, OptMethod
from tnc_tpu_torch.contractionpath.paths.greedy import _ssa_greedy
from tnc_tpu_torch.ops.backends import NumpyBackend, TorchBackend, run_steps_timed
from tnc_tpu_torch.tensornetwork.approximate import attach_random_data, unit_scale
from tnc_tpu_torch.tensornetwork.contraction import contract_tensor_network_sliced
from tnc_tpu_torch.tensornetwork.simplify import simplify_network
from tnc_tpu_torch.tensornetwork.tensor import CompositeTensor, LeafTensor
from tests._torch_sliced_cases import SMALL, _both

ref_rc = importlib.import_module("tnc_tpu.builders.random_circuit")
port_rc = importlib.import_module("tnc_tpu_torch.builders.random_circuit")

#: a grid of fitted constants: flops/s x launch overhead (s) x bytes/s
GRID = list(itertools.product([1e10, 1e12, 5e13], [0.0, 1e-5, 1e-3],
                              [None, 1e9, 1e11, 3e12]))


def _models(constants):
    """The same constants as both packages' cost models (``None``: none)."""
    if constants is None:
        return None, None
    return port_cal.CalibratedCostModel(*constants), ref_cal.CalibratedCostModel(*constants)


@pytest.fixture
def registry(monkeypatch):
    """A fresh span registry, recording off, restored after the test; the
    reference's too."""
    for module in (port_core, ref_core):
        for name in ("_ENABLED", "_STEP_TIME", "_REGISTRY"):
            monkeypatch.setattr(module, name, getattr(module, name))
    monkeypatch.delenv("TNC_TPU_COMPLEX_MULT", raising=False)
    monkeypatch.delenv("TNC_TPU_DOT_PRECISION", raising=False)
    ref_core.configure(enabled=False, registry=ref_core.MetricsRegistry(), step_time=False)
    return obs.configure(enabled=False, registry=obs.MetricsRegistry(), step_time=False)


# -- programs ---------------------------------------------------------------------


def _circuit(qubits, seed=42):
    """The port's and the reference's programs of one random circuit, each
    package building, planning and compiling on its own."""
    out = []
    for rc, layout, greedy, opt, prog in (
        (port_rc, ConnectivityLayout, Greedy, OptMethod, port_prog),
        (ref_rc, RefLayout, RefGreedy, RefOptMethod, ref_prog),
    ):
        tn = rc.random_circuit(qubits, 12, 0.4, 0.4, np.random.default_rng(seed),
                               layout.SYCAMORE, bitstring="*" * qubits)
        path = greedy(opt.GREEDY).find_path(tn).replace_path()
        out.append((tn, path, prog.build_program(tn, path)))
    return out


def _peps(args):
    out = []
    for build, greedy, opt, prog in ((port_peps, Greedy, OptMethod, port_prog),
                                     (ref_peps, RefGreedy, RefOptMethod, ref_prog)):
        tn = build(*args)
        path = greedy(opt.GREEDY).find_path(tn).replace_path()
        out.append((tn, path, prog.build_program(tn, path)))
    return out


def _synthetic(dims):
    """Both packages' programs of a chain of matrices ``(d0, d1) @ (d1, d2)
    @ ...`` contracted left to right (metadata only)."""
    out = []
    for leaf, composite, path_cls, prog in (
        (LeafTensor, CompositeTensor, ContractionPath, port_prog),
        (RefLeaf, RefComposite, RefPath, ref_prog),
    ):
        tn = composite([leaf([i, i + 1], [a, b]) for i, (a, b) in enumerate(zip(dims, dims[1:]))])
        path = path_cls.simple([(0, i) for i in range(1, len(dims) - 1)])
        out.append(prog.build_program(tn, path))
    return out


@functools.lru_cache(maxsize=None)
def _step_lists():
    """``name -> (port steps, reference steps)`` of every ladder case (the
    names are :data:`STEP_LIST_NAMES`)."""
    lists = {}
    (_, _, p16), (_, _, r16) = _circuit(16)
    lists["random16"] = (p16.steps, r16.steps)
    (_, _, pp), (_, _, rp) = _peps((3, 3, 2, 16, 0))
    lists["peps33_b16"] = (pp.steps, rp.steps)
    both = _both(SMALL)
    port_sp, ref_sp = both["port"]["sp"], both["ref"]["sp"]
    lists["sycamore20_m6"] = (port_sp.program.steps, ref_sp.program.steps)
    port_chunks = port_chunked.split_program(port_sp.program, 16)
    ref_chunks = ref_chunked.split_program(ref_sp.program, 16)
    assert len(port_chunks) == len(ref_chunks) == 2
    for i, (pc, rc) in enumerate(zip(port_chunks, ref_chunks)):
        lists[f"sycamore20_m6 chunk {i}"] = (pc.steps, rc.steps)
    # a stem (2048^3, Strassen-eligible) between two small-step runs
    port_syn, ref_syn = _synthetic([2, 4, 8, 2048, 2048, 2048, 4, 2, 2])
    lists["synthetic stem"] = (port_syn.steps, ref_syn.steps)
    # one stem whose rung (strassen, or gauss with `high`) depends on bytes/s
    port_one, ref_one = _synthetic([2048, 2048, 2048])
    lists["synthetic single stem"] = (port_one.steps, ref_one.steps)
    assert list(lists) == STEP_LIST_NAMES
    return lists


STEP_LIST_NAMES = ["random16", "peps33_b16", "sycamore20_m6", "sycamore20_m6 chunk 0",
                   "sycamore20_m6 chunk 1", "synthetic stem", "synthetic single stem"]


def _same_policy(port, ref) -> None:
    assert port.signature() == ref.signature()
    assert port.dispatch_count() == ref.dispatch_count()


# -- the ladder's rules and policies ---------------------------------------------------


@pytest.mark.parametrize("name", STEP_LIST_NAMES)
def test_ladder_rules_match_reference(name, registry):
    port_steps, ref_steps = _step_lists()[name]
    for constants in [None] + GRID:
        pm, rm = _models(constants)
        assert port_sc.chain_flop_ceiling(pm) == ref_sc.chain_flop_ceiling(rm)
        for budget in (1e-5, 1e-6, 1e-3):
            assert port_sc.plan_precision_modes(port_steps, pm, None, budget) == (
                ref_sc.plan_precision_modes(ref_steps, rm, None, budget))
        ceiling = port_sc.chain_flop_ceiling(pm)
        for s, e in port_prog.chain_groups(port_steps, max_flops=ceiling):
            assert port_sc._chain_pays(pm, port_steps[s:e]) == ref_sc._chain_pays(
                rm, ref_steps[s:e])
        for ps, rs in zip(port_steps, ref_steps):
            dims = port_prog.step_dims(ps)
            assert dims == ref_prog.step_dims(rs)
            assert port_sc._strassen_saving_s(pm, *dims) == ref_sc._strassen_saving_s(rm, *dims)
            assert port_sc._fused_transpose_saving_s(pm, ps) == (
                ref_sc._fused_transpose_saving_s(rm, rs))


@pytest.mark.parametrize("name", STEP_LIST_NAMES)
def test_plan_kernel_steps_matches_reference(name, registry):
    port_steps, ref_steps = _step_lists()[name]
    for constants in [None] + GRID:
        pm, rm = _models(constants)
        _same_policy(port_sc.plan_kernel_steps(port_steps, pm),
                     ref_sc.plan_kernel_steps(ref_steps, rm))
        for ceiling in (2.0 ** 18, 2.0 ** 30):
            _same_policy(port_sc.plan_kernel_steps(port_steps, pm, chain_max_flops=ceiling),
                         ref_sc.plan_kernel_steps(ref_steps, rm, chain_max_flops=ceiling))


@pytest.mark.parametrize("force", ["chain", "strassen", "gauss", "fused_transpose"])
def test_forced_rungs_under_a_model_match_reference(force, registry):
    for name in ("random16", "synthetic stem", "synthetic single stem"):
        port_steps, ref_steps = _step_lists()[name]
        for constants in GRID[::5]:
            pm, rm = _models(constants)
            _same_policy(port_sc.plan_kernel_steps(port_steps, pm, force),
                         ref_sc.plan_kernel_steps(ref_steps, rm, force))


def test_plan_kernels_passes_the_chain_ceiling_through(registry):
    (_, _, port), (_, _, ref) = _circuit(16)
    pm, rm = _models((1e12, 1e-3, 1e11))
    for ceiling in (None, 2.0 ** 16, 2.0 ** 26):
        got = port_sc.plan_kernels(port, pm, None, ceiling)
        _same_policy(got, ref_sc.plan_kernels(ref, rm, None, ceiling))
        _same_policy(got, port_sc.plan_kernel_steps(port.steps, pm, None, ceiling))


def test_every_rung_is_chosen_somewhere(registry):
    """Across the grid and the step lists the calibrated ladder picks
    every rung, and each pick is the reference's (the cases above)."""
    seen = collections.Counter()
    for port_steps, _ in _step_lists().values():
        for constants in GRID:
            policy = port_sc.plan_kernel_steps(port_steps, _models(constants)[0])
            seen.update(set(policy.modes))
            seen["chain"] += bool(policy.chains)
            seen["high"] += "high" in policy.precision_modes
    for rung in ("chain", "strassen", "fused_transpose", "gauss", "high"):
        assert seen[rung], rung


def test_high_rung_is_never_stacked_on_strassen(registry):
    """One 2048^3 stem: under a bandwidth where Strassen loses it runs gauss
    with the automatic ``high`` rung; where Strassen wins it runs strassen
    and the rung is dropped, though the precision plan alone promotes it.
    A forced ``TNC_TPU_DOT_PRECISION`` stays on every step."""
    port_steps, ref_steps = _step_lists()["synthetic single stem"]
    flops_per_s = 1e12
    window = port_sc.plan_kernel_steps(port_steps, port_cal.CalibratedCostModel(
        flops_per_s, 0.0, 100.0 * flops_per_s / 2048))
    assert window.signature() == (("gauss",), (), ("high",))
    fast = port_cal.CalibratedCostModel(flops_per_s, 0.0, 1000.0 * flops_per_s / 2048)
    wins = port_sc.plan_kernel_steps(port_steps, fast)
    assert wins.signature() == (("strassen",), (), ())
    assert port_sc.plan_precision_modes(port_steps, fast) == ("high",)
    ref_fast = ref_cal.CalibratedCostModel(flops_per_s, 0.0, 1000.0 * flops_per_s / 2048)
    _same_policy(wins, ref_sc.plan_kernel_steps(ref_steps, ref_fast))
    forced = port_sc.plan_kernel_steps(port_steps, fast, precision_force="high")
    assert forced.signature() == (("strassen",), (), ("high",))
    _same_policy(forced, ref_sc.plan_kernel_steps(ref_steps, ref_fast, precision_force="high"))


# -- step spans and the calibrated backend ------------------------------------------------------


def _arrays(prog_mod, tn):
    return [leaf.data.into_data() for leaf in prog_mod.flat_leaf_tensors(tn)]


def _span_args(records, executor):
    return [(r.name, {k: v for k, v in r.args.items() if k != "executor"})
            for r in records if r.args.get("executor") == executor]


def test_step_spans_match_the_reference_and_calibrate_the_policy(registry):
    """With tracing and step time on, the port's split executor records one
    ``torch`` span per launch unit, named and argued as the reference's
    eager ``JaxBackend`` names and argues them; a fresh backend plans
    ``plan_kernels(program, cost_model=from_registry())`` once, and the same
    samples, renamed to ``jax``, give the reference the same policy."""
    (port_tn, _, port), (ref_tn, _, ref) = _circuit(12)
    obs.configure(enabled=True, step_time=True)
    backend = TorchBackend(device="cpu", split_complex=True)
    got = backend.execute(port, _arrays(port_prog, port_tn))
    records = obs.get_registry().span_records()
    no_model = backend.kernel_policy(port)
    assert len(records) == no_model.dispatch_count() < len(port.steps)
    assert {r.args["executor"] for r in records} == {"torch"}

    ref_core.configure(enabled=True, step_time=True)
    want = JaxBackend(dtype="complex64", split_complex=True, precision="float32").execute(
        ref, _arrays(ref_prog, ref_tn))
    ref_records = ref_core.get_registry().span_records()
    assert _span_args(records, "torch") == _span_args(ref_records, "jax")
    assert np.max(np.abs(got - np.asarray(want))) <= 1e-5 * np.max(np.abs(want))

    fresh = TorchBackend(device="cpu", split_complex=True)
    policy = fresh.kernel_policy(port)
    model = port_cal.CalibratedCostModel.from_registry()
    assert model is not None
    _same_policy(policy, port_sc.plan_kernels(port, cost_model=model))
    # planned once: more samples leave the cached policy as it is
    fresh.execute(port, _arrays(port_prog, port_tn))
    assert fresh.kernel_policy(port) is policy

    renamed = [ref_cal.StepSample(s.name, s.flops, s.bytes, s.dur_s, "jax")
               for s in port_cal.step_samples(records)]
    ref_model = ref_cal.fit_device_model(ref_cal.aggregate_samples(renamed))
    _same_policy(policy, ref_sc.plan_kernels(
        ref, cost_model=ref_cal.CalibratedCostModel.from_device_model(ref_model)))


def test_native_complex_and_numpy_spans_match_the_reference(registry):
    """Native complex (``split_complex=False``) records one ``naive`` span a
    step under step time; the numpy oracle records its spans whenever
    tracing is on, as the reference's does, and none with
    ``step_spans=False``; the split executor without step time none."""
    (port_tn, _, port), (ref_tn, _, ref) = _circuit(10)
    port_arrays, ref_arrays = _arrays(port_prog, port_tn), _arrays(ref_prog, ref_tn)
    obs.configure(enabled=True)
    ref_core.configure(enabled=True)
    TorchBackend(device="cpu", split_complex=True).execute(port, port_arrays)
    assert obs.get_registry().span_records() == []
    NumpyBackend().execute(port, port_arrays)
    RefNumpyBackend().execute(ref, ref_arrays)
    numpy_spans = _span_args(obs.get_registry().span_records(), "numpy")
    assert len(numpy_spans) == len(port.steps)
    assert numpy_spans == _span_args(ref_core.get_registry().span_records(), "numpy")
    obs.reset()
    NumpyBackend().execute(port, port_arrays, step_spans=False)
    assert obs.get_registry().span_records() == []
    obs.configure(step_time=True)
    TorchBackend(device="cpu").execute(port, port_arrays)
    spans = obs.get_registry().span_records()
    assert [(r.name, r.args["mode"], r.args["bytes_in"]) for r in spans] == [
        (name, "naive", args["bytes_in"] / 2) for name, args in numpy_spans]


def test_run_steps_timed_records_are_unchanged_by_spans(registry):
    """The records ``chip_smoke.py`` reads are the same with tracing off and
    on, and the spans carry each record's label and predicted cost."""
    (port_tn, _, port), _ = _circuit(10)
    backend = TorchBackend(device="cpu", split_complex=True)
    policy = backend.kernel_policy(port)
    placed = backend._device_buffers(_arrays(port_prog, port_tn))
    _, off = run_steps_timed(port, list(placed), policy)
    assert obs.get_registry().span_records() == []
    obs.configure(enabled=True)
    _, on = run_steps_timed(port, list(placed), policy, sync=True)
    spans = obs.get_registry().span_records()
    keys = ("label", "mode", "flops", "bytes_in", "bytes_out")
    assert [{k: r[k] for k in keys} for r in off] == [{k: r[k] for k in keys} for r in on]
    assert [(s.name, s.args["mode"], s.args["flops"], s.args["bytes_in"], s.args["bytes_out"])
            for s in spans] == [tuple(r[k] for k in keys) for r in on]
    assert all(r["ms"] >= 0.0 and r["host_ms"] >= 0.0 for r in on)


def _fill_registry(constants, port_registry, seed=3):
    """Step spans of executor ``torch`` whose fit gives ``constants``
    (flops/s, launch s, bytes/s); returns the same records for the
    reference (executor ``jax``)."""
    flops_per_s, dispatch_s, bytes_per_s = constants
    rng = np.random.default_rng(seed)
    port_recs, ref_recs = [], []
    for i in range(32):
        flops, nbytes = float(rng.uniform(1e6, 1e10)), float(rng.uniform(1e5, 1e9))
        dur = flops / flops_per_s + nbytes / bytes_per_s + dispatch_s
        for module, recs, executor in ((port_core, port_recs, "torch"),
                                       (ref_core, ref_recs, "jax")):
            recs.append(module.SpanRecord(
                f"step[{i}] synthetic", 0, int(round(dur * 1e9)), 1, 1, "main", 0,
                {"executor": executor, "flops": flops, "bytes_in": nbytes, "bytes_out": 0.0}))
    port_registry._spans.extend(port_recs)
    return ref_recs


class _Records:
    def __init__(self, records):
        self._records = records

    def span_records(self, include_open=False):
        return list(self._records)


def _peps_pair(args):
    tn = port_peps(*args)
    scale = unit_scale(tn)
    attach_random_data(tn, np.random.default_rng(42), scale=scale)
    ref_tn = ref_attach(ref_peps(*args), np.random.default_rng(42), scale=scale)
    path = Greedy(OptMethod.GREEDY).find_path(tn).replace_path()
    ref_path = RefGreedy(RefOptMethod.GREEDY).find_path(ref_tn).replace_path()
    return (tn, path, port_prog.build_program(tn, path)), (
        ref_tn, ref_path, ref_prog.build_program(ref_tn, ref_path))


CALIBRATED_CASES = {
    # launch-bound: the ceiling rises and one more chain forms than without
    # a model
    "random16 chains": ((1e12, 1e-3, 1e11), lambda: _circuit(16)),
    # bandwidth-bound: both transpose steps the gate admits are promoted
    "peps33_b16 fused_transpose": ((1e12, 1e-5, 1e9), lambda: _peps_pair((3, 3, 2, 16, 0))),
}


@pytest.mark.parametrize("case", list(CALIBRATED_CASES))
def test_calibrated_policy_result_matches_reference(case, registry):
    constants, build = CALIBRATED_CASES[case]
    (port_tn, _, port), (ref_tn, _, ref) = build()
    ref_recs = _fill_registry(constants, registry)
    backend = TorchBackend(device="cpu", split_complex=True)
    policy = backend.kernel_policy(port)
    ref_model = ref_cal.CalibratedCostModel.from_registry(_Records(ref_recs))
    ref_policy = ref_sc.plan_kernels(ref, cost_model=ref_model)
    _same_policy(policy, ref_policy)
    no_model = port_sc.plan_kernels(port)
    if "chains" in case:
        assert len(policy.chains) > len(no_model.chains)
    else:
        assert policy.modes.count("fused_transpose") == 2
        assert "fused_transpose" not in no_model.modes

    port_sc.reset_routed()
    got = backend.execute(port, _arrays(port_prog, port_tn))
    assert port_sc.FUSED_TRANSPOSE_ROUTED == {}
    buffers = ref_place_buffers(_arrays(ref_prog, ref_tn), "complex64", True)
    fn = jit_program(ref, True, "float32", donate=False, policy=ref_policy)
    want = np.asarray(ref_sc.combine_array(*fn(buffers))).reshape(ref.result_shape)
    oracle = NumpyBackend().execute(port, _arrays(port_prog, port_tn))
    scale = float(np.max(np.abs(oracle)))
    assert float(np.max(np.abs(got - want))) <= 1e-4 * scale
    assert float(np.max(np.abs(got - oracle))) <= 1e-4 * scale


def test_tracing_off_keeps_every_policy(registry):
    """No samples: the backend's policy is the no-model ladder, the
    reference's too, and nothing is recorded."""
    (port_tn, _, port), (_, _, ref) = _circuit(16)
    backend = TorchBackend(device="cpu", split_complex=True)
    policy = backend.kernel_policy(port)
    _same_policy(policy, port_sc.plan_kernels(port))
    _same_policy(policy, ref_sc.plan_kernels(ref))
    backend.execute(port, _arrays(port_prog, port_tn))
    assert obs.get_registry().span_records() == []
    assert port_cal.CalibratedCostModel.from_registry() is None


@pytest.mark.parametrize("strategy", ["chunked", "loop"])
def test_sliced_executors_plan_without_a_model(strategy, registry, monkeypatch):
    """The registry holds samples of a launch-bound model, yet the chunked
    executor and the per-slice loop plan every policy without one, as the
    reference's do; their sum matches the oracle's."""
    _fill_registry((1e12, 1e-3, 1e11), registry)
    assert port_cal.CalibratedCostModel.from_registry() is not None
    seen = []
    real = port_sc.plan_kernel_steps

    def spy(steps, cost_model=None, *args, **kwargs):
        seen.append(cost_model)
        return real(steps, cost_model, *args, **kwargs)

    monkeypatch.setattr(port_sc, "plan_kernel_steps", spy)
    cell = _both(SMALL)["port"]
    backend = TorchBackend(device="cpu", split_complex=True, sliced_strategy=strategy,
                           slice_batch=2, chunk_steps=8)
    got = contract_tensor_network_sliced(cell["tn"], cell["path"], cell["slicing"], backend)
    want = contract_tensor_network_sliced(cell["tn"], cell["path"], cell["slicing"],
                                          NumpyBackend())
    assert seen and all(m is None for m in seen)
    g, w = complex(got.data.into_data()), complex(want.data.into_data())
    assert abs(g - w) <= 1e-5 * abs(w)


# -- the planner's objectives and cost-model arguments -------------------------------------------


def _sycamore20(depth=8, seed=7):
    out = []
    for build, simplify, ssa in ((sycamore_circuit, simplify_network, _ssa_greedy),
                                 (ref_sycamore, ref_simplify, ref_ssa_greedy)):
        tn, _ = build(20, depth, np.random.default_rng(seed)).into_amplitude_network("0" * 20)
        tn = simplify(tn)
        out.append((tn, list(tn.tensors), ssa(list(tn.tensors))))
    assert out[0][2] == out[1][2]
    return out


MODEL_CONSTANTS = [(1e12, 2e-5, None), (3e11, 1e-3, 5e10)]


@pytest.mark.parametrize("constants", MODEL_CONSTANTS)
def test_objectives_match_reference(constants):
    (_, port_in, ssa), (_, ref_in, _) = _sycamore20(6)
    pm, rm = _models(constants)
    replace = ssa_replace_ordering(ContractionPath.simple(list(ssa))).toplevel
    port_path, ref_path = ContractionPath.simple(replace), RefPath.simple(replace)
    for port_obj, ref_obj in ((port_cost.CalibratedObjective(pm),
                               ref_cost.CalibratedObjective(rm)),
                              (port_cost.CalibratedObjective(pm, bytes_per_elem=8.0),
                               ref_cost.CalibratedObjective(rm, bytes_per_elem=8.0)),
                              (port_cost.SizeObjective(), ref_cost.SizeObjective()),
                              (port_cost.resolve_objective("size"),
                               ref_cost.resolve_objective("size")),
                              (port_cost.resolve_objective(None),
                               ref_cost.resolve_objective(None))):
        assert port_obj.name == ref_obj.name
        for (i, j) in replace[:20]:
            assert port_obj.pair_cost(port_in[i], port_in[j]) == ref_obj.pair_cost(
                ref_in[i], ref_in[j])
        assert port_obj.path_cost(port_in, port_path) == ref_obj.path_cost(ref_in, ref_path)
        assert port_obj.ssa_path_cost(port_in, ssa) == ref_obj.ssa_path_cost(ref_in, ssa)
        sl = port_slicing.find_slicing(port_in, replace, 2.0 ** 10)
        ref_sl = ref_slicing.Slicing(sl.legs, sl.dims)
        assert port_obj.sliced_path_cost(port_in, replace, sl) == ref_obj.sliced_path_cost(
            ref_in, replace, ref_sl)
    obj = port_cost.CalibratedObjective(pm)
    assert port_cost.resolve_objective(obj) is obj
    assert port_cost.contract_size_tensors_bytes(port_in[0], port_in[1]) == (
        ref_cost.contract_size_tensors_bytes(ref_in[0], ref_in[1]))
    with pytest.raises(ValueError):
        port_cost.resolve_objective("seconds")
    with pytest.raises(ValueError):
        port_cost.CalibratedObjective(None)


@pytest.mark.parametrize("constants", MODEL_CONSTANTS)
def test_stem_accountant_prices_seconds_as_the_reference(constants):
    (_, port_in, ssa), (_, ref_in, _) = _sycamore20(6)
    replace = ssa_replace_ordering(ContractionPath.simple(list(ssa))).toplevel
    pm, rm = _models(constants)
    port = port_slicing.StemAccountant(port_in, replace, cost_model=pm)
    ref = ref_slicing.StemAccountant(ref_in, replace, cost_model=rm)
    legs = sorted({leg for t in port_in for leg in t.legs})
    for removed in (set(), set(legs[::9]), set(legs[2::5])):
        per_slice = port_slicing._make_replayer(port_in, replace).flops(removed)
        for slices in (1, 16):
            assert port.hoisted_cost(removed, per_slice, slices) == ref.hoisted_cost(
                removed, per_slice, slices)


NO_BUDGET = dict(reconf_rounds=1, step_budget=None, final_rounds=2, final_budget=None)


@pytest.mark.parametrize("constants", MODEL_CONSTANTS)
def test_slice_and_reconfigure_with_a_model_matches_reference(constants):
    (_, port_in, ssa), (_, ref_in, _) = _sycamore20()
    pm, rm = _models(constants)
    got = port_slicing.slice_and_reconfigure(port_in, ssa, 2.0 ** 14, cost_model=pm,
                                             **NO_BUDGET)
    want = ref_slicing.slice_and_reconfigure(ref_in, ssa, 2.0 ** 14, cost_model=rm,
                                             **NO_BUDGET)
    assert got[0] == want[0]
    assert (got[1].legs, got[1].dims) == (want[1].legs, want[1].dims)
    assert got[1].num_slices > 1


def test_hyperoptimizer_with_a_calibrated_objective_matches_reference(monkeypatch):
    """Joint slicing on: every trial's slice set, the joint search and the
    classic repair price in seconds under the objective's model."""
    monkeypatch.setenv("TNC_TPU_HYPER_WORKERS", "1")
    (port_tn, _, _), (ref_tn, _, _) = _sycamore20(6)
    pm, rm = _models((3e11, 1e-3, 5e10))
    opts = dict(ntrials=3, seed=42, target_size=2.0 ** 10, polish_rounds=1,
                polish_steps=300, reconfigure_budget=None, joint_slicing=True,
                joint_sa_steps=200, joint_sa_rounds=1)
    a = port_hyper.Hyperoptimizer(objective=port_cost.CalibratedObjective(pm), **opts)
    b = ref_hyper.Hyperoptimizer(objective=ref_cost.CalibratedObjective(rm), **opts)
    got, want = a.find_path(port_tn), b.find_path(ref_tn)
    assert got.ssa_path.toplevel == want.ssa_path.toplevel
    assert (got.flops, got.size) == (want.flops, want.size)
    assert (a.last_slicing is None) == (b.last_slicing is None)
    if a.last_slicing is not None:
        assert (a.last_slicing.legs, a.last_slicing.dims) == (
            b.last_slicing.legs, b.last_slicing.dims)
    assert math.isfinite(got.flops)
