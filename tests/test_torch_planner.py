"""The port's planner against the JAX package's, on the CPU.

``tnc_tpu_torch`` keeps its own copies of the planner of BASELINE config
#3: the hypergraph and its multilevel partitioner (Python and the native
C++ engines, whose sources are the reference's byte for byte), the
contraction tree and its subtree reconfiguration, the tree refiners, the
incremental sliced-cost evaluator, ``slice_and_reconfigure`` and the
``Hyperoptimizer``. Every case feeds both packages the same network from
the same seed and compares their results exactly, with every wall-clock
budget off (a budget stops a search by the clock, so only budget-free
runs are reproducible). The planner modules import no ``torch``.
"""

import ast
import importlib
import pathlib
import random
import subprocess
import sys

import numpy as np
import pytest

import tnc_tpu.contractionpath.contraction_tree as ref_tree
import tnc_tpu.contractionpath.paths.hyper as ref_hyper
import tnc_tpu.contractionpath.paths.tree_refine as ref_refine
import tnc_tpu.contractionpath.sliced_cost as ref_sliced_cost
import tnc_tpu.contractionpath.slicing as ref_slicing
import tnc_tpu.partitioning.hypergraph as ref_hypergraph
import tnc_tpu.partitioning.native_binding as ref_native
import tnc_tpu_torch.contractionpath.contraction_tree as port_tree
import tnc_tpu_torch.contractionpath.paths.hyper as port_hyper
import tnc_tpu_torch.contractionpath.paths.tree_refine as port_refine
import tnc_tpu_torch.contractionpath.sliced_cost as port_sliced_cost
import tnc_tpu_torch.contractionpath.slicing as port_slicing
import tnc_tpu_torch.partitioning.hypergraph as port_hypergraph
import tnc_tpu_torch.partitioning.native_binding as port_native
from tnc_tpu.builders.connectivity import ConnectivityLayout as RefLayout
from tnc_tpu.builders.random_circuit import random_circuit as ref_random_circuit
from tnc_tpu.contractionpath.paths.greedy import _ssa_greedy as ref_ssa_greedy
from tnc_tpu_torch.benchmark import northstar
from tnc_tpu_torch.builders.connectivity import ConnectivityLayout
from tnc_tpu_torch.builders.random_circuit import random_circuit
from tnc_tpu_torch.contractionpath.contraction_path import (
    ContractionPath,
    ssa_replace_ordering,
)
from tnc_tpu_torch.contractionpath.paths.greedy import _ssa_greedy

# the partitioning packages export a function named ``bisect`` that hides
# the module of that name from ``import ... as``
ref_bisect = importlib.import_module("tnc_tpu.partitioning.bisect")
port_bisect = importlib.import_module("tnc_tpu_torch.partitioning.bisect")

REPO = pathlib.Path(__file__).resolve().parents[1]
PLANNER_MODULES = [
    "tnc_tpu_torch.partitioning.hypergraph",
    "tnc_tpu_torch.partitioning.bisect",
    "tnc_tpu_torch.partitioning.native_binding",
    "tnc_tpu_torch.contractionpath.contraction_tree",
    "tnc_tpu_torch.contractionpath.paths.tree_refine",
    "tnc_tpu_torch.contractionpath.sliced_cost",
    "tnc_tpu_torch.contractionpath.slicing",
    "tnc_tpu_torch.contractionpath.paths.hyper",
    "tnc_tpu_torch.benchmark.northstar",
    "tnc_tpu_torch.contractionpath.paths.optimal",
    "tnc_tpu_torch.contractionpath.paths.branchbound",
    "tnc_tpu_torch.contractionpath.communication_schemes",
    "tnc_tpu_torch.tensornetwork.partitioning",
    "tnc_tpu_torch.contractionpath.repartitioning.__init__",
    "tnc_tpu_torch.contractionpath.repartitioning.simulated_annealing",
    "tnc_tpu_torch.contractionpath.repartitioning.genetic",
    "tnc_tpu_torch.contractionpath.balancing",
    "tnc_tpu_torch.contractionpath.treecut",
]
ENGINES = ["native", "python"]
NO_BUDGET = dict(reconf_rounds=1, step_budget=None, final_rounds=2, final_budget=None)


@pytest.fixture(params=ENGINES)
def engine(request, monkeypatch):
    """Both packages on their native engines, or both on Python."""
    if request.param == "python":
        monkeypatch.setenv("TNC_TPU_NO_NATIVE", "1")
    else:
        monkeypatch.delenv("TNC_TPU_NO_NATIVE", raising=False)
        assert port_native.load_native() is not None, port_native.NATIVE
        assert ref_native.load_native() is not None
    return request.param


def _circuits(qubits=16, depth=8, seed=21):
    """The same Sycamore-layout random amplitude circuit in both packages
    (as ``tests/test_paths.py`` builds it)."""
    port = random_circuit(qubits, depth, 0.4, 0.4, np.random.default_rng(seed),
                          ConnectivityLayout.SYCAMORE, bitstring="0" * qubits)
    ref = ref_random_circuit(qubits, depth, 0.4, 0.4, np.random.default_rng(seed),
                             RefLayout.SYCAMORE, bitstring="0" * qubits)
    return port, ref


# the pure-Python engines are ~1000x slower than the native ones: their
# cases take a smaller circuit
SIZES = {"native": (16, 8, 21), "python": (10, 6, 21)}
# slicing targets (log2 elements) below each circuit's unsliced peak
TARGETS = {"native": (8, 10), "python": (5, 6)}
# subtree sizes the exact DP re-solves
SUBTREE = {"native": 12, "python": 6}


def _ssa_both(qubits=16, depth=8, seed=21):
    port, ref = _circuits(qubits, depth, seed)
    ssa = _ssa_greedy(list(port.tensors))
    assert ssa == ref_ssa_greedy(list(ref.tensors))
    return list(port.tensors), list(ref.tensors), ssa


def _replace(ssa):
    return ssa_replace_ordering(ContractionPath.simple(list(ssa))).toplevel


# -- the port stands alone ---------------------------------------------------


@pytest.mark.parametrize("name", ["partitioner.cpp", "treedp.cpp", "slicereplay.cpp"])
def test_native_sources_are_the_reference_bytes(name):
    port = REPO / "tnc_tpu_torch" / "partitioning" / "native" / name
    ref = REPO / "tnc_tpu" / "partitioning" / "native" / name
    assert port.read_bytes() == ref.read_bytes()


@pytest.mark.parametrize("module", PLANNER_MODULES)
def test_planner_module_imports_neither_torch_nor_the_reference(module):
    path = REPO / (module.replace(".", "/") + ".py")
    for node in ast.walk(ast.parse(path.read_text())):
        names = []
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        for name in names:
            top = name.split(".")[0]
            assert top not in ("torch", "jax", "tnc_tpu"), f"{module} imports {name}"


def test_planner_loads_without_torch():
    """A spawn worker of the trial pool re-imports the hyper module: it
    must not pull in torch."""
    code = ("import sys; import tnc_tpu_torch.contractionpath.paths.hyper, "
            "tnc_tpu_torch.benchmark.northstar; "
            "assert 'torch' not in sys.modules and 'jax' not in sys.modules")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True)


def test_native_build_stays_in_the_build_directory(engine):
    port_native.load_native()
    if engine == "python":
        assert port_native.NATIVE.startswith("python")
        return
    assert port_native.NATIVE == "native"
    build = REPO / "tnc_tpu_torch" / "partitioning" / "_build"
    assert port_native.NATIVE_PATH.parent == build
    assert port_native.NATIVE_PATH.name.startswith("_partitioner-")
    tracked = subprocess.run(
        ["git", "ls-files", "tnc_tpu_torch/partitioning"], cwd=REPO,
        capture_output=True, text=True).stdout.split()
    assert not [t for t in tracked if t.endswith(".so")]


def test_without_a_compiler_the_python_engines_run(monkeypatch, tmp_path):
    """No compiler: ``load_native`` answers None, ``NATIVE`` says why, and
    the planner's callers run their Python engines (same partition)."""
    monkeypatch.setattr(port_native, "_lib", None)
    monkeypatch.setattr(port_native, "_load_failed", None)
    monkeypatch.setattr(port_native, "_BUILD_DIR", tmp_path)
    monkeypatch.setenv("CXX", str(tmp_path / "no-such-compiler"))
    monkeypatch.delenv("TNC_TPU_NO_NATIVE", raising=False)
    assert port_native.load_native() is None
    assert port_native.NATIVE.startswith("python: no native library")
    port, ref = _circuits(*SIZES["python"])
    a = port_hypergraph.hypergraph_from_tensors(port.tensors)
    b = ref_hypergraph.hypergraph_from_tensors(ref.tensors)
    monkeypatch.setenv("TNC_TPU_NO_NATIVE", "1")  # the reference's Python engines
    assert port_bisect.partition_kway(a, 2, 0.1, random.Random(11)) == \
        ref_bisect.partition_kway(b, 2, 0.1, random.Random(11))
    assert not list(tmp_path.iterdir())


# -- hypergraph and partitioner ----------------------------------------------


def test_hypergraph_matches_reference():
    port, ref = _circuits()
    a = port_hypergraph.hypergraph_from_tensors(port.tensors)
    b = ref_hypergraph.hypergraph_from_tensors(ref.tensors)
    assert (a.num_vertices, a.vertex_weights, a.edge_pins, a.edge_weights) == (
        b.num_vertices, b.vertex_weights, b.edge_pins, b.edge_weights)
    part = [random.Random(5).randrange(3) for _ in range(a.num_vertices)]
    assert a.cut_weight(part) == b.cut_weight(part)
    assert a.km1_weight(part) == b.km1_weight(part)


@pytest.mark.parametrize("seed", [0, 3])
def test_bisect_matches_reference(seed):
    port, ref = _circuits()
    a = port_hypergraph.hypergraph_from_tensors(port.tensors)
    b = ref_hypergraph.hypergraph_from_tensors(ref.tensors)
    got = port_bisect.bisect(a, 0.1, random.Random(seed), coarsen_to=20)
    want = ref_bisect.bisect(b, 0.1, random.Random(seed), coarsen_to=20)
    assert got == want and set(got) == {0, 1}


@pytest.mark.parametrize("k,objective", [(2, "cut"), (4, "cut"), (4, "km1")])
def test_partition_kway_matches_reference(engine, k, objective):
    port, ref = _circuits(*SIZES[engine])
    a = port_hypergraph.hypergraph_from_tensors(port.tensors)
    b = ref_hypergraph.hypergraph_from_tensors(ref.tensors)
    got = port_bisect.partition_kway(a, k, 0.1, random.Random(11), objective)
    want = ref_bisect.partition_kway(b, k, 0.1, random.Random(11), objective)
    assert got == want
    assert set(got) == set(range(k))


def test_native_km1_refine_and_weight_match_reference_and_python():
    port, ref = _circuits()
    a = port_hypergraph.hypergraph_from_tensors(port.tensors)
    b = ref_hypergraph.hypergraph_from_tensors(ref.tensors)
    part = [v % 4 for v in range(a.num_vertices)]
    got = port_native.native_kway_refine_km1(a, part, 4, 0.2)
    assert got == ref_native.native_kway_refine_km1(b, part, 4, 0.2)
    assert port_native.native_km1_weight(a, got, 4) == a.km1_weight(got)
    assert port_native.native_km1_weight(a, [9] * a.num_vertices, 4) is None
    python = list(part)
    port_bisect.kway_refine_km1(a, python, 4, 0.2)
    assert a.km1_weight(got) <= a.km1_weight(part)
    assert a.km1_weight(python) <= a.km1_weight(part)


# -- contraction tree and refiners --------------------------------------------


def test_native_optimal_order_matches_python_dp(monkeypatch):
    port, _ = _circuits()
    tree = port_tree.ContractionTree.from_ssa_path(list(port.tensors),
                                                   _ssa_greedy(list(port.tensors)))
    top = max((i for i, nd in enumerate(tree.nodes) if not nd.is_leaf),
              key=tree.node_cost)
    legs = [tree.nodes[f].legs for f in tree._collect_frontier(top, 10)]
    for minimize in ("flops", "size"):
        native = port_native.native_optimal_order(legs, tree.dims, minimize)
        monkeypatch.setenv("TNC_TPU_NO_NATIVE", "1")
        python = tree._optimal_order(legs, minimize)
        monkeypatch.delenv("TNC_TPU_NO_NATIVE")
        assert native is not None and native[0] == python[0]


@pytest.mark.parametrize("minimize", ["flops", "size"])
def test_reconfigure_matches_reference(engine, minimize):
    port_in, ref_in, ssa = _ssa_both(*SIZES[engine])
    a = port_tree.ContractionTree.from_ssa_path(port_in, ssa)
    b = ref_tree.ContractionTree.from_ssa_path(ref_in, ssa)
    a.reconfigure(8, 4, minimize=minimize, time_budget=None)
    b.reconfigure(8, 4, minimize=minimize, time_budget=None)
    assert a.to_ssa_path() == b.to_ssa_path()
    assert a.total_cost() == b.total_cost()
    assert a.tree_weights() == b.tree_weights()
    if minimize == "flops":
        assert a.total_cost()[0] <= port_tree.ContractionTree.from_ssa_path(
            port_in, ssa).total_cost()[0]


@pytest.mark.parametrize("finder", ["TreeAnnealing", "TreeReconfigure", "TreeTempering"])
def test_tree_refiners_match_reference(finder):
    port, ref = _circuits(12, 6, 4)
    opts = {"TreeAnnealing": dict(iterations=10, seed=9),
            "TreeReconfigure": dict(subtree_size=8, max_rounds=3),
            "TreeTempering": dict(num_replicas=3, rounds=3, seed=9)}[finder]
    got = getattr(port_refine, finder)(**opts).find_path(port)
    want = getattr(ref_refine, finder)(**opts).find_path(ref)
    assert got.ssa_path.toplevel == want.ssa_path.toplevel
    assert (got.flops, got.size) == (want.flops, want.size)


# -- sliced cost and slicing --------------------------------------------------


def test_sliced_cost_evaluator_matches_reference(engine):
    port_in, ref_in, ssa = _ssa_both(*SIZES[engine])
    replace = _replace(ssa)
    a = port_sliced_cost.SlicedCostEvaluator(port_in, replace)
    b = ref_sliced_cost.SlicedCostEvaluator(ref_in, replace)
    target = 2.0 ** TARGETS[engine][0]
    port_sliced_cost.greedy_slice_to_target(a, target)
    ref_sliced_cost.greedy_slice_to_target(b, target)
    assert sorted(a.removed) == sorted(b.removed) and a.removed
    assert (a.cost(), a.peak(), a.per_slice_flops(), a.num_slices) == (
        b.cost(), b.peak(), b.per_slice_flops(), b.num_slices)
    assert a.hoist_split() == b.hoist_split()
    removed = set(a.removed)
    acct = port_slicing.StemAccountant(port_in, replace)
    per_slice = port_slicing._make_replayer(port_in, replace).flops(removed)
    assert acct.hoist_split(removed, per_slice) == a.hoist_split()
    sl = port_slicing.Slicing(tuple(sorted(removed)),
                              tuple(2 for _ in removed))
    assert port_slicing.hoisted_sliced_flops(port_in, replace, sl) == \
        ref_slicing.hoisted_sliced_flops(
            ref_in, replace, ref_slicing.Slicing(sl.legs, sl.dims))


@pytest.mark.parametrize("which", [0, 1])
def test_slice_and_reconfigure_matches_reference(engine, which):
    target_log2 = TARGETS[engine][which]
    port_in, ref_in, ssa = _ssa_both(*SIZES[engine])
    opts = dict(NO_BUDGET, subtree_size=SUBTREE[engine])
    got = port_slicing.slice_and_reconfigure(port_in, ssa, 2.0 ** target_log2, **opts)
    want = ref_slicing.slice_and_reconfigure(ref_in, ssa, 2.0 ** target_log2, **opts)
    assert got[0] == want[0]
    assert (got[1].legs, got[1].dims) == (want[1].legs, want[1].dims)
    assert port_slicing.sliced_peak(port_in, got[0], got[1]) <= 2.0 ** target_log2
    assert port_slicing.sliced_flops(port_in, got[0], got[1]) == ref_slicing.sliced_flops(
        ref_in, want[0], want[1])


def test_joint_slice_search_matches_reference():
    port_in, ref_in, ssa = _ssa_both()
    opts = dict(sa_steps=300, sa_rounds=1, seed=5)
    got = port_sliced_cost.joint_slice_search(port_in, ssa, 2.0 ** 9, **opts)
    want = ref_sliced_cost.joint_slice_search(ref_in, ssa, 2.0 ** 9, **opts)
    assert got[0] == want[0] and got[2] == want[2]
    assert (got[1].legs, got[1].dims) == (want[1].legs, want[1].dims)


def test_native_replayer_matches_python_replay():
    port_in, _, ssa = _ssa_both()
    replace = _replace(ssa)
    native = port_slicing._make_replayer(port_in, replace)
    python = port_slicing._PyReplayer(port_in, replace)
    assert isinstance(native, port_native.SlicedReplayer)
    legs = sorted({leg for t in port_in for leg in t.legs})
    for removed in (set(), set(legs[::7]), set(legs[3::5])):
        assert native.sizes(removed) == python.sizes(removed)
        assert native.flops(removed) == python.flops(removed)
        assert native.peak_and_flops(removed) == python.peak_and_flops(removed)
        assert native.peak(removed) == python.peak(removed)


# -- the hyper-optimizer ------------------------------------------------------


def _hyper(module):
    return module.Hyperoptimizer(
        ntrials=4, seed=42, target_size=2.0 ** 9, polish_rounds=1,
        polish_steps=400, reconfigure_budget=None, joint_slicing=True,
        joint_sa_steps=300, joint_sa_rounds=1)


def test_hyperoptimizer_matches_reference(monkeypatch):
    """Joint slicing on, on the native engines (the joint search re-solves
    12-node subtrees, which the Python DP takes minutes over)."""
    monkeypatch.setenv("TNC_TPU_HYPER_WORKERS", "1")
    port, ref = _circuits()
    a, b = _hyper(port_hyper), _hyper(ref_hyper)
    got, want = a.find_path(port), b.find_path(ref)
    assert got.ssa_path.toplevel == want.ssa_path.toplevel
    assert (got.flops, got.size) == (want.flops, want.size)
    assert a.last_slicing is not None
    assert (a.last_slicing.legs, a.last_slicing.dims) == (
        b.last_slicing.legs, b.last_slicing.dims)


def test_hyperoptimizer_without_slicing_matches_reference(engine, monkeypatch):
    monkeypatch.setenv("TNC_TPU_HYPER_WORKERS", "1")
    port, ref = _circuits(*SIZES[engine])
    opts = dict(ntrials=3, seed=7, polish_rounds=1, polish_steps=300,
                reconfigure_budget=None, reconfigure_size=SUBTREE[engine])
    got = port_hyper.Hyperoptimizer(**opts).find_path(port)
    want = ref_hyper.Hyperoptimizer(**opts).find_path(ref)
    assert got.ssa_path.toplevel == want.ssa_path.toplevel
    assert got.flops == want.flops


def test_hyper_pool_matches_serial_loop(monkeypatch):
    """Trial ``t`` draws from ``Random(seed + t)`` and results merge by
    trial index, so the spawn pool gives the serial loop's plan."""
    port, _ = _circuits()
    opts = dict(ntrials=6, seed=3, polish_rounds=0, reconfigure_rounds=1)
    monkeypatch.setenv("TNC_TPU_HYPER_WORKERS", "1")
    one = port_hyper.Hyperoptimizer(**opts)
    serial = one.find_path(port)
    monkeypatch.setenv("TNC_TPU_HYPER_WORKERS", "2")
    two = port_hyper.Hyperoptimizer(**opts)
    pooled = two.find_path(port)
    assert serial.ssa_path.toplevel == pooled.ssa_path.toplevel
    assert serial.flops == pooled.flops
    assert one.last_trials == {"mode": "serial", "workers": 1, "pool_error": None}
    assert two.last_trials in ({"mode": "pool", "workers": 2, "pool_error": None},
                               {"mode": "serial", "workers": 1,
                                "pool_error": two.last_trials["pool_error"]})


# -- the north-star plan and its cache ---------------------------------------

SMALL_PLAN = dict(
    hyper_options=dict(polish_rounds=1, polish_steps=400, reconfigure_budget=None,
                       joint_sa_steps=300, joint_sa_rounds=1),
    slice_options=dict(step_budget=None, final_budget=None),
)


def test_plan_cache_round_trips(tmp_path, monkeypatch):
    monkeypatch.setenv("TNC_TPU_HYPER_WORKERS", "1")
    made = northstar.plan_northstar(12, 6, 3, 2, 8.0, cache=True, cache_dir=tmp_path,
                                    **SMALL_PLAN)
    assert not made.record["cached"]
    assert made.record["slice_peak"] <= 2.0 ** 8
    kept = northstar.plan_northstar(12, 6, 3, 2, 8.0, cache=True, cache_dir=tmp_path,
                                    **SMALL_PLAN)
    assert kept.record["cached"]
    assert kept.path.toplevel == made.path.toplevel
    assert kept.slicing == made.slicing
    for key in ("slices", "sliced_total_flops", "path_flops", "sliced_legs"):
        assert kept.record[key] == made.record[key]
    # other options, or a path that does not contract the network, are not used
    other = dict(SMALL_PLAN, slice_options=dict(step_budget=None, final_budget=None,
                                                final_rounds=1))
    file = tmp_path / (northstar.northstar_plan_key(12, 6, 3, 2, 8.0) + ".json")
    assert northstar.load_plan(file, made.tn, {"hyper": SMALL_PLAN["hyper_options"],
                                               "slice": other["slice_options"]}) is None
    assert northstar.load_plan(file, northstar.northstar_network(12, 5, 3)[0]) is None


def test_plan_module_keeps_the_reference_key_fields():
    from tnc_tpu.benchmark.northstar import northstar_plan_key as ref_key

    port_key = northstar.northstar_plan_key(53, 14, 42, 128, 29.0)
    assert ref_key(53, 14, 42, 128, 29.0).endswith("hyper-target2^29")
    assert port_key.endswith("_hyper-target2^29")
    assert "sycamore-53-m14-seed42-trials128" in port_key


def test_doctests():
    import doctest

    for name in PLANNER_MODULES + ["tnc_tpu_torch.contractionpath.contraction_cost"]:
        result = doctest.testmod(importlib.import_module(name))
        assert result.failed == 0, name
