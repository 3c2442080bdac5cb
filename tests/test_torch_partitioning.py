"""The port's partitioned planner, part one, against the JAX package's on
the CPU: the new path helpers and fan-in costs, the exact and
branch-and-bound finders, the six communication schemes and the
hypergraph partitioning of a network.

``tnc_tpu_torch`` keeps its own copies of ``contraction_path.path`` /
``ssa_ordering`` / ``validate_path``, ``contraction_cost``'s
communication costs and ``compute_memory_requirements``,
``paths/optimal.py``, ``paths/branchbound.py``,
``communication_schemes.py`` and ``tensornetwork/partitioning.py``. Every
case feeds both packages the same network (built from the same numpy
seed) and the same ``random.Random`` seed, and compares the results
exactly: paths, fan-ins, assignments and costs are equal, not close.
Partitioning runs on both engines of the port's partitioner (native and
``TNC_TPU_NO_NATIVE=1``), each against the reference on the same engine.
"""

import doctest
import importlib
import random

import pytest

import tnc_tpu.contractionpath.communication_schemes as ref_schemes
import tnc_tpu.contractionpath.contraction_cost as ref_cost
import tnc_tpu.contractionpath.contraction_path as ref_cpath
import tnc_tpu.contractionpath.paths as ref_paths
import tnc_tpu.partitioning.native_binding as ref_native
import tnc_tpu.tensornetwork.partitioning as ref_part
import tnc_tpu_torch.contractionpath.communication_schemes as port_schemes
import tnc_tpu_torch.contractionpath.contraction_cost as port_cost
import tnc_tpu_torch.contractionpath.contraction_path as port_cpath
import tnc_tpu_torch.contractionpath.paths as port_paths
import tnc_tpu_torch.partitioning.native_binding as port_native
import tnc_tpu_torch.tensornetwork.partitioning as port_part
from _torch_partition_cases import (
    MODEL,
    RefComposite,
    circuits,
    path_obj,
    random_network,
    tensor_obj,
)
from tnc_tpu.obs.calibrate import CalibratedCostModel as RefModel
from tnc_tpu_torch.obs.calibrate import CalibratedCostModel
from tnc_tpu_torch.tensornetwork.tensor import CompositeTensor

NEW_MODULES = [
    "contractionpath.paths.optimal",
    "contractionpath.paths.branchbound",
    "contractionpath.communication_schemes",
    "tensornetwork.partitioning",
    "contractionpath.contraction_path",
    "contractionpath.contraction_cost",
]
ENGINES = ["native", "python"]
@pytest.fixture(params=ENGINES)
def engine(request, monkeypatch):
    """Both packages on their native partitioners, or both on Python."""
    if request.param == "python":
        monkeypatch.setenv("TNC_TPU_NO_NATIVE", "1")
    else:
        monkeypatch.delenv("TNC_TPU_NO_NATIVE", raising=False)
        assert port_native.load_native() is not None, port_native.NATIVE
        assert ref_native.load_native() is not None
    return request.param


@pytest.mark.parametrize("module", NEW_MODULES)
def test_doctests(module):
    mod = importlib.import_module(f"tnc_tpu_torch.{module}")
    assert doctest.testmod(mod).failed == 0


# -- contraction_path and contraction_cost -----------------------------------


def test_path_constructor_matches_reference():
    got = port_cpath.path({1: port_cpath.path((0, 1), (0, 2))}, (0, 1), (2, 0))
    want = ref_cpath.path({1: ref_cpath.path((0, 1), (0, 2))}, (0, 1), (2, 0))
    assert path_obj(got) == path_obj(want)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_ssa_ordering_matches_reference(seed):
    """Optimizer triples with scattered intermediate ids map to the same
    SSA path."""
    rng = random.Random(seed)
    n = 7
    live = list(range(n))
    triples, next_id = [], 100
    while len(live) > 1:
        a, b = rng.sample(live, 2)
        live.remove(a)
        live.remove(b)
        out = next_id + rng.randrange(1, 5)
        next_id = out
        live.append(out)
        triples.append((a, b, out))
    assert (port_cpath.ssa_ordering(triples, n).toplevel
            == ref_cpath.ssa_ordering(triples, n).toplevel)


@pytest.mark.parametrize("pairs,n", [
    ([(0, 1), (0, 2)], 3), ([(0, 1), (1, 2)], 3), ([(0, 0)], 2),
    ([(0, 1)], 3), ([], 1), ([], 2), ([(2, 1), (2, 0), (2, 3)], 4)])
def test_validate_path_matches_reference(pairs, n):
    got = port_cpath.validate_path(port_cpath.ContractionPath.simple(pairs), n)
    assert got == ref_cpath.validate_path(ref_cpath.ContractionPath.simple(pairs), n)


def _externals(seed, k=5):
    """``k`` partition externals of a random network, both packages."""
    port, ref = random_network(15, seed, extra=6)
    blocks = [i % k for i in range(15)]
    out = []
    for tn, cls in ((port, CompositeTensor), (ref, RefComposite)):
        out.append([cls([t for t, b in zip(tn.tensors, blocks) if b == p])
                    .external_tensor() for p in range(k)])
    return out


@pytest.mark.parametrize("seed", [0, 5])
@pytest.mark.parametrize("calibrated", [False, True])
def test_communication_costs_match_reference(seed, calibrated):
    port_ext, ref_ext = _externals(seed)
    rng = random.Random(seed)
    latencies = [rng.random() * 1e4 for _ in port_ext]
    path = [(0, 1), (2, 3), (0, 2), (4, 0)]
    fn = (port_cost.CalibratedObjective(CalibratedCostModel(*MODEL)).pair_cost
          if calibrated else None)
    ref_fn = (ref_cost.CalibratedObjective(RefModel(*MODEL)).pair_cost
              if calibrated else None)
    for only_ops in (False, True):
        for critical in (False, True):
            assert port_cost.communication_path_cost(
                port_ext, path, only_ops, critical, latencies, fn) == \
                ref_cost.communication_path_cost(
                    ref_ext, path, only_ops, critical, latencies, ref_fn)
        assert port_cost.communication_path_op_costs(
            port_ext, path, only_ops, latencies, fn) == \
            ref_cost.communication_path_op_costs(ref_ext, path, only_ops, latencies, ref_fn)
    assert port_cost.communication_path_cost(port_ext[:1], [], tensor_cost=[3.0]) == (3.0, 3.0)
    with pytest.raises(ValueError):
        port_cost.communication_path_cost(port_ext, path, tensor_cost=[1.0])


def test_compute_memory_requirements_matches_reference():
    """A nested path's peak under the element and byte estimators."""
    port, ref = circuits(8, 4, 3)
    blocks = [i % 3 for i in range(len(port))]
    port_ptn = port_part.partition_tensor_network(port, blocks)
    ref_ptn = ref_part.partition_tensor_network(ref, blocks)
    port_path = port_paths.Greedy(port_paths.OptMethod.GREEDY).find_path(port_ptn)
    ref_path = ref_paths.Greedy(ref_paths.OptMethod.GREEDY).find_path(ref_ptn)
    assert path_obj(port_path.replace_path()) == path_obj(ref_path.replace_path())
    for port_fn, ref_fn in ((port_cost.contract_size_tensors, ref_cost.contract_size_tensors),
                            (port_cost.contract_size_tensors_bytes,
                             ref_cost.contract_size_tensors_bytes)):
        got = port_cost.compute_memory_requirements(
            port_ptn.tensors, port_path.replace_path(), port_fn)
        want = ref_cost.compute_memory_requirements(
            ref_ptn.tensors, ref_path.replace_path(), ref_fn)
        assert got == want > 0


# -- Optimal and branch-and-bound --------------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
@pytest.mark.parametrize("cost", ["FLOPS", "SIZE"])
def test_optimal_matches_reference(seed, cost):
    port, ref = random_network(9, seed)
    got = port_paths.Optimal(port_paths.CostType[cost]).find_path(port)
    want = ref_paths.Optimal(ref_paths.CostType[cost]).find_path(ref)
    assert path_obj(got.replace_path()) == path_obj(want.replace_path())
    assert (got.flops, got.size) == (want.flops, want.size)


def test_optimal_refuses_large_networks():
    port, _ = random_network(6, 0)
    with pytest.raises(ValueError):
        port_paths.Optimal(max_tensors=5).find_path(port)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
@pytest.mark.parametrize("nbranch", [None, 3, 10])
@pytest.mark.parametrize("cost", ["FLOPS", "SIZE"])
def test_branchbound_matches_reference(seed, nbranch, cost):
    port, ref = random_network(8, seed)
    got = port_paths.BranchBound(nbranch, 4.0, port_paths.CostType[cost]).find_path(port)
    want = ref_paths.BranchBound(nbranch, 4.0, ref_paths.CostType[cost]).find_path(ref)
    assert path_obj(got.replace_path()) == path_obj(want.replace_path())
    assert (got.flops, got.size) == (want.flops, want.size)


@pytest.mark.parametrize("seed", [0, 1])
def test_branchbound_with_a_calibrated_objective_matches_reference(seed):
    port, ref = random_network(8, seed)
    got = port_paths.BranchBound(objective=port_cost.CalibratedObjective(
        CalibratedCostModel(*MODEL))).find_path(port)
    want = ref_paths.BranchBound(objective=ref_cost.CalibratedObjective(
        RefModel(*MODEL))).find_path(ref)
    assert path_obj(got.replace_path()) == path_obj(want.replace_path())


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("calibrated", [False, True])
def test_weighted_branchbound_matches_reference(seed, calibrated):
    port, ref = random_network(7, seed)
    rng = random.Random(seed)
    latency = {i: rng.random() * (1e-4 if calibrated else 1e4) for i in range(7)}
    port_obj = (port_cost.CalibratedObjective(CalibratedCostModel(*MODEL))
                if calibrated else None)
    ref_obj = ref_cost.CalibratedObjective(RefModel(*MODEL)) if calibrated else None
    got = port_paths.WeightedBranchBound(latency, objective=port_obj).find_path(port)
    want = ref_paths.WeightedBranchBound(latency, objective=ref_obj).find_path(ref)
    assert path_obj(got.replace_path()) == path_obj(want.replace_path())
    with pytest.raises(ValueError):
        port_paths.WeightedBranchBound({0: 0.0}).find_path(port)


def test_finders_on_nested_composites_match_reference():
    """The finders recurse into a partitioned network as the reference's do."""
    port, ref = random_network(12, 4)
    blocks = [i // 4 for i in range(12)]
    port_ptn = port_part.partition_tensor_network(port, blocks)
    ref_ptn = ref_part.partition_tensor_network(ref, blocks)
    for name in ("Optimal", "BranchBound"):
        got = getattr(port_paths, name)().find_path(port_ptn)
        want = getattr(ref_paths, name)().find_path(ref_ptn)
        assert path_obj(got.replace_path()) == path_obj(want.replace_path()), name


# -- communication schemes ---------------------------------------------------


@pytest.mark.parametrize("scheme", list(port_schemes.CommunicationScheme))
@pytest.mark.parametrize("seed", [0, 3])
@pytest.mark.parametrize("calibrated", [False, True])
def test_scheme_fanin_matches_reference(scheme, seed, calibrated):
    port_ext, ref_ext = _externals(seed, k=6)
    rng = random.Random(seed)
    latency = {i: rng.random() * (1e-4 if calibrated else 1e5) for i in range(6)}
    port_model = CalibratedCostModel(*MODEL) if calibrated else None
    ref_model = RefModel(*MODEL) if calibrated else None
    got = scheme.communication_path(port_ext, latency, random.Random(seed),
                                    cost_model=port_model)
    want = ref_schemes.CommunicationScheme(scheme.value).communication_path(
        ref_ext, latency, random.Random(seed), cost_model=ref_model)
    assert got == want
    assert len(got) == 5
    assert port_cpath.validate_path(port_cpath.ContractionPath.simple(got), 6)


def test_scheme_edges_match_reference():
    port_ext, ref_ext = _externals(1, k=3)
    for scheme in port_schemes.CommunicationScheme:
        assert scheme.communication_path(port_ext[:1]) == []
    with pytest.raises(ValueError):
        port_schemes.CommunicationScheme.BIPARTITION_SWEEP.communication_path(port_ext)
    # no latency map: zero latencies, as the reference's default
    got = port_schemes.CommunicationScheme.WEIGHTED_BRANCH_BOUND.communication_path(port_ext)
    want = ref_schemes.CommunicationScheme.WEIGHTED_BRANCH_BOUND.communication_path(ref_ext)
    assert got == want


def test_calibrated_latency_map_and_fanin_levels_match_reference():
    flops = {0: 1e9, 1: 0.0, 2: 3.5e11, 3: 12.0}
    steps = {0: 10.0, 2: 0.0, 3: 4.0}
    for local_steps in (None, steps):
        assert port_schemes.calibrated_latency_map(
            flops, CalibratedCostModel(*MODEL), local_steps) == \
            ref_schemes.calibrated_latency_map(flops, RefModel(*MODEL), local_steps)
    for path in ([(0, 1), (2, 3), (0, 2)], [(0, 1), (0, 2), (0, 3)],
                 [(3, 2), (1, 0), (5, 4), (1, 3), (1, 5)], []):
        assert port_schemes.fanin_levels(path) == ref_schemes.fanin_levels(path)


# -- find_partitioning and friends ------------------------------------------


@pytest.mark.parametrize("k", [1, 2, 3, 4])
@pytest.mark.parametrize("strategy", ["MIN_CUT", "COMMUNITY_FINDING"])
@pytest.mark.parametrize("balanced", [True, False])
def test_find_partitioning_matches_reference(engine, k, strategy, balanced):
    port, ref = circuits(*((10, 5, 8) if engine == "native" else (6, 3, 8)))
    got = port_part.find_partitioning(
        port, k, port_part.PartitioningStrategy[strategy], balanced, seed=5)
    want = ref_part.find_partitioning(
        ref, k, ref_part.PartitioningStrategy[strategy], balanced, seed=5)
    assert got == want
    assert sorted(set(got)) == list(range(k))


@pytest.mark.parametrize("objective", ["cut", "km1"])
@pytest.mark.parametrize("unit", [True, False])
def test_find_partitioning_with_a_config_matches_reference(engine, objective, unit):
    port, ref = circuits(*((10, 5, 8) if engine == "native" else (6, 3, 8)))
    got = port_part.find_partitioning(port, 3, config=port_part.PartitionConfig(
        objective=objective, imbalance=0.1, seed=9, refine_passes=3,
        unit_vertex_weights=unit))
    want = ref_part.find_partitioning(ref, 3, config=ref_part.PartitionConfig(
        objective=objective, imbalance=0.1, seed=9, refine_passes=3,
        unit_vertex_weights=unit))
    assert got == want
    assert port_part.PartitionConfig.for_strategy(
        port_part.PartitioningStrategy.COMMUNITY_FINDING, 0.05, 3).__dict__ == \
        ref_part.PartitionConfig.for_strategy(
            ref_part.PartitioningStrategy.COMMUNITY_FINDING, 0.05, 3).__dict__


def test_find_partitioning_refuses_k0():
    port, _ = circuits(6, 3, 8)
    with pytest.raises(ValueError):
        port_part.find_partitioning(port, 0)


def test_find_partitioning_records_its_span(monkeypatch):
    """The ``plan.find_partitioning`` span, through the port's ``obs``,
    in a fresh registry (the module state restored after)."""
    from tnc_tpu_torch.obs import core as port_core

    port, _ = circuits(6, 3, 8)
    registry = port_core.MetricsRegistry()
    monkeypatch.setattr(port_core, "_REGISTRY", registry)
    monkeypatch.setattr(port_core, "_ENABLED", True)
    port_part.find_partitioning(port, 2)
    assert [r.name for r in registry.span_records()] == ["plan.find_partitioning"]


@pytest.mark.parametrize("k", [2, 4])
def test_communication_partitioning_matches_reference(engine, k):
    port, ref = circuits(*((10, 5, 8) if engine == "native" else (6, 3, 8)))
    weights = [float(t.size()) for t in port.tensors]
    got = port_part.communication_partitioning(port, k, weights, seed=3)
    want = ref_part.communication_partitioning(ref, k, weights, seed=3)
    assert got == want
    with pytest.raises(ValueError):
        port_part.communication_partitioning(port, k, weights[1:])


def test_partition_tensor_network_matches_reference():
    port, ref = circuits(8, 4, 2)
    blocks = [(3 * i) % 5 for i in range(len(port))]
    blocks = [b if b != 2 else 4 for b in blocks]  # an empty block is dropped
    got = port_part.partition_tensor_network(port, blocks)
    want = ref_part.partition_tensor_network(ref, blocks)
    assert tensor_obj(got) == tensor_obj(want)
    assert len(got) == 4
    with pytest.raises(ValueError):
        port_part.partition_tensor_network(port, blocks[1:])
