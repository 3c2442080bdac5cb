"""The port's partitioned planner, part two, against the JAX package's on
the CPU: ``compute_solution`` and ``compute_solution_with_paths``, the
simulated-annealing models and engine, the genetic repartitioner,
``balance_partitions_iter``'s shift schemes and ``plan_treecut``, then
partitioned programs contracted on the port's ``TorchBackend``.

Every planning case feeds both packages the same network (same numpy
seed) and the same ``random.Random`` seed and compares exactly: the
assignments, nested paths, scores and cost histories are equal. The
contractions hold the port's split FP32 ``TorchBackend(device="cpu",
split_complex=True)`` (the kernels' plain versions) to the reference's
``JaxBackend(split_complex=True)`` (Pallas in interpret mode) and to the
port's complex128 ``NumpyBackend``: an amplitude within ``1e-5 *
max(|ref|, 2^-14)``, an expectation value within 1e-5 absolute and 1e-3
relative (``chip_smoke.py``'s gates for config #4); and the port's
complex128 result to the reference's complex128 within ``1e-12``
relative.
"""

import doctest
import importlib
import random
import subprocess
import sys

import numpy as np
import pytest
from _torch_partition_cases import MODEL, circuits, path_obj, tensor_obj

import tnc_tpu.contractionpath.balancing as ref_bal
import tnc_tpu.contractionpath.repartitioning as ref_rep
import tnc_tpu.contractionpath.repartitioning.genetic as ref_gen
import tnc_tpu.contractionpath.repartitioning.simulated_annealing as ref_sa
import tnc_tpu.contractionpath.treecut as ref_cut
import tnc_tpu_torch.contractionpath.balancing as port_bal
import tnc_tpu_torch.contractionpath.repartitioning as port_rep
import tnc_tpu_torch.contractionpath.repartitioning.genetic as port_gen
import tnc_tpu_torch.contractionpath.repartitioning.simulated_annealing as port_sa
import tnc_tpu_torch.contractionpath.treecut as port_cut
from tnc_tpu.builders.qaoa_circuit import qaoa_circuit as ref_qaoa
from tnc_tpu.builders.sycamore_circuit import sycamore_circuit as ref_sycamore
from tnc_tpu.contractionpath.communication_schemes import (
    CommunicationScheme as RefScheme,
)
from tnc_tpu.contractionpath.paths.greedy import _ssa_greedy as ref_ssa_greedy
from tnc_tpu.obs.calibrate import CalibratedCostModel as RefModel
from tnc_tpu.ops.backends import JaxBackend
from tnc_tpu.ops.backends import NumpyBackend as RefNumpyBackend
from tnc_tpu.ops.program import build_program as ref_build_program
from tnc_tpu.ops.program import flat_leaf_tensors as ref_flat
from tnc_tpu.tensornetwork.partitioning import find_partitioning as ref_find
from tnc_tpu.tensornetwork.simplify import simplify_network as ref_simplify
from tnc_tpu_torch.builders.qaoa_circuit import qaoa_circuit
from tnc_tpu_torch.builders.sycamore_circuit import sycamore_circuit
from tnc_tpu_torch.contractionpath.communication_schemes import CommunicationScheme
from tnc_tpu_torch.contractionpath.paths.greedy import _ssa_greedy
from tnc_tpu_torch.obs.calibrate import CalibratedCostModel
from tnc_tpu_torch.ops.backends import NumpyBackend, TorchBackend
from tnc_tpu_torch.ops.program import build_program, flat_leaf_tensors
from tnc_tpu_torch.tensornetwork.partitioning import find_partitioning
from tnc_tpu_torch.tensornetwork.simplify import simplify_network

NEW_MODULES = [
    "contractionpath.repartitioning",
    "contractionpath.repartitioning.simulated_annealing",
    "contractionpath.repartitioning.genetic",
    "contractionpath.balancing",
    "contractionpath.treecut",
]
TOL = 1e-5  # an amplitude in split FP32 against complex128, times max(|ref|, 2^-14)
EV_ABS, EV_REL = 1e-5, 1e-3  # an expectation value's absolute and relative gates
SCHEMES = ["GREEDY", "BIPARTITION_SWEEP", "WEIGHTED_BRANCH_BOUND"]


@pytest.fixture(autouse=True)
def _no_worker_override(monkeypatch):
    """Worker counts come from each call, not the environment."""
    monkeypatch.delenv("TNC_TPU_SA_WORKERS", raising=False)


@pytest.fixture(scope="module")
def networks():
    """The reference's repartitioning network (10 qubits, depth 5, LINE)
    in both packages, and its 4-way min-cut assignment."""
    port, ref = circuits()
    initial = find_partitioning(port, 4)
    assert initial == ref_find(ref, 4)
    return port, ref, initial


def solution_obj(s):
    """An SA solution (a list, or a tuple of list / paths / externals /
    costs) as plain tuples."""
    if isinstance(s, tuple):
        return tuple(solution_obj(x) for x in s)
    if isinstance(s, list):
        return tuple(solution_obj(x) for x in s)
    if hasattr(s, "legs"):
        return tensor_obj(s)
    return s


@pytest.mark.parametrize("module", NEW_MODULES)
def test_doctests(module):
    mod = importlib.import_module(f"tnc_tpu_torch.{module}")
    assert doctest.testmod(mod).failed == 0


def test_repartitioning_modules_load_without_torch():
    """A spawn worker of the SA or genetic pool re-imports these modules:
    they must not pull in torch (or JAX)."""
    code = ("import sys; "
            "import tnc_tpu_torch.contractionpath.repartitioning.simulated_annealing, "
            "tnc_tpu_torch.contractionpath.repartitioning.genetic, "
            "tnc_tpu_torch.contractionpath.balancing, tnc_tpu_torch.contractionpath.treecut, "
            "tnc_tpu_torch.tensornetwork.partitioning; "
            "assert 'torch' not in sys.modules and 'jax' not in sys.modules")
    subprocess.run([sys.executable, "-c", code], check=True)


# -- compute_solution ---------------------------------------------------------


@pytest.mark.parametrize("scheme", SCHEMES)
@pytest.mark.parametrize("calibrated", [False, True])
def test_compute_solution_matches_reference(networks, scheme, calibrated):
    port, ref, initial = networks
    got = port_rep.compute_solution(
        port, initial, CommunicationScheme[scheme], random.Random(4),
        cost_model=CalibratedCostModel(*MODEL) if calibrated else None)
    want = ref_rep.compute_solution(
        ref, initial, RefScheme[scheme], random.Random(4),
        cost_model=RefModel(*MODEL) if calibrated else None)
    assert tensor_obj(got[0]) == tensor_obj(want[0])
    assert path_obj(got[1]) == path_obj(want[1])
    assert got[2:] == want[2:]
    assert got[2] <= got[3]


@pytest.mark.parametrize("calibrated", [False, True])
def test_compute_solution_with_paths_matches_reference(networks, calibrated):
    port, ref, initial = networks
    blocks = port_sa._blocks_by_id(port, initial)
    local = [port_sa._local_greedy_path(b) for b in blocks]
    model = CalibratedCostModel(*MODEL) if calibrated else None
    ref_model = RefModel(*MODEL) if calibrated else None
    for fanin in (None, [(0, 1), (2, 3), (0, 2)]):
        got = port_rep.compute_solution_with_paths(
            port, initial, local, CommunicationScheme.BIPARTITION_SWEEP,
            random.Random(2), fanin, model)
        want = ref_rep.compute_solution_with_paths(
            ref, initial, local, RefScheme.BIPARTITION_SWEEP, random.Random(2),
            fanin, ref_model)
        assert tensor_obj(got[0]) == tensor_obj(want[0])
        assert path_obj(got[1]) == path_obj(want[1])
        assert got[2:] == want[2:]


@pytest.mark.parametrize("fanin", [[(0, 1), (2, 3)], [(0, 1), (0, 1), (0, 2)],
                                   [(0, 4), (0, 2), (0, 3)], [(0, 0), (0, 2), (0, 3)]])
def test_compute_solution_with_paths_refuses_a_bad_fanin(networks, fanin):
    port, ref, initial = networks
    local = [port_sa._local_greedy_path(b) for b in port_sa._blocks_by_id(port, initial)]
    with pytest.raises(ValueError) as got:
        port_rep.compute_solution_with_paths(port, initial, local, communication_path=fanin)
    with pytest.raises(ValueError) as want:
        ref_rep.compute_solution_with_paths(ref, initial, local, communication_path=fanin)
    assert str(got.value) == str(want.value)


# -- simulated annealing ------------------------------------------------------


def _models(port, ref, name, **kw):
    if name in ("NaivePartitioningModel", "NaiveIntermediatePartitioningModel"):
        return getattr(port_sa, name)(port, 4, **kw), getattr(ref_sa, name)(ref, 4, **kw)
    return getattr(port_sa, name)(port, **kw), getattr(ref_sa, name)(ref, **kw)


MODELS = ["NaivePartitioningModel", "NaiveIntermediatePartitioningModel",
          "LeafPartitioningModel", "IntermediatePartitioningModel"]


@pytest.mark.parametrize("name", MODELS)
def test_sa_model_trials_and_scores_match_reference(networks, name):
    """The same trial moves from the same seed, scored the same."""
    port, ref, initial = networks
    pm, rm = _models(port, ref, name)
    ps, rs = pm.initial_solution(initial), rm.initial_solution(initial)
    assert solution_obj(ps) == solution_obj(rs)
    prng, rrng = random.Random(5), random.Random(5)
    for _ in range(12):
        ps = pm.generate_trial_solution(ps, prng)
        rs = rm.generate_trial_solution(rs, rrng)
        assert solution_obj(ps) == solution_obj(rs)
        assert pm.evaluate(ps, prng) == rm.evaluate(rs, rrng)


@pytest.mark.parametrize("name", MODELS)
def test_sa_memory_limit_matches_reference(networks, name):
    port, ref, initial = networks
    pm, rm = _models(port, ref, name, memory_limit=1.0)
    got = pm.evaluate(pm.initial_solution(initial), random.Random(0))
    assert got == rm.evaluate(rm.initial_solution(initial), random.Random(0)) == float("inf")


@pytest.mark.parametrize("name", ["NaiveIntermediatePartitioningModel",
                                  "IntermediatePartitioningModel"])
def test_sa_cached_evaluation_equals_the_full_one(networks, name):
    """The per-block caches a move keeps score as a from-scratch
    evaluation of the same assignment and local paths does."""
    port, _, initial = networks
    pm = _models(port, port, name)[0]
    sol = pm.initial_solution(initial)
    rng = random.Random(7)
    paths_at = 1 if name.startswith("Naive") else 2
    for step in range(20):
        sol = pm.generate_trial_solution(sol, rng)
        full = port_sa.evaluate_partitioning_with_paths(
            port, sol[0], sol[paths_at], CommunicationScheme.GREEDY, None,
            random.Random(step))
        assert pm.evaluate(sol, random.Random(step)) == full


def test_sa_needs_two_partitions(networks):
    port, _, _ = networks
    with pytest.raises(ValueError):
        port_sa.NaivePartitioningModel(port, 1)


@pytest.mark.parametrize("name", ["NaivePartitioningModel", "IntermediatePartitioningModel"])
@pytest.mark.parametrize("workers", [1, 2])
def test_sa_balance_partitions_matches_reference(networks, name, workers):
    """One work-bounded round (``max_rounds=1``) gives the reference's
    assignment and score, inline and on a spawn pool of two workers."""
    port, ref, initial = networks
    pm, rm = _models(port, ref, name)
    got = port_sa.balance_partitions(pm, pm.initial_solution(initial), random.Random(11),
                                     n_trials=4, n_workers=workers, max_rounds=1)
    want = ref_sa.balance_partitions(rm, rm.initial_solution(initial), random.Random(11),
                                     n_trials=4, n_workers=1, max_rounds=1)
    assert solution_obj(got) == solution_obj(want)


def test_sa_rounds_match_reference(networks):
    """Three rounds: the temperature schedule and restarts agree too."""
    port, ref, initial = networks
    pm, rm = _models(port, ref, "NaiveIntermediatePartitioningModel")
    got = port_sa.balance_partitions(pm, pm.initial_solution(initial), random.Random(3),
                                     n_trials=3, n_workers=1, max_rounds=3)
    want = ref_sa.balance_partitions(rm, rm.initial_solution(initial), random.Random(3),
                                     n_trials=3, n_workers=1, max_rounds=3)
    assert solution_obj(got) == solution_obj(want)


# -- genetic ------------------------------------------------------------------


@pytest.mark.parametrize("workers", ["1", "2"])
def test_genetic_balance_matches_reference(networks, monkeypatch, workers):
    port, ref, initial = networks
    settings = dict(population_size=6, max_generations=3, stale_limit=3)
    monkeypatch.setenv("TNC_TPU_SA_WORKERS", workers)
    got = port_gen.balance_partitions(port, initial, 4, random.Random(3),
                                      settings=port_gen.GeneticSettings(**settings))
    monkeypatch.setenv("TNC_TPU_SA_WORKERS", "1")
    want = ref_gen.balance_partitions(ref, initial, 4, random.Random(3),
                                      settings=ref_gen.GeneticSettings(**settings))
    assert got == want
    assert got[1] <= port_sa.evaluate_partitioning(
        port, initial, CommunicationScheme.GREEDY, None, random.Random(0))


# -- balance_partitions_iter ----------------------------------------------------


SCHEME_NAMES = [s for s in vars(port_bal.BalancingScheme) if s.isupper()]


@pytest.mark.parametrize("scheme", SCHEME_NAMES)
def test_balance_partitions_iter_matches_reference(networks, scheme):
    port, ref, initial = networks
    value = getattr(port_bal.BalancingScheme, scheme)
    got = port_bal.balance_partitions_iter(
        port, initial, port_bal.BalanceSettings(iterations=6, scheme=value), random.Random(0))
    want = ref_bal.balance_partitions_iter(
        ref, initial, ref_bal.BalanceSettings(iterations=6, scheme=value), random.Random(0))
    assert got[0] == want[0]
    assert tensor_obj(got[1]) == tensor_obj(want[1])
    assert path_obj(got[2]) == path_obj(want[2])
    assert got[3] == want[3]
    assert min(got[3]) == got[3][got[0]]


def test_balance_partitions_iter_options_match_reference(networks):
    """The weighted-random pick, the communication scheme, a memory limit
    and a calibrated model."""
    port, ref, initial = networks
    opts = dict(iterations=5, scheme=port_bal.BalancingScheme.INTERMEDIATE_TENSORS,
                height_limit=3, weighted_random_top=3, memory_limit=1e12)
    got = port_bal.balance_partitions_iter(port, initial, port_bal.BalanceSettings(
        communication_scheme=CommunicationScheme.WEIGHTED_BRANCH_BOUND,
        cost_model=CalibratedCostModel(*MODEL), **opts), random.Random(8))
    want = ref_bal.balance_partitions_iter(ref, initial, ref_bal.BalanceSettings(
        communication_scheme=RefScheme.WEIGHTED_BRANCH_BOUND,
        cost_model=RefModel(*MODEL), **opts), random.Random(8))
    assert (got[0], got[3]) == (want[0], want[3])
    assert path_obj(got[2]) == path_obj(want[2])
    with pytest.raises(ValueError):
        port_bal.balance_partitions_iter(port, [0] * len(port))


# -- plan_treecut ---------------------------------------------------------------


def _sycamore_both(qubits=12, depth=6, seed=42):
    port, _ = sycamore_circuit(qubits, depth, np.random.default_rng(seed)) \
        .into_amplitude_network("0" * qubits)
    ref, _ = ref_sycamore(qubits, depth, np.random.default_rng(seed)) \
        .into_amplitude_network("0" * qubits)
    ssa = _ssa_greedy(list(port.tensors))
    assert ssa == ref_ssa_greedy(list(ref.tensors))
    return port, ref, ssa


def _plan_obj(p):
    return (p.assignment, p.local_paths, p.toplevel, p.critical_estimate,
            p.serial_estimate)


@pytest.mark.parametrize("k", [1, 2, 4])
def test_plan_treecut_matches_reference(k):
    port, ref, ssa = _sycamore_both()
    got = port_cut.plan_treecut(list(port.tensors), ssa, k, seed=3)
    want = ref_cut.plan_treecut(list(ref.tensors), ssa, k, seed=3)
    assert _plan_obj(got) == _plan_obj(want)
    assert got.speedup_estimate == want.speedup_estimate


def test_plan_treecut_with_fewer_tensors_than_blocks_matches_reference():
    port, ref, _ = _sycamore_both(4, 1)
    tensors, ref_tensors = list(port.tensors)[:3], list(ref.tensors)[:3]
    ssa = [(0, 1), (3, 2)]
    got = port_cut.plan_treecut(tensors, ssa, 4, seed=3)
    assert _plan_obj(got) == _plan_obj(ref_cut.plan_treecut(ref_tensors, ssa, 4, seed=3))


# -- partitioned programs on the port's backends ---------------------------------


def _contract_both(ptn, ppath, ref_ptn, ref_ppath):
    """The port's split FP32 and complex128 results and the reference's
    split JAX and complex128 results of one partitioned plan."""
    program = build_program(ptn, ppath)
    arrays = [leaf.data.into_data() for leaf in flat_leaf_tensors(ptn)]
    ref_program = ref_build_program(ref_ptn, ref_ppath)
    ref_arrays = [leaf.data.into_data() for leaf in ref_flat(ref_ptn)]
    for a, b in zip(arrays, ref_arrays):
        assert np.array_equal(a, b)
    torch_out = TorchBackend(device="cpu", split_complex=True).execute(program, arrays)
    numpy_out = NumpyBackend().execute(program, arrays)
    jax_out = JaxBackend(split_complex=True).execute(ref_program, ref_arrays)
    ref_out = RefNumpyBackend().execute(ref_program, ref_arrays)
    return [complex(np.asarray(x).reshape(-1)[0])
            for x in (torch_out, numpy_out, jax_out, ref_out)]


def _hold(torch_v, numpy_v, jax_v, ref_v, expectation=False):
    assert abs(numpy_v - ref_v) <= 1e-12 * abs(ref_v)
    for got in (torch_v, jax_v):
        err = abs(got - numpy_v)
        if expectation:
            assert err <= EV_ABS and err <= EV_REL * abs(numpy_v), (got, numpy_v)
        else:
            assert err <= TOL * max(abs(numpy_v), 2.0 ** -14), (got, numpy_v)


@pytest.mark.parametrize("balance", ["sa", "iter"])
def test_partitioned_qaoa_contracts_as_the_reference(balance):
    """``qaoa_circuit(8, 1)``'s ⟨Z…Z⟩, simplified, split in two, refined
    by one SA round or by ``balance_partitions_iter``, contracted."""
    port = simplify_network(qaoa_circuit(8, 1, np.random.default_rng(42))
                            .into_expectation_value_network())
    ref = ref_simplify(ref_qaoa(8, 1, np.random.default_rng(42))
                       .into_expectation_value_network())
    initial = find_partitioning(port, 2)
    assert initial == ref_find(ref, 2)
    if balance == "sa":
        pm = port_sa.IntermediatePartitioningModel(port)
        rm = ref_sa.IntermediatePartitioningModel(ref)
        prng, rrng = random.Random(42), random.Random(42)
        best, _ = port_sa.balance_partitions(pm, pm.initial_solution(initial), prng,
                                             n_trials=4, n_workers=1, max_rounds=1)
        rbest, _ = ref_sa.balance_partitions(rm, rm.initial_solution(initial), rrng,
                                             n_trials=4, n_workers=1, max_rounds=1)
        assert best[0] == rbest[0]
        ptn, ppath, _, _ = port_rep.compute_solution(port, best[0], rng=prng)
        ref_ptn, ref_ppath, _, _ = ref_rep.compute_solution(ref, rbest[0], rng=rrng)
    else:
        _, ptn, ppath, _ = port_bal.balance_partitions_iter(
            port, initial, port_bal.BalanceSettings(iterations=4), random.Random(1))
        _, ref_ptn, ref_ppath, _ = ref_bal.balance_partitions_iter(
            ref, initial, ref_bal.BalanceSettings(iterations=4), random.Random(1))
    assert path_obj(ppath) == path_obj(ref_ppath)
    values = _contract_both(ptn, ppath, ref_ptn, ref_ppath)
    assert values[1] != 0
    _hold(*values, expectation=True)


def test_treecut_amplitude_contracts_as_the_reference():
    """A 12-qubit Sycamore amplitude cut 4 ways from its Greedy tree."""
    port, ref, ssa = _sycamore_both()
    plan = port_cut.plan_treecut(list(port.tensors), ssa, 4, seed=3)
    ref_plan = ref_cut.plan_treecut(list(ref.tensors), ssa, 4, seed=3)
    ptn, ppath, _, _ = port_rep.compute_solution_with_paths(
        port, plan.assignment, plan.local_paths, rng=random.Random(0))
    ref_ptn, ref_ppath, _, _ = ref_rep.compute_solution_with_paths(
        ref, ref_plan.assignment, ref_plan.local_paths, rng=random.Random(0))
    assert path_obj(ppath) == path_obj(ref_ppath)
    _hold(*_contract_both(ptn, ppath, ref_ptn, ref_ppath))


def test_config4_full_width_plans_as_the_reference():
    """BASELINE config #4 at full width — ``qaoa_circuit(30, 2,
    default_rng(42))``'s ⟨Z…Z⟩, simplified — planned the bench's way by
    both packages: ``find_partitioning(tn, 4)``, one SA round of
    ``IntermediatePartitioningModel`` on one worker from
    ``random.Random(42)``, ``compute_solution``."""
    port = simplify_network(qaoa_circuit(30, 2, np.random.default_rng(42))
                            .into_expectation_value_network())
    ref = ref_simplify(ref_qaoa(30, 2, np.random.default_rng(42))
                       .into_expectation_value_network())
    out = []
    for tn, find, sa, rep in ((port, find_partitioning, port_sa, port_rep),
                              (ref, ref_find, ref_sa, ref_rep)):
        initial = find(tn, 4)
        rng = random.Random(42)
        model = sa.IntermediatePartitioningModel(tn)
        best, score = sa.balance_partitions(model, model.initial_solution(initial), rng,
                                            n_workers=1, max_rounds=1)
        _, path, parallel, serial = rep.compute_solution(tn, best[0], rng=rng)
        out.append((initial, best[0], score, path_obj(path), parallel, serial))
    assert out[0] == out[1]
    assert [out[0][0].count(b) for b in range(4)] == [56, 56, 59, 57]
