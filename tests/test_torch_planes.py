"""The port's planning planes and cost-truth loop
(``tnc_tpu_torch.contractionpath.symbolic``, ``tnc_tpu_torch.serve.replan``,
``tnc_tpu_torch.serve.plansvc``, ``tnc_tpu_torch.obs.cost_truth``) against
the JAX package on the CPU.

- Symbolic plans digest, serialise and diff as the reference's; a record
  either package writes loads in the other.
- ``plan_predicted_cost`` agrees under the flops and the calibrated
  objective, sliced and not; the replanner, run once by hand with the same
  seeded optimizer (clock budgets off), swaps in the reference's plan and
  a ``NumpyBackend`` service then serves the reference's bits; a
  ``SharedCacheWatcher`` adopts a plan the reference's replanner published.
- Trial grids, seeded trials and the merged best agree; a trial board
  written by one package is worked and merged by the other; the planner
  pod's delegated search swaps the reference's plan in; the worker CLI.
- ``refit_model`` gives the reference's constants to 1e-12, a registry
  either package publishes loads in the other, the sampler, scoreboard,
  swap watch and controller run the reference's sequences; an adopted
  generation leaves ``TorchBackend.policy_key()`` as it was.

Configurations: ``sycamore_circuit(12, 4)`` and ``(14, 5)`` (rng 42);
every service stops in a ``with`` block or a ``finally``.
"""

import doctest
import json

import numpy as np
import pytest

import tnc_tpu.contractionpath.symbolic as ref_symbolic
import tnc_tpu.obs.calibrate as ref_calibrate
import tnc_tpu.obs.cost_truth as ref_ct
import tnc_tpu.resilience.retry as ref_retry
import tnc_tpu.serve.plansvc as ref_plansvc
import tnc_tpu.serve.replan as ref_replan
import tnc_tpu_torch.contractionpath.symbolic as port_symbolic
import tnc_tpu_torch.obs as port_obs
import tnc_tpu_torch.obs.calibrate as port_calibrate
import tnc_tpu_torch.obs.cost_truth as port_ct
import tnc_tpu_torch.resilience.retry as port_retry
import tnc_tpu_torch.serve.plansvc as port_plansvc
import tnc_tpu_torch.serve.replan as port_replan
from tnc_tpu.builders.sycamore_circuit import sycamore_circuit as ref_sycamore
from tnc_tpu.contractionpath import contraction_cost as ref_cost
from tnc_tpu.contractionpath.paths import Greedy as RefGreedy
from tnc_tpu.contractionpath.paths import OptMethod as RefOptMethod
from tnc_tpu.contractionpath.paths.hyper import Hyperoptimizer as RefHyper
from tnc_tpu.contractionpath.slicing import find_slicing as ref_find_slicing
from tnc_tpu.ops.backends import NumpyBackend as RefNumpyBackend
from tnc_tpu.ops.program import flat_leaf_tensors as ref_flat_leaves
from tnc_tpu.serve import ContractionService as RefService
from tnc_tpu.serve import PlanCache as RefPlanCache
from tnc_tpu_torch.builders.sycamore_circuit import sycamore_circuit
from tnc_tpu_torch.contractionpath import contraction_cost as port_cost
from tnc_tpu_torch.contractionpath.paths import Greedy, OptMethod
from tnc_tpu_torch.contractionpath.paths.hyper import Hyperoptimizer
from tnc_tpu_torch.contractionpath.slicing import find_slicing
from tnc_tpu_torch.ops.backends import NumpyBackend, TorchBackend
from tnc_tpu_torch.ops.program import flat_leaf_tensors
from tnc_tpu_torch.serve import ContractionService, PlanCache

WAIT = 60
BITS = ["".join(str(int(b)) for b in row)
        for row in np.random.default_rng(3).integers(0, 2, (4, 12))]


@pytest.fixture(autouse=True)
def quick_retries():
    for mod in (port_retry, ref_retry):
        mod.configure_retry(mod.RetryPolicy(max_attempts=3, base_delay_s=0.0))
    yield
    for mod in (port_retry, ref_retry):
        mod.configure_retry(None)


def _circuit(qubits=12, depth=4, port=True):
    return (sycamore_circuit if port else ref_sycamore)(qubits, depth,
                                                        np.random.default_rng(42))


def _structure(qubits, depth, port=True):
    """The amplitude template network's flat leaves, its Greedy path and
    peak."""
    tn = _circuit(qubits, depth, port).into_amplitude_template(None).network
    res = (Greedy(OptMethod.GREEDY) if port else RefGreedy(RefOptMethod.GREEDY)).find_path(tn)
    leaves = (flat_leaf_tensors if port else ref_flat_leaves)(tn)
    return tn, leaves, res


# --- symbolic -----------------------------------------------------------------


PLANS = [
    ([(0, 1), (2, 3)], [7, 4], [2, 2], 96.0),
    ([(0, 1), (4, 2), (5, 3)], [7], [2], 1.0),
    ([(0, 1), (2, 3), (4, 5)], [9], [2], 1.0),
    ([(1, 2), (0, 3)], [], [], 5.5),
]


@pytest.mark.parametrize("i", range(len(PLANS)))
def test_symbolic_digests_and_wire_match_reference(i):
    pairs, legs, dims, cost = PLANS[i]
    port = port_symbolic.SymbolicPlan.from_search(pairs, legs, dims, cost,
                                                   provenance={"trial": i})
    ref = ref_symbolic.SymbolicPlan.from_search(pairs, legs, dims, cost,
                                                provenance={"trial": i})
    assert port.digest() == ref.digest() == port_symbolic.plan_digest(pairs, legs)
    assert port.to_obj() == ref.to_obj()
    # a record either package writes loads in the other
    assert ref_symbolic.SymbolicPlan.from_obj(json.loads(json.dumps(port.to_obj()))) == ref
    assert port_symbolic.SymbolicPlan.from_obj(json.loads(json.dumps(ref.to_obj()))) == port
    assert port.subtree_keys() == ref.subtree_keys()
    assert port.num_slices == ref.num_slices
    assert (port.slicing() is None) == (ref.slicing() is None)


def test_symbolic_tampered_record_rejected_by_both():
    obj = port_symbolic.SymbolicPlan.from_search(*PLANS[0]).to_obj()
    obj["pairs"][0] = [1, 0]
    for mod in (port_symbolic, ref_symbolic):
        with pytest.raises(ValueError, match="digest mismatch"):
            mod.SymbolicPlan.from_obj(obj)


@pytest.mark.parametrize("a, b", [(0, 1), (1, 2), (2, 2), (3, 0)])
def test_symbolic_diff_matches_reference(a, b):
    def diff(mod):
        pa, pb = (mod.SymbolicPlan.from_search(*PLANS[k]) for k in (a, b))
        d = mod.diff(pa, pb)
        return (d.shared_subtrees, d.only_a, d.only_b, d.slices_added, d.slices_dropped,
                d.identical)

    assert diff(port_symbolic) == diff(ref_symbolic)


def test_symbolic_plan_of_a_real_path_matches_reference():
    _, _, port_res = _structure(12, 4)
    _, _, ref_res = _structure(12, 4, port=False)
    port = port_symbolic.SymbolicPlan.from_search(port_res.ssa_path.toplevel, [], [], 1.0)
    ref = ref_symbolic.SymbolicPlan.from_search(ref_res.ssa_path.toplevel, [], [], 1.0)
    assert port.digest() == ref.digest()


# --- replan -------------------------------------------------------------------


MODEL = dict(flops_per_s=2.5e10, dispatch_s=4e-6, bytes_per_s=3e11)


@pytest.mark.parametrize("qubits, depth", [(12, 4), (14, 5)])
@pytest.mark.parametrize("objective", ["flops", "calibrated"])
@pytest.mark.parametrize("sliced", [False, True], ids=["unsliced", "sliced"])
def test_plan_predicted_cost_matches_reference(qubits, depth, objective, sliced):
    def cost(port):
        tn, leaves, res = _structure(qubits, depth, port)
        cost_mod, cal = (port_cost, port_calibrate) if port else (ref_cost, ref_calibrate)
        obj = (cost_mod.FlopsObjective() if objective == "flops" else
               cost_mod.CalibratedObjective(cal.CalibratedCostModel(**MODEL)))
        path = res.replace_path()
        slicing = None
        if sliced:
            slicing = (find_slicing if port else ref_find_slicing)(
                tn.tensors, path.toplevel, res.size / 4.0)
        mod = port_replan if port else ref_replan
        return mod.plan_predicted_cost(leaves, path.toplevel, slicing, obj)

    assert cost(True) == pytest.approx(cost(False), rel=1e-12)


def _optimizer(port):
    kw = dict(ntrials=2, seed=42, polish_rounds=1, polish_steps=200,
              reconfigure_budget=None)
    return Hyperoptimizer(**kw) if port else RefHyper(**kw)


def _replanned(port, tmp_path, qubits=12, depth=4):
    """A service over numpy with a plan cache, the replanner run once by
    hand; returns the swap verdict, the replanner's stats, the stored plan
    record and the amplitudes served after it."""
    service_cls, backend, cache_cls, mod = (
        (ContractionService, NumpyBackend(), PlanCache, port_replan) if port else
        (RefService, RefNumpyBackend(), RefPlanCache, ref_replan))
    cache = cache_cls(tmp_path / ("port" if port else "ref"))
    svc = service_cls.from_circuit(_circuit(qubits, depth, port), backend=backend,
                                   plan_cache=cache)
    try:
        replanner = mod.BackgroundReplanner(svc, cache, optimizer=_optimizer(port))
        swapped = replanner._attempt_once()
        again = replanner._attempt_once()  # the verdict is final
        amps = [svc.amplitude(b, timeout_s=WAIT) for b in BITS]
        key = cache.key_for_network(svc.bound.template.network, svc.bound.target_size)
        record = cache.load(key)
        swaps = svc.stats()["counts"]["plan_swaps"]
    finally:
        svc.stop()
    return swapped, again, dict(replanner.stats), record, np.array(amps), swaps


def test_replanner_swap_serves_the_reference_bits(tmp_path):
    port = _replanned(True, tmp_path)
    ref = _replanned(False, tmp_path)
    assert port[0] is ref[0] is True and port[1] is ref[1] is False
    assert port[2] == ref[2]
    assert port[3]["pairs"] == ref[3]["pairs"] and port[3]["finder"] == "Hyperoptimizer"
    assert port[3]["program_sig"] == ref[3]["program_sig"]
    assert port[4].tobytes() == ref[4].tobytes()
    assert port[5] == ref[5] == 1


def test_replanner_leaves_search_plans_and_cold_structures_alone(tmp_path):
    from tnc_tpu_torch.serve import bind_circuit

    cache = PlanCache(tmp_path)
    # bound without the cache: no record to price the incumbent by
    with ContractionService(bind_circuit(_circuit()), backend=NumpyBackend()) as svc:
        replanner = port_replan.BackgroundReplanner(svc, cache, optimizer=_optimizer(True))
        assert replanner._attempt_once() is False and replanner.stats["attempts"] == 0
    # min_hits: a structure below its heat is left for later
    with ContractionService.from_circuit(_circuit(), backend=NumpyBackend(),
                                         plan_cache=cache) as svc:
        replanner = port_replan.BackgroundReplanner(svc, cache, optimizer=_optimizer(True),
                                                    min_hits=5)
        assert replanner._attempt_once() is False and replanner.stats["attempts"] == 0


def test_replanner_cost_model_adoption_matches_reference():
    def run(port):
        mod, cal = (port_replan, port_calibrate) if port else (ref_replan, ref_calibrate)

        class Svc:
            bound = None

            def measured_plan_seconds(self):
                return 0.25

        flops_only = mod.BackgroundReplanner(Svc(), None, optimizer=_optimizer(port))
        seconds = mod.BackgroundReplanner(Svc(), None, optimizer=_optimizer(port),
                                          cost_model=cal.CalibratedCostModel(**MODEL))
        seconds._done_keys.add("k")
        flops_only.adopt_cost_model(cal.CalibratedCostModel(flops_per_s=1e9))
        seconds.adopt_cost_model(cal.CalibratedCostModel(flops_per_s=1e9))
        return (flops_only.measured_incumbent(), flops_only.cost_model,
                seconds.measured_incumbent(), seconds.objective.name,
                seconds.cost_model.flops_per_s, sorted(seconds._done_keys))

    assert run(True) == run(False) == (None, None, 0.25, run(True)[3], 1e9, [])


def test_watcher_adopts_the_reference_replanners_publish(tmp_path):
    """A port replica sharing the cache directory picks up the plan the
    reference's replanner stored there, and serves its bits."""
    cache_dir = tmp_path / "shared"
    port_svc = ContractionService.from_circuit(_circuit(), backend=NumpyBackend(),
                                               plan_cache=PlanCache(cache_dir))
    try:
        watcher = port_replan.SharedCacheWatcher(port_svc, port_svc._plan_cache)
        assert watcher.poll_once() is False  # nothing new yet
        ref_cache = RefPlanCache(cache_dir)
        ref_svc = RefService.from_circuit(_circuit(port=False), backend=RefNumpyBackend(),
                                          plan_cache=ref_cache)
        try:
            ref_replanner = ref_replan.BackgroundReplanner(ref_svc, ref_cache,
                                                           optimizer=_optimizer(False))
            assert ref_replanner._attempt_once() is True
            ref_amps = [ref_svc.amplitude(b, timeout_s=WAIT) for b in BITS]
        finally:
            ref_svc.stop()
        assert watcher.poll_once() is True
        assert watcher.poll_once() is False
        port_amps = [port_svc.amplitude(b, timeout_s=WAIT) for b in BITS]
        assert port_svc.bound.plan["finder"] == "Hyperoptimizer"
        assert watcher.stats == {"adopts": 1, "skips": 0, "abandons": 0}
    finally:
        port_svc.stop()
    assert np.array(port_amps).tobytes() == np.array(ref_amps).tobytes()


def test_background_threads_swap_through_from_circuit(tmp_path):
    """``from_circuit(background_replan=True, shared_cache_watch=True)``
    starts the replanner and the watcher, and ``stop()`` ends them."""
    with ContractionService.from_circuit(
            _circuit(), backend=NumpyBackend(), plan_cache=PlanCache(tmp_path),
            background_replan=True, replan_options={"optimizer": _optimizer(True)},
            shared_cache_watch=True) as svc:
        replanner = svc._replanner
        import time

        t0 = time.monotonic()
        while replanner.stats["swaps"] + replanner.stats["rejects"] < 1:
            assert time.monotonic() - t0 < WAIT
            time.sleep(0.01)
        for b in BITS:
            svc.amplitude(b, timeout_s=WAIT)
        assert svc.stats()["counts"]["plan_swaps"] >= 1
        threads = [replanner._thread] + [w._thread for w in svc._watchers]
    assert svc._replanner is None and svc._watchers == []
    assert not any(t.is_alive() for t in threads)


# --- plansvc ------------------------------------------------------------------


@pytest.mark.parametrize("ntrials, seed", [(1, 42), (5, 7), (9, 42)])
def test_seed_trials_match_reference(ntrials, seed):
    port = port_plansvc.seed_trials(ntrials, seed=seed)
    ref = ref_plansvc.seed_trials(ntrials, seed=seed)
    assert [s.to_obj() for s in port] == [s.to_obj() for s in ref]
    assert [s.digest() for s in port] == [s.digest() for s in ref]
    assert [ref_plansvc.TrialSpec.from_obj(s.to_obj()) for s in port] == ref


@pytest.mark.parametrize("k", range(4))
def test_seeded_trial_gives_the_reference_pairs(k):
    spec_obj = port_plansvc.seed_trials(4, seed=42, sa_steps=200)[k].to_obj()
    _, leaves, res = _structure(12, 4)
    _, ref_leaves, _ = _structure(12, 4, port=False)
    target = res.size / 2.0
    port = port_plansvc.run_trial(port_plansvc.TrialSpec.from_obj(spec_obj), leaves, target)
    ref = ref_plansvc.run_trial(ref_plansvc.TrialSpec.from_obj(spec_obj), ref_leaves, target)
    assert port.pairs == ref.pairs and port.slice_legs == ref.slice_legs
    assert port.digest() == ref.digest()
    assert port.cost == pytest.approx(ref.cost, rel=1e-12)
    assert port.to_obj()["provenance"] == ref.to_obj()["provenance"]


def test_best_plan_and_local_runs_match_reference():
    _, leaves, res = _structure(12, 4)
    _, ref_leaves, _ = _structure(12, 4, port=False)
    target = res.size / 2.0
    port = port_plansvc.run_trials_local(leaves, target,
                                         port_plansvc.seed_trials(4, sa_steps=100))
    ref = ref_plansvc.run_trials_local(ref_leaves, target,
                                       ref_plansvc.seed_trials(4, sa_steps=100))
    assert [p and p.digest() for p in port] == [p and p.digest() for p in ref]
    assert port_plansvc.best_plan(port).digest() == ref_plansvc.best_plan(ref).digest()


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_board_written_by_one_package_merges_in_the_other(tmp_path, writer):
    """One package seeds the board and posts the grid; the other works it;
    the best plan read back by either is the same."""
    _, leaves, res = _structure(12, 4, port=writer == "port")
    seed_mod, work_mod = ((port_plansvc, ref_plansvc) if writer == "port"
                          else (ref_plansvc, port_plansvc))
    board = seed_mod.TrialBoard(tmp_path / "board", owner="seeder")
    assert board.publish_structure(leaves, res.size / 2.0, key="k")
    for spec in seed_mod.seed_trials(3, sa_steps=100):
        assert board.post_trial(spec)
    worker = work_mod.TrialBoard(tmp_path / "board", owner="worker")
    assert work_mod.work_board(worker) == 3
    assert board.done() and worker.done()
    best = [mod.best_plan(mod.TrialBoard(tmp_path / "board").results())
            for mod in (port_plansvc, ref_plansvc)]
    assert best[0].digest() == best[1].digest() and best[0].cost == best[1].cost


def _pod_swap(port, tmp_path):
    """A numpy service under a budget, its pod's delegated search run by
    hand (the poll loop idle); returns the verdict, the pod's stats, the
    served plan's finder and the amplitudes after the swap."""
    service_cls, backend, cache_cls = (
        (ContractionService, NumpyBackend(), PlanCache) if port else
        (RefService, RefNumpyBackend(), RefPlanCache))
    root = tmp_path / ("port" if port else "ref")
    svc = service_cls.from_circuit(_circuit(port=port), backend=backend,
                                   plan_cache=cache_cls(root / "cache"), target_size=2.0 ** 7)
    try:
        svc.enable_plansvc(directory=str(root / "boards"), ntrials=3, sa_steps=100,
                           sa_rounds=1, poll_interval_s=3600.0, margin=1.5)
        pod = svc._plansvc
        key = svc._plan_cache.key_for_network(svc.bound.template.network,
                                              svc.bound.target_size)
        swapped = pod.delegate(svc.bound, key)
        amps = [svc.amplitude(b, timeout_s=WAIT) for b in BITS]
        stats = svc.stats()["plansvc"]
        finder = svc.bound.plan["finder"]
        heartbeat = pod.heartbeat_payload()
    finally:
        svc.stop()
    return swapped, stats, finder, np.array(amps), heartbeat


def test_pod_delegated_search_swaps_the_reference_plan(tmp_path):
    port = _pod_swap(True, tmp_path)
    ref = _pod_swap(False, tmp_path)
    assert port[0] is ref[0] is True
    assert port[1]["counts"] == ref[1]["counts"] and port[1]["role"] == ref[1]["role"]
    assert port[1]["best_cost"] == ref[1]["best_cost"]
    assert port[2] == ref[2] == "PlannerFleet"
    assert port[3].tobytes() == ref[3].tobytes()
    assert port[4] == ref[4]


def test_plansvc_needs_a_plan_cache_and_the_worker_cli(tmp_path, capsys):
    with pytest.raises(ValueError, match="requires a plan_cache"):
        ContractionService.from_circuit(_circuit(), backend=NumpyBackend(), plansvc=True)
    assert port_plansvc.main([str(tmp_path / "empty")]) == 2
    _, leaves, res = _structure(12, 4)
    board = port_plansvc.TrialBoard(tmp_path / "board")
    board.publish_structure(leaves, res.size / 2.0)
    for spec in port_plansvc.seed_trials(2, sa_steps=50):
        board.post_trial(spec)
    assert port_plansvc.main([str(tmp_path / "board"), "--max-trials", "1"]) == 0
    assert port_plansvc.main([str(tmp_path / "board")]) == 0
    out = capsys.readouterr().out
    assert "ran 1 trials" in out and board.done()


# --- cost truth ---------------------------------------------------------------


def _samples(mod, kind):
    rng = np.random.default_rng({"flops": 1, "bytes": 2, "flat": 3, "few": 4}[kind])
    if kind == "few":
        return [mod.StepSample("a", 1e9, 0.0, 1.0)]
    out = []
    for i in range(24):
        flops = float(rng.uniform(1e6, 1e9))
        nbytes = float(rng.uniform(1e5, 1e8)) if kind != "flops" else 0.0
        if kind == "flat":
            flops, nbytes = 1e8, 1e6
        dur = flops / 2e10 + nbytes / 4e11 + 5e-6 + float(rng.normal(0, 1e-7))
        out.append(mod.StepSample(f"s{i}", flops, nbytes, abs(dur), source="serve"))
    return out


@pytest.mark.parametrize("kind", ["flops", "bytes", "flat", "few"])
@pytest.mark.parametrize("current", [None, (1e10, 1e-5, 2e11), (4e10, 0.0, None)])
def test_refit_model_matches_reference(kind, current):
    def fit(ct_mod, cal):
        cur = None if current is None else cal.CalibratedCostModel(*current)
        cfg = ct_mod.CostTruthConfig(refit_min_samples=2)
        return ct_mod.refit_model(cur, _samples(cal, kind), cfg)

    (port, pinfo), (ref, rinfo) = fit(port_ct, port_calibrate), fit(ref_ct, ref_calibrate)
    pfit, rfit = pinfo.pop("fit", None), rinfo.pop("fit", None)
    assert pinfo == pytest.approx(rinfo, rel=1e-12)
    assert (pfit is None) == (rfit is None)
    if pfit is not None:
        assert pfit["terms"] == rfit["terms"]
        for name in ("flops_per_s", "bytes_per_s", "dispatch_s"):
            assert (pfit[name] is None) == (rfit[name] is None)
            if pfit[name] is not None:
                assert pfit[name] == pytest.approx(rfit[name], rel=1e-12)
    if ref is None:
        assert port is None
        return
    for name in ("flops_per_s", "dispatch_s", "bytes_per_s"):
        a, b = getattr(port, name), getattr(ref, name)
        assert (a is None) == (b is None)
        if a is not None:
            assert a == pytest.approx(b, rel=1e-12)


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_registry_published_by_one_package_loads_in_the_other(tmp_path, writer):
    mods = [(port_ct, port_calibrate), (ref_ct, ref_calibrate)]
    if writer == "reference":
        mods.reverse()
    (w_ct, w_cal), (r_ct, _) = mods
    reg = w_ct.ModelRegistry(tmp_path)
    assert reg.publish(w_cal.CalibratedCostModel(1e9, 2e-6, 3e11), n_samples=5,
                       trigger="seed") == 1
    assert reg.publish(w_cal.CalibratedCostModel(2e9, 1e-6, None), trigger="drift") == 2
    reader = r_ct.ModelRegistry(tmp_path)
    version, model = reader.latest()
    assert version == 2 and (model.flops_per_s, model.dispatch_s, model.bytes_per_s) == (
        2e9, 1e-6, None)
    assert reader.fingerprint() == reg.fingerprint()
    assert reader.publish(model, trigger="refit") == 3
    assert reg.latest()[0] == 3
    # corrupt bytes degrade to no model in both
    (tmp_path / port_ct.REGISTRY_FILE).write_text("{not json")
    assert reader.latest() is None and reg.load() is None


def test_sampler_scoreboard_and_swap_watch_match_reference():
    def run(mod):
        sampler = mod.ProductionSampler(capacity=3)
        for i in range(20):
            sampler.offer("amplitude", 1 << (i % 3), 1e6 * (i + 1), 1e3 * i, 1 + i % 4,
                          0.001 * (i + 1))
        board = mod.PlanScoreboard(max_plans=2)
        reads = []
        for i in range(9):
            board.note(f"k{i % 3}", 0.01 * (i + 1), predicted_s=0.005 if i % 2 else None)
            reads.append(board.measured_seconds(f"k{i % 3}", min_samples=2))
        watches = []
        for samples in ([0.02, 0.03, 0.1, 0.1], [0.011, 0.012, 0.01, 0.009, 0.01]):
            watch = mod.SwapWatch(key="k", baseline_s=0.01, window=4, tolerance=1.5,
                                  min_samples=2)
            watches.append([watch.note(s) for s in samples])
        return (sampler.counts(), [s.__dict__ for s in sampler.samples()],
                [s.__dict__ for s in sampler.fit_samples()], board.rows(), reads, watches)

    assert run(port_ct) == run(ref_ct)


def test_cost_truth_controller_matches_reference(tmp_path):
    def run(ct_mod, cal, root):
        clock = [100.0]
        ct = ct_mod.CostTruth(
            ct_mod.CostTruthConfig(refit_min_samples=4, refit_cooldown_s=10.0,
                                   rollback_window=4, rollback_min_samples=1,
                                   use_step_spans=False),
            model=cal.CalibratedCostModel(flops_per_s=1e9),
            registry=ct_mod.ModelRegistry(root), clock=lambda: clock[0])
        events = [ct.model_version]
        for i in range(6):
            events.append(ct.observe_dispatch("amplitude", 8, 0.02 + 0.001 * i, flops=1e7,
                                              nbytes=1e5, steps=10, plan_key="old",
                                              predicted_s=0.01))
        events.append(ct.maybe_refit(trigger="drift"))
        events.append(ct.maybe_refit(trigger="drift"))  # cooldown
        clock[0] += 20.0
        events.append(ct.adopt_pending())
        events.append(ct.arm_swap_watch("new", "prior bound", "sig-new", 0.02))
        for _ in range(3):
            events.append(ct.observe_dispatch("amplitude", 8, 0.1, flops=1e7, steps=10,
                                              plan_key="new"))
        events.append(ct.take_rollback())
        events.append(ct.is_pinned("sig-new"))
        stats = ct.stats()
        stats.pop("fitted_unix")
        stats.pop("registry")
        stats["last_refit"].pop("fit", None)
        return events, stats

    port = run(port_ct, port_calibrate, tmp_path / "port")
    ref = run(ref_ct, ref_calibrate, tmp_path / "ref")
    assert [e if not isinstance(e, tuple) else e[0] for e in port[0]] == \
        [e if not isinstance(e, tuple) else e[0] for e in ref[0]]
    assert port[1] == ref[1]


@pytest.mark.parametrize("value, enabled", [("0", False), ("1", True), (None, True)])
def test_kill_switch_matches_reference(monkeypatch, value, enabled):
    if value is None:
        monkeypatch.delenv("TNC_TPU_COST_TRUTH", raising=False)
    else:
        monkeypatch.setenv("TNC_TPU_COST_TRUTH", value)
    assert port_ct.config_from_env().enabled is ref_ct.config_from_env().enabled is enabled


def test_service_cost_truth_matches_reference(tmp_path):
    def run(service_cls, backend, circuit, root):
        with service_cls.from_circuit(circuit, backend=backend, cost_truth=True,
                                      cost_truth_options={"registry": str(root)}) as svc:
            for b in BITS:
                svc.amplitude(b, timeout_s=WAIT)
            cal = svc.stats()["calibration"]
        return cal["counts"], sorted(cal), cal["sampler"]["offered"], cal["model_version"]

    port = run(ContractionService, NumpyBackend(), _circuit(), tmp_path / "port")
    ref = run(RefService, RefNumpyBackend(), _circuit(port=False), tmp_path / "ref")
    assert port == ref
    assert port[2] == len(BITS)


@pytest.fixture
def step_spans(monkeypatch):
    """The port's registry holding step spans of a small program run with
    step timing on, so that a fresh ``TorchBackend`` fits a model; both
    module states restored after."""
    from tnc_tpu_torch.obs import core

    for name in ("_ENABLED", "_STEP_TIME", "_REGISTRY"):
        monkeypatch.setattr(core, name, getattr(core, name))
    port_obs.configure(enabled=True, step_time=True, registry=port_obs.MetricsRegistry())
    from tnc_tpu_torch.tensornetwork.contraction import contract_tensor_network

    for qubits in (10, 12):
        tn = _circuit(qubits, 4).into_amplitude_network("0" * qubits)[0]
        res = Greedy(OptMethod.GREEDY).find_path(tn)
        contract_tensor_network(tn, res.replace_path(),
                                TorchBackend(device="cpu", split_complex=True))
    port_obs.configure(enabled=False, step_time=False)
    return monkeypatch


def test_adopted_generation_keeps_the_policy_key(step_spans, tmp_path):
    """The service adopts a refitted generation at a batch boundary; the
    backend's own fit, and ``policy_key()`` with it, stay as they were."""
    backend = TorchBackend(device="cpu", split_complex=True)
    key_before = backend.policy_key()
    assert key_before[2] is not None  # the backend fitted the step spans
    with ContractionService.from_circuit(
            _circuit(), backend=backend, cost_truth=True, cost_truth_options={
                "registry": str(tmp_path),
                "config": port_ct.CostTruthConfig(refit_min_samples=2, refit_cooldown_s=0.0,
                                                  use_step_spans=False)}) as svc:
        for b in BITS:
            svc.amplitude(b, timeout_s=WAIT)
        ct = svc._cost_truth
        assert ct.maybe_refit(trigger="manual")
        svc.amplitude(BITS[0], timeout_s=WAIT)  # the batch boundary adopts it
        assert svc.stats()["calibration"]["model_version"] == ct.model_version == 1
        assert svc.cost_model is ct.model
        assert backend.cost_model() is not ct.model
        assert backend.policy_key() == key_before


@pytest.mark.parametrize("module", [port_symbolic, port_ct, port_replan, port_plansvc],
                         ids=["symbolic", "cost_truth", "replan", "plansvc"])
def test_doctests(module):
    assert doctest.testmod(module).failed == 0
