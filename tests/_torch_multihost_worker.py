"""The ranks of the port's multi-process serving tests
(``tests/test_torch_multihost_serve.py``, ``tests/test_torch_multihost_fleet.py``):
two processes of a gloo process group over a ``FileStore``, each running
one scenario of :mod:`tnc_tpu_torch.serve.multihost` on CPU tensors
(``NumpyBackend``, the reference's bits) and writing what it returns to
``<out_dir>/<rank>.pkl``.

Every scenario binds its circuits through one plan cache in ``out_dir``:
rank 0 plans and publishes, a broadcast is the barrier, rank 1 binds with
no planner call. Rank 0 runs the root (a ``ContractionService`` with a
``ClusterDispatcher``, or the dispatcher alone); rank 1 parks in
``serve_cluster``.
"""

import multiprocessing
import os
import pickle
import threading
import time

import numpy as np

WORLD = 2
JOIN_S = 120.0  # a test's limit on its two ranks

SERVE = (8, 4, 5)  # brickwork_circuit(qubits, depth, default_rng(seed))
SLICED = (8, 6, 9)  # the same, bound at target 64: 4 slices
SLICED_TARGET = 64
BITS_SEED = 23


def serve_bits(n: int = 24) -> list[str]:
    """``n`` bitstrings of the serving circuit, the reference test's rows."""
    return [format(int(v), "08b")
            for v in np.random.default_rng(BITS_SEED).integers(0, 256, size=n)]


def _circuit(cfg):
    from tnc_tpu_torch.builders.random_circuit import brickwork_circuit

    qubits, depth, seed = cfg
    return brickwork_circuit(qubits, depth, np.random.default_rng(seed))


def _planner_calls() -> int:
    from tnc_tpu_torch import obs

    return sum(1 for r in obs.get_registry().span_records() if r.name == "plan.find_path")


def _bind_shared(rank: int, cfg, out_dir: str, target_size=None):
    """Bind ``cfg`` through the shared plan cache: rank 0 first (it plans
    and publishes), rank 1 after the barrier, with no planner call."""
    from tnc_tpu_torch.parallel.partitioned import broadcast_object
    from tnc_tpu_torch.serve import PlanCache, bind_circuit

    cache = PlanCache(os.path.join(out_dir, "plans"))
    bound = None
    if rank == 0:
        bound = bind_circuit(_circuit(cfg), plan_cache=cache, target_size=target_size)
    broadcast_object(None, root=0)  # barrier: the plan is published
    planned = 0
    if rank != 0:
        before = _planner_calls()
        bound = bind_circuit(_circuit(cfg), plan_cache=cache, target_size=target_size)
        planned = _planner_calls() - before
    return bound, cache, planned


def _det(bound, bits):
    return [bound.template.request_bits(b) for b in bits]


def bras(rank, world, out_dir):
    """The bra-sharded service: 24 requests, batches of 8 over 2 ranks."""
    from tnc_tpu_torch.ops.backends import NumpyBackend
    from tnc_tpu_torch.serve import ClusterDispatcher, ContractionService, serve_cluster

    bound, cache, planned = _bind_shared(rank, SERVE, out_dir)
    bits = serve_bits()
    if rank == 0:
        dispatcher = ClusterDispatcher()
        with ContractionService(bound, backend=NumpyBackend(), dispatcher=dispatcher,
                                max_batch=8, max_wait_ms=20.0) as svc:
            got = np.asarray([f.result(timeout=60) for f in [svc.submit(b) for b in bits]])
            batches = svc.stats()["counts"]["batches"]
        dispatcher.stop()
        return {"got": got, "batches": batches}
    served = serve_cluster(bound, NumpyBackend(), plan_cache=cache)
    key = cache.key_for_network(bound.template.network, bound.target_size)
    return {"served": served, "planned": planned, "hits": cache.hits(key)}


def slices(rank, world, out_dir):
    """One collective slice-range-sharded batch of 6 requests."""
    from tnc_tpu_torch.ops.backends import NumpyBackend
    from tnc_tpu_torch.serve import cluster_amplitudes_sliced

    bound, _cache, planned = _bind_shared(rank, SLICED, out_dir, SLICED_TARGET)
    got = cluster_amplitudes_sliced(bound, _det(bound, serve_bits()[:6]), NumpyBackend())
    return {"got": got, "planned": planned, "slices": bound.sliced.slicing.num_slices}


def plan_swap(rank, world, out_dir):
    """A round under the cached plan, then a swap the root publishes
    through the shared cache: the worker rebuilds its bound from the cache
    (no planner call) before it serves the next round."""
    from tnc_tpu_torch import obs
    from tnc_tpu_torch.contractionpath.paths.greedy import Greedy, OptMethod
    from tnc_tpu_torch.ops.backends import NumpyBackend
    from tnc_tpu_torch.serve import (
        ClusterDispatcher,
        ContractionService,
        bind_template,
        plan_signature,
        serve_cluster,
    )

    bound, cache, _planned = _bind_shared(rank, SERVE, out_dir)
    bits = serve_bits()
    if rank != 0:
        before = _planner_calls()
        served = serve_cluster(bound, NumpyBackend(), plan_cache=cache)
        return {"served": served, "planned": _planner_calls() - before,
                "rebinds": obs.counters_by_prefix("serve.cluster.worker_rebinds")}
    dispatcher = ClusterDispatcher()
    backend = NumpyBackend()
    with ContractionService(bound, backend=backend, dispatcher=dispatcher,
                            max_batch=8, max_wait_ms=20.0) as svc:
        first = np.asarray([f.result(timeout=60) for f in [svc.submit(b) for b in bits[:4]]])
        key = cache.key_for_network(bound.template.network, bound.target_size)
        for seed in range(1, 50):  # another plan of the same structure
            cache.invalidate(key)
            swapped = bind_template(bound.template, Greedy(OptMethod.RANDOM_GREEDY,
                                                           ntrials=2, seed=seed), cache)
            if plan_signature(swapped) != plan_signature(bound):
                break
        svc.swap_bound(swapped)
        second = np.asarray([f.result(timeout=60) for f in
                             [svc.submit(b) for b in bits[4:12]]])
        swaps = svc.stats()["counts"]["plan_swaps"]
    dispatcher.stop()
    det = _det(bound, bits)
    return {"first": first, "second": second, "swaps": swaps,
            "old_sig": plan_signature(bound), "new_sig": plan_signature(swapped),
            "first_local": bound.amplitudes_det(det[:4], backend),
            "second_local": np.concatenate(
                [swapped.amplitudes_det(det[4:8], backend),
                 swapped.amplitudes_det(det[8:12], backend)])}


def stop_drain(rank, world, out_dir):
    """``stop()`` while a round is held open by a slow root broadcast: the
    stop waits behind the round, which completes, then releases the worker."""
    from tnc_tpu_torch.ops.backends import NumpyBackend
    from tnc_tpu_torch.resilience.faultinject import faults
    from tnc_tpu_torch.serve import ClusterDispatcher, DispatcherStoppedError, serve_cluster

    bound, _cache, _planned = _bind_shared(rank, SERVE, out_dir)
    if rank != 0:
        return {"served": serve_cluster(bound, NumpyBackend())}
    det = _det(bound, serve_bits()[:4])
    dispatcher = ClusterDispatcher()
    results = []
    with faults("cluster.broadcast(side=root)=slow:0.6*1"):
        t = threading.Thread(target=lambda: results.append(
            dispatcher(bound, det, NumpyBackend())))
        t.start()
        time.sleep(0.15)  # the round holds the dispatcher's lock, asleep
        t0 = time.monotonic()
        dispatcher.stop()  # waits behind the round
        stop_s = time.monotonic() - t0
        t.join(60)
    try:
        dispatcher(bound, det, NumpyBackend())
        refused = False
    except DispatcherStoppedError:
        refused = True
    return {"results": results, "stop_s": stop_s, "refused": refused,
            "local": bound.amplitudes_det(det[:2], NumpyBackend()),
            "local_tail": bound.amplitudes_det(det[2:], NumpyBackend())}


def kill_resume(rank, world, out_dir):
    """Rank 1 is SIGKILLed mid-range (after its slice-3 checkpoint): the
    root's bounded gather marks its slot lost and resumes the range from
    the shared checkpoint. The next round gives rank 1 nothing and does
    not wait for it."""
    from tnc_tpu_torch import obs
    from tnc_tpu_torch.obs.fleet import FleetRegistry
    from tnc_tpu_torch.ops.backends import NumpyBackend
    from tnc_tpu_torch.resilience.faultinject import configure_faults
    from tnc_tpu_torch.serve import ClusterDispatcher, serve_cluster
    from tnc_tpu_torch.serve import elastic

    os.environ["TNC_TPU_CKPT_EVERY"] = "1"
    fleet_dir = os.path.join(out_dir, "fleet")
    ckpt_dir = os.path.join(out_dir, "ckpt")
    bound, _cache, _planned = _bind_shared(rank, SLICED, out_dir, SLICED_TARGET)
    det = _det(bound, serve_bits()[:1])
    if rank != 0:
        configure_faults("cluster.worker(phase=slice,s=3)=kill*1")
        serve_cluster(bound, NumpyBackend(), fleet_dir=fleet_dir, heartbeat_s=0.2)
        return {"survived": True}  # never reached: the rule kills this rank
    backend = NumpyBackend()
    registry = FleetRegistry(fleet_dir, name="root", stale_after_s=1.0)
    deadline = time.monotonic() + 30
    while 1 not in elastic.live_processes(registry, world) and time.monotonic() < deadline:
        time.sleep(0.05)
    before = elastic.counters().get("reassigned", 0)
    dispatcher = ClusterDispatcher(registry=registry, timeout_s=2.0, ckpt_dir=ckpt_dir)
    t0 = time.monotonic()
    got = dispatcher(bound, det, backend)
    lost_round_s = time.monotonic() - t0
    lost_ranges = dispatcher.last_ranges
    resumed = obs.counters_by_prefix("resilience.ckpt.resumed")
    reassigned = elastic.counters().get("reassigned", 0) - before
    t0 = time.monotonic()
    again = dispatcher(bound, det, backend)
    next_round_s = time.monotonic() - t0
    next_ranges = dispatcher.last_ranges
    dispatcher.stop()
    oracle = (bound.amplitudes_det(det, backend, slice_range=(0, 2))
              + bound.amplitudes_det(det, backend, slice_range=(2, 4)))
    return {"got": got, "again": again, "oracle": oracle, "lost_ranges": lost_ranges,
            "next_ranges": next_ranges, "lost": sorted(dispatcher.lost),
            "reassigned": reassigned, "resumed": resumed,
            "lost_round_s": lost_round_s, "next_round_s": next_round_s,
            "full": bound.amplitudes_det(det, backend)}


def slow_excluded(rank, world, out_dir):
    """Rank 1 is slow, not dead: it reads its first command, then sleeps
    past the root's ``timeout_s``. The root's gather marks it lost and
    recomputes its rows; the next round and the stop wait for it no more.
    Rank 1 wakes, answers into the abandoned gather, parks, finds itself
    left out and leaves ``serve_cluster`` with ``ProcessExcluded``."""
    from tnc_tpu_torch.ops.backends import NumpyBackend
    from tnc_tpu_torch.parallel.partitioned import ProcessExcluded
    from tnc_tpu_torch.resilience.faultinject import configure_faults
    from tnc_tpu_torch.serve import ClusterDispatcher, serve_cluster
    from tnc_tpu_torch.serve import elastic

    bound, _cache, _planned = _bind_shared(rank, SERVE, out_dir)
    det = _det(bound, serve_bits()[:4])
    if rank != 0:
        configure_faults("cluster.broadcast(side=worker)=slow:4.0*1")
        t0 = time.monotonic()
        try:
            served = serve_cluster(bound, NumpyBackend())
            error = None
        except ProcessExcluded as exc:
            served, error = None, str(exc)
        return {"served": served, "error": error, "left_s": time.monotonic() - t0}
    backend = NumpyBackend()
    before = elastic.counters().get("reassigned", 0)
    dispatcher = ClusterDispatcher(timeout_s=1.0)
    t0 = time.monotonic()
    got = dispatcher(bound, det, backend)
    lost_round_s = time.monotonic() - t0
    t0 = time.monotonic()
    again = dispatcher(bound, det, backend)
    next_round_s = time.monotonic() - t0
    next_ranges = dispatcher.last_ranges
    t0 = time.monotonic()
    dispatcher.stop()
    stop_s = time.monotonic() - t0
    return {"got": got, "again": again, "lost": sorted(dispatcher.lost),
            "reassigned": elastic.counters().get("reassigned", 0) - before,
            "lost_round_s": lost_round_s, "next_round_s": next_round_s,
            "next_ranges": next_ranges, "stop_s": stop_s,
            "shards": np.concatenate([bound.amplitudes_det(det[:2], backend),
                                      bound.amplitudes_det(det[2:], backend)]),
            "full": bound.amplitudes_det(det, backend)}


def fleet_trace(rank, world, out_dir):
    """The fleet plane across the two processes: rank 1's dispatch spans
    carry the root's request ids and dispatch sequence, and the root's
    ``/fleet`` view lists both replicas and sums rank 1's batches."""
    import json
    import urllib.request

    from tnc_tpu_torch import obs
    from tnc_tpu_torch.obs.fleet import FleetRegistry
    from tnc_tpu_torch.ops.backends import NumpyBackend
    from tnc_tpu_torch.serve import ClusterDispatcher, ContractionService, serve_cluster

    fleet_dir = os.path.join(out_dir, "fleet")
    bound, _cache, _planned = _bind_shared(rank, SERVE, out_dir)
    bits = serve_bits()[:16]
    if rank != 0:
        served = serve_cluster(bound, NumpyBackend(), fleet_dir=fleet_dir,
                               telemetry_port=0, heartbeat_s=0.2)
        spans = [(r.name, dict(r.args)) for r in obs.get_registry().span_records()
                 if r.name == "serve.dispatch"]
        return {"served": served, "spans": spans}
    seqs = []

    class Recording(ClusterDispatcher):
        def __call__(self, bound, bits, backend=None):
            from tnc_tpu_torch.obs.fleet import current_dispatch_context

            out = super().__call__(bound, bits, backend)
            seqs.append((self._seq, current_dispatch_context().riders))
            return out

    dispatcher = Recording(registry=FleetRegistry(fleet_dir, name="p0"), timeout_s=30.0)
    with ContractionService(bound, backend=NumpyBackend(), dispatcher=dispatcher,
                            max_batch=8, max_wait_ms=20.0) as svc:
        svc.serve_telemetry(port=0)
        svc.attach_fleet(directory=fleet_dir, heartbeat_s=0.2)
        deadline = time.monotonic() + 30
        while svc.fleet_snapshot()["roster"]["live"] < 2 and time.monotonic() < deadline:
            time.sleep(0.05)
        for i in range(0, len(bits), 8):
            [f.result(timeout=60) for f in [svc.submit(b) for b in bits[i:i + 8]]]
        url = svc._telemetry.url
        with urllib.request.urlopen(url + "/fleet", timeout=10) as resp:
            view = json.loads(resp.read().decode("utf-8"))
    dispatcher.stop()
    return {"seqs": seqs, "view": view}


SCENARIOS = {f.__name__: f for f in (bras, slices, plan_swap, stop_drain, kill_resume,
                                     slow_excluded, fleet_trace)}


def run(rank: int, world: int, store_path: str, scenario: str, out_dir: str) -> None:
    import torch.distributed as dist

    from tnc_tpu_torch import obs
    from tnc_tpu_torch.obs.core import MetricsRegistry

    obs.configure(enabled=True, registry=MetricsRegistry())
    store = dist.FileStore(store_path, world)
    dist.init_process_group("gloo", store=store, rank=rank, world_size=world)
    try:
        result = SCENARIOS[scenario](rank, world, out_dir)
    finally:
        dist.destroy_process_group()
    with open(os.path.join(out_dir, f"{rank}.pkl"), "wb") as f:
        pickle.dump(result, f)


def spawn(tmp_path, scenario: str, exits=(0, 0)) -> list:
    """Spawn the two ranks of ``scenario`` and join them under ``JOIN_S``:
    a rank still running then fails the test (both are killed first), as
    does an exit code other than ``exits``. Returns each rank's result
    (``None`` for a rank expected to die)."""
    ctx = multiprocessing.get_context("spawn")
    store = str(tmp_path / "store")
    procs = [ctx.Process(target=run, args=(rank, WORLD, store, scenario, str(tmp_path)))
             for rank in range(WORLD)]
    for p in procs:
        p.start()
    t0 = time.monotonic()
    try:
        for p in procs:
            p.join(max(JOIN_S - (time.monotonic() - t0), 1.0))
        hung = [rank for rank, p in enumerate(procs) if p.is_alive()]
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(10)
    assert not hung, f"{scenario}: ranks {hung} still running after {JOIN_S} s"
    codes = tuple(p.exitcode for p in procs)
    assert codes == tuple(exits), f"{scenario}: exit codes {codes}, expected {exits}"
    out = []
    for rank in range(WORLD):
        if codes[rank] != 0:
            out.append(None)
            continue
        with open(tmp_path / f"{rank}.pkl", "rb") as f:
            out.append(pickle.load(f))
    return out
