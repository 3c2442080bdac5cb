"""The port's elastic plane (``tnc_tpu_torch.serve.elastic``) and the
service's elastic scheduling against the JAX package's on the CPU (the
counterpart of ``tests/test_elastic.py``).

- membership: ``live_processes`` over real ``FleetRegistry`` heartbeats
  and ``assign_ranges`` equal the reference's on the same inputs (a
  hypothesis property over live sets);
- scheduling: ``weighted_fair_order`` equals the reference's (hypothesis
  over tenants, priorities and weights); a tenant over its quota is
  rejected at admission with ``TenantQuotaError``; the service's window
  selection dispatches in the order the reference's does;
- preemption on ``NumpyBackend`` (the backend with slice hooks): a
  higher-priority submit preempts a sliced contraction at a checkpoint
  boundary and both answers are **bitwise** their never-preempted
  goldens, which are the reference's bits; an always-yielding gate raises
  ``PreemptionExhaustedError``;
- scaling: ``ElasticController.decide`` gives the reference's decisions on
  the same sequence and clock; ``LocalAutoscaler`` workers
  (``python -m tnc_tpu_torch.serve.elastic --worker``) join and leave the
  registry;
- ``stats()["elastic"]``, the ``serve_elastic_*`` families and the
  dispatcher's ``last_ranges`` as the reference's.

The sliced program: ``brickwork_circuit(8, 6, default_rng(9))`` bound at
target 64 (4 slices).
"""

import time

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

import tnc_tpu.serve as ref_serve
import tnc_tpu.serve.elastic as ref_elastic
import tnc_tpu_torch.serve as port_serve
import tnc_tpu_torch.serve.elastic as elastic
from tnc_tpu.builders.random_circuit import brickwork_circuit as ref_brickwork
from tnc_tpu.obs.fleet import FleetRegistry as RefFleetRegistry
from tnc_tpu.ops.backends import NumpyBackend as RefNumpyBackend
from tnc_tpu_torch.builders.random_circuit import brickwork_circuit
from tnc_tpu_torch.obs.fleet import FleetRegistry
from tnc_tpu_torch.ops.backends import NumpyBackend


@pytest.fixture(scope="module")
def bounds(tmp_path_factory):
    """The port's and the reference's sliced bound program (4 slices)."""
    port = port_serve.bind_circuit(
        brickwork_circuit(8, 6, np.random.default_rng(9)),
        plan_cache=port_serve.PlanCache(str(tmp_path_factory.mktemp("plans"))),
        target_size=64)
    ref = ref_serve.bind_circuit(ref_brickwork(8, 6, np.random.default_rng(9)),
                                 target_size=64)
    assert port.sliced.slicing.num_slices == ref.sliced.slicing.num_slices == 4
    return port, ref


def _parked(bound, **kw):
    """A service whose 10 s window parks submissions in the queue."""
    return port_serve.ContractionService(bound, backend=NumpyBackend(), max_batch=64,
                                         max_wait_ms=1e4, **kw)


def test_live_processes_over_heartbeats_equal_the_reference(tmp_path):
    got = []
    for registry, live, sub in ((FleetRegistry, elastic.live_processes, "port"),
                                (RefFleetRegistry, ref_elastic.live_processes, "ref")):
        d = str(tmp_path / sub)
        registry(d, name="w1").heartbeat({"process": 1})
        registry(d, name="w9").heartbeat({"process": 9})  # out of range
        registry(d, name="aux").heartbeat({"role": "aux"})  # no index
        registry(d, name="junk").heartbeat({"process": "nan"})
        observer = registry(d, name="obs")
        got.append([live(observer, 2, root=0, stale_after_s=s) for s in (None, -1.0, 60.0)])
    assert got[0] == got[1] == [{0, 1}, {0}, {0, 1}]
    assert elastic.live_processes(FleetRegistry(str(tmp_path / "empty")), 4, root=3) == {3}


def test_live_processes_survive_a_roster_error():
    class Boom:
        def roster(self):
            raise OSError("shared volume gone")

    assert elastic.live_processes(Boom(), 4, root=0) == ref_elastic.live_processes(
        Boom(), 4, root=0) == {0}


@given(st.integers(0, 40), st.sets(st.integers(-2, 9), max_size=6), st.integers(0, 6))
@settings(max_examples=80, deadline=None)
def test_assign_ranges_equal_the_reference(n_items, live, n):
    got = elastic.assign_ranges(n_items, live, n)
    assert got == ref_elastic.assign_ranges(n_items, live, n)
    members = sorted(p for p in live if 0 <= p < max(n, 1)) or [0]
    assert [i for lo, hi in got for i in range(lo, hi)] == list(range(n_items))
    assert all((lo, hi) == (0, 0) for slot, (lo, hi) in enumerate(got) if slot not in members)


@given(st.lists(st.tuples(st.sampled_from("abcd"), st.integers(-1, 3)), max_size=14),
       st.dictionaries(st.sampled_from("abcd"), st.sampled_from([0.0, -1.0, 0.5, 1.0, 2.0, 3.0]),
                       max_size=4),
       st.sampled_from([1.0, 0.0, 2.0]))
@settings(max_examples=100, deadline=None)
def test_weighted_fair_order_equals_the_reference(items, weights, default_weight):
    args = (items, lambda i: i[0], lambda i: i[1], weights, default_weight)
    got = elastic.weighted_fair_order(*args)
    assert got == ref_elastic.weighted_fair_order(*args)
    assert sorted(got) == list(range(len(items)))


def test_weighted_fair_order_known_orders():
    prio = [("t", 0), ("t", 5), ("t", 0), ("u", 9)]
    assert elastic.weighted_fair_order(prio, lambda i: i[0], lambda i: i[1]) == [3, 1, 0, 2]
    stride = ["a", "a", "b", "b"]
    assert elastic.weighted_fair_order(stride, lambda t: t, lambda t: 0,
                                       weights={"b": 2.0}) == [2, 0, 3, 1]


def test_tenant_quota_rejects_at_admission(bounds):
    port, ref = bounds
    got = []
    for service, bound, backend, config in (
            (port_serve.ContractionService, port, NumpyBackend(), elastic.ElasticConfig),
            (ref_serve.ContractionService, ref, RefNumpyBackend(), ref_elastic.ElasticConfig)):
        svc = service(bound, backend=backend, max_batch=64, max_wait_ms=1e4)
        svc.enable_elastic(config(tenant_quotas={"capped": 1}))
        svc.start()
        try:
            svc.submit("0" * 8, tenant="capped")
            with pytest.raises(Exception) as info:
                svc.submit("1" * 8, tenant="capped")
            svc.submit("1" * 8, tenant="other")
            stats = svc.stats()
            got.append((type(info.value).__name__, stats["counts"]["rejected"],
                        stats["elastic"]["tenants"]))
        finally:
            svc.stop(drain=False)
    assert got[0] == got[1] == ("TenantQuotaError", 1, {"capped": 1, "other": 1})
    assert issubclass(port_serve.TenantQuotaError, port_serve.QueueFullError)


def test_window_selection_follows_weighted_fair_order(bounds):
    """A dispatch held open, then tenant traffic queued behind it: the
    service dispatches one request a batch in the order that taking
    ``weighted_fair_order``'s first of what is queued gives, the order the
    reference's service takes too; the higher priority goes next."""
    from tnc_tpu.resilience.faultinject import faults as ref_faults
    from tnc_tpu_torch.resilience.faultinject import faults

    port, ref = bounds
    queued = [("b", 0, "00000001"), ("b", 0, "00000010"), ("a", 0, "00000011"),
              ("a", 0, "00000100"), ("a", 0, "00000101"), ("b", 1, "00000110")]
    orders = []
    for service, bound, backend, config, fault in (
            (port_serve.ContractionService, port, NumpyBackend(), elastic.ElasticConfig, faults),
            (ref_serve.ContractionService, ref, RefNumpyBackend(), ref_elastic.ElasticConfig,
             ref_faults)):
        done = []
        svc = service(bound, backend=backend, max_batch=1, max_wait_ms=0.0)
        svc.enable_elastic(config(tenant_weights={"a": 2.0, "b": 1.0}))
        with fault("serve.dispatch=slow:0.5*1"), svc:
            first = svc.submit("0" * 8, tenant="a")
            time.sleep(0.2)  # the blocker is dispatching
            futs = []
            for i, (tenant, prio, bits) in enumerate(queued):
                f = svc.submit(bits, tenant=tenant, priority=prio)
                f.add_done_callback(lambda _f, i=i: done.append(i))
                futs.append(f)
            first.result(timeout=60)
            [f.result(timeout=60) for f in futs]
        orders.append(done)
    expect, left = [], list(range(len(queued)))
    while left:  # what the window takes: the first of each fresh order
        pick = elastic.weighted_fair_order([queued[i] for i in left], lambda q: q[0],
                                           lambda q: q[1], weights={"a": 2.0, "b": 1.0})[0]
        expect.append(left.pop(pick))
    assert orders[0] == orders[1] == expect
    assert expect[0] == 5  # the priority-1 request dispatches next


def test_priority_preempts_a_sliced_contraction_bitwise(bounds, tmp_path, monkeypatch):
    """A priority-5 submit lands mid-way through a slowed sliced
    contraction on ``NumpyBackend``, preempts it at a checkpoint boundary,
    finishes first; both answers bitwise their never-preempted goldens,
    which are the reference's bits."""
    from tnc_tpu_torch.resilience.faultinject import faults

    port, ref = bounds
    monkeypatch.setenv("TNC_TPU_CKPT_EVERY", "1")
    backend = NumpyBackend()
    long_bits, hi_bits = "00000011", "11110000"
    golden = {b: np.asarray(port.amplitudes_det([port.template.request_bits(b)], backend))
              for b in (long_bits, hi_bits)}
    for b, g in golden.items():
        want = np.asarray(ref.amplitudes_det([ref.template.request_bits(b)], RefNumpyBackend()))
        assert g.tobytes() == want.tobytes()
    before = elastic.counters().get("preempted", 0)
    done_order = []
    svc = port_serve.ContractionService(port, backend=backend, max_batch=1, max_wait_ms=1.0)
    svc.enable_elastic(elastic.ElasticConfig(ckpt_dir=str(tmp_path / "ckpt")))
    with faults("sliced.slice=slow:0.1*-1"), svc:
        f_long = svc.submit(long_bits, priority=0)
        f_long.add_done_callback(lambda f: done_order.append("long"))
        time.sleep(0.15)
        f_hi = svc.submit(hi_bits, priority=5)
        f_hi.add_done_callback(lambda f: done_order.append("hi"))
        hi = np.asarray([f_hi.result(timeout=120)])
        long = np.asarray([f_long.result(timeout=120)])
    assert elastic.counters().get("preempted", 0) - before >= 1
    assert done_order[0] == "hi", done_order
    assert hi.tobytes() == golden[hi_bits].tobytes()
    assert long.tobytes() == golden[long_bits].tobytes()
    assert svc.stats()["counts"]["failed"] == 0


def test_preemption_exhausted(bounds, tmp_path, monkeypatch):
    port, _ = bounds
    monkeypatch.setenv("TNC_TPU_CKPT_EVERY", "1")
    det = [port.template.request_bits("00000011")]
    with pytest.raises(elastic.PreemptionExhaustedError):
        elastic.preemptible_amplitudes(port, det, NumpyBackend(), ckpt=str(tmp_path / "ckpt"),
                                       should_yield=lambda cursor: True, max_yields=2)


def test_no_preemption_without_slice_hooks(bounds, tmp_path):
    """A backend without slice hooks (``TorchBackend``, here on the CPU)
    never calls the gate: the contraction runs through, as in the
    reference's ``JaxBackend`` path."""
    from tnc_tpu_torch.ops.backends import TorchBackend

    port, _ = bounds
    det = [port.template.request_bits("00000011")]
    backend = TorchBackend(device="cpu")
    calls = []
    got = elastic.preemptible_amplitudes(port, det, backend, ckpt=str(tmp_path / "ckpt"),
                                         should_yield=lambda c: calls.append(c) or True)
    assert calls == [] and got.tobytes() == port.amplitudes_det(det, backend).tobytes()


DECISIONS = [  # (t, queue_depth, live, burn)
    (0.0, 10, 1, 0.0), (1.0, 10, 2, 0.0), (20.0, 0, 2, 0.0), (40.0, 0, 1, 0.0),
    (40.0, 0, 3, 5.0), (60.0, 0, 2, 5.0), (61.0, 2, 2, 0.5), (90.0, 3, 3, 0.0),
    (120.0, 8, 3, 0.0), (150.0, 0, 0, 0.0)]


def test_controller_decisions_equal_the_reference():
    got = []
    for module in (elastic, ref_elastic):
        clk = {"t": 0.0}
        ctrl = module.ElasticController(min_replicas=1, max_replicas=3, scale_up_depth=4,
                                        scale_down_depth=0, burn_threshold=2.0,
                                        cooldown_s=10.0, clock=lambda clk=clk: clk["t"])
        seen = []
        ctrl.on_decision.append(seen.append)
        ctrl.on_decision.append(lambda d: 1 / 0)  # must not propagate
        rows = []
        for t, depth, live, burn in DECISIONS:
            clk["t"] = t
            rows.append(ctrl.decide(depth, live, burn))
        assert seen == rows and ctrl.last_decision == rows[-1]
        got.append(rows)
    assert got[0] == got[1]
    assert [r["action"] for r in got[0][:3]] == ["scale_up", "hold", "scale_down"]


@pytest.mark.parametrize("stats", [
    None, {}, {"objectives": [{"windows": [{"burn_long": 3.5}, {"burn_long": 1.0}]},
                              {"windows": [{"burn_long": "junk"}]}]},
    {"objectives": [{"windows": None}]}])
def test_burn_from_slo_equals_the_reference(stats):
    assert (elastic.ElasticController.burn_from_slo(stats)
            == ref_elastic.ElasticController.burn_from_slo(stats))


def test_service_elastic_check_uses_the_controller(bounds):
    port, _ = bounds
    clk = {"t": 0.0}
    ctrl = elastic.ElasticController(scale_up_depth=1, cooldown_s=0.0, clock=lambda: clk["t"])
    svc = _parked(port)
    svc.enable_elastic(elastic.ElasticConfig(), controller=ctrl)
    assert svc.elastic_check() is not None  # before start: an empty queue
    svc.start()
    try:
        svc.submit("0" * 8)
        decision = svc.elastic_check()
        assert decision["action"] == "scale_up"
        assert svc.stats()["elastic"]["controller"] == decision
    finally:
        svc.stop(drain=False)


def test_local_autoscaler_workers_join_and_leave(tmp_path):
    fleet = str(tmp_path / "fleet")
    observer = FleetRegistry(fleet, name="observer")

    def wait_for(pred, timeout=60.0):
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            live = elastic.live_processes(observer, 8, root=0)
            if pred(live):
                return live
            time.sleep(0.1)
        return elastic.live_processes(observer, 8, root=0)

    with elastic.LocalAutoscaler(fleet, base_process=1, interval_s=0.2) as auto:
        assert auto.scale_to(2) == 2
        live = wait_for(lambda s: {1, 2} <= s)
        assert {0, 1, 2} <= live, live
        assert auto.apply({"action": "scale_down"}) == 1
        live = wait_for(lambda s: 2 not in s)
        assert 2 not in live and 1 in live, live
        assert auto.apply({"action": "hold"}) == 1
    assert auto.count() == 0
    assert wait_for(lambda s: s == {0}) == {0}  # SIGTERM: a clean leave
    assert elastic.main.__module__ == "tnc_tpu_torch.serve.elastic"


def test_stats_and_prometheus_families(bounds):
    port, _ = bounds
    elastic.count_event("reassigned")
    svc = _parked(port)
    svc.enable_elastic(elastic.ElasticConfig(tenant_weights={"b": 2.0}, tenant_quotas={"b": 9}),
                       controller=elastic.ElasticController())
    svc.start()
    try:
        svc.submit("0" * 8, tenant="b")
        block = svc.stats()["elastic"]
        assert block["counters"].get("reassigned", 0) >= 1
        assert (block["tenants"], block["weights"], block["quotas"]) == (
            {"b": 1}, {"b": 2.0}, {"b": 9})
        fams = svc._prometheus_families()
        names = {name for (_kind, name, _labels, _v) in fams}
        assert {"serve.elastic.events", "serve.elastic.tenant_queue",
                "serve.elastic.scale_target"} <= names
        assert {labels["tenant"]: v for (_k, name, labels, v) in fams
                if name == "serve.elastic.tenant_queue"} == {"b": 1.0}
        from tnc_tpu_torch.obs.http import render_prometheus

        text = render_prometheus(None, fams)
        assert 'tnc_tpu_serve_elastic_tenant_queue{tenant="b"} 1' in text
    finally:
        svc.stop(drain=False)


def test_counters_round_trip():
    before = elastic.counters().get("__test__", 0)
    elastic.count_event("__test__")
    elastic.count_event("__test__", 2)
    assert elastic.counters()["__test__"] == before + 3


def test_dispatcher_alone_runs_locally(bounds):
    """Without a process group the dispatcher runs the batch locally and
    leaves ``last_ranges`` in its no-registry state, as the reference's."""
    port, ref = bounds
    d = port_serve.ClusterDispatcher()
    det = [port.template.request_bits("0" * 8)]
    out = d(port, det, NumpyBackend())
    want = ref_serve.ClusterDispatcher()(ref, [ref.template.request_bits("0" * 8)],
                                         RefNumpyBackend())
    assert out.tobytes() == want.tobytes() and d.last_ranges is None
    d.stop()
    with pytest.raises(port_serve.DispatcherStoppedError):
        d(port, det, NumpyBackend())


def test_round_ranges_leave_out_a_stale_live_member_as_the_reference(tmp_path):
    """The roster-aware placement alone, with no process lost: a worker
    whose heartbeat went stale (its process alive) gets ``(0, 0)`` and
    work again once it beats; the ranges equal the reference dispatcher's
    on the same registry directory, judged by the registry's
    ``stale_after_s``."""
    worker = FleetRegistry(tmp_path, name="p1")
    port = port_serve.ClusterDispatcher(
        registry=FleetRegistry(tmp_path, name="p0", stale_after_s=0.5))
    ref = ref_serve.ClusterDispatcher(
        registry=RefFleetRegistry(tmp_path, name="p0", stale_after_s=0.5))
    bits = ["0" * 8] * 5
    seen = []
    for step in ("live", "stale", "recovered"):
        if step == "stale":
            time.sleep(0.7)
        else:
            worker.heartbeat({"process": 1})
        seen.append([d._round_ranges("bras", None, bits, 2) for d in (port, ref)])
    assert seen == [[[(0, 3), (3, 5)]] * 2, [[(0, 5), (0, 0)]] * 2, [[(0, 3), (3, 5)]] * 2]
    assert not port.lost


@pytest.mark.parametrize("module", ["elastic", "multihost"])
def test_doctests(module):
    import doctest

    import tnc_tpu_torch.serve.multihost as multihost

    assert doctest.testmod({"elastic": elastic, "multihost": multihost}[module]).failed == 0
