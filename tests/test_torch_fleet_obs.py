"""The port's fleet observability plane (``tnc_tpu_torch.obs.fleet``)
against the JAX package's ``tnc_tpu.obs.fleet`` on the CPU (the
counterpart of ``tests/test_fleet_obs.py``).

- ``TraceContext``'s broadcast form, ``dispatch_context`` and
  ``adopt_trace_context`` give the reference's dicts and span args;
- ``FleetRegistry``'s join / stale / recover / reap cycle counts the
  reference's transitions on the same clock; corrupt entries are dropped;
  a ``Heartbeat`` keeps its cadence through provider errors and retires;
- ``merge_fleet_metrics`` and the series-label helpers equal the
  reference's on the same inputs (a hypothesis property over random
  snapshots), ``FleetAggregator`` federates local, value and unreachable
  sources as the reference does;
- the flight recorder dumps on SIGKILL (its periodic flush) and on SIGTERM
  (termination preserved), in a subprocess, as the reference's does; the
  obs package re-exports the plane lazily.

Process identity here is one process (no process group).
"""

import json
import os
import signal
import socket
import subprocess
import sys
import time

import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

import tnc_tpu.obs as ref_obs
import tnc_tpu.obs.fleet as ref_fleet
import tnc_tpu_torch.obs as obs
import tnc_tpu_torch.obs.fleet as fleet
from tnc_tpu.obs.core import MetricsRegistry as RefRegistry
from tnc_tpu_torch.obs.core import MetricsRegistry

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def enabled_obs():
    reg = obs.configure(enabled=True, registry=MetricsRegistry())
    ref_reg = ref_obs.configure(enabled=True, registry=RefRegistry())
    try:
        yield reg, ref_reg
    finally:
        obs.configure(enabled=False, registry=MetricsRegistry())
        ref_obs.configure(enabled=False, registry=RefRegistry())


def test_trace_context_round_trip_equals_the_reference():
    kw = dict(riders="r1,r2,r3", kind="marginal", generation=4, seq=17,
              root_process=0, root_pid=1234)
    ctx = fleet.TraceContext(**kw)
    assert ctx.to_obj() == ref_fleet.TraceContext(**kw).to_obj()
    assert fleet.TraceContext.from_obj(ctx.to_obj()) == ctx
    # a reference root's command decodes on a port worker
    assert fleet.TraceContext.from_obj(ref_fleet.TraceContext(**kw).to_obj()) == ctx


@pytest.mark.parametrize("junk", [None, "nope", ["r1"], {"riders": "r9", "future_field": 1},
                                  {"seq": None, "generation": ""}])
def test_trace_context_from_junk_as_the_reference(junk):
    got, want = fleet.TraceContext.from_obj(junk), ref_fleet.TraceContext.from_obj(junk)
    assert (got is None) == (want is None)
    if got is not None:
        assert got.to_obj() == want.to_obj()


def test_dispatch_context_is_thread_local_and_restores():
    import threading

    assert fleet.current_dispatch_context() is None
    with fleet.dispatch_context(riders="r7,r8", kind="amplitude", generation=2) as ctx:
        assert fleet.current_dispatch_context() is ctx
        assert ctx.riders == "r7,r8" and ctx.root_pid == os.getpid()
        seen = []
        t = threading.Thread(target=lambda: seen.append(fleet.current_dispatch_context()))
        t.start()
        t.join(10)
        assert seen == [None]
        with fleet.dispatch_context(riders="r9") as inner:
            assert fleet.current_dispatch_context() is inner
        assert fleet.current_dispatch_context() is ctx
    assert fleet.current_dispatch_context() is None


def test_adopted_context_rides_every_span_as_the_reference(enabled_obs):
    reg, ref_reg = enabled_obs
    kw = dict(riders="r1,r2", kind="amplitude", generation=3, seq=5)
    for package, o, r in ((fleet, obs, reg), (ref_fleet, ref_obs, ref_reg)):
        with package.adopt_trace_context(package.TraceContext(**kw)):
            with o.span("serve.dispatch", remote=1):
                with o.span("partitioned.local_phase"):
                    pass
            with o.span("x", riders="override"):
                pass
        with package.adopt_trace_context(None):
            with o.span("plain"):
                pass
    rows = [[(s.name, s.args) for s in r.span_records()] for r in (reg, ref_reg)]
    assert rows[0] == rows[1]
    args = dict(rows[0])
    assert args["partitioned.local_phase"]["riders"] == "r1,r2"
    assert args["partitioned.local_phase"]["seq"] == 5
    assert args["x"]["riders"] == "override" and "riders" not in args["plain"]


def test_replica_identity_from_the_process_probe():
    ident = fleet.replica_identity()
    assert ident["pid"] == os.getpid() and ident["host"] == socket.gethostname()
    assert ident["process"] == 0 and ident["process_count"] == 1
    assert sorted(ident) == sorted(ref_fleet.replica_identity())
    assert fleet.replica_name(ident) == "p0" == ref_fleet.replica_name({"process": 0})
    assert fleet.replica_name({"process": 3}) == ref_fleet.replica_name({"process": 3})
    assert obs.replica_name is fleet.replica_name  # a lazy re-export


def test_registry_join_stale_recover_reap_cycle_as_the_reference(enabled_obs, tmp_path):
    views = []
    for package, o, sub in ((fleet, obs, "port"), (ref_fleet, ref_obs, "ref")):
        d = tmp_path / sub
        writer = package.FleetRegistry(d, name="w1", stale_after_s=0.5)
        reader = package.FleetRegistry(d, name="r0", stale_after_s=0.5)
        writer.heartbeat({"queue_depth": 3})
        steps = [reader.roster()]
        time.sleep(0.7)
        steps.append(reader.roster())
        writer.heartbeat({"queue_depth": 0})
        steps.append(reader.roster())
        time.sleep(0.7)
        reaped = reader.reap(reap_after_s=0.5)
        steps.append(reader.roster())
        views.append((
            [(s["live"], s["stale"], s["transitions"],
              [(r["name"], r["state"], r["payload"]) for r in s["replicas"]]) for s in steps],
            reaped, o.counters_by_prefix("fleet.replica.")))
    assert views[0] == views[1]
    steps, reaped, counters = views[0]
    assert steps[0][2]["joined"] == 1 and steps[1][2]["went_stale"] == 1
    assert steps[2][2]["recovered"] == 1 and reaped == ["w1"] and steps[3][3] == []
    assert counters["fleet.replica.reaped"] == 1.0


def test_retire_is_a_clean_leave(enabled_obs, tmp_path):
    writer = fleet.FleetRegistry(tmp_path, name="w1")
    reader = fleet.FleetRegistry(tmp_path, name="r0")
    writer.heartbeat()
    assert reader.roster()["live"] == 1
    writer.retire()
    roster = reader.roster()
    assert roster["replicas"] == [] and roster["transitions"]["left"] == 1


def test_corrupt_entry_dropped_not_raised(enabled_obs, tmp_path):
    fleet.FleetRegistry(tmp_path, name="ok").heartbeat()
    (tmp_path / "hb-bad.json").write_text("{not json", encoding="utf-8")
    (tmp_path / "hb-list.json").write_text("[1, 2]", encoding="utf-8")
    names = [r["name"] for r in fleet.FleetRegistry(tmp_path, name="r0").roster()["replicas"]]
    assert names == ["ok"]
    assert not (tmp_path / "hb-bad.json").exists() and not (tmp_path / "hb-list.json").exists()
    assert obs.counters_by_prefix("fleet.registry.") == {
        "fleet.registry.corrupt_dropped": 2.0}


def test_heartbeat_cadence_survives_provider_errors(enabled_obs, tmp_path):
    registry = fleet.FleetRegistry(tmp_path, name="w1")
    calls = []

    def provider():
        calls.append(1)
        if len(calls) == 2:
            raise RuntimeError("stats hook broke")
        return {"queue_depth": len(calls)}

    hb = fleet.Heartbeat(registry, provider=provider, interval_s=0.05).start()
    try:
        deadline = time.monotonic() + 5
        while len(calls) < 3 and time.monotonic() < deadline:
            time.sleep(0.02)
        assert len(calls) >= 3, "heartbeat cadence stalled"
    finally:
        hb.stop()
    counters = obs.counters_by_prefix("fleet.heartbeat")
    assert counters["fleet.heartbeat.provider_errors"] == 1.0
    assert counters["fleet.heartbeats"] >= 3.0
    assert list(tmp_path.glob("hb-*.json")) == []


def test_last_heartbeat_age(tmp_path):
    reg = fleet.FleetRegistry(tmp_path, name="w1")
    assert reg.last_heartbeat_age_s() is None
    reg.heartbeat()
    assert 0.0 <= reg.last_heartbeat_age_s() < 5.0


MERGE_CASES = [
    ({"p1": {"x_total": 0.3, 'y_total{type="a"}': 1.0},
      "p0": {"x_total": 0.1, 'y_total{type="a"}': 2.0}, "p2": {"x_total": 0.2}},
     {"x_total": "counter", "y_total": "counter"}),
    ({"p0": {"x_total": 2.0}, "w1": {'x_total{replica="w1"}': 3.0}}, {"x_total": "counter"}),
    ({"p0": {"depth": 1.0}, "p1": {"depth": 4.0}}, {"depth": "gauge"}),
    ({"p0": {'lat{quantile="0.99",type="amplitude"}': 0.010},
      "p1": {'lat{quantile="0.99",type="amplitude"}': 0.030}}, {"lat": "summary"}),
    ({"p0": {"a_total": 1.0, "b": 2.0}, "p1": {"a_total": 2.0, "b": 3.0}}, None),
]


@pytest.mark.parametrize("per, types", MERGE_CASES)
def test_merge_fleet_metrics_equals_the_reference(per, types):
    got = fleet.merge_fleet_metrics(per, types)
    assert json.dumps(got, sort_keys=True) == json.dumps(
        ref_fleet.merge_fleet_metrics(per, types), sort_keys=True)
    assert "pooled" not in json.dumps(got)


_names = st.sampled_from(["x_total", "y_total", "depth", "lat", "lat_count"])
_labels = st.sampled_from(["", '{type="a"}', '{replica="w1"}', '{quantile="0.5"}',
                           '{replica="w2",type="b"}', '{quantile="0.99",type="a"}'])
_snapshot = st.dictionaries(st.tuples(_names, _labels).map("".join),
                            st.floats(-1e6, 1e6, allow_nan=False), max_size=6)


@given(st.dictionaries(st.sampled_from(["p0", "p1", "w3", "root"]), _snapshot, max_size=4),
       st.sampled_from([None, {"x_total": "counter", "lat": "summary", "depth": "gauge"}]))
@settings(max_examples=80, deadline=None)
def test_merge_fleet_metrics_property_equals_the_reference(per, types):
    got = fleet.merge_fleet_metrics(per, types)
    assert json.dumps(got, sort_keys=True) == json.dumps(
        ref_fleet.merge_fleet_metrics(per, types), sort_keys=True)


@pytest.mark.parametrize("series", ["x", 'x{type="a"}', 'x{replica="w1",type="a"}',
                                    'x{replica="w1"}', 'x{type="a",replica="w1"}'])
def test_series_label_helpers_equal_the_reference(series):
    assert fleet._series_with_replica(series, "p0") == ref_fleet._series_with_replica(series, "p0")
    assert fleet._series_without_replica(series) == ref_fleet._series_without_replica(series)


def test_aggregator_federates_sources_as_the_reference(tmp_path):
    """Local render, heartbeat counters and an endpoint that cannot be
    scraped (no scheme: nothing leaves the host) give the reference's
    body."""
    from tnc_tpu.obs.http import render_prometheus as ref_render
    from tnc_tpu_torch.obs.http import render_prometheus

    bodies = []
    for package, render, sub in ((fleet, render_prometheus, "port"),
                                 (ref_fleet, ref_render, "ref")):
        reg = package.FleetRegistry(tmp_path / sub, name="p0")
        package.FleetRegistry(tmp_path / sub, name="w1").heartbeat(
            {"counters": {"x_total": 2.0}})
        local = ("p0", lambda render=render: render(
            None, [("counter", "x", {}, 3.0), ("gauge", "depth", {}, 1.0)]))
        agg = package.FleetAggregator(endpoints=["nowhere"], registry=reg, local=local)
        body = agg.snapshot()
        body["roster"] = [(r["name"], r["state"]) for r in body["roster"]["replicas"]]
        body["unreachable"] = sorted(body["unreachable"])
        bodies.append(json.dumps(body, sort_keys=True))
    assert bodies[0] == bodies[1]
    body = json.loads(bodies[0])
    assert body["counters"]["x_total"] == 2.0 and body["unreachable"] == ["replica0"]


FLIGHT_CHILD = """
import sys, time
import tnc_tpu_torch.obs as obs
obs.refresh_from_env()
obs.counter_add("crash.widgets", 41)
with obs.span("crash.outer", stage=1):
    with obs.span("crash.inner"):
        pass
obs.counter_add("crash.widgets", 1)
print("ARMED", flush=True)
time.sleep(120)
"""


def _spawn_flight(directory):
    env = dict(os.environ, TNC_TPU_TRACE="1", TNC_TPU_FLIGHT_RECORDER=str(directory),
               TNC_TPU_FLIGHT_INTERVAL="0.1")
    proc = subprocess.Popen([sys.executable, "-c", FLIGHT_CHILD], stdout=subprocess.PIPE,
                            text=True, env=env, cwd=REPO)
    line = proc.stdout.readline().strip()
    assert line == "ARMED", f"flight child never armed: {line!r}"
    return proc


def _flight_dump(directory):
    dumps = [f for f in os.listdir(directory) if f.startswith("flight-") and f.endswith(".json")]
    assert len(dumps) == 1, f"flight dumps {os.listdir(directory)}"
    with open(os.path.join(directory, dumps[0]), encoding="utf-8") as fh:
        return json.load(fh)


def test_flight_recorder_dump_survives_sigkill(tmp_path):
    """SIGKILL cannot be caught; the periodic flush leaves a dump at most
    one interval stale, with the reference's keys."""
    proc = _spawn_flight(tmp_path)
    try:
        time.sleep(0.6)  # > the flush interval: the ring reached the disk
        proc.send_signal(signal.SIGKILL)
        proc.wait(timeout=30)
    finally:
        if proc.poll() is None:
            proc.kill()
    assert proc.returncode == -signal.SIGKILL
    doc = _flight_dump(tmp_path)
    assert sorted(doc) == ["context", "counters", "dropped_spans", "dumps", "gauges",
                           "name", "reason", "replica", "spans", "written_unix"]
    assert doc["counters"]["crash.widgets"] == 42.0 and doc["replica"]["pid"] == proc.pid
    assert {"crash.outer", "crash.inner"} <= {s["name"] for s in doc["spans"]}
    outer = [s for s in doc["spans"] if s["name"] == "crash.outer"][0]
    assert outer["args"] == {"stage": 1}


def test_flight_recorder_dumps_on_sigterm_and_still_terminates(tmp_path):
    proc = _spawn_flight(tmp_path)
    try:
        proc.send_signal(signal.SIGTERM)
        proc.wait(timeout=30)
    finally:
        if proc.poll() is None:
            proc.kill()
    assert proc.returncode == -signal.SIGTERM  # the disposition is preserved
    doc = _flight_dump(tmp_path)
    assert doc["reason"] in ("sigterm", "atexit", "periodic")
    assert doc["counters"]["crash.widgets"] == 42.0


def test_flight_recorder_in_process_dump_equals_the_reference(enabled_obs, tmp_path):
    docs = []
    for package, o, sub in ((fleet, obs, "port"), (ref_fleet, ref_obs, "ref")):
        o.counter_add("fr.unit", 7)
        with o.span("fr.span", k=1):
            pass
        package.set_flight_annotation(model_version=3)
        try:
            fr = package.FlightRecorder(tmp_path / sub, capacity=8, flush_interval_s=60)
            path = fr.dump("unit-test")
            with open(path, encoding="utf-8") as fh:
                doc = json.load(fh)
            fr.install()
            assert fr._installed
            fr.uninstall()
            assert not fr._installed
        finally:
            package.set_flight_annotation(model_version=None)
        docs.append({k: doc[k] for k in ("reason", "counters", "gauges", "context",
                                         "dropped_spans", "name", "dumps")}
                    | {"spans": [(s["name"], s["args"]) for s in doc["spans"]]})
    assert docs[0] == docs[1]
    assert docs[0]["context"] == {"model_version": 3}
    assert fleet.flight_annotations() == {}


def test_recent_spans_as_the_reference(enabled_obs):
    reg, ref_reg = enabled_obs
    for o in (obs, ref_obs):
        for i in range(5):
            with o.span(f"s{i}"):
                pass
    for n in (0, 1, 3, 9):
        assert ([r.name for r in reg.recent_spans(n)]
                == [r.name for r in ref_reg.recent_spans(n)])


def test_fleet_names_re_export_lazily():
    code = ("import sys, tnc_tpu_torch.obs as o; "
            "assert 'tnc_tpu_torch.obs.fleet' not in sys.modules; "
            "o.FleetRegistry; assert 'tnc_tpu_torch.obs.fleet' in sys.modules; "
            "assert 'torch.distributed' not in sys.modules")
    env = {k: v for k, v in os.environ.items() if k != "TNC_TPU_FLIGHT_RECORDER"}
    subprocess.run([sys.executable, "-c", code], check=True, cwd=REPO, env=env, timeout=120)
    assert sorted(obs._FLEET_EXPORTS) == sorted(ref_obs._FLEET_EXPORTS)


def test_doctests():
    import doctest

    assert doctest.testmod(fleet).failed == 0
