"""The port's trace export, telemetry endpoint and SLO engine
(``tnc_tpu_torch.obs.core``'s trace path and profiler knob,
``tnc_tpu_torch.obs.export``, ``tnc_tpu_torch.obs.http``,
``tnc_tpu_torch.obs.slo``) against the JAX package on the CPU.

- ``process_trace_path`` gives the reference's answers; the port's probe
  reads ``torch.distributed`` (a gloo group of one process keeps the
  path); ``TNC_TPU_TRACE=<path>`` writes the Chrome trace at exit;
  ``maybe_jax_profiler_trace`` runs a ``torch.profiler`` trace into
  ``TNC_TPU_TRACE_JAX`` and is a no-op without it.
- ``chrome_trace_events``, ``trace_summary``, ``serve_trace_rollup``,
  ``export_jsonl``, ``merge_trace_files`` and ``render_prometheus`` give
  the reference's output from registries fed the same records;
  ``TelemetryServer`` serves ``/metrics``, ``/healthz``, ``/slo``,
  ``/calibration`` and ``/fleet`` on port 0 over loopback and releases
  the port when it stops.
- ``SLOEngine`` and ``DriftDetector`` give the reference's ``stats()``,
  ``burn_rates()`` and ``check()`` for the same event sequence under an
  injected clock; a service with queries excludes the same kinds from
  drift (``drift_stable``) as the reference's.

Configurations: ``sycamore_circuit(12, 4)`` (rng 42); every service stops
in a ``with`` block and every wait has a timeout.
"""

import doctest
import json
import os
import socket
import subprocess
import sys
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

import tnc_tpu.obs.core as ref_core
import tnc_tpu.obs.export as ref_export
import tnc_tpu.obs.http as ref_http
import tnc_tpu.obs.slo as ref_slo
import tnc_tpu.resilience.retry as ref_retry
import tnc_tpu_torch.obs.core as port_core
import tnc_tpu_torch.obs.export as port_export
import tnc_tpu_torch.obs.http as port_http
import tnc_tpu_torch.obs.slo as port_slo
import tnc_tpu_torch.resilience.retry as port_retry
from tnc_tpu.builders.sycamore_circuit import sycamore_circuit as ref_sycamore
from tnc_tpu.ops.backends import NumpyBackend as RefNumpyBackend
from tnc_tpu.serve.service import ContractionService as RefService
from tnc_tpu_torch.builders.sycamore_circuit import sycamore_circuit
from tnc_tpu_torch.ops.backends import NumpyBackend
from tnc_tpu_torch.serve import ContractionService

Q, M = 12, 4
WAIT = 30
BITS = ["".join(str(int(b)) for b in row)
        for row in np.random.default_rng(5).integers(0, 2, (6, Q))]


@pytest.fixture(autouse=True)
def quick_retries():
    for mod in (port_retry, ref_retry):
        mod.configure_retry(mod.RetryPolicy(max_attempts=3, base_delay_s=0.0))
    yield
    for mod in (port_retry, ref_retry):
        mod.configure_retry(None)


@pytest.fixture
def gates(monkeypatch):
    """Both packages' obs module state, restored after the test; no export
    armed at exit."""
    for module in (port_core, ref_core):
        for name in ("_ENABLED", "_STEP_TIME", "_REGISTRY", "_TRACE_PATH"):
            monkeypatch.setattr(module, name, getattr(module, name))
        monkeypatch.setattr(module, "_ATEXIT_REGISTERED", True)
    monkeypatch.delenv("TNC_TPU_FLIGHT_RECORDER", raising=False)
    return monkeypatch


# --- obs core: trace paths, the probe, the exit export, the profiler ----------


@pytest.mark.parametrize("path, index, count", [
    ("/tmp/t.json", 0, 1), ("/tmp/t.json", 2, 4), ("/tmp/run/trace", 1, 2),
    ("trace.json", 3, 8), ("a.b.json", 0, 2), ("/tmp/t.json", 5, 1)])
def test_process_trace_path_matches_reference(path, index, count):
    assert port_core.process_trace_path(path, index, count) == \
        ref_core.process_trace_path(path, index, count)


def test_probe_without_a_process_group_keeps_the_path():
    assert port_core.process_identity() == (1, 0)
    assert port_core.process_trace_path("/tmp/t.json") == "/tmp/t.json" == \
        ref_core.process_trace_path("/tmp/t.json")


def _free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def test_probe_reads_a_gloo_group_of_one_process():
    import torch.distributed as dist

    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{_free_port()}",
                            rank=0, world_size=1)
    try:
        assert port_core.process_identity() == (1, 0)
        assert port_core.process_trace_path("/tmp/t.json") == "/tmp/t.json"
        from tnc_tpu_torch.obs import fleet as port_fleet  # the identity's home

        assert port_fleet.replica_identity()["process_count"] == 1
        assert port_fleet.replica_name() == "p0"
    finally:
        dist.destroy_process_group()
    assert port_core.process_identity() == (1, 0)


@pytest.mark.parametrize("value, records, path_set", [
    ("1", True, False), ("on", True, False), ("0", False, False),
    ("trace.json", True, True)])
def test_trace_env_sets_the_export_path_as_the_reference(gates, tmp_path, value, records,
                                                          path_set):
    raw = str(tmp_path / value) if value.endswith(".json") else value
    for core in (port_core, ref_core):
        gates.setattr(core, "_TRACE_PATH", None)
        gates.setenv("TNC_TPU_TRACE", raw)
        assert core.refresh_from_env() is records
        assert core.trace_path() == (raw if path_set else None)


def test_trace_env_path_writes_the_chrome_trace_at_exit(tmp_path):
    path = tmp_path / "exit.json"
    code = ("from tnc_tpu_torch import obs\n"
            "with obs.span('plan.demo', flops=8):\n"
            "    obs.counter_add('serve.requests', 2)\n")
    env = {**os.environ, "TNC_TPU_TRACE": str(path)}
    subprocess.run([sys.executable, "-c", code], env=env, check=True, timeout=120,
                   cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    doc = json.loads(path.read_text())
    names = [e["name"] for e in doc["traceEvents"] if e["ph"] == "B"]
    assert names == ["plan.demo"]
    assert doc["otherData"]["counters"]["serve.requests"] == 2.0
    assert doc["otherData"]["replica"]["process_count"] == 1


def test_profiler_knob_writes_a_torch_trace(tmp_path, monkeypatch):
    monkeypatch.setenv("TNC_TPU_TRACE_JAX", str(tmp_path / "prof"))
    with port_core.maybe_jax_profiler_trace() as prof:
        with port_core.maybe_jax_profiler_trace() as inner:  # never nests
            (torch.ones(8, 8) @ torch.ones(8, 8)).sum()
    assert inner.path is None
    assert prof.path is not None and os.path.dirname(prof.path) == str(tmp_path / "prof")
    doc = json.loads(open(prof.path).read())
    assert doc["traceEvents"]
    monkeypatch.delenv("TNC_TPU_TRACE_JAX")
    with port_core.maybe_jax_profiler_trace() as off:
        pass
    assert off.path is None


# --- export -------------------------------------------------------------------


def _fed(core_mod, records, counters=(), gauges=(), observed=()):
    """A registry of ``core_mod`` holding the same span records and
    metrics; the epoch anchors pinned so that both packages' exports
    agree."""
    reg = core_mod.MetricsRegistry()
    reg.epoch_unix_ns = 1_700_000_000_000_000_000
    for rec in records:
        reg._spans.append(core_mod.SpanRecord(**rec))
    for name, value, labels in counters:
        reg.counter_add(name, value, **labels)
    for name, value, labels in gauges:
        reg.gauge_set(name, value, **labels)
    for name, value, labels in observed:
        reg.observe(name, value, **labels)
    return reg


def _records():
    pid = os.getpid()
    recs = []
    t = 1_000_000
    for i in range(3):
        rid = f"r{2 * i + 1}"
        recs.append(dict(name="serve.dispatch", start_ns=t, dur_ns=4_000_000, pid=pid,
                         tid=11, thread_name="tnc-serve-dispatch", depth=0,
                         args={"batch": 2, "kind": "amplitude",
                               "riders": f"{rid},r{2 * i + 2}", "generation": i}))
        for j, r in enumerate((rid, f"r{2 * i + 2}")):
            recs.append(dict(name="serve.request", start_ns=t + 4_001_000 + j, dur_ns=0,
                             pid=pid, tid=11, thread_name="tnc-serve-dispatch", depth=0,
                             args={"rid": r, "type": "amplitude", "outcome": "completed",
                                   "latency_s": 0.005 + 0.001 * i, "queue_age_s": 0.001,
                                   "batch_wait_s": 0.0, "dispatch_s": 0.004, "riders": 2,
                                   "generation": i}))
        recs.append(dict(name="plan.find_path", start_ns=t + 5_000_000, dur_ns=2_000_000,
                         pid=pid, tid=7, thread_name="MainThread", depth=0,
                         args={"finder": "Greedy", "tensors": 40, "predicted_flops": 1e6}))
        recs.append(dict(name="sliced.prelude", start_ns=t + 5_500_000, dur_ns=500_000,
                         pid=pid, tid=7, thread_name="MainThread", depth=1,
                         args={"flops": 64.0, "bytes": 128.0}))
        t += 10_000_000
    return recs


METRICS = dict(
    counters=[("serve.requests", 3.0, {"outcome": "completed"}),
              ("serve.requests", 1.0, {"outcome": 'fa"il\\ed\n'}),
              ("resilience.retry.attempts", 2.0, {"site": "backend.dispatch"})],
    gauges=[("serve.queue_depth", 4.0, {}), ("hbm_peak_bytes", 2.0 ** 29, {})],
    observed=[("serve.latency_s", v, {}) for v in (0.1, 0.2, 0.05, 0.4)]
    + [("step_ms", 1.5, {"kind": "gauss"})])


def _pair(with_metrics=True):
    kw = METRICS if with_metrics else {}
    return (_fed(port_core, _records(), **kw), _fed(ref_core, _records(), **kw))


def test_chrome_trace_events_match_reference():
    port, ref = _pair()
    assert port_export.chrome_trace_events(port) == ref_export.chrome_trace_events(ref)


@pytest.mark.parametrize("fn", ["trace_summary", "serve_trace_rollup"])
def test_summaries_match_reference(fn):
    port, ref = _pair()
    events = port_export.chrome_trace_events(port)
    assert getattr(port_export, fn)(events) == getattr(ref_export, fn)(events)


@pytest.mark.parametrize("fn, arg", [("format_serve_rollup", "serve_trace_rollup"),
                                     ("format_summary_table", "trace_summary")])
def test_formatters_match_reference(fn, arg):
    events = port_export.chrome_trace_events(_pair()[0])
    rows = getattr(ref_export, arg)(events)
    assert getattr(port_export, fn)(rows) == getattr(ref_export, fn)(rows)


def test_serve_rollup_attributes_every_dispatch():
    rollup = port_export.serve_trace_rollup(port_export.chrome_trace_events(_pair()[0]))
    assert len(rollup["requests"]) == 6
    assert rollup["attributed_share"] == 1.0
    assert rollup["by_type"]["amplitude"]["dispatches"] == 3


def test_exported_files_load_and_merge_as_the_reference(tmp_path):
    port, ref = _pair()
    a = port_export.export_chrome_trace(str(tmp_path / "port.json"), port)
    b = ref_export.export_chrome_trace(str(tmp_path / "ref.json"), ref)
    doc_a, doc_b = json.loads(open(a).read()), json.loads(open(b).read())
    assert doc_a["traceEvents"] == doc_b["traceEvents"]
    assert doc_a["otherData"]["replica"] == doc_b["otherData"]["replica"]
    assert port_export.load_trace_events(a) == ref_export.load_trace_events(b)
    # a file either package wrote merges in the other
    assert port_export.merge_trace_files([a, b]) == ref_export.merge_trace_files([a, b])


def test_jsonl_matches_reference(tmp_path):
    port, ref = _pair()
    a = port_export.export_jsonl(str(tmp_path / "port.jsonl"), port)
    b = ref_export.export_jsonl(str(tmp_path / "ref.jsonl"), ref)
    assert open(a).read() == open(b).read()


def test_emit_metrics_counts_as_the_reference():
    port, ref = _pair()
    assert port_export.emit_metrics(registry=port) == ref_export.emit_metrics(registry=ref)


# --- http ---------------------------------------------------------------------


EXTRA = [("counter", "serve.requests", {"outcome": "completed"}, 5.0),
         ("gauge", "serve.queue_depth", {}, 2.0),
         ("summary", "serve.latency_seconds", {"quantile": "0.5"}, 0.01)]


@pytest.mark.parametrize("extra, base", [((), None), (EXTRA, None),
                                         (EXTRA, {"replica": "p0"})])
def test_render_prometheus_matches_reference(extra, base):
    port, ref = _pair()
    got = port_http.render_prometheus(port, extra=extra, base_labels=base)
    want = ref_http.render_prometheus(ref, extra=extra, base_labels=base)
    assert got == want
    assert port_http.parse_prometheus(got) == ref_http.parse_prometheus(want)
    assert port_http.parse_prometheus_types(got) == ref_http.parse_prometheus_types(want)


def _get(url: str):
    try:
        with urllib.request.urlopen(url, timeout=WAIT) as resp:
            return resp.status, resp.read()
    except urllib.error.HTTPError as err:
        return err.code, err.read()


def test_telemetry_server_routes_and_port_release():
    reg = _pair()[0]
    health = {"status": "ok"}
    server = port_http.TelemetryServer(
        registry=reg, port=0, health_fn=lambda: dict(health),
        slo_fn=lambda: {"enabled": True, "alerts": []},
        extra_metrics_fn=lambda: EXTRA,
        calibration_fn=lambda: {"enabled": True, "model_version": 3}).start()
    host, port = "127.0.0.1", server.port
    try:
        status, body = _get(f"{server.url}/metrics")
        assert status == 200
        assert port_http.parse_prometheus(body.decode()) == port_http.parse_prometheus(
            port_http.render_prometheus(reg, extra=EXTRA))
        assert _get(f"{server.url}/healthz") == (200, json.dumps(health).encode())
        assert json.loads(_get(f"{server.url}/slo")[1]) == {"enabled": True, "alerts": []}
        assert json.loads(_get(f"{server.url}/calibration")[1])["model_version"] == 3
        assert json.loads(_get(f"{server.url}/fleet")[1]) == {"enabled": False}
        assert _get(f"{server.url}/nothing")[0] == 404
        health["status"] = "stopped"
        assert _get(f"{server.url}/healthz")[0] == 503
    finally:
        server.stop()
    assert port_http.wait_port_released(host, port)


# --- the service's endpoint ---------------------------------------------------


def _circuit(port=True):
    return (sycamore_circuit if port else ref_sycamore)(Q, M, np.random.default_rng(42))


def test_service_telemetry_scrape_matches_stats():
    with ContractionService.from_circuit(_circuit(), backend=NumpyBackend(),
                                         telemetry_port=0) as svc:
        for f in [svc.submit(b) for b in BITS]:
            f.result(timeout=WAIT)
        url, port = svc._telemetry.url, svc._telemetry.port
        metrics = port_http.parse_prometheus(_get(f"{url}/metrics")[1].decode())
        stats = svc.stats()
        health = json.loads(_get(f"{url}/healthz")[1])
        assert json.loads(_get(f"{url}/slo")[1]) == {"enabled": False}
        assert json.loads(_get(f"{url}/calibration")[1]) == {"enabled": False}
    assert metrics['tnc_tpu_serve_requests_total{outcome="completed"}'] == \
        stats["counts"]["completed"] == len(BITS)
    assert metrics["tnc_tpu_serve_latency_seconds_count"] == len(BITS)
    assert health["status"] == "ok" and health["replica"]["process"] == 0
    assert port_http.wait_port_released("127.0.0.1", port)


def test_service_metric_families_match_reference():
    """The port's ``_prometheus_families`` name the reference's families and
    labels, with the same counts, after the same traffic."""
    def families(service_cls, backend, circuit):
        with service_cls.from_circuit(circuit, backend=backend, cost_truth=True) as svc:
            for b in BITS:
                svc.submit(b).result(timeout=WAIT)
            fams = svc._prometheus_families()
        return {(kind, name, tuple(sorted(labels.items()))): value
                for kind, name, labels, value in fams
                if not name.startswith("serve.latency") and "latency" not in name}

    port = families(ContractionService, NumpyBackend(), _circuit())
    ref = families(RefService, RefNumpyBackend(), _circuit(False))
    assert port.keys() == ref.keys()
    counts = [k for k in port if k[0] == "counter"]
    assert {k: port[k] for k in counts} == {k: ref[k] for k in counts}


# --- slo ----------------------------------------------------------------------


class FakeClock:
    def __init__(self, t: float = 1000.0):
        self.t = t

    def __call__(self) -> float:
        return self.t


def _engines(clock, **cfg):
    objectives = cfg.pop("objectives", ("amplitude", 0.05, 0.9))
    windows = cfg.pop("windows", ((10.0, 40.0, 2.0), (30.0, 120.0, 1.5)))
    out = []
    for mod in (port_slo, ref_slo):
        config = mod.SLOConfig(
            objectives=tuple(mod.LatencyObjective(*o) for o in
                             ([objectives] if isinstance(objectives[0], str) else objectives)),
            windows=tuple(mod.BurnWindow(*w) for w in windows), **cfg)
        out.append(mod.SLOEngine(config, clock=clock))
    return out


SEQUENCES = {
    "healthy": [(1.0, "amplitude", 0.01, "completed")] * 20,
    "slow burst": [(1.0, "amplitude", 0.01, "completed")] * 10
    + [(0.5, "amplitude", 0.2, "completed")] * 10,
    "failures": [(0.5, "amplitude", 0.01, "failed"), (0.5, "amplitude", 0.01, "completed"),
                 (0.5, "sample", 0.3, "expired"), (0.5, "amplitude", 0.0, "rejected")] * 5,
    "old bad, new good": [(0.2, "amplitude", 0.5, "completed")] * 10
    + [(6.0, "amplitude", 0.01, "completed")] * 10,
    "thin": [(1.0, "amplitude", 0.5, "completed")] * 3,
}


@pytest.mark.parametrize("name", sorted(SEQUENCES))
def test_slo_engine_matches_reference(name):
    clock = FakeClock()
    port, ref = _engines(clock, objectives=(("amplitude", 0.05, 0.9), ("*", 0.1, 0.8)),
                         min_requests=4)
    snapshots = []
    for dt, kind, lat, outcome in SEQUENCES[name]:
        clock.t += dt
        for eng in (port, ref):
            eng.record_request(kind, lat, outcome, timeline={"kind": kind})
        snapshots.append((port.burn_rates(), ref.burn_rates()))
    for got, want in snapshots:
        assert got == want
    assert port.check() == ref.check()
    assert port.stats() == ref.stats()
    assert port.timelines() == ref.timelines()


@pytest.mark.parametrize("ratios, baseline", [
    ([1.0] * 12, 0), ([1.0] * 8 + [3.0] * 8, 4), ([1.0] * 8 + [0.2] * 8, 4),
    ([2.0] * 16, 0), ([1.0, None] * 8, 4)])
def test_drift_detector_matches_reference(ratios, baseline):
    dets = [mod.DriftDetector(threshold=1.5, alpha=0.3, min_samples=4,
                              baseline_samples=baseline) for mod in (port_slo, ref_slo)]
    for i, r in enumerate(ratios):
        for det in dets:
            if r is None:
                det.update("amplitude/b8", None, 0.01 * (1 + i % 3))
            else:
                det.update("amplitude/b8", 0.01, 0.01 * r)
    assert dets[0].stats() == dets[1].stats()
    assert dets[0].alerting() == dets[1].alerting()


def test_slo_drift_alerts_and_exclusions_match_reference():
    clock = FakeClock()
    port, ref = _engines(clock, drift_min_samples=4, drift_baseline_samples=4)
    for i in range(12):
        clock.t += 0.5
        for eng in (port, ref):
            eng.record_dispatch("amplitude/b8", 0.01, 0.01 if i < 6 else 0.05)
            eng.record_dispatch_excluded("sample/b4")
    assert port.check() == ref.check()
    assert [a["kind"] for a in port.check()] == ["drift"]
    assert port.stats() == ref.stats()


def test_service_slo_drift_exclusions_match_reference():
    """With queries on, sampling and expectation dispatches are counted as
    excluded from drift and marginals and amplitudes are tracked, as the
    reference's service does (``drift_stable``)."""
    def run(service_cls, backend, circuit, slo_mod):
        cfg = slo_mod.SLOConfig(objectives=(slo_mod.LatencyObjective("*", 60.0, 0.9),))
        with service_cls.from_circuit(circuit, backend=backend, queries=True, slo=cfg,
                                      max_batch=4, max_wait_ms=0) as svc:
            svc.amplitude(BITS[0], timeout_s=WAIT)
            svc.sample(2, seed=1, timeout_s=WAIT)
            svc.expectation("z" + "i" * (Q - 1), timeout_s=WAIT)
            svc.marginal("01" + "*" * (Q - 2), timeout_s=WAIT)
            slo = svc.stats()["slo"]
        return slo["drift_excluded"], sorted(slo["drift"]), slo["outcomes"]

    port = run(ContractionService, NumpyBackend(), _circuit(), port_slo)
    ref = run(RefService, RefNumpyBackend(), _circuit(False), ref_slo)
    assert port == ref
    assert port[0] == {"sample/b1": 1, "expectation/b1": 1}
    assert port[1] == ["amplitude/b1", "marginal/b1"]


def test_service_burn_alert_on_slow_requests():
    from tnc_tpu_torch.resilience import faults

    cfg = port_slo.SLOConfig(objectives=(port_slo.LatencyObjective("amplitude", 0.05, 0.9),),
                             windows=(port_slo.BurnWindow(60.0, 120.0, 2.0),),
                             min_requests=4)
    with ContractionService.from_circuit(_circuit(), backend=NumpyBackend(), slo=cfg,
                                         max_batch=8, telemetry_port=0) as svc:
        for f in [svc.submit(b) for b in BITS]:
            f.result(timeout=WAIT)
        assert svc.stats()["slo"]["alerts"] == []
        with faults("serve.dispatch=slow:0.1*-1"):
            for b in BITS:
                svc.amplitude(b, timeout_s=WAIT)
        alerts = svc.stats()["slo"]["alerts"]
        body = json.loads(_get(f"{svc._telemetry.url}/slo")[1])
    assert [a["kind"] for a in alerts] == ["burn"]
    assert body["enabled"] and [a["kind"] for a in body["alerts"]] == ["burn"]
    assert len(body["recent_requests"]) == 2 * len(BITS)


@pytest.mark.parametrize("module", [port_core, port_export, port_http, port_slo],
                         ids=["core", "export", "http", "slo"])
def test_doctests(module, gates):
    assert doctest.testmod(module).failed == 0
