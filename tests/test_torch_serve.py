"""The port's serving front end (``tnc_tpu_torch.serve.service``: the
micro-batching ``ContractionService`` and the ``FidelityRouter``) and its
query handlers (``tnc_tpu_torch.queries.handlers``) against the JAX
package on the CPU.

- A ``ContractionService`` over ``NumpyBackend()`` answers the reference
  service's bits for the same requests: amplitudes from several threads,
  sampling, expectation values and marginals on one mixed queue (no
  dispatched batch mixes two batching keys), and under ``swap_bound``.
- Deadlines, admission control, dedup, retry in place and degradation to
  singletons count as the reference's do; a poisoned request fails alone.
- The ``FidelityRouter`` gives the reference's ``ApproxAnswer`` on the
  numpy backend (converged, escalated, capped); on every ``TorchBackend``
  an escalated answer's error floor is ``COMPLEX64_ERR_REL``.
- With no backend the service builds one ``TorchBackend()``, which raises
  without CUDA; ``from_circuit(fleet_dir=, fleet_endpoints=)``,
  ``attach_fleet`` and ``enable_elastic`` give the reference's fleet view
  and elastic stats (the planes themselves are held in
  ``tests/test_torch_fleet_obs.py`` and ``tests/test_torch_elastic.py``, the
  in-process planes in ``tests/test_torch_planes.py`` and
  ``tests/test_torch_telemetry.py``).

Every wait has a timeout and every service stops in a ``with`` block.
Configurations: ``sycamore_circuit(12, 4)`` (rng 42) and
``qaoa_circuit(8, 1)`` (rng 42) on a line.
"""

import doctest
import threading
import time

import numpy as np
import pytest
import torch

import tnc_tpu.resilience.faultinject as ref_faults
import tnc_tpu.resilience.retry as ref_retry
import tnc_tpu_torch.queries.handlers as port_handlers
import tnc_tpu_torch.resilience.faultinject as port_faults
import tnc_tpu_torch.resilience.retry as port_retry
import tnc_tpu_torch.serve.service as port_service
from tnc_tpu.builders.qaoa_circuit import qaoa_circuit as ref_qaoa
from tnc_tpu.builders.sycamore_circuit import sycamore_circuit as ref_sycamore
from tnc_tpu.ops.backends import NumpyBackend as RefNumpyBackend
from tnc_tpu.serve.service import ContractionService as RefService
from tnc_tpu_torch.approx.ladder import COMPLEX64_ERR_REL
from tnc_tpu_torch.builders.qaoa_circuit import qaoa_circuit
from tnc_tpu_torch.builders.sycamore_circuit import sycamore_circuit
from tnc_tpu_torch.ops.backends import NumpyBackend, TorchBackend
from tnc_tpu_torch.serve import (
    ApproxAnswer,
    ContractionService,
    DeadlineExceededError,
    FidelityRouter,
    QueueFullError,
    ServiceClosedError,
    bind_circuit,
)

Q, M = 12, 4
WAIT = 30  # seconds any future may take
RNG = np.random.default_rng(9)
BITS = ["".join(str(int(b)) for b in row) for row in RNG.integers(0, 2, (12, Q))]


@pytest.fixture(autouse=True)
def quick_retries():
    for mod in (port_retry, ref_retry):
        mod.configure_retry(mod.RetryPolicy(max_attempts=3, base_delay_s=0.0))
    yield
    for mod in (port_retry, ref_retry):
        mod.configure_retry(None)


def _circuit(port=True):
    return (sycamore_circuit if port else ref_sycamore)(Q, M, np.random.default_rng(42))


def _services(**kw):
    """The port's and the reference's service over numpy, same settings."""
    port = ContractionService.from_circuit(_circuit(), backend=NumpyBackend(), **kw)
    try:
        ref = RefService.from_circuit(_circuit(False), backend=RefNumpyBackend(), **kw)
    except Exception:
        port.stop()
        raise
    return port, ref


def _results(futures):
    return [f.result(timeout=WAIT) for f in futures]


def _submit_from_threads(svc, jobs, threads=4):
    """Run ``jobs`` (callables submitting on ``svc``, each returning a
    future) from ``threads`` threads; returns the futures in job order."""
    out = [None] * len(jobs)

    def run(k):
        for i in range(k, len(jobs), threads):
            out[i] = jobs[i](svc)

    workers = [threading.Thread(target=run, args=(k,)) for k in range(threads)]
    for w in workers:
        w.start()
    for w in workers:
        w.join(timeout=WAIT)
    return out


def _bits(values):
    return [np.asarray(v).tobytes() for v in values]


# --- amplitudes and the mixed queue -----------------------------------------


@pytest.mark.parametrize("max_batch,max_wait_ms", [(4, 5.0), (32, 20.0), (1, 0.0)])
def test_amplitudes_match_reference_bits(max_batch, max_wait_ms):
    port, ref = _services(max_batch=max_batch, max_wait_ms=max_wait_ms)
    with port, ref:
        jobs = [lambda s, b=b: s.submit(b) for b in BITS + BITS[:3]]
        got = _results(_submit_from_threads(port, jobs))
        want = _results(_submit_from_threads(ref, jobs))
        counts = port.stats()["counts"]
    assert _bits(got) == _bits(want)
    assert all(isinstance(a, complex) for a in got)
    assert counts["completed"] == counts["submitted"] == len(jobs)
    assert counts["failed"] == counts["degraded_batches"] == 0


def test_mixed_queue_matches_reference_and_never_mixes_keys():
    jobs = (
        [lambda s, b=b: s.submit(b) for b in BITS[:8]]
        + [lambda s, i=i: s.submit_marginal(BITS[i][:4] + "*" * (Q - 4)) for i in range(4)]
        + [lambda s, i=i: s.submit_marginal("*" * 6 + BITS[i][6:]) for i in range(4)]
        + [lambda s, i=i: s.submit_sample(3, seed=i) for i in range(4)]
        + [lambda s, i=i: s.submit_expectation([(0.5, "z" * (i + 1) + "i" * (Q - i - 1)),
                                                (1.0, "x" + "i" * (Q - 1))])
           for i in range(4)]
    )
    port, ref = _services(queries=True, max_batch=16, max_wait_ms=30.0)
    groups = []
    real = port._dispatch_group

    def record(kind, payloads, bound):
        keys = {port._handlers[kind].validate(p)[1] if kind != "amplitude" else ("amplitude",)
                for p in payloads}
        groups.append((kind, len(payloads), keys))
        return real(kind, payloads, bound)

    port._dispatch_group = record
    with port, ref:
        got = _results(_submit_from_threads(port, jobs))
        want = _results(_submit_from_threads(ref, jobs))
        by_type = port.stats()["by_type"]
        ref_by_type = ref.stats()["by_type"]
    assert _bits(got[:8]) == _bits(want[:8])
    assert got[8:16] == want[8:16]  # marginals, floats
    assert got[16:20] == want[16:20]  # samples, bitstring lists
    assert _bits(got[20:]) == _bits(want[20:])
    assert all(len(keys) == 1 for _, _, keys in groups)
    for kind in ("amplitude", "marginal", "sample", "expectation"):
        assert by_type[kind]["counts"]["completed"] == ref_by_type[kind]["counts"]["completed"]
        assert by_type[kind]["counts"]["failed"] == 0


def test_handlers_answer_as_the_reference_alone():
    from tnc_tpu.queries.handlers import ExpectationQueryHandler as RefExpectation
    from tnc_tpu.queries.handlers import MarginalQueryHandler as RefMarginal

    port_e, ref_e = port_handlers.ExpectationQueryHandler(_circuit()), RefExpectation(
        _circuit(False))
    payloads = [port_e.validate("zz" + "i" * (Q - 2))[0], port_e.validate(
        [(2.0, "y" + "i" * (Q - 1)), (1.0, "zz" + "i" * (Q - 2))])[0]]
    assert payloads == [ref_e.validate("zz" + "i" * (Q - 2))[0], ref_e.validate(
        [(2.0, "y" + "i" * (Q - 1)), (1.0, "zz" + "i" * (Q - 2))])[0]]
    assert _bits(port_e.dispatch(payloads, NumpyBackend())) == _bits(
        ref_e.dispatch(payloads, RefNumpyBackend()))
    port_m, ref_m = port_handlers.MarginalQueryHandler(_circuit()), RefMarginal(_circuit(False))
    pats = ["10" + "*" * (Q - 2), "01" + "*" * (Q - 2)]
    assert [port_m.validate(p) for p in pats] == [ref_m.validate(p) for p in pats]
    assert port_m.dispatch(pats, NumpyBackend()) == ref_m.dispatch(pats, RefNumpyBackend())
    with pytest.raises(ValueError):
        port_handlers.SampleQueryHandler(None).validate({"n_samples": 0})


def test_swap_bound_keeps_the_bits():
    with ContractionService.from_circuit(_circuit(), backend=NumpyBackend()) as svc:
        want = _results([svc.submit(b) for b in BITS])
        svc.swap_bound(bind_circuit(_circuit()))
        got = _results([svc.submit(b) for b in BITS])
        other = sycamore_circuit(Q, M, np.random.default_rng(43))
        with pytest.raises(ValueError):
            svc.swap_bound(bind_circuit(other))
        assert svc.stats()["counts"]["plan_swaps"] == 1
    assert _bits(got) == _bits(want)


def test_dispatcher_hook():
    seen = []

    def dispatcher(bound, bits, backend):
        seen.append(len(bits))
        return bound.amplitudes_det(bits, backend)

    port = ContractionService(bind_circuit(_circuit()), backend=NumpyBackend(),
                              dispatcher=dispatcher, max_wait_ms=20.0)
    with port:
        got = _results([port.submit(b) for b in BITS[:4]])
    want = bind_circuit(_circuit()).amplitudes(BITS[:4], NumpyBackend())
    assert _bits(got) == _bits(list(want)) and sum(seen) == 4


# --- deadlines, admission, dedup, retry, degradation --------------------------


def test_deadlines_expire_like_reference():
    port, ref = _services()
    with port, ref:
        for svc, error in ((port, DeadlineExceededError), (ref, Exception)):
            fut = svc.submit(BITS[0], timeout_s=0.0)
            with pytest.raises(error) as info:
                fut.result(timeout=WAIT)
            assert type(info.value).__name__ == "DeadlineExceededError"
            assert svc.amplitude(BITS[1], timeout_s=WAIT) is not None
        assert port.stats()["counts"] == ref.stats()["counts"]
        assert port.stats()["by_type"]["amplitude"]["counts"]["expired"] == 1


def test_admission_rejects_past_max_queue():
    def fill(svc, faults, full_error):
        with faults.faults("serve.dispatch=slow:0.5*1"):
            first = svc.submit(BITS[0])
            time.sleep(0.2)  # the dispatcher holds it in the slow dispatch
            queued = [svc.submit(BITS[1]), svc.submit(BITS[2])]
            with pytest.raises(full_error):
                svc.submit(BITS[3])
            _results([first] + queued)
        return svc.stats()["counts"]

    port, ref = _services(max_queue=2, max_wait_ms=0.0, max_batch=1)
    with port, ref:
        got = fill(port, port_faults, QueueFullError)
        want = fill(ref, ref_faults, Exception)
    assert got == want and got["rejected"] == 1


def test_dedup_collapses_identical_riders():
    port, ref = _services(max_batch=8, max_wait_ms=200.0)
    with port, ref:
        results = {}
        for name, svc in (("port", port), ("ref", ref)):
            futs = [svc.submit(b) for b in [BITS[0]] * 4 + [BITS[1]] * 2 + [BITS[2], BITS[3]]]
            results[name] = _results(futs)
        assert port.stats()["counts"]["deduped"] == ref.stats()["counts"]["deduped"] == 4
    assert _bits(results["port"]) == _bits(results["ref"])


def test_transient_retries_in_place():
    port, ref = _services(max_wait_ms=0.0)
    with port, ref:
        with port_faults.faults("serve.dispatch=transient*1"):
            got = port.amplitude(BITS[0], timeout_s=WAIT)
        with ref_faults.faults("serve.dispatch=transient*1"):
            want = ref.amplitude(BITS[0], timeout_s=WAIT)
        assert port.stats()["counts"] == ref.stats()["counts"]
        assert port.stats()["counts"]["degraded_batches"] == 0
    assert _bits([got]) == _bits([want])


def test_a_failed_batch_degrades_to_singletons():
    port, ref = _services(max_batch=4, max_wait_ms=200.0)
    with port, ref:
        out = {}
        for name, svc, faults in (("port", port, port_faults), ("ref", ref, ref_faults)):
            with faults.faults("serve.dispatch(batch=4)=fatal*1"):
                out[name] = _results([svc.submit(b) for b in BITS[:4]])
        assert port.stats()["counts"] == ref.stats()["counts"]
        assert port.stats()["counts"]["degraded_batches"] == 1
    assert _bits(out["port"]) == _bits(out["ref"])


def test_a_poisoned_request_fails_alone():
    with ContractionService.from_circuit(_circuit(), backend=NumpyBackend(), max_batch=4,
                                         max_wait_ms=200.0) as svc:
        with port_faults.faults("serve.dispatch(batch=1)=fatal*1; "
                                "serve.dispatch(batch=4)=fatal*1"):
            futs = [svc.submit(b) for b in BITS[:4]]
            outcomes = []
            for f in futs:
                try:
                    outcomes.append(f.result(timeout=WAIT))
                except port_faults.InjectedFatal:
                    outcomes.append(None)
        counts = svc.stats()["counts"]
    assert outcomes.count(None) == 1 and counts["failed"] == 1 and counts["completed"] == 3


def test_closed_service_and_cancellation():
    svc = ContractionService(bind_circuit(_circuit()), backend=NumpyBackend(),
                             max_wait_ms=200.0)
    with svc:
        fut = svc.submit(BITS[0])
        fut.cancel()
        ok = svc.submit(BITS[1])
        ok.result(timeout=WAIT)
    with pytest.raises(ServiceClosedError):
        svc.submit(BITS[0])
    counts = svc.stats()["counts"]
    assert counts["cancelled"] == 1 and counts["rejected"] == 1
    svc.reset_stats()
    assert svc.stats()["counts"]["submitted"] == 0


def test_stop_without_drain_fails_the_queue():
    svc = ContractionService(bind_circuit(_circuit()), backend=NumpyBackend(),
                             max_wait_ms=0.0, max_batch=1)
    svc.start()
    try:
        with port_faults.faults("serve.dispatch=slow:0.3*1"):
            first = svc.submit(BITS[0])
            time.sleep(0.1)
            queued = svc.submit(BITS[1])
            svc.stop(drain=False)
        first.result(timeout=WAIT)
        with pytest.raises(ServiceClosedError):
            queued.result(timeout=WAIT)
    finally:
        svc.stop()


def test_stats_and_async_facade():
    import asyncio

    with ContractionService.from_circuit(_circuit(), backend=NumpyBackend(),
                                         max_wait_ms=5.0) as svc:
        amp = asyncio.run(asyncio.wait_for(svc.amplitude_async(BITS[0]), WAIT))
        _results([svc.submit(b) for b in BITS])
        stats = svc.stats()
    assert isinstance(amp, complex)
    assert set(stats) == {"counts", "batch_size", "latency_s", "by_type", "by_tier"}
    assert stats["latency_s"]["count"] == len(BITS) + 1
    assert stats["by_tier"]["exact"]["dispatch"]["count"] == stats["counts"]["batches"]
    assert 0 < stats["latency_s"]["p50"] <= stats["latency_s"]["p99"] <= stats["latency_s"]["max"]


# --- the fidelity router ------------------------------------------------------


def _qaoa(port=True):
    return (qaoa_circuit if port else ref_qaoa)(8, 1, np.random.default_rng(42))


def _approx_fields(a):
    return (a.chi_used, a.escalated, a.tolerance_met, a.sweeps)


@pytest.mark.parametrize("kind,payload,rtol", [
    ("amplitude", "01100110", 1e-2),
    ("amplitude", "11110000", 1e-12),
    ("expectation", [(1.0, "zz" + "i" * 6), (0.5, "i" * 7 + "x")], 1e-3),
    ("marginal", "1*0*****", 1e-3),
    ("marginal", "1*0*****", 1e-12),
])
def test_router_matches_reference(kind, payload, rtol):
    opts = {"chi_cap": 4}
    port = ContractionService.from_circuit(_qaoa(), backend=NumpyBackend(), approx=True,
                                           queries=True, approx_options=opts)
    with port, RefService.from_circuit(_qaoa(False), backend=RefNumpyBackend(), approx=True,
                                       queries=True, approx_options=opts) as ref:
        submit = {"amplitude": "submit", "expectation": "submit_expectation",
                  "marginal": "submit_marginal"}[kind]
        got = getattr(port, submit)(payload, rtol=rtol).result(timeout=WAIT)
        want = getattr(ref, submit)(payload, rtol=rtol).result(timeout=WAIT)
        tiers, ref_tiers = port.stats()["by_tier"], ref.stats()["by_tier"]
    assert isinstance(got, ApproxAnswer)
    assert _approx_fields(got) == _approx_fields(want)
    assert abs(got.value - want.value) <= 1e-10 * max(abs(want.value), 1e-3)
    assert abs(got.err - want.err) <= 1e-9 * max(want.err, 1e-12)
    assert tiers["approx"]["counts"] == ref_tiers["approx"]["counts"]
    assert tiers["approx"]["router"]["rungs"] == ref_tiers["approx"]["router"]["rungs"]


def test_router_escalation_budget():
    with ContractionService.from_circuit(
            _qaoa(), backend=NumpyBackend(), approx=True,
            approx_options={"chi_cap": 2, "max_escalations": 1}) as svc:
        first = svc.submit("01010101", rtol=1e-12).result(timeout=WAIT)
        second = svc.submit("01010101", rtol=1e-12).result(timeout=WAIT)
        approx = svc.stats()["by_tier"]["approx"]
    assert first.escalated and not second.escalated and not second.tolerance_met
    assert approx["counts"]["escalated"] == 1 and approx["counts"]["escalation_capped"] == 1


@pytest.mark.parametrize("dtype", ["complex64", "complex128"])
def test_escalation_floor_on_every_torch_backend(dtype):
    """The exact pipeline's floor is COMPLEX64_ERR_REL on a TorchBackend of
    either dtype: its products run in FP32. (rtol 1e-12 is below both
    sweeps' floors, so the ladder escalates in either dtype.)"""
    backend = TorchBackend(device="cpu", dtype=dtype, split_complex=True)
    with ContractionService.from_circuit(_qaoa(), backend=backend, approx=True,
                                         approx_options={"chi_cap": 4}) as svc:
        bits = "00111100"
        got = svc.submit(bits, rtol=1e-12).result(timeout=WAIT)
        exact = svc.amplitude(bits, timeout_s=WAIT)
    scale = 2.0 ** -4
    assert got.escalated and got.chi_used is None
    assert got.value == exact
    assert got.err == COMPLEX64_ERR_REL * max(abs(exact), scale)


def test_router_needs_a_nearest_neighbour_circuit_and_rtol():
    with ContractionService.from_circuit(_circuit(), backend=NumpyBackend()) as svc:
        with pytest.raises(ValueError):
            svc.submit(BITS[0], rtol=1e-2)
        with pytest.raises(Exception):
            svc.enable_approx(_circuit())
    with ContractionService.from_circuit(_qaoa(), backend=NumpyBackend(), approx=True) as svc:
        with pytest.raises(ValueError):
            svc.submit("0" * 8, rtol=0.0)
        with pytest.raises(ValueError):
            svc.submit("0*" * 4, rtol=1e-2)
        assert isinstance(svc.fidelity_router, FidelityRouter)


# --- the card default and the planes not ported ----------------------------


def test_default_backend_is_the_card():
    if torch.cuda.is_available():
        pytest.skip("checks the CUDA-less host")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ContractionService(bind_circuit(_circuit()))


def _fleet_view(snap: dict) -> tuple:
    """The parts of a ``/fleet`` body that do not depend on the process:
    replica names, the roster's live names and the unreachable names."""
    roster = snap.get("roster") or {"replicas": []}
    return (snap["replicas"], sorted(r["name"] for r in roster["replicas"]
                                     if r["state"] == "live"),
            sorted(snap["unreachable"]))


@pytest.mark.parametrize("option", [{"fleet_dir": "x"}, {"fleet_endpoints": ("x",)}])
def test_planes_not_ported_raise(option, tmp_path):
    """``from_circuit``'s fleet options join the fleet plane as the
    reference's do: a registry directory (here under ``tmp_path``) puts this
    replica on the roster, an endpoint that cannot be scraped ("x", no
    scheme: nothing leaves the host) is listed unreachable."""
    views = []
    for service, backend, circuit, sub in (
            (ContractionService, NumpyBackend(), _circuit(), "port"),
            (RefService, RefNumpyBackend(), _circuit(False), "ref")):
        kw = dict(option)
        if "fleet_dir" in kw:
            kw["fleet_dir"] = str(tmp_path / sub)
        with service.from_circuit(circuit, backend=backend, **kw) as svc:
            views.append(_fleet_view(svc.fleet_snapshot()))
    assert views[0] == views[1]
    assert views[0][1] == (["p0"] if "fleet_dir" in option else [])
    assert views[0][2] == ([] if "fleet_dir" in option else ["replica0"])


@pytest.mark.parametrize("option", [
    {"plansvc": True}, {"background_replan": True}, {"shared_cache_watch": True}])
def test_cache_planes_need_a_plan_cache_as_the_reference(option):
    for service, backend, circuit in ((ContractionService, NumpyBackend(), _circuit()),
                                      (RefService, RefNumpyBackend(), _circuit(False))):
        with pytest.raises(ValueError, match="requires a plan_cache"):
            service.from_circuit(circuit, backend=backend, **option)


def test_service_methods_not_ported_raise():
    """``attach_fleet()`` with no directory federates this replica alone and
    ``enable_elastic()`` adds the reference's ``stats()["elastic"]`` block;
    ``enable_plansvc`` still asks for a plan cache."""
    from tnc_tpu.serve.rebind import bind_circuit as ref_bind

    got = []
    for service, bind, backend, circuit in (
            (ContractionService, bind_circuit, NumpyBackend(), _circuit()),
            (RefService, ref_bind, RefNumpyBackend(), _circuit(False))):
        with service(bind(circuit), backend=backend) as svc:
            assert svc.fleet_snapshot() is None
            svc.attach_fleet()
            assert svc.enable_elastic() is svc
            snap = svc.fleet_snapshot()
            elastic = svc.stats()["elastic"]
            elastic.pop("counters")  # process-global tallies
            got.append((snap["replicas"], snap["unreachable"], elastic))
            with pytest.raises(ValueError, match="requires a plan_cache"):
                svc.enable_plansvc()
    assert got[0] == got[1]
    assert got[0][0] == ["p0"]


@pytest.mark.parametrize("module", [port_service, port_handlers], ids=["service", "handlers"])
def test_doctests(module):
    assert doctest.testmod(module).failed == 0


def test_top_level_exports():
    import tnc_tpu_torch
    from tnc_tpu_torch.ops.sliced import SliceYield
    from tnc_tpu_torch.resilience import RetryPolicy, SliceCheckpoint, fault_point

    assert tnc_tpu_torch.ContractionService is ContractionService
    assert tnc_tpu_torch.FidelityRouter is FidelityRouter
    assert (tnc_tpu_torch.RetryPolicy, tnc_tpu_torch.fault_point,
            tnc_tpu_torch.SliceCheckpoint, tnc_tpu_torch.SliceYield) == (
        RetryPolicy, fault_point, SliceCheckpoint, SliceYield)
    with pytest.raises(AttributeError):
        tnc_tpu_torch.Nothing  # noqa: B018
