"""The port's span registry and calibration layer (``tnc_tpu_torch.obs``)
against the JAX package's (``tnc_tpu.obs``), on the CPU.

- ``fit_device_model`` on seeded sample sets, one landing on each rung of
  the term ladder (flops, bytes and launch overhead; flops and overhead;
  flops and bytes; flops alone), a set of one repeated shape, a set too
  small to fit, bytes-only samples and an exact set whose solve leaves a
  numerically-zero negative overhead that the fit clamps: the port's
  ``terms`` and constants equal the reference's to rtol 1e-12.
- ``aggregate_samples``, ``pick_source`` (the port's device source is
  ``"torch"`` where the reference's is ``"jax"``), ``error_report``,
  ``calibration_report`` and ``format_calibration_table`` on the same
  span records give the reference's output.
- Every ``CalibratedCostModel`` method gives the reference's numbers.
- The env gates ``TNC_TPU_TRACE`` and ``TNC_TPU_STEP_TIME`` parse as the
  reference parses them, and a span records its name and arguments.
"""

import doctest
import math

import numpy as np
import pytest

import tnc_tpu.obs.calibrate as ref_cal
import tnc_tpu.obs.core as ref_core
import tnc_tpu_torch.obs.calibrate as port_cal
import tnc_tpu_torch.obs.core as port_core
from tnc_tpu_torch import obs

RTOL = 1e-12


def _exact(seed: int):
    rng = np.random.default_rng(seed)
    f, b = rng.uniform(1e6, 1e9, 24), rng.uniform(1e5, 1e8, 24)
    return f, b, f / 2e12 + b / 1e12


def _clamp_set():
    """The first seeded exact set whose three-term solve leaves the
    overhead a numerically-zero negative (which seed that is depends on
    rounding, so it is searched for)."""
    for seed in range(64):
        f, b, y = _exact(seed)
        raw = np.linalg.lstsq(np.stack([f, b, np.ones_like(f)], axis=1), y, rcond=None)[0][2]
        if -1e-13 <= raw < 0.0:
            return f, b, y
    raise AssertionError("no seed leaves a negative overhead")


def _sets(seed: int = 1) -> dict:
    """``(flops, bytes, seconds)`` arrays of every fit case, from one seed.
    Each case's comment names the fit rung it lands on."""
    rng = np.random.default_rng(seed)
    n = 24
    f = rng.uniform(1e6, 1e9, n)
    b = rng.uniform(1e5, 1e8, n)
    noise = 1.0 + 0.01 * rng.standard_normal(n)
    return {
        # independent flops and bytes, a launch constant: all three terms
        "three_terms": (f, b, (f / 2e12 + b / 1e12 + 2e-5) * noise),
        # bytes proportional to flops: rank-deficient with bytes, so the
        # fit takes flops and overhead
        "flops_dispatch": (f, 3.0 * f, f / 2e12 + 2e-5 + 1e-7 * rng.standard_normal(n)),
        # a negative constant: both overhead fits go negative, so the fit
        # takes flops and bytes
        "flops_bytes": (f, b, f / 2e12 + b / 1e13 - 5e-6),
        # no bytes and a negative constant: flops alone
        "flops_only": (f, np.zeros(n), f / 2e12 - 1e-5),
        # every sample the same shape: only the flops column has full rank
        "same_shape": (np.full(n, 1e8), np.full(n, 1e6), rng.uniform(1e-4, 2e-4, n)),
        # exact flops and bytes with no constant: the solve leaves the
        # overhead at ~-1e-20, which the fit clamps to 0
        "clamp": _clamp_set(),
        # fewer than two usable samples
        "one_sample": (f[:1], b[:1], (f / 2e12)[:1]),
        # no flops anywhere: no fit, and no aggregate throughput either
        "bytes_only": (np.zeros(n), b, b / 1e12),
    }


WANT_TERMS = {
    "three_terms": ("flops", "bytes", "dispatch"),
    "flops_dispatch": ("flops", "dispatch"),
    "flops_bytes": ("flops", "bytes"),
    "flops_only": ("flops",),
    "same_shape": ("flops",),
    "clamp": ("flops", "bytes", "dispatch"),
    "one_sample": None,
    "bytes_only": None,
}


def _samples(module, case: str, source: str):
    f, b, y = _sets()[case]
    return [module.StepSample(f"step[{i}] {int(fi)}", float(fi), float(bi), float(yi), source)
            for i, (fi, bi, yi) in enumerate(zip(f, b, y))]


def _same_model(port, ref) -> None:
    if ref is None:
        assert port is None
        return
    assert port.terms == ref.terms and port.n_samples == ref.n_samples
    assert math.isclose(port.flops_per_s, ref.flops_per_s, rel_tol=RTOL)
    assert math.isclose(port.dispatch_s, ref.dispatch_s, rel_tol=RTOL, abs_tol=0.0)
    assert (port.bytes_per_s is None) == (ref.bytes_per_s is None)
    if ref.bytes_per_s is not None:
        assert math.isclose(port.bytes_per_s, ref.bytes_per_s, rel_tol=RTOL)


# -- the fit -----------------------------------------------------------------


@pytest.mark.parametrize("case", list(WANT_TERMS))
def test_fit_device_model_matches_reference(case):
    port = port_cal.fit_device_model(_samples(port_cal, case, "torch"))
    ref = ref_cal.fit_device_model(_samples(ref_cal, case, "jax"))
    _same_model(port, ref)
    assert (None if port is None else port.terms) == WANT_TERMS[case]


def test_fit_clamps_a_numerically_zero_negative_overhead():
    """The clamp case's exact solve does leave a tiny negative overhead,
    which both packages set to zero."""
    f, b, y = _sets()["clamp"]
    raw = np.linalg.lstsq(np.stack([f, b, np.ones_like(f)], axis=1), y, rcond=None)[0][2]
    assert -1e-13 <= raw < 0.0
    model = port_cal.fit_device_model(_samples(port_cal, "clamp", "torch"))
    assert model.dispatch_s == 0.0
    assert math.isclose(model.flops_per_s, 2e12, rel_tol=1e-9)
    assert math.isclose(model.bytes_per_s, 1e12, rel_tol=1e-9)


def test_predict_s_matches_reference():
    port = port_cal.fit_device_model(_samples(port_cal, "three_terms", "torch"))
    ref = ref_cal.fit_device_model(_samples(ref_cal, "three_terms", "jax"))
    for flops, nbytes in ((0.0, 0.0), (1e9, 0.0), (0.0, 1e8), (3e10, 2e9)):
        assert math.isclose(port.predict_s(flops, nbytes), ref.predict_s(flops, nbytes),
                            rel_tol=RTOL)


# -- samples and reports from span records ---------------------------------------


class _Records:
    """A registry stand-in holding given span records."""

    def __init__(self, records):
        self._records = records

    def span_records(self, include_open=False):
        return list(self._records)


def _records(module, device: str, seed: int = 5):
    """Span records as both packages' executors write them: repeated step
    spans of a device and a numpy executor, a chain span, and spans that
    are not steps or carry no cost (ignored)."""
    rng = np.random.default_rng(seed)
    out = []
    for rep in range(3):
        for i in range(12):
            flops = float(2 ** (10 + i))
            for executor, scale in ((device, 1.0), ("numpy", 40.0)):
                dur = (flops / 1e11 + 5e-6) * scale * (1.0 + 0.05 * rng.random())
                out.append(module.SpanRecord(
                    f"step[{i}] {2 ** i}x4·4x{2 ** i}", 0, int(dur * 1e9), 1, 1, "main", 0,
                    {"executor": executor, "flops": flops, "bytes_in": 8.0 * flops ** 0.75,
                     "bytes_out": 8.0 * 2 ** i, "mode": "gauss"}))
        out.append(module.SpanRecord("step[12..14] chain x3", 0, 40_000, 1, 1, "main", 0,
                                     {"executor": device, "flops": 3e4, "bytes_in": 1e4,
                                      "bytes_out": 64.0, "mode": "chain", "steps": 3}))
    out.append(module.SpanRecord("compile", 0, 10 ** 9, 1, 1, "main", 0, {"flops": 1e9}))
    out.append(module.SpanRecord("step[99] empty", 0, 1000, 1, 1, "main", 0,
                                 {"executor": device}))
    return out


def _port_and_ref_samples():
    port = port_cal.step_samples(_records(port_core, "torch"))
    ref = ref_cal.step_samples(_records(ref_core, "jax"))
    return port, ref


def _same_samples(port, ref) -> None:
    assert len(port) == len(ref)
    for p, r in zip(port, ref):
        assert (p.name, p.flops, p.bytes, p.dur_s) == (r.name, r.flops, r.bytes, r.dur_s)
        assert p.source == {"jax": "torch"}.get(r.source, r.source)


def test_step_samples_and_aggregate_match_reference():
    port, ref = _port_and_ref_samples()
    _same_samples(port, ref)
    _same_samples(port_cal.aggregate_samples(port), ref_cal.aggregate_samples(ref))
    # a registry argument reads the same records
    _same_samples(port_cal.step_samples(registry=_Records(_records(port_core, "torch"))),
                  ref)


@pytest.mark.parametrize("mix", [
    {"torch": 2, "numpy": 5}, {"torch": 1, "numpy": 5}, {"numpy": 3}, {},
    {"torch": 4}, {"a": 2, "b": 2},
])
def test_pick_source_prefers_the_device_as_the_reference_does(mix):
    def samples(module, device):
        return [module.StepSample(f"step[{i}]", 1.0, 1.0, 1.0,
                                  device if src == "torch" else src)
                for src, n in mix.items() for i in range(n)]

    want = ref_cal.pick_source(samples(ref_cal, "jax"))
    assert port_cal.pick_source(samples(port_cal, "torch")) == (
        "torch" if want == "jax" else want)


def test_error_report_matches_reference():
    port, ref = _port_and_ref_samples()
    port = [s for s in port_cal.aggregate_samples(port) if s.source == "torch"]
    ref = [s for s in ref_cal.aggregate_samples(ref) if s.source == "jax"]
    port_model, ref_model = port_cal.fit_device_model(port), ref_cal.fit_device_model(ref)
    _same_model(port_model, ref_model)
    for top in (0, 3, 8, 100):
        assert port_cal.error_report(port, port_model, top) == ref_cal.error_report(
            ref, ref_model, top)


@pytest.mark.parametrize("source", [None, "numpy"])
def test_calibration_report_matches_reference(source):
    port = port_cal.calibration_report(_Records(_records(port_core, "torch")), top=5,
                                       source=source)
    ref = ref_cal.calibration_report(_Records(_records(ref_core, "jax")), top=5,
                                     source=source)
    assert port.pop("fitted_unix") > 0 and ref.pop("fitted_unix") > 0
    assert port.pop("source") == {"jax": "torch"}.get(ref["source"], ref["source"])
    ref.pop("source")
    assert port == ref
    assert port_cal.format_calibration_table({**port, "source": "x"}) == (
        ref_cal.format_calibration_table({**ref, "source": "x"}))
    assert port_cal.calibration_report(_Records([])) is None


def test_roofline_rows_match_reference():
    rows = [{"name": "step[0] a", "count": 3, "total_ms": 2.5, "flops": 1e9, "bytes_in": 1e6},
            {"name": "sliced.prelude", "count": 1, "total_ms": 0.0, "bytes": 1e8},
            {"name": "compile", "count": 1, "total_ms": 10.0}]
    assert port_cal.roofline_rows(rows) == ref_cal.roofline_rows(rows)
    assert port_cal.format_roofline_table(port_cal.roofline_rows(rows)) == (
        ref_cal.format_roofline_table(ref_cal.roofline_rows(rows)))


# -- the cost model ----------------------------------------------------------------

CONSTANTS = [(1e12, 0.0, None), (2.5e12, 2e-5, None), (1e11, 1e-3, 4e11),
             (5e13, 7e-6, 2e12), (3e9, -1.0, 0.0)]


@pytest.mark.parametrize("constants", CONSTANTS)
def test_calibrated_cost_model_matches_reference(constants):
    port = port_cal.CalibratedCostModel(*constants)
    ref = ref_cal.CalibratedCostModel(*constants)
    assert vars(port) == vars(ref)
    assert port.dispatch_equivalent_flops() == ref.dispatch_equivalent_flops()
    for flops, nbytes, dispatches in ((0.0, 0.0, 1.0), (1e9, 0.0, 1.0), (1e9, 1e8, 3.0),
                                      (5e12, 2e9, 0.0)):
        assert port.op_seconds(flops, nbytes, dispatches) == ref.op_seconds(
            flops, nbytes, dispatches)
    for args in ((0.0, 1e6, 4), (1e9, 1e7, 64, 12.0, 40.0), (2e10, 0.0, 1), (0.0, 0.0, 8)):
        assert port.sliced_cost(*args) == ref.sliced_cost(*args)
    report = {"flops_per_s": constants[0], "dispatch_overhead_s": constants[1],
              "bytes_per_s": constants[2]}
    assert vars(port_cal.CalibratedCostModel.from_report(report)) == vars(
        ref_cal.CalibratedCostModel.from_report(report))
    with pytest.raises(ValueError):
        port_cal.CalibratedCostModel(0.0)


@pytest.mark.parametrize("case", ["three_terms", "flops_bytes", "same_shape"])
def test_cost_model_from_device_model_matches_reference(case):
    port = port_cal.fit_device_model(_samples(port_cal, case, "torch"))
    ref = ref_cal.fit_device_model(_samples(ref_cal, case, "jax"))
    got = vars(port_cal.CalibratedCostModel.from_device_model(port))
    want = vars(ref_cal.CalibratedCostModel.from_device_model(ref))
    assert got.keys() == want.keys()
    for key in got:
        if want[key] is None:
            assert got[key] is None
        else:
            assert math.isclose(got[key], want[key], rel_tol=RTOL)


def test_cost_model_from_registry_matches_reference():
    port = port_cal.CalibratedCostModel.from_registry(_Records(_records(port_core, "torch")))
    ref = ref_cal.CalibratedCostModel.from_registry(_Records(_records(ref_core, "jax")))
    assert vars(port) == vars(ref)
    numpy_only = port_cal.CalibratedCostModel.from_registry(
        _Records(_records(port_core, "torch")), source="numpy")
    assert vars(numpy_only) == vars(ref_cal.CalibratedCostModel.from_registry(
        _Records(_records(ref_core, "jax")), source="numpy"))
    assert port_cal.CalibratedCostModel.from_registry(_Records([])) is None


# -- the span registry and its env gates ----------------------------------------------


@pytest.fixture
def gates(monkeypatch):
    """Both packages' module state, restored after the test."""
    for module in (port_core, ref_core):
        for name in ("_ENABLED", "_STEP_TIME", "_REGISTRY"):
            monkeypatch.setattr(module, name, getattr(module, name))
    for module in (port_core, ref_core):
        monkeypatch.setattr(module, "_TRACE_PATH", module._TRACE_PATH)
        monkeypatch.setattr(module, "_ATEXIT_REGISTERED", True)  # arms no export
    monkeypatch.delenv("TNC_TPU_FLIGHT_RECORDER", raising=False)
    return monkeypatch


TRACE_VALUES = [None, "", "0", "1", "true", "TRUE", " yes ", "on", "off", "Off", "no",
                "false", "2", "trace.json"]
STEP_VALUES = [None, "", "0", "1", "true", "On", "YES", "no", "x"]


@pytest.mark.parametrize("trace", TRACE_VALUES)
@pytest.mark.parametrize("step", STEP_VALUES)
def test_env_gates_parse_as_the_reference(gates, trace, step, tmp_path):
    for name, value in (("TNC_TPU_TRACE", trace), ("TNC_TPU_STEP_TIME", step)):
        if value is None:
            gates.delenv(name, raising=False)
        else:
            gates.setenv(name, str(tmp_path / value) if value.endswith(".json") else value)
    assert port_core.refresh_from_env() == ref_core.refresh_from_env()
    assert port_core.enabled() == ref_core.enabled()
    assert port_core.step_timing_enabled() == ref_core.step_timing_enabled()


def test_span_records_name_args_and_nesting(gates):
    reg = obs.configure(enabled=True, registry=obs.MetricsRegistry())
    with obs.span("outer", flops=64.0, executor="torch") as outer:
        with obs.span("inner"):
            pass
        outer.set(mode="gauss")
    inner_rec, outer_rec = reg.span_records()
    assert (inner_rec.name, inner_rec.depth, inner_rec.args) == ("inner", 1, {})
    assert (outer_rec.name, outer_rec.depth) == ("outer", 0)
    assert outer_rec.args == {"flops": 64.0, "executor": "torch", "mode": "gauss"}
    assert outer_rec.dur_ns >= inner_rec.dur_ns >= 0
    with obs.span("open"):
        assert [r.name for r in reg.span_records(include_open=True)][-1] == "open"
    fresh = obs.reset()
    assert fresh is obs.get_registry() and fresh.span_records() == [] and obs.enabled()
    obs.configure(enabled=False)
    assert obs.span("off") is obs.NULL_SPAN
    with obs.span("off", flops=1.0):
        pass
    assert fresh.span_records() == []


def test_span_cap_drops_and_counts(gates):
    reg = obs.configure(enabled=True, registry=obs.MetricsRegistry(max_spans=2))
    for i in range(5):
        with obs.span(f"s{i}"):
            pass
    assert [r.name for r in reg.span_records()] == ["s0", "s1"]
    assert reg.dropped_spans() == 3


@pytest.mark.parametrize("module", [port_core, port_cal])
def test_doctests(module, gates):
    failures, _ = doctest.testmod(module)
    assert failures == 0
