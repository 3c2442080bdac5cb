"""Cost-model calibration: predicted-vs-measured per-step accounting (the
port's copy of ``tnc_tpu.obs.calibrate``; the device executor's samples
carry the source ``"torch"`` where the reference's carry ``"jax"``).

The planner stack chooses paths, slicings and kernels from *predicted*
flops/bytes (``contractionpath/contraction_cost.py``,
``ops/program.steps_flops``, the hoisted ``StemAccountant``), and the
executors record *measured* wall time per step when per-step timing is
on (``TNC_TPU_STEP_TIME``; always-on for the synchronous numpy oracle —
see :func:`tnc_tpu_torch.ops.backends.run_steps_timed`). This module is where
the two ledgers meet:

- :func:`step_samples` collects ``step[i] MxK·KxN`` span records into
  (predicted flops, predicted bytes, measured seconds) samples;
- :func:`fit_device_model` least-squares-fits an effective device model
  ``time ≈ flops/F + bytes/B + c`` — achieved FLOP/s, achieved bytes/s,
  and a per-dispatch overhead — degrading gracefully to fewer terms
  when the samples can't identify all three;
- :func:`error_report` quantifies the cost model's prediction-error
  distribution and names the worst-mispredicted steps as a
  roofline-style table;
- :func:`calibration_report` bundles both into one plain-data
  ``calibration`` block;
- :class:`CalibratedCostModel` converts planner flop counts into
  *seconds* under the fitted model — the slicing scorers
  (``slice_and_reconfigure``, ``StemAccountant``) accept it in place of raw op counts, closing the
  plan → measure → replan loop: with a real per-dispatch overhead the
  planner stops treating 4× more slices as free.

>>> model = fit_device_model([
...     StepSample("step[0] a", 1e9, 0.0, 0.01),
...     StepSample("step[1] b", 2e9, 0.0, 0.02),
... ])
>>> round(model.flops_per_s / 1e9, 3)
100.0
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Iterable, Sequence

import numpy as np

from tnc_tpu_torch.obs.core import MetricsRegistry, SpanRecord, get_registry

#: span-name prefix identifying per-step timing spans
#: (:func:`tnc_tpu_torch.ops.program.step_label`)
STEP_PREFIX = "step["


@dataclass(frozen=True)
class StepSample:
    """One calibration observation: a step's predicted cost next to its
    measured wall time. ``source`` is the executor that measured it
    (``"numpy"`` / ``"torch"``) — samples from different executors must
    never share a fit (a host-measured millisecond says nothing about
    the device)."""

    name: str
    flops: float
    bytes: float
    dur_s: float
    source: str = ""


@dataclass(frozen=True)
class DeviceModel:
    """Fitted effective device model: ``predict_s(flops, bytes) =
    flops / flops_per_s + bytes / bytes_per_s + dispatch_s``.

    ``bytes_per_s`` is ``None`` when the samples could not identify a
    bandwidth term (all steps compute-bound, or flops ∝ bytes);
    ``terms`` records which terms the accepted fit used.
    """

    flops_per_s: float
    bytes_per_s: float | None
    dispatch_s: float
    n_samples: int
    terms: tuple[str, ...]

    def predict_s(self, flops: float, bytes_: float = 0.0) -> float:
        t = self.dispatch_s
        if flops and self.flops_per_s:
            t += flops / self.flops_per_s
        if bytes_ and self.bytes_per_s:
            t += bytes_ / self.bytes_per_s
        return t


def step_samples(
    records: Iterable[SpanRecord] | None = None,
    registry: MetricsRegistry | None = None,
) -> list[StepSample]:
    """Per-step samples from span records (default: the active
    registry). Only ``step[...]`` spans carrying a predicted cost
    qualify; everything else in the trace is ignored."""
    if records is None:
        reg = registry if registry is not None else get_registry()
        records = reg.span_records()
    out: list[StepSample] = []
    for rec in records:
        if not rec.name.startswith(STEP_PREFIX):
            continue
        flops = float(rec.args.get("flops", 0.0))
        nbytes = float(rec.args.get("bytes_in", 0.0)) + float(
            rec.args.get("bytes_out", 0.0)
        )
        if flops <= 0.0 and nbytes <= 0.0:
            continue
        out.append(
            StepSample(
                rec.name, flops, nbytes, rec.dur_ns / 1e9,
                str(rec.args.get("executor", "")),
            )
        )
    return out


def aggregate_samples(samples: Sequence[StepSample]) -> list[StepSample]:
    """One sample per distinct (step name, source), measured time =
    median over its occurrences (reps, slices) — damps scheduler noise
    before the fit without letting hot steps outvote the rest. Grouping
    includes the source so a host and a device measurement of the same
    step stay distinct samples."""
    groups: dict[tuple[str, str], list[StepSample]] = {}
    for s in samples:
        groups.setdefault((s.name, s.source), []).append(s)
    out = []
    for (name, source), grp in groups.items():
        med = float(np.median([g.dur_s for g in grp]))
        out.append(StepSample(name, grp[0].flops, grp[0].bytes, med, source))
    return out


def pick_source(samples: Sequence[StepSample]) -> str | None:
    """The executor whose samples a fit should use when a trace mixes
    several (a device run whose CPU-baseline/oracle phases also emitted
    numpy step spans): prefer the device (``torch``) samples — they are
    the hardware being modeled — else the most numerous source.
    ``None`` when there are no samples."""
    counts: dict[str, int] = {}
    for s in samples:
        counts[s.source] = counts.get(s.source, 0) + 1
    if not counts:
        return None
    if counts.get("torch", 0) >= 2:
        return "torch"
    return max(counts, key=lambda k: (counts[k], k))


_TERM_LADDER = (
    ("flops", "bytes", "dispatch"),
    ("flops", "dispatch"),
    ("flops", "bytes"),
    ("flops",),
)


def fit_device_model(samples: Sequence[StepSample]) -> DeviceModel | None:
    """Least-squares fit of the effective device model.

    Walks a term ladder — (flops, bytes, overhead) → (flops, overhead)
    → (flops, bytes) → (flops) — and accepts the first fit whose design
    matrix has full rank and whose coefficients are all physical
    (positive throughput, non-negative bandwidth/overhead); degenerate
    sample sets (e.g. every step the same shape) fall through to the
    aggregate-throughput estimate. Returns ``None`` below 2 usable
    samples.
    """
    usable = [
        s for s in samples if s.dur_s > 0.0 and (s.flops > 0.0 or s.bytes > 0.0)
    ]
    if len(usable) < 2:
        return None
    f = np.asarray([s.flops for s in usable], dtype=np.float64)
    b = np.asarray([s.bytes for s in usable], dtype=np.float64)
    y = np.asarray([s.dur_s for s in usable], dtype=np.float64)

    for terms in _TERM_LADDER:
        cols = []
        if "flops" in terms:
            cols.append(f)
        if "bytes" in terms:
            cols.append(b)
        if "dispatch" in terms:
            cols.append(np.ones_like(f))
        if len(usable) < len(cols):
            continue
        design = np.stack(cols, axis=1)
        try:
            coef, _res, rank, _sv = np.linalg.lstsq(design, y, rcond=None)
        except np.linalg.LinAlgError:  # pragma: no cover - defensive
            continue
        if rank < len(cols):
            continue
        named = dict(zip(terms, coef))
        if named.get("flops", 0.0) <= 0.0:
            continue
        for term in ("bytes", "dispatch"):
            # numerically-zero negatives from an exact solve are noise,
            # not an unphysical model
            if term in named and -1e-13 <= named[term] < 0.0:
                named[term] = 0.0
        if named.get("bytes", 0.0) < 0.0 or named.get("dispatch", 0.0) < 0.0:
            continue
        byte_coef = named.get("bytes", 0.0)
        return DeviceModel(
            flops_per_s=float(1.0 / named["flops"]),
            bytes_per_s=float(1.0 / byte_coef) if byte_coef > 0.0 else None,
            dispatch_s=float(named.get("dispatch", 0.0)),
            n_samples=len(usable),
            terms=terms,
        )

    total_f, total_y = float(f.sum()), float(y.sum())
    if total_f <= 0.0 or total_y <= 0.0:
        return None
    return DeviceModel(
        flops_per_s=total_f / total_y,
        bytes_per_s=None,
        dispatch_s=0.0,
        n_samples=len(usable),
        terms=("flops",),
    )


def error_report(
    samples: Sequence[StepSample], model: DeviceModel, top: int = 8
) -> dict:
    """Cost-model error distribution + the worst-mispredicted steps.

    Relative error is ``(predicted - measured) / measured`` per step;
    the percentiles are over its absolute value. ``worst_steps`` rows
    carry the step name (index + matmul dims), both times, the signed
    relative error, and the step's achieved FLOP/s — a roofline-style
    table of exactly the steps the cost model gets most wrong."""
    rows = []
    for s in samples:
        if s.dur_s <= 0.0:
            continue
        pred = model.predict_s(s.flops, s.bytes)
        rel = (pred - s.dur_s) / s.dur_s
        rows.append(
            {
                "step": s.name,
                "measured_s": float(f"{s.dur_s:.4e}"),
                "predicted_s": float(f"{pred:.4e}"),
                "rel_err": round(rel, 4),
                "flops": s.flops,
                "achieved_flops_per_s": float(f"{s.flops / s.dur_s:.4e}"),
            }
        )
    abs_errs = np.asarray([abs(r["rel_err"]) for r in rows]) if rows else None
    report = {
        "n_steps": len(rows),
        "error_p50": (
            round(float(np.percentile(abs_errs, 50)), 4) if rows else None
        ),
        "error_p90": (
            round(float(np.percentile(abs_errs, 90)), 4) if rows else None
        ),
        "error_max": round(float(abs_errs.max()), 4) if rows else None,
        "worst_steps": sorted(
            rows, key=lambda r: -abs(r["rel_err"])
        )[: max(top, 0)],
    }
    return report


def calibration_report(
    registry: MetricsRegistry | None = None,
    top: int = 8,
    source: str | None = None,
) -> dict | None:
    """The ``calibration`` block of a run's record: fitted
    model (achieved FLOP/s, bytes/s, per-dispatch overhead) + the
    prediction-error distribution, from whatever per-step spans the
    run recorded. When the trace mixes executors the fit uses one
    ``source`` only (:func:`pick_source` unless given), recorded in
    the block — a host/device blend is not a device model. ``None``
    when no fit is possible (no step spans — e.g. tracing off, or a
    device-only run without ``TNC_TPU_STEP_TIME``)."""
    samples = aggregate_samples(step_samples(registry=registry))
    if source is None:
        source = pick_source(samples)
    samples = [s for s in samples if s.source == source]
    model = fit_device_model(samples)
    if model is None:
        return None
    report = {
        "source": source,
        "flops_per_s": float(f"{model.flops_per_s:.4e}"),
        "bytes_per_s": (
            float(f"{model.bytes_per_s:.4e}")
            if model.bytes_per_s is not None
            else None
        ),
        "dispatch_overhead_s": float(f"{model.dispatch_s:.4e}"),
        "fit_terms": list(model.terms),
        "n_samples": model.n_samples,
        # when the constants were fit: the staleness anchor of a record
        "fitted_unix": time.time(),
    }
    report.update(error_report(samples, model, top=top))
    return report


def format_calibration_table(report: dict) -> str:
    """Human rendering of a :func:`calibration_report`: fitted constants, error percentiles, and the
    worst-step roofline rows."""
    lines = [
        "fitted device model: "
        f"{report['flops_per_s']:.3e} FLOP/s, "
        + (
            f"{report['bytes_per_s']:.3e} B/s, "
            if report.get("bytes_per_s")
            else "no bandwidth term, "
        )
        + f"{report['dispatch_overhead_s'] * 1e6:.1f} us/dispatch "
        f"({report['n_samples']} steps, "
        f"source={report.get('source') or '?'})",
        "cost-model |rel err|: "
        f"p50 {report['error_p50']:.1%}  p90 {report['error_p90']:.1%}  "
        f"max {report['error_max']:.1%}",
    ]
    head = (
        f"{'worst-mispredicted step':<34} {'measured':>12} {'predicted':>12} "
        f"{'rel_err':>8} {'GFLOP/s':>9}"
    )
    lines += [head, "-" * len(head)]
    for r in report.get("worst_steps", []):
        lines.append(
            f"{r['step']:<34} {r['measured_s']:>11.3e}s {r['predicted_s']:>11.3e}s "
            f"{r['rel_err']:>+7.1%} {r['achieved_flops_per_s'] / 1e9:>9.2f}"
        )
    return "\n".join(lines)


# -- roofline view over an exported trace -------------------------------


def roofline_rows(summary_rows: Sequence[dict]) -> list[dict]:
    """Per-stage roofline rows from trace-summary rows (``name``, ``count``,
    ``total_ms`` and counters, as the reference's ``obs.trace_summary``
    gives them): every stage that carried a flops or bytes counter gains its
    achieved throughput (GFLOP/s, GB/s) over its measured wall time —
    per-step spans and phase spans (``sliced.prelude`` / ``.residual``)
    alike."""
    out = []
    for r in summary_rows:
        flops = float(r.get("flops", 0.0))
        nbytes = (
            float(r.get("bytes", 0.0))
            + float(r.get("bytes_in", 0.0))
            + float(r.get("bytes_out", 0.0))
        )
        if flops <= 0.0 and nbytes <= 0.0:
            continue
        secs = r["total_ms"] / 1e3
        out.append(
            {
                "name": r["name"],
                "count": r["count"],
                "total_ms": r["total_ms"],
                "flops": flops,
                "bytes": nbytes,
                "gflops_per_s": (flops / secs / 1e9) if secs > 0 else 0.0,
                "gbytes_per_s": (nbytes / secs / 1e9) if secs > 0 else 0.0,
            }
        )
    return out


def format_roofline_table(rows: Sequence[dict]) -> str:
    """Aligned text table for :func:`roofline_rows`."""
    head = (
        f"{'stage':<36} {'count':>7} {'total_ms':>12} {'flops':>11} "
        f"{'bytes':>11} {'GFLOP/s':>9} {'GB/s':>8}"
    )
    lines = [head, "-" * len(head)]
    for r in rows:
        lines.append(
            f"{r['name']:<36} {r['count']:>7} {r['total_ms']:>12.2f} "
            f"{r['flops']:>11.3g} {r['bytes']:>11.3g} "
            f"{r['gflops_per_s']:>9.2f} {r['gbytes_per_s']:>8.2f}"
        )
    return "\n".join(lines)


# -- planner-facing cost model ------------------------------------------


class CalibratedCostModel:
    """Seconds-domain cost for the slicing/partitioning scorers.

    Wraps a fitted :class:`DeviceModel` (or explicit constants) and
    converts planner op counts into predicted wall time, including the
    per-dispatch overhead raw flop counts are blind to — under it,
    slicing 4× deeper for a 5% flop saving correctly loses once the
    added dispatches outweigh the flops. Consumed by
    ``StemAccountant(cost_model=...)`` /
    ``slice_and_reconfigure(cost_model=...)`` and the kernel ladder
    (:func:`tnc_tpu_torch.ops.split_complex.plan_kernels`).

    >>> m = CalibratedCostModel(flops_per_s=1e9, dispatch_s=1e-3)
    >>> m.sliced_cost(0.0, 1e6, 4)        # 4 * (1 ms flops + 1 ms dispatch)
    0.008
    >>> m.sliced_cost(0.0, 4e6, 1) < m.sliced_cost(0.0, 1e6, 4)
    True
    """

    def __init__(
        self,
        flops_per_s: float,
        dispatch_s: float = 0.0,
        bytes_per_s: float | None = None,
    ):
        if flops_per_s <= 0.0:
            raise ValueError("flops_per_s must be positive")
        self.flops_per_s = float(flops_per_s)
        self.dispatch_s = max(float(dispatch_s), 0.0)
        self.bytes_per_s = (
            float(bytes_per_s) if bytes_per_s else None
        )

    @classmethod
    def from_device_model(cls, model: DeviceModel) -> "CalibratedCostModel":
        return cls(model.flops_per_s, model.dispatch_s, model.bytes_per_s)

    @classmethod
    def from_report(cls, report: dict) -> "CalibratedCostModel":
        """From a record's ``calibration`` block — replanning a
        workload with the constants a previous run measured."""
        return cls(
            report["flops_per_s"],
            report.get("dispatch_overhead_s", 0.0),
            report.get("bytes_per_s"),
        )

    @classmethod
    def from_registry(
        cls,
        registry: MetricsRegistry | None = None,
        source: str | None = None,
    ) -> "CalibratedCostModel | None":
        """Fit from the live registry's step spans (one source only —
        :func:`pick_source` unless given); ``None`` when no fit is
        possible."""
        samples = aggregate_samples(step_samples(registry=registry))
        if source is None:
            source = pick_source(samples)
        model = fit_device_model(
            [s for s in samples if s.source == source]
        )
        return cls.from_device_model(model) if model is not None else None

    def dispatch_equivalent_flops(self) -> float:
        """Flops whose predicted compute time equals ONE dispatch
        overhead — the scale below which a step is dispatch-dominated.
        The kernel promotion ladder's chain rung
        (:func:`tnc_tpu_torch.ops.split_complex.plan_kernels`) fuses runs of
        such steps into one dispatch; a step several times this size
        gains nothing from fusion.

        >>> CalibratedCostModel(1e12, dispatch_s=2e-5).dispatch_equivalent_flops()
        20000000.0
        """
        return self.dispatch_s * self.flops_per_s

    def op_seconds(
        self, flops: float, nbytes: float = 0.0, dispatches: float = 1.0
    ) -> float:
        """Predicted seconds for a region of ``dispatches`` dispatched
        steps. ``dispatch_s`` is fitted from per-STEP samples, so a
        region running N steps pays it N times."""
        t = dispatches * self.dispatch_s + flops / self.flops_per_s
        if nbytes and self.bytes_per_s:
            t += nbytes / self.bytes_per_s
        return t

    def sliced_cost(
        self,
        invariant_flops: float,
        residual_flops: float,
        num_slices: int,
        steps_per_slice: float = 1.0,
        prelude_steps: float = 1.0,
    ) -> float:
        """Predicted seconds of a hoisted sliced execution: the
        invariant stem once (when non-empty), then per slice the
        residual flops plus the per-step overhead times the residual
        step count — the calibrated analogue of the planner's
        ``invariant + num_slices * residual`` flop formula. The fitted
        ``dispatch_s`` is a per-STEP constant, so callers that know the
        step split (``StemAccountant``) pass ``steps_per_slice`` /
        ``prelude_steps``; the default of 1 underestimates overhead for
        multi-step programs but stays monotone in the slice count."""
        prelude = (
            self.op_seconds(invariant_flops, dispatches=prelude_steps)
            if invariant_flops > 0.0
            else 0.0
        )
        return prelude + num_slices * self.op_seconds(
            residual_flops, dispatches=steps_per_slice
        )
