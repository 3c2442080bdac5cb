"""Serving SLO engine: burn-rate alerts + calibrated drift detection (the
port's copy of ``tnc_tpu.obs.slo``).

The service records
per-request latencies and the calibrated cost model predicts seconds
for every dispatch, but nothing *compares* them to an objective — nobody
can answer "is the fleet meeting its latency SLO right now, and is the
hardware drifting from the calibrated model?". Three pieces:

- **Objectives** (:class:`LatencyObjective`): declarative per-query-type
  targets — "99% of ``amplitude`` requests complete within 50 ms". A
  request is *bad* when it misses the latency threshold or terminates
  in any non-``completed`` outcome (failed / expired / rejected /
  cancelled — the server burned budget either way).
- **Multi-window burn rates**: the SRE-book alerting rule. For an
  objective with target ``f`` the error budget is ``1 - f``; the burn
  rate over a window is ``bad_fraction / budget`` (burn 1.0 = spending
  exactly the budget). An alert needs the burn to exceed the window
  pair's ``factor`` over BOTH the short and the long window — the short
  window makes alerts fast, the long window keeps a transient blip from
  paging (:class:`BurnWindow`).
- **Drift detection** (:class:`DriftDetector`): per executor bucket
  (query type × batch-size bucket), an EWMA of the ratio of measured
  dispatch seconds to the :class:`~tnc_tpu_torch.obs.calibrate.
  CalibratedCostModel` prediction. A healthy fleet holds the ratio
  near its baseline; hardware degradation, a bad plan swap, or a
  co-tenant stealing the machine moves it — the ROADMAP's
  predicted-vs-measured incident signal, computed from data each
  dispatch already carries. ``baseline_samples > 0`` self-baselines
  each bucket on its first observations, so drift means "changed since
  this service started", robust to a miscalibrated model.

Alerts are **edge-triggered** for side effects (one ``slo.alerts``
counter bump + one warning log when an alert starts firing) and
**level-read** for state: :meth:`SLOEngine.check` returns what is
firing *now*, and the service surfaces it as ``stats()["slo"]["alerts"]``
and the ``/slo`` endpoint (:mod:`tnc_tpu_torch.obs.http`).

Everything takes an injectable clock so the burn math is testable with
synthetic timelines (``tests/test_torch_telemetry.py``).

>>> cfg = SLOConfig(
...     objectives=(LatencyObjective("amplitude", 0.05, target=0.9),),
...     windows=(BurnWindow(10.0, 40.0, 2.0),), min_requests=4)
>>> eng = SLOEngine(cfg, clock=lambda: 100.0)
>>> for _ in range(8):
...     eng.record_request("amplitude", 0.5, "completed", t=99.0)
>>> [a["kind"] for a in eng.check(t=100.0)]
['burn']
"""

from __future__ import annotations

import logging
import threading
import time
from collections import deque
from dataclasses import dataclass, field

from tnc_tpu_torch.obs import core as obs_core

logger = logging.getLogger(__name__)

#: terminal request outcomes the engine accounts (everything but
#: ``completed`` consumes error budget)
OUTCOMES = ("completed", "failed", "expired", "rejected", "cancelled")


@dataclass(frozen=True)
class LatencyObjective:
    """One declarative objective: ``target`` fraction of ``type``
    requests must complete within ``threshold_s``. ``type="*"`` matches
    every query type (one fleet-wide objective)."""

    type: str
    threshold_s: float
    target: float = 0.99

    def __post_init__(self):
        if not 0.0 < self.target < 1.0:
            raise ValueError("target must be in (0, 1)")
        if self.threshold_s <= 0.0:
            raise ValueError("threshold_s must be positive")

    @property
    def budget(self) -> float:
        return 1.0 - self.target

    def matches(self, kind: str) -> bool:
        return self.type == "*" or self.type == kind

    def is_bad(self, latency_s: float, outcome: str) -> bool:
        return outcome != "completed" or latency_s > self.threshold_s


@dataclass(frozen=True)
class BurnWindow:
    """A short/long window pair with the burn-rate ``factor`` both must
    exceed to alert (multi-window, multi-burn-rate alerting)."""

    short_s: float
    long_s: float
    factor: float

    def __post_init__(self):
        if not 0.0 < self.short_s <= self.long_s:
            raise ValueError("need 0 < short_s <= long_s")
        if self.factor <= 0.0:
            raise ValueError("factor must be positive")


#: classic page/ticket pair: 14.4x over 5m+1h pages, 6x over 30m+6h
#: tickets (both scaled to the budget)
DEFAULT_WINDOWS = (
    BurnWindow(300.0, 3600.0, 14.4),
    BurnWindow(1800.0, 21600.0, 6.0),
)


@dataclass(frozen=True)
class SLOConfig:
    """Engine configuration. ``drift_baseline_samples > 0`` (the
    default) makes drift self-relative: each bucket's first N
    observations set its baseline ratio, which absorbs per-bucket
    systematics the per-dispatch prediction cannot see (batched
    dispatch work scales with batch size; the cost model predicts one
    dispatch). Set 0 only when the prediction is absolute-trustworthy
    for every bucket — the raw ratio is then compared to 1 directly."""

    objectives: tuple = ()
    windows: tuple = DEFAULT_WINDOWS
    min_requests: int = 10  # short-window events below this never alert
    drift_threshold: float = 1.5  # alert when ratio leaves [1/t, t]
    drift_alpha: float = 0.2  # EWMA weight of the newest sample
    drift_min_samples: int = 8  # per bucket, before drift may alert
    drift_baseline_samples: int = 8
    max_timelines: int = 256  # recent per-request timelines retained
    # hard cap on retained request events: the burn windows bound
    # retention in TIME, this bounds it in COUNT (a 100-rps service
    # with the default 6h long window would otherwise hold millions of
    # tuples and pay a full scan per evaluation — the scan runs on the
    # dispatcher thread each check interval). Past the cap the oldest
    # events drop and long-window burn under-counts — bounded like the
    # obs span cap, loud in the config rather than silent OOM.
    max_events: int = 20_000


@dataclass
class _Bucket:
    """Per-executor-bucket drift state."""

    ewma: float = 0.0
    n: int = 0
    baseline: float = 1.0
    baseline_done: bool = False
    calibrated: bool = False  # bucket mode, fixed by its FIRST sample
    _warmup: list = field(default_factory=list)


class DriftDetector:
    """EWMA of measured-vs-predicted dispatch seconds per bucket.

    ``update(bucket, predicted_s, measured_s)`` folds one dispatch in;
    with ``predicted_s`` None/0 the raw measured seconds are tracked
    instead (self-baselining then makes the ratio unitless). The
    detector alerts when a bucket's normalized ratio leaves
    ``[1/threshold, threshold]`` after ``min_samples`` — both slowdowns
    and "suspiciously fast" (a plan swap that stopped doing the work)
    are incidents.

    >>> d = DriftDetector(threshold=1.5, alpha=0.5, min_samples=2)
    >>> d.update("amp/b8", 0.010, 0.010)
    >>> d.update("amp/b8", 0.010, 0.010)
    >>> d.alerting()
    {}
    >>> for _ in range(8):
    ...     d.update("amp/b8", 0.010, 0.100)
    >>> round(d.alerting()["amp/b8"], 1) > 1.5
    True
    """

    def __init__(
        self,
        threshold: float = 1.5,
        alpha: float = 0.2,
        min_samples: int = 8,
        baseline_samples: int = 0,
    ):
        if threshold <= 1.0:
            raise ValueError("drift threshold must be > 1")
        if not 0.0 < alpha <= 1.0:
            raise ValueError("alpha must be in (0, 1]")
        self.threshold = float(threshold)
        self.alpha = float(alpha)
        self.min_samples = int(min_samples)
        self.baseline_samples = int(baseline_samples)
        self._buckets: dict[str, _Bucket] = {}

    def update(
        self, bucket: str, predicted_s: float | None, measured_s: float
    ) -> None:
        calibrated = bool(predicted_s and predicted_s > 0.0)
        b = self._buckets.setdefault(bucket, _Bucket())
        if b.n == 0:
            b.calibrated = calibrated
        elif b.calibrated != calibrated:
            # ratio and raw-seconds samples must never share an EWMA —
            # that would fabricate drift. A calibrated bucket drops a
            # raw sample (prediction hiccup, e.g. during a plan swap);
            # a RAW bucket whose predictions come online restarts in
            # calibrated mode — freezing it would silently disable
            # drift for that bucket forever over one first-dispatch
            # hiccup.
            if calibrated:
                b = self._buckets[bucket] = _Bucket(calibrated=True)
            else:
                obs_core.counter_add("slo.drift.dropped", bucket=bucket)
                return
        ratio = (
            measured_s / predicted_s if calibrated else float(measured_s)
        )
        b.n += 1
        b.ewma = (
            ratio
            if b.n == 1
            else self.alpha * ratio + (1.0 - self.alpha) * b.ewma
        )
        if self.baseline_samples > 0 and not b.baseline_done:
            b._warmup.append(ratio)
            if len(b._warmup) >= self.baseline_samples:
                mid = sorted(b._warmup)
                b.baseline = mid[len(mid) // 2] or 1.0
                b.baseline_done = True
                b._warmup.clear()

    def _normalized(self, b: _Bucket) -> float:
        return b.ewma / b.baseline if b.baseline else b.ewma

    def _bucket_alerting(self, b: _Bucket) -> bool:
        if b.n < self.min_samples:
            return False
        if self.baseline_samples > 0:
            if not b.baseline_done:
                return False
        elif not b.calibrated:
            # raw measured seconds with no baseline to normalize them:
            # the ratio band is unitless and the comparison meaningless
            return False
        r = self._normalized(b)
        return r > self.threshold or (r > 0.0 and r < 1.0 / self.threshold)

    def alerting(self) -> dict[str, float]:
        """``{bucket: normalized ratio}`` for every drifting bucket."""
        return {
            name: self._normalized(b)
            for name, b in self._buckets.items()
            if self._bucket_alerting(b)
        }

    def stats(self) -> dict[str, dict]:
        """Per-bucket state rows. ``n``/``ewma``/``baseline`` expose the
        sample counts and EWMA state ``min_samples``/``baseline_samples``
        tuning needs to be observable; ``calibrated`` says whether the
        bucket tracks measured/predicted ratios or raw seconds."""
        return {
            name: {
                "ratio": round(self._normalized(b), 4),
                "ewma": round(b.ewma, 6),
                "baseline": round(b.baseline, 6),
                "n": b.n,
                "calibrated": b.calibrated,
                "baseline_done": b.baseline_done,
                "alerting": self._bucket_alerting(b),
            }
            for name, b in self._buckets.items()
        }


class SLOEngine:
    """Burn-rate + drift evaluation over a live request stream.

    The serving layer calls :meth:`record_request` at every terminal
    outcome and :meth:`record_dispatch` after every batch dispatch;
    :meth:`check` (cheap, called at batch boundaries and by ``stats()``)
    evaluates every objective window pair and drift bucket, fires
    edge-triggered side effects for NEW alerts (``slo.alerts`` counter,
    warning log), and returns the currently-firing alert list. All
    public methods are thread-safe.
    """

    def __init__(self, config: SLOConfig | None = None, clock=time.monotonic):
        self.config = config or SLOConfig()
        self._clock = clock
        self._lock = threading.Lock()
        # (t, kind, latency_s, bad-per-objective tuple)
        self._events: deque = deque(maxlen=self.config.max_events)
        self._outcome_counts: dict[str, int] = {o: 0 for o in OUTCOMES}
        self._timelines: deque = deque(maxlen=self.config.max_timelines)
        self.drift = DriftDetector(
            threshold=self.config.drift_threshold,
            alpha=self.config.drift_alpha,
            min_samples=self.config.drift_min_samples,
            baseline_samples=self.config.drift_baseline_samples,
        )
        self._active: dict[str, dict] = {}
        self._alerts_total = 0
        # dispatches the drift detector never saw, per bucket: kinds
        # whose handlers declare drift_stable=False are excluded from
        # drift (their per-bucket seconds are not comparable), but the
        # excluded volume must stay visible or min_requests tuning
        # reads "no drift" as "no traffic"
        self._drift_excluded: dict[str, int] = {}
        self._horizon = max(
            (w.long_s for w in self.config.windows), default=0.0
        )

    def _now(self, t: float | None) -> float:
        return self._clock() if t is None else float(t)

    # -- ingestion -------------------------------------------------------

    def record_request(
        self,
        kind: str,
        latency_s: float,
        outcome: str = "completed",
        t: float | None = None,
        timeline: dict | None = None,
    ) -> None:
        """One terminal request outcome. ``timeline`` (optional) is the
        request's plain-data trace record, retained in a bounded ring
        for the ``/slo`` endpoint's recent-requests view."""
        t = self._now(t)
        bad = tuple(
            obj.matches(kind) and obj.is_bad(latency_s, outcome)
            for obj in self.config.objectives
        )
        with self._lock:
            self._events.append((t, kind, float(latency_s), bad))
            self._outcome_counts[outcome] = (
                self._outcome_counts.get(outcome, 0) + 1
            )
            if timeline is not None:
                self._timelines.append(timeline)
            self._prune(t)

    def record_dispatch(
        self, bucket: str, predicted_s: float | None, measured_s: float
    ) -> None:
        """One batch dispatch's measured wall seconds next to the
        calibrated prediction (None when no cost model is attached —
        drift then tracks raw measured seconds per bucket)."""
        with self._lock:
            self.drift.update(bucket, predicted_s, measured_s)

    def record_dispatch_excluded(self, bucket: str) -> None:
        """One dispatch of a payload-variant (``drift_stable=False``)
        kind, deliberately NOT fed to the drift detector — counted per
        bucket so the exclusion is observable instead of silent."""
        with self._lock:
            self._drift_excluded[bucket] = (
                self._drift_excluded.get(bucket, 0) + 1
            )

    def _prune(self, now: float) -> None:
        horizon = self._horizon
        while self._events and now - self._events[0][0] > horizon:
            self._events.popleft()

    # -- evaluation ------------------------------------------------------

    def burn_rates(self, t: float | None = None) -> list[dict]:
        """Current burn per objective per window pair (the ``/slo`` and
        ``stats()`` surface). ONE pass over the event deque accumulates
        (total, bad) per objective per distinct window edge — this runs
        on the serving dispatcher thread every check interval, so the
        scan cost must not multiply by objectives x windows."""
        now = self._now(t)
        objs = self.config.objectives
        edges = sorted(
            {e for w in self.config.windows for e in (w.short_s, w.long_s)}
        )
        # counts[obj_idx][edge] = [total, bad]
        counts = [{e: [0, 0] for e in edges} for _ in objs]
        with self._lock:
            for tev, kind, _lat, flags in self._events:
                age = now - tev
                if edges and age > edges[-1]:
                    continue
                for i, obj in enumerate(objs):
                    if not obj.matches(kind):
                        continue
                    bad = 1 if flags[i] else 0
                    for e in edges:
                        if age <= e:
                            c = counts[i][e]
                            c[0] += 1
                            c[1] += bad
        out = []
        for i, obj in enumerate(objs):
            row = {
                "type": obj.type,
                "threshold_s": obj.threshold_s,
                "target": obj.target,
                "windows": [],
            }
            for w in self.config.windows:
                ts, bads = counts[i][w.short_s]
                tl, badl = counts[i][w.long_s]
                bs = (bads / ts) / obj.budget if ts else 0.0
                bl = (badl / tl) / obj.budget if tl else 0.0
                row["windows"].append(
                    {
                        "short_s": w.short_s,
                        "long_s": w.long_s,
                        "factor": w.factor,
                        "burn_short": round(bs, 4),
                        "burn_long": round(bl, 4),
                        "events_short": ts,
                        "alerting": (
                            ts >= self.config.min_requests
                            and bs > w.factor
                            and bl > w.factor
                        ),
                    }
                )
            out.append(row)
        return out

    def check(self, t: float | None = None) -> list[dict]:
        """Evaluate everything; fire side effects for alerts that are
        NEW since the last check; return the currently-firing alerts."""
        now = self._now(t)
        return self._evaluate(self.burn_rates(now), now)

    def _evaluate(self, burn_rows: list[dict], now: float) -> list[dict]:
        """Alert evaluation over precomputed burn rows (so ``stats()``
        scans the event window once, not twice)."""
        active: dict[str, dict] = {}
        for row in burn_rows:
            for w in row["windows"]:
                if not w["alerting"]:
                    continue
                key = f"burn:{row['type']}:{w['short_s']:g}s"
                active[key] = {
                    "kind": "burn",
                    "key": key,
                    "type": row["type"],
                    "value": min(w["burn_short"], w["burn_long"]),
                    "threshold": w["factor"],
                    "detail": (
                        f"burn {w['burn_short']:.1f}x/{w['burn_long']:.1f}x "
                        f"over {w['short_s']:g}s/{w['long_s']:g}s windows "
                        f"(budget factor {w['factor']:g})"
                    ),
                }
        with self._lock:
            for bucket, ratio in self.drift.alerting().items():
                key = f"drift:{bucket}"
                active[key] = {
                    "kind": "drift",
                    "key": key,
                    "bucket": bucket,
                    "value": round(ratio, 4),
                    "threshold": self.config.drift_threshold,
                    "detail": (
                        f"measured/predicted dispatch ratio {ratio:.2f} "
                        f"left [{1 / self.config.drift_threshold:.2f}, "
                        f"{self.config.drift_threshold:.2f}]"
                    ),
                }
            fresh = [a for k, a in active.items() if k not in self._active]
            self._active = active
            self._alerts_total += len(fresh)
        for alert in fresh:
            obs_core.counter_add("slo.alerts", kind=alert["kind"])
            logger.warning("SLO alert: %s — %s", alert["key"], alert["detail"])
        return list(active.values())

    # -- surfaces --------------------------------------------------------

    def timelines(self) -> list[dict]:
        """Most recent per-request timeline records (bounded ring)."""
        with self._lock:
            return list(self._timelines)

    def stats(self, t: float | None = None) -> dict:
        """Plain-data snapshot: objectives + burns, drift buckets, the
        firing alerts, and outcome totals — the ``stats()["slo"]`` block
        and the ``/slo`` endpoint body."""
        now = self._now(t)
        burn_rows = self.burn_rates(now)
        alerts = self._evaluate(burn_rows, now)
        with self._lock:
            outcomes = dict(self._outcome_counts)
            drift = self.drift.stats()
            excluded = dict(self._drift_excluded)
            total = self._alerts_total
        return {
            "objectives": burn_rows,
            "drift": drift,
            "drift_excluded": excluded,
            "alerts": alerts,
            "alerts_total": total,
            "outcomes": outcomes,
        }
