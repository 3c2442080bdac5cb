"""Cost-truth loop: online calibration from production telemetry (the
port's copy of ``tnc_tpu.obs.cost_truth``).

Every decision surface in the stack — planner objectives, kernel/chain
promotion, slicing budgets, replan margins, approx-tier quotes — prices
work through a :class:`~tnc_tpu_torch.obs.calibrate.CalibratedCostModel`, but
that model is fit *offline* from bench runs, and the serving
:class:`~tnc_tpu_torch.obs.slo.DriftDetector` can only *alert* when reality
diverges. This module closes the loop:

- :class:`ProductionSampler` reservoir-samples per-dispatch telemetry
  by (query type × power-of-two batch bucket) in the serving hot path.
  One ``offer()`` is a dict lookup, a counter bump and (past capacity)
  one seeded-RNG draw — suppressible like ``TNC_TPU_TRACE``.
- :func:`refit_model` streams the samples through the same
  ``time ≈ flops/F + bytes/B + c`` least-squares fit the offline
  calibration uses (:func:`~tnc_tpu_torch.obs.calibrate.fit_device_model`),
  with **hysteresis**: a minimum sample count, a bounded per-term
  relative change per epoch (the clamp), and a minimum relative change
  below which the refit is a no-op — so one noisy epoch can never slew
  the fleet's pricing.
- :class:`ModelRegistry` persists each accepted fit as a **versioned**
  model generation with the plan-cache atomic-JSON discipline (unique
  temp file + ``os.replace``; corrupt entries deleted and counted,
  never raised). :class:`ModelRegistryWatcher` is the
  ``SharedCacheWatcher`` analogue: replicas sharing the registry
  directory poll a cheap byte fingerprint and stage new generations
  into their service, which adopts them **only at batch boundaries** —
  a trace never sees two models inside one dispatch.
- :class:`PlanScoreboard` accumulates measured dispatch seconds vs the
  seconds predicted at plan time, keyed by plan-cache key. The
  :class:`~tnc_tpu_torch.serve.replan.BackgroundReplanner` margin compares
  candidates against the *measured* incumbent when the scoreboard is
  warm; a swapped plan whose measured cost regresses beyond tolerance
  within its first N batches (:class:`SwapWatch`) **auto-rolls back**
  to the prior plan, counted and regression-pinned so the bad plan is
  not re-adopted.

:class:`CostTruth` bundles the pieces into the controller a
:class:`~tnc_tpu_torch.serve.service.ContractionService` owns
(``enable_cost_truth``); ``stats()["calibration"]`` and the
``/calibration`` telemetry endpoint surface its state.

>>> cfg = CostTruthConfig(refit_min_samples=2, refit_cooldown_s=0.0)
>>> ct = CostTruth(cfg, model=CalibratedCostModel(flops_per_s=1e9))
>>> ct.model_version
1
>>> for _ in range(4):
...     ct.observe_dispatch("amplitude", 1, 0.02, flops=1e7, nbytes=0.0,
...                         steps=1, plan_key="k", predicted_s=0.01)
>>> ct.maybe_refit(trigger="doctest")
True
>>> ct.adopt_pending() is not None
True
>>> ct.model_version
2
"""

from __future__ import annotations

import json
import logging
import os
import random
import threading
import time
import uuid
from dataclasses import dataclass, field, replace
from pathlib import Path
from typing import Sequence

from tnc_tpu_torch.obs.calibrate import (
    CalibratedCostModel,
    StepSample,
    fit_device_model,
)
from tnc_tpu_torch.utils.digest import stable_digest

logger = logging.getLogger(__name__)

#: registry file name inside the registry directory — one generation
#: file per fleet (the version lives inside, monotone across publishes)
REGISTRY_FILE = "cost_model.json"

#: env kill switch, same discipline as TNC_TPU_TRACE: set to "0" to
#: suppress production sampling entirely (the hot-path hook reduces to
#: one attribute check)
ENV_SUPPRESS = "TNC_TPU_COST_TRUTH"


@dataclass(frozen=True)
class CostTruthConfig:
    """Knobs for the whole loop. The defaults are production-shaped:
    refits need evidence (``refit_min_samples``), move slowly
    (``max_rel_step`` per epoch), and never thrash
    (``refit_cooldown_s``, ``min_rel_change``)."""

    enabled: bool = True  # master switch for the production sampler
    reservoir_size: int = 64  # per-(type × bucket) retained samples
    refit_min_samples: int = 16  # distinct samples before a refit runs
    refit_cooldown_s: float = 5.0  # min seconds between refit epochs
    # hysteresis: each fitted constant moves at most this relative step
    # from the current model per epoch (0.5 = ±50%)
    max_rel_step: float = 0.5
    # a clamped fit within this relative distance of the current model
    # on every term is dropped (no version churn on noise)
    min_rel_change: float = 0.01
    # drain the reservoirs after an accepted refit so the next epoch
    # fits fresh traffic, not a stale mixture
    reset_after_refit: bool = True
    # merge the live registry's per-step spans (run_steps_timed /
    # TNC_TPU_STEP_TIME machinery) into the fit when present
    use_step_spans: bool = True
    # scoreboard: measured incumbent seconds need this many dispatches
    # before the replanner margin (or a rollback baseline) trusts them
    scoreboard_min_samples: int = 8
    scoreboard_max_plans: int = 64
    # rollback: watch the first N post-swap dispatches; if their mean
    # measured seconds exceed tolerance × the pre-swap baseline after
    # min_samples, restage the prior plan
    rollback_window: int = 8
    rollback_tolerance: float = 1.5
    rollback_min_samples: int = 3


@dataclass(frozen=True)
class DispatchSample:
    """One sampled dispatch: the per-dispatch totals the service can
    see (template-program flops/bytes, step count) next to the measured
    wall seconds."""

    kind: str
    bucket: int
    flops: float
    nbytes: float
    steps: int
    dur_s: float


class ProductionSampler:
    """Per-(type × bucket) reservoir sampling of dispatch telemetry.

    Classic Algorithm R per stratum with a seeded RNG (deterministic
    across runs for a given offer sequence): the first ``capacity``
    offers fill the reservoir, after which offer *i* replaces a random
    slot with probability ``capacity / i``. ``enabled=False`` turns
    :meth:`offer` into a single boolean check — the suppressed path the
    overhead pin measures.

    >>> s = ProductionSampler(capacity=2)
    >>> for i in range(10):
    ...     s.offer("amplitude", 1, 1e6, 0.0, 3, 0.001 * (i + 1))
    >>> s.counts()["offered"]
    10
    >>> s.counts()["kept"]
    2
    """

    def __init__(self, capacity: int = 64, enabled: bool = True):
        self.capacity = max(1, int(capacity))
        self.enabled = bool(enabled)
        self._rng = random.Random(0xC057)
        self._lock = threading.Lock()
        # stratum key (kind, bucket) -> [seen_count, list[DispatchSample]]
        self._strata: dict[tuple[str, int], list] = {}
        self._offered = 0

    def offer(
        self,
        kind: str,
        bucket: int,
        flops: float,
        nbytes: float,
        steps: int,
        dur_s: float,
    ) -> None:
        if not self.enabled:
            return
        sample = DispatchSample(
            kind, int(bucket), float(flops), float(nbytes),
            max(int(steps), 1), float(dur_s),
        )
        with self._lock:
            self._offered += 1
            stratum = self._strata.setdefault((kind, int(bucket)), [0, []])
            stratum[0] += 1
            kept = stratum[1]
            if len(kept) < self.capacity:
                kept.append(sample)
            else:
                j = self._rng.randrange(stratum[0])
                if j < self.capacity:
                    kept[j] = sample

    def samples(self) -> list[DispatchSample]:
        with self._lock:
            return [
                s for stratum in self._strata.values() for s in stratum[1]
            ]

    def fit_samples(self) -> list[StepSample]:
        """The reservoir contents as per-STEP samples for
        :func:`~tnc_tpu_torch.obs.calibrate.fit_device_model`: each dispatch
        sample is normalized by its step count, so the fitted
        ``dispatch_s`` stays the per-step constant
        :meth:`CalibratedCostModel.op_seconds` expects."""
        out = []
        for s in self.samples():
            n = max(s.steps, 1)
            out.append(
                StepSample(
                    f"dispatch[{s.kind}/b{s.bucket}]",
                    s.flops / n, s.nbytes / n, s.dur_s / n,
                    source="serve",
                )
            )
        return out

    def counts(self) -> dict:
        with self._lock:
            kept = sum(len(st[1]) for st in self._strata.values())
            by_bucket = {
                f"{kind}/b{bucket}": {"seen": st[0], "kept": len(st[1])}
                for (kind, bucket), st in sorted(self._strata.items())
            }
            return {
                "offered": self._offered,
                "kept": kept,
                "buckets": by_bucket,
            }

    def reset(self) -> None:
        with self._lock:
            self._strata.clear()


def _clamp_term(
    current: float | None, fitted: float | None, max_rel_step: float
) -> tuple[float | None, bool]:
    """One fitted constant bounded to ``±max_rel_step`` relative change
    from the current value. A term the current model lacks adopts the
    fit directly (first epoch learns it); a term the FIT lacks keeps
    the current value (absence of evidence is not evidence the term
    vanished). Returns ``(value, clamped?)``."""
    if fitted is None:
        return current, False
    if current is None or current <= 0.0:
        return fitted, False
    lo = current / (1.0 + max_rel_step)
    hi = current * (1.0 + max_rel_step)
    if fitted < lo:
        return lo, True
    if fitted > hi:
        return hi, True
    return fitted, False


def refit_model(
    current: CalibratedCostModel | None,
    samples: Sequence[StepSample],
    config: CostTruthConfig,
) -> tuple[CalibratedCostModel | None, dict]:
    """One streaming-refit epoch: least-squares fit over ``samples``,
    per-term clamp against ``current``, significance gate. Returns
    ``(model, info)`` where ``model`` is None when no refit should be
    adopted (too few samples, degenerate fit, or change below
    ``min_rel_change``) and ``info`` records why.

    >>> cfg = CostTruthConfig(refit_min_samples=2)
    >>> cur = CalibratedCostModel(flops_per_s=2e9)
    >>> rows = [StepSample("a", 1e9, 0.0, 1.0), StepSample("b", 2e9, 0.0, 2.0)]
    >>> model, info = refit_model(cur, rows, cfg)
    >>> info["clamped"]  # raw fit is 1e9 flops/s: 2x off, clamped to 1.5x
    ['flops_per_s']
    >>> round(model.flops_per_s / 1e9, 3)
    1.333
    """
    info: dict = {"n_samples": len(samples)}
    if len(samples) < config.refit_min_samples:
        info["rejected"] = "min_samples"
        return None, info
    fitted = fit_device_model(samples)
    if fitted is None:
        info["rejected"] = "no_fit"
        return None, info
    info["fit"] = {
        "flops_per_s": fitted.flops_per_s,
        "bytes_per_s": fitted.bytes_per_s,
        "dispatch_s": fitted.dispatch_s,
        "terms": list(fitted.terms),
    }
    clamped: list[str] = []
    if current is None:
        new = CalibratedCostModel.from_device_model(fitted)
    else:
        f, c = _clamp_term(
            current.flops_per_s, fitted.flops_per_s, config.max_rel_step
        )
        if c:
            clamped.append("flops_per_s")
        d, c = _clamp_term(
            current.dispatch_s or None, fitted.dispatch_s or None,
            config.max_rel_step,
        )
        if c:
            clamped.append("dispatch_s")
        b, c = _clamp_term(
            current.bytes_per_s, fitted.bytes_per_s, config.max_rel_step
        )
        if c:
            clamped.append("bytes_per_s")
        new = CalibratedCostModel(f, d or 0.0, b)
        # significance gate: every term within min_rel_change of the
        # current model means nothing worth a new fleet-wide generation
        def _rel(a, b_):
            if not a and not b_:
                return 0.0
            if not a or not b_:
                return 1.0
            return abs(a - b_) / abs(a)

        moved = max(
            _rel(current.flops_per_s, new.flops_per_s),
            _rel(current.dispatch_s, new.dispatch_s),
            _rel(current.bytes_per_s, new.bytes_per_s),
        )
        info["moved"] = round(moved, 6)
        if moved < config.min_rel_change:
            info["rejected"] = "below_min_rel_change"
            return None, info
    info["clamped"] = clamped
    return new, info


class ModelRegistry:
    """Versioned on-disk cost-model generations.

    One ``cost_model.json`` per registry directory, written with the
    plan-cache atomic discipline: a uniquely named temp file is
    ``json.dump``-ed, flushed, fsynced and ``os.replace``-d over the
    entry, so N racing publishers leave whichever complete generation
    landed last and readers are lock-free. The document is
    :meth:`CalibratedCostModel.from_report`-compatible plus provenance
    (``version``, ``fitted_unix``, ``n_samples``, ``trigger``).

    >>> import tempfile
    >>> reg = ModelRegistry(tempfile.mkdtemp())
    >>> reg.publish(CalibratedCostModel(flops_per_s=1e9), trigger="seed")
    1
    >>> reg.publish(CalibratedCostModel(flops_per_s=2e9), trigger="drift")
    2
    >>> version, model = reg.latest()
    >>> version, round(model.flops_per_s / 1e9, 1)
    (2, 2.0)
    """

    def __init__(self, directory: str | Path):
        self.directory = Path(directory)
        self.directory.mkdir(parents=True, exist_ok=True)
        self.path = self.directory / REGISTRY_FILE
        self._counts = {
            "publish": 0, "load": 0, "corrupt": 0, "store_failed": 0,
        }
        self._lock = threading.Lock()

    def _count(self, key: str) -> None:
        with self._lock:
            self._counts[key] += 1

    def load(self) -> dict | None:
        """The raw current generation document (None when absent). A
        corrupt entry is deleted and counted, never raised — the
        plan-cache rule: bad bytes degrade to 'no model', not a crash."""
        try:
            raw = self.path.read_bytes()
        except OSError:
            return None
        self._count("load")
        try:
            doc = json.loads(raw.decode("utf-8"))
            if not isinstance(doc, dict) or "flops_per_s" not in doc:
                raise ValueError("not a model document")
            return doc
        except (ValueError, UnicodeDecodeError):
            self._count("corrupt")
            logger.warning(
                "cost-truth registry: corrupt model document %s deleted",
                self.path,
            )
            try:
                self.path.unlink()
            except OSError:
                pass
            return None

    def latest(self) -> tuple[int, CalibratedCostModel] | None:
        doc = self.load()
        if doc is None:
            return None
        try:
            return int(doc.get("version", 0)), CalibratedCostModel.from_report(
                doc
            )
        except (ValueError, TypeError, KeyError):
            self._count("corrupt")
            return None

    def publish(
        self,
        model: CalibratedCostModel,
        n_samples: int = 0,
        trigger: str = "",
        fitted_unix: float | None = None,
        extra: dict | None = None,
    ) -> int:
        """Write the next generation (current version + 1) atomically;
        returns the published version number."""
        doc = self.load()
        version = int(doc.get("version", 0)) + 1 if doc else 1
        out = {
            "version": version,
            "flops_per_s": model.flops_per_s,
            "dispatch_overhead_s": model.dispatch_s,
            "bytes_per_s": model.bytes_per_s,
            "fitted_unix": (
                time.time() if fitted_unix is None else float(fitted_unix)
            ),
            "n_samples": int(n_samples),
            "trigger": trigger,
        }
        if extra:
            out.update(extra)
        tmp = self.path.with_name(
            f"{REGISTRY_FILE}.{os.getpid()}.{uuid.uuid4().hex[:8]}.json.tmp"
        )
        try:
            with open(tmp, "w", encoding="utf-8") as fh:
                json.dump(out, fh)
                fh.flush()
                os.fsync(fh.fileno())
            os.replace(tmp, self.path)
        except OSError:
            self._count("store_failed")
            logger.warning(
                "cost-truth registry: publish failed", exc_info=True
            )
            try:
                tmp.unlink()
            except OSError:
                pass
            return version
        self._count("publish")
        return version

    def fingerprint(self) -> str | None:
        """Cheap byte digest of the current generation file — the
        watcher's change probe (same idiom as
        :meth:`~tnc_tpu_torch.serve.plancache.PlanCache.entry_fingerprint`)."""
        try:
            raw = self.path.read_bytes()
        except OSError:
            return None
        return stable_digest("cost-model-bytes", raw)

    def stats(self) -> dict:
        with self._lock:
            return dict(self._counts)


class ModelRegistryWatcher:
    """Adopt model generations published by OTHER replicas — the
    :class:`~tnc_tpu_torch.serve.replan.SharedCacheWatcher` path for cost
    models. A fingerprint poll notices a new generation, loads it, and
    stages it on the service's :class:`CostTruth`; the dispatcher
    adopts it at the next batch boundary, so a fleet sharing one
    registry directory converges on one auditable model generation
    without any replica re-fitting.

    >>> ModelRegistryWatcher.__name__
    'ModelRegistryWatcher'
    """

    def __init__(self, service, registry: ModelRegistry,
                 poll_interval_s: float = 0.25):
        self.service = service
        self.registry = registry
        self.poll_interval_s = float(poll_interval_s)
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._seen = registry.fingerprint()
        self.stats = {"adopts": 0, "skips": 0}

    def start(self) -> "ModelRegistryWatcher":
        if self._thread is not None:
            return self
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._loop, name="tnc-serve-modelwatch", daemon=True
        )
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        thread, self._thread = self._thread, None
        if thread is not None:
            thread.join(timeout=60.0)

    def __enter__(self) -> "ModelRegistryWatcher":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    def poll_once(self) -> bool:
        """One fingerprint probe; True when a foreign generation was
        staged for adoption."""
        fp = self.registry.fingerprint()
        if fp is None or fp == self._seen:
            return False
        self._seen = fp
        latest = self.registry.latest()
        if latest is None:
            return False
        version, model = latest
        ct = getattr(self.service, "_cost_truth", None)
        if ct is None or not ct.stage(version, model, origin="registry"):
            # our own publish (already current/staged), or an older
            # generation racing in: nothing to adopt
            self.stats["skips"] += 1
            return False
        self.stats["adopts"] += 1
        logger.info(
            "staged shared cost-model generation v%d for adoption", version
        )
        return True

    def _loop(self) -> None:
        while not self._stop.wait(self.poll_interval_s):
            try:
                self.poll_once()
            except Exception:  # noqa: BLE001 — the watcher must survive
                logger.exception("cost-model registry watch poll failed")


@dataclass
class _ScoreRow:
    n: int = 0
    total_s: float = 0.0
    ewma_s: float = 0.0
    predicted_s: float | None = None
    last_s: float = 0.0
    updated: float = 0.0


class PlanScoreboard:
    """Measured dispatch seconds vs plan-time predictions, per plan key.

    ``note(key, measured_s, predicted_s)`` folds one dispatch in;
    :meth:`measured_seconds` answers the replanner's margin question —
    "what does the incumbent plan actually cost?" — once the row has
    enough samples. Bounded: past ``max_plans`` keys the least recently
    updated row is evicted.

    >>> sb = PlanScoreboard(max_plans=4)
    >>> for _ in range(3):
    ...     sb.note("k", 0.02, predicted_s=0.01)
    >>> sb.measured_seconds("k", min_samples=3)
    0.02
    >>> sb.measured_seconds("k", min_samples=4) is None
    True
    """

    def __init__(self, max_plans: int = 64, alpha: float = 0.2):
        self.max_plans = max(1, int(max_plans))
        self.alpha = float(alpha)
        self._rows: dict[str, _ScoreRow] = {}
        self._lock = threading.Lock()

    def note(
        self, key: str, measured_s: float, predicted_s: float | None = None
    ) -> None:
        with self._lock:
            row = self._rows.get(key)
            if row is None:
                if len(self._rows) >= self.max_plans:
                    oldest = min(
                        self._rows, key=lambda k: self._rows[k].updated
                    )
                    del self._rows[oldest]
                row = self._rows[key] = _ScoreRow()
            row.n += 1
            row.total_s += float(measured_s)
            row.ewma_s = (
                float(measured_s)
                if row.n == 1
                else self.alpha * float(measured_s)
                + (1.0 - self.alpha) * row.ewma_s
            )
            row.last_s = float(measured_s)
            if predicted_s is not None:
                row.predicted_s = float(predicted_s)
            row.updated = time.monotonic()

    def measured_seconds(
        self, key: str, min_samples: int = 1
    ) -> float | None:
        """Mean measured seconds per dispatch for ``key``, or None when
        the row is cold (fewer than ``min_samples`` dispatches)."""
        with self._lock:
            row = self._rows.get(key)
            if row is None or row.n < max(min_samples, 1):
                return None
            return row.total_s / row.n

    def rows(self) -> dict:
        with self._lock:
            out = {}
            for key, row in self._rows.items():
                mean = row.total_s / row.n if row.n else 0.0
                out[key] = {
                    "n": row.n,
                    "mean_s": round(mean, 6),
                    "ewma_s": round(row.ewma_s, 6),
                    "predicted_s": (
                        round(row.predicted_s, 6)
                        if row.predicted_s is not None
                        else None
                    ),
                    "measured_over_predicted": (
                        round(mean / row.predicted_s, 4)
                        if row.predicted_s
                        else None
                    ),
                }
            return out


@dataclass
class SwapWatch:
    """Post-swap regression watch: the first ``window`` measured
    dispatches of a newly adopted plan, judged against the pre-swap
    ``baseline_s``. Verdicts: ``"regressed"`` (mean measured exceeds
    ``tolerance × baseline`` after ``min_samples``), ``"ok"`` (window
    exhausted without regressing), None (still watching)."""

    key: str
    baseline_s: float
    window: int
    tolerance: float
    min_samples: int
    samples: list = field(default_factory=list)
    verdict: str | None = None

    def note(self, measured_s: float) -> str | None:
        if self.verdict is not None:
            return self.verdict
        self.samples.append(float(measured_s))
        n = len(self.samples)
        if n >= self.min_samples:
            mean = sum(self.samples) / n
            if mean > self.tolerance * self.baseline_s:
                self.verdict = "regressed"
                return self.verdict
        if n >= self.window:
            self.verdict = "ok"
        return self.verdict


class CostTruth:
    """The controller a serving process owns: sampler + refit + registry
    + scoreboard + rollback state, with the thread discipline the
    service needs (everything here is leaf-level: no method calls back
    into the service).

    Model adoption is two-phase by design: :meth:`stage` records a
    pending ``(version, model)`` and :meth:`adopt_pending` — called by
    the dispatcher at a batch boundary — makes it current, so no batch
    is ever priced (spanned, drift-predicted, quoted) under two model
    generations."""

    def __init__(
        self,
        config: CostTruthConfig | None = None,
        model: CalibratedCostModel | None = None,
        registry: ModelRegistry | None = None,
        clock=time.monotonic,
    ):
        self.config = config or CostTruthConfig()
        self.registry = registry
        self._clock = clock
        self._lock = threading.Lock()
        self.sampler = ProductionSampler(
            capacity=self.config.reservoir_size,
            enabled=self.config.enabled,
        )
        self.scoreboard = PlanScoreboard(
            max_plans=self.config.scoreboard_max_plans
        )
        self.counts = {
            "samples": 0, "refits": 0, "refit_rejected": 0,
            "publishes": 0, "model_adoptions": 0, "rollbacks": 0,
            "rollback_watches": 0, "rollback_pinned": 0,
        }
        self._pending: tuple[int, CalibratedCostModel, str] | None = None
        self._last_refit = -float("inf")
        self._last_refit_info: dict = {}
        self._fitted_unix: float | None = None
        self.swap_watch: SwapWatch | None = None
        self._rollback_bound = None  # the prior BoundProgram to restore
        self._rollback_staged = False
        self._pinned_sigs: set[str] = set()
        self.last_rollback: dict | None = None
        # seed generation: adopt the registry's current generation when
        # one exists (the fleet's source of truth beats a local offline
        # fit); otherwise publish the offline model as generation 1 so
        # the audit trail starts at the constants that were serving
        self.model = model
        self.model_version = 0
        if registry is not None:
            latest = registry.latest()
            if latest is not None:
                self.model_version, self.model = latest
            elif model is not None:
                self.model_version = registry.publish(
                    model, trigger="seed"
                )
                self.counts["publishes"] += 1
        elif model is not None:
            self.model_version = 1

    # -- hot path --------------------------------------------------------

    def observe_dispatch(
        self,
        kind: str,
        batch: int,
        dur_s: float,
        flops: float = 0.0,
        nbytes: float = 0.0,
        steps: int = 1,
        plan_key: str | None = None,
        predicted_s: float | None = None,
    ) -> str | None:
        """One measured dispatch: feed the sampler, the scoreboard and
        (when one is armed for ``plan_key``) the post-swap watch.
        Returns ``"rollback"`` exactly once, when the watch's verdict
        turns regressed — the caller (the service) then restages the
        prior plan."""
        if not self.config.enabled:
            return None
        with self._lock:
            self.counts["samples"] += 1
        if flops > 0.0:
            self.sampler.offer(kind, batch, flops, nbytes, steps, dur_s)
        if plan_key is None:
            return None
        self.scoreboard.note(plan_key, dur_s, predicted_s=predicted_s)
        with self._lock:
            watch = self.swap_watch
            if watch is None or watch.key != plan_key:
                return None
            verdict = watch.note(dur_s)
            if verdict is None:
                return None
            self.swap_watch = None
            if verdict != "regressed":
                self._rollback_bound = None
                return None
            # regression confirmed: pin the bad plan and hand the prior
            # bound back to the service for restaging
            self.counts["rollbacks"] += 1
            self.last_rollback = {
                "key": plan_key[:12],
                "baseline_s": round(watch.baseline_s, 6),
                "measured_s": round(
                    sum(watch.samples) / len(watch.samples), 6
                ),
                "tolerance": watch.tolerance,
                "samples": len(watch.samples),
            }
            return "rollback"

    # -- refit -----------------------------------------------------------

    def maybe_refit(
        self, trigger: str = "drift", now: float | None = None
    ) -> bool:
        """One refit epoch, gated by cooldown and sample count; on an
        accepted fit the new model is published to the registry (when
        one is attached) and staged for batch-boundary adoption.
        Returns True when a new generation was staged."""
        if not self.config.enabled:
            return False
        now = self._clock() if now is None else now
        with self._lock:
            if now - self._last_refit < self.config.refit_cooldown_s:
                return False
            self._last_refit = now
        rows = self.sampler.fit_samples()
        if self.config.use_step_spans:
            rows = rows + self._step_span_samples()
        new, info = refit_model(self.model, rows, self.config)
        info["trigger"] = trigger
        with self._lock:
            self._last_refit_info = info
        if new is None:
            with self._lock:
                self.counts["refit_rejected"] += 1
            return False
        fitted_unix = time.time()
        if self.registry is not None:
            version = self.registry.publish(
                new, n_samples=len(rows), trigger=trigger,
                fitted_unix=fitted_unix,
            )
            with self._lock:
                self.counts["publishes"] += 1
        else:
            version = self.model_version + 1
        staged = self.stage(version, new, origin="refit")
        if staged:
            with self._lock:
                self.counts["refits"] += 1
                self._fitted_unix = fitted_unix
            if self.config.reset_after_refit:
                self.sampler.reset()
            logger.info(
                "cost-truth refit (trigger=%s): staged model v%d "
                "(%.3e flops/s, %.1e s/dispatch)",
                trigger, version, new.flops_per_s, new.dispatch_s,
            )
        return staged

    def _step_span_samples(self) -> list[StepSample]:
        """Live per-step span samples (the ``run_steps_timed`` /
        ``TNC_TPU_STEP_TIME`` machinery), when obs tracing is on —
        merged into the refit so device-step truth sharpens the
        dispatch-level fit. Best-effort: tracing off → empty."""
        try:
            from tnc_tpu_torch import obs
            from tnc_tpu_torch.obs.calibrate import (
                aggregate_samples,
                pick_source,
                step_samples,
            )

            if not obs.enabled():
                return []
            rows = aggregate_samples(step_samples())
            source = pick_source(rows)
            return [s for s in rows if s.source == source]
        except Exception:  # noqa: BLE001 — sampling must never raise
            return []

    # -- model adoption --------------------------------------------------

    def stage(
        self, version: int, model: CalibratedCostModel, origin: str = ""
    ) -> bool:
        """Record a pending generation for batch-boundary adoption.
        False (no-op) when ``version`` is not newer than the current or
        already-staged generation — the guard that keeps a replica's
        own publish from round-tripping through the watcher."""
        with self._lock:
            if version <= self.model_version:
                return False
            if self._pending is not None and version <= self._pending[0]:
                return False
            self._pending = (int(version), model, origin)
            return True

    def adopt_pending(self) -> tuple[int, CalibratedCostModel] | None:
        """Make the staged generation current (the dispatcher calls
        this at batch boundaries, next to plan-swap adoption). Returns
        ``(version, model)`` when an adoption happened."""
        with self._lock:
            pending, self._pending = self._pending, None
            if pending is None:
                return None
            version, model, _origin = pending
            self.model = model
            self.model_version = version
            self.counts["model_adoptions"] += 1
        return version, model

    # -- rollback plumbing -----------------------------------------------

    def arm_swap_watch(self, key: str, prior_bound, bad_sig: str | None,
                       baseline_s: float | None) -> bool:
        """Arm the post-swap regression watch after a plan adoption.
        Needs a measured (or predicted) baseline; without one the swap
        is unwatchable and simply trusted. ``prior_bound`` is what a
        rollback restores; ``bad_sig`` is the adopted plan's signature,
        pinned on rollback so the regressed plan cannot be re-adopted."""
        if self.config.rollback_window <= 0 or baseline_s is None:
            return False
        if baseline_s <= 0.0 or prior_bound is None:
            return False
        with self._lock:
            if self._rollback_staged:
                # the adoption IS the rollback: restore trust, no watch
                self._rollback_staged = False
                return False
            self.swap_watch = SwapWatch(
                key=key,
                baseline_s=float(baseline_s),
                window=self.config.rollback_window,
                tolerance=self.config.rollback_tolerance,
                min_samples=self.config.rollback_min_samples,
            )
            self._rollback_bound = prior_bound
            self._bad_sig = bad_sig
            self.counts["rollback_watches"] += 1
        return True

    def take_rollback(self):
        """Consume the rollback: pin the regressed plan's signature and
        return the prior bound to restage (None when already taken)."""
        with self._lock:
            bound, self._rollback_bound = self._rollback_bound, None
            if bound is None:
                return None
            bad_sig = getattr(self, "_bad_sig", None)
            if bad_sig is not None and bad_sig not in self._pinned_sigs:
                self._pinned_sigs.add(bad_sig)
                self.counts["rollback_pinned"] += 1
            self._rollback_staged = True
            return bound

    def is_pinned(self, sig: str | None) -> bool:
        if sig is None:
            return False
        with self._lock:
            return sig in self._pinned_sigs

    def count(self, key: str, n: int = 1) -> None:
        with self._lock:
            self.counts[key] = self.counts.get(key, 0) + n

    # -- surfaces --------------------------------------------------------

    def stats(self) -> dict:
        with self._lock:
            counts = dict(self.counts)
            pending = self._pending
            watch = self.swap_watch
            last_refit_info = dict(self._last_refit_info)
            fitted_unix = self._fitted_unix
            last_rollback = (
                dict(self.last_rollback) if self.last_rollback else None
            )
            pinned = len(self._pinned_sigs)
        model = self.model
        out = {
            "enabled": self.config.enabled,
            "model_version": self.model_version,
            "model": (
                {
                    "flops_per_s": model.flops_per_s,
                    "dispatch_s": model.dispatch_s,
                    "bytes_per_s": model.bytes_per_s,
                }
                if model is not None
                else None
            ),
            "fitted_unix": fitted_unix,
            "pending_version": pending[0] if pending else None,
            "counts": counts,
            "sampler": self.sampler.counts(),
            "last_refit": last_refit_info,
            "scoreboard": self.scoreboard.rows(),
            "swap_watch": (
                {
                    "key": watch.key[:12],
                    "baseline_s": round(watch.baseline_s, 6),
                    "samples": len(watch.samples),
                    "window": watch.window,
                }
                if watch is not None
                else None
            ),
            "last_rollback": last_rollback,
            "pinned_plans": pinned,
        }
        if self.registry is not None:
            out["registry"] = self.registry.stats()
        return out


def config_from_env(
    config: CostTruthConfig | None = None,
) -> CostTruthConfig:
    """Apply the ``TNC_TPU_COST_TRUTH`` kill switch to a config — the
    same one-env-var suppression discipline as ``TNC_TPU_TRACE``."""
    cfg = config or CostTruthConfig()
    if os.environ.get(ENV_SUPPRESS, "1") == "0":
        cfg = replace(cfg, enabled=False)
    return cfg
