"""Planner fleet: distributed, cached, always-on path search (the port's
copy of ``tnc_tpu.serve.plansvc``; a board either package writes is read
by the other).

The joint tree+slice search made sliced rescoring cheap; what the
hardest structures need now is search *scale*. This module turns the N
replicas of a serving fleet into N× planner throughput during idle
windows, with zero new infrastructure: work distribution rides the
plan-cache directory discipline (atomic unique-tmp JSON, mtime
staleness), trial results travel as symbolic plans
(:mod:`tnc_tpu_torch.contractionpath.symbolic` — digest-deduped, structurally
diffable), and the merged winner publishes through the normal
:class:`~tnc_tpu_torch.serve.plancache.PlanCache` store so every
:class:`~tnc_tpu_torch.serve.replan.SharedCacheWatcher` replica adopts it
live.

Roles and protocol (one directory per structure under the board root):

- ``structure.json`` — the trial *seed*: the network's flat leaves
  (legs + bond dims only, never tensor data), the peak budget, and the
  deterministic trial grid parameters. The first replica to publish it
  is the **coordinator**; everyone else is a **worker**. Both then run
  the same claim loop — the roles differ only in who seeded.
- ``trial-<digest>.json`` — one trial spec, created with
  ``O_CREAT|O_EXCL`` so duplicate specs (two replicas seeding the same
  grid, a re-seeded coordinator) dedupe by digest at the filesystem.
- ``lease-<digest>.json`` — a worker's claim on a trial, also
  exclusive-create. A lease whose mtime goes stale (a SIGKILL'd
  worker) is **reclaimed** by atomic takeover (unique tmp +
  ``os.replace``); racing reclaims are benign because trials are
  deterministic functions of (structure, spec) and results dedupe by
  digest.
- ``result-<digest>.json`` — the trial's
  :class:`~tnc_tpu_torch.contractionpath.symbolic.SymbolicPlan` (or a failure
  marker, so a structurally infeasible trial terminates instead of
  being reclaimed forever), written with the plan cache's unique-tmp +
  fsync + replace pattern.

Idle gating: the in-service pod (:class:`PlannerFleet`) only works
while ``service.queue_depth() == 0`` — the exact signal
:class:`~tnc_tpu_torch.serve.replan.BackgroundReplanner` uses, so planning
never competes with serving. The replanner itself **delegates** its
hot-key searches to the pod when one is attached (one code path for
replanning and fleet planning, no cache-key races); a standalone
worker process (``python -m tnc_tpu_torch.serve.plansvc <board-dir>``) joins
the same board from outside any service.

Trial diversity (the coordinator's grid, :func:`seed_trials`): a
greedy baseline, SA temperature ladders, partition+slice SA moves
(arXiv:2507.20667 — ``p_partition_move`` in
:func:`~tnc_tpu_torch.contractionpath.sliced_cost.anneal_sliced`), and
slice-aware bisection whose cut weights discount already-sliced legs.
Every trial is deterministic given (structure, spec), so a distributed
N-trial budget selects from exactly the candidate set a single-node
N-trial run would — distributed search can tie but never lose.

The pod's thread does host work only (trials, the merge's
``record_for`` and ``bind_template``); the swapped plan reaches the card
when the service's dispatcher adopts it at a batch boundary.
"""

from __future__ import annotations

import json
import logging
import math
import os
import random
import threading
import time
import uuid
from dataclasses import dataclass
from pathlib import Path
from typing import Mapping, Sequence

from tnc_tpu_torch import obs
from tnc_tpu_torch.contractionpath.contraction_cost import (
    CalibratedObjective,
    FlopsObjective,
    contract_path_cost,
)
from tnc_tpu_torch.contractionpath.contraction_path import (
    ContractionPath,
    ssa_replace_ordering,
)
from tnc_tpu_torch.contractionpath.symbolic import SymbolicPlan
from tnc_tpu_torch.tensornetwork.tensor import LeafTensor
from tnc_tpu_torch.utils.digest import stable_digest

logger = logging.getLogger(__name__)

WIRE_VERSION = 1


# -- trial specs --------------------------------------------------------


@dataclass(frozen=True)
class TrialSpec:
    """One deterministic planner trial: which base tree to build
    (``kind``) and how hard to refine it jointly. Identity is the
    stable digest of every field — the board's dedupe key.

    >>> s = TrialSpec(kind="sa", seed=43)
    >>> TrialSpec.from_obj(s.to_obj()) == s
    True
    """

    kind: str = "sa"  # greedy | sa | sa_partition | bisect
    seed: int = 42
    sa_steps: int = 600
    sa_rounds: int = 2
    t_start: float = 0.3
    t_end: float = 0.01
    p_partition: float = 0.0
    imbalance: float = 0.1
    slice_seed: int = 0

    def digest(self) -> str:
        return stable_digest(
            "tnc-trial-v%d" % WIRE_VERSION,
            self.kind, self.seed, self.sa_steps, self.sa_rounds,
            self.t_start, self.t_end, self.p_partition, self.imbalance,
            self.slice_seed,
        )

    def to_obj(self) -> dict:
        return {
            "version": WIRE_VERSION,
            "kind": self.kind,
            "seed": self.seed,
            "sa_steps": self.sa_steps,
            "sa_rounds": self.sa_rounds,
            "t_start": self.t_start,
            "t_end": self.t_end,
            "p_partition": self.p_partition,
            "imbalance": self.imbalance,
            "slice_seed": self.slice_seed,
        }

    @classmethod
    def from_obj(cls, obj: Mapping) -> "TrialSpec":
        if not isinstance(obj, Mapping) or obj.get("version") != WIRE_VERSION:
            raise ValueError(f"unusable trial spec: {obj!r:.80}")
        return cls(
            kind=str(obj["kind"]),
            seed=int(obj["seed"]),
            sa_steps=int(obj["sa_steps"]),
            sa_rounds=int(obj["sa_rounds"]),
            t_start=float(obj["t_start"]),
            t_end=float(obj["t_end"]),
            p_partition=float(obj["p_partition"]),
            imbalance=float(obj["imbalance"]),
            slice_seed=int(obj["slice_seed"]),
        )


#: temperature ladder for the SA trial grid (hot explores, cold polishes)
_TEMP_GRID = ((0.5, 0.01), (0.3, 0.01), (0.15, 0.005))
_TRIAL_KINDS = ("sa", "sa_partition", "bisect")


def seed_trials(
    ntrials: int,
    seed: int = 42,
    sa_steps: int = 600,
    sa_rounds: int = 2,
) -> list[TrialSpec]:
    """The coordinator's deterministic diversity grid: trial 0 is the
    greedy baseline (so the merged best can never lose to the no-search
    plan), then kinds cycle through plain SA / partition+slice SA /
    slice-aware bisection across the temperature ladder, with the
    bisection imbalance drawn exactly like the Hyperoptimizer's trials
    (``Random(seed + t)``). Same (ntrials, seed) → same specs on every
    replica, so concurrent seeders dedupe to one grid.

    >>> a, b = seed_trials(5, seed=7), seed_trials(5, seed=7)
    >>> [s.digest() for s in a] == [s.digest() for s in b]
    True
    >>> len({s.digest() for s in a})
    5
    """
    specs = [
        TrialSpec(kind="greedy", seed=seed, sa_steps=0, sa_rounds=0)
    ]
    for t in range(1, max(1, int(ntrials))):
        kind = _TRIAL_KINDS[(t - 1) % len(_TRIAL_KINDS)]
        t_start, t_end = _TEMP_GRID[((t - 1) // len(_TRIAL_KINDS))
                                    % len(_TEMP_GRID)]
        lo, hi = 0.02, 0.40  # the hyper search's imbalance range
        imbalance = lo + (hi - lo) * random.Random(seed + t).random()
        specs.append(TrialSpec(
            kind=kind,
            seed=seed + t,
            sa_steps=int(sa_steps),
            sa_rounds=int(sa_rounds),
            t_start=t_start,
            t_end=t_end,
            p_partition=0.15 if kind == "sa_partition" else 0.0,
            imbalance=round(imbalance, 6),
            slice_seed=t,
        ))
    return specs


# -- trial execution ----------------------------------------------------


def _greedy_base(inputs: Sequence[LeafTensor]) -> list[tuple[int, int]]:
    from tnc_tpu_torch.contractionpath.paths.greedy import _ssa_greedy

    return _ssa_greedy(list(inputs))


def _greedy_slice_set(
    inputs: Sequence[LeafTensor],
    base: list[tuple[int, int]],
    target_size: float,
) -> frozenset[int]:
    """The greedy plan's slice set under the budget — the discount set
    for slice-aware bisection (legs that will be sliced away anyway
    should be cheap to cut)."""
    from tnc_tpu_torch.contractionpath.sliced_cost import (
        SlicedCostEvaluator,
        greedy_slice_to_target,
    )

    replace = ssa_replace_ordering(
        ContractionPath.simple(list(base))
    ).toplevel
    ev = SlicedCostEvaluator(inputs, list(replace))
    try:
        greedy_slice_to_target(ev, target_size)
    except ValueError:
        return frozenset()
    return ev.removed


def _bisect_base(
    inputs: Sequence[LeafTensor],
    spec: TrialSpec,
    discount_legs: frozenset[int],
) -> list[tuple[int, int]]:
    """One slice-aware bisection tree: the Hyperoptimizer's trial
    pipeline (rank<=2 absorption, recursive bisection, greedy cutoff)
    with the candidate slice set's cut weights discounted."""
    from tnc_tpu_torch.contractionpath.paths.hyper import (
        _bisection_path_impl,
        _simplify,
    )

    dims: dict[int, int] = {}
    for t in inputs:
        for leg, dim in t.edges():
            dims[leg] = dim
    prefix, legs_map, next_id = _simplify(
        {i: frozenset(t.legs) for i, t in enumerate(inputs)}, dims
    )
    core_ids = sorted(legs_map)
    rng = random.Random(spec.seed)
    return prefix + _bisection_path_impl(
        core_ids, legs_map, dims, next_id, rng, spec.imbalance, 12,
        discount_legs=discount_legs or None,
    )


def run_trial(
    spec: TrialSpec,
    inputs: Sequence[LeafTensor],
    target_size: float,
    cost_model=None,
) -> SymbolicPlan:
    """Execute one trial: build the kind's base tree, refine it with
    :func:`~tnc_tpu_torch.contractionpath.sliced_cost.joint_slice_search`
    under the budget, and wrap the winner as a wire-ready
    :class:`~tnc_tpu_torch.contractionpath.symbolic.SymbolicPlan`.
    Deterministic given (structure, spec) — which is what lets a
    distributed trial budget select from the identical candidate set a
    single-node run would. Raises ``ValueError`` when the budget is
    unreachable even from the greedy base."""
    from tnc_tpu_torch.contractionpath.sliced_cost import (
        SlicedCostEvaluator,
        joint_slice_search,
    )

    inputs = list(inputs)
    greedy = _greedy_base(inputs)
    if spec.kind == "bisect":
        discount = _greedy_slice_set(inputs, greedy, target_size)
        bases = [_bisect_base(inputs, spec, discount), greedy]
    else:
        bases = [greedy]

    last_err: Exception | None = None
    for base in bases:
        try:
            pairs, slicing, cost = joint_slice_search(
                inputs,
                base,
                target_size,
                cost_model=cost_model,
                sa_steps=spec.sa_steps,
                sa_rounds=spec.sa_rounds,
                seed=spec.seed ^ (spec.slice_seed << 8),
                temps=(spec.t_start, spec.t_end),
                p_partition_move=spec.p_partition,
            )
        except ValueError as exc:  # this base can't reach the budget
            last_err = exc
            continue
        replace = ssa_replace_ordering(
            ContractionPath.simple(list(pairs))
        ).toplevel
        ev = SlicedCostEvaluator(
            inputs, list(replace), removed=slicing.legs,
            cost_model=cost_model,
        )
        return SymbolicPlan.from_search(
            pairs,
            slicing.legs,
            slicing.dims,
            cost,
            sliced_total=ev.sliced_total(),
            peak=ev.peak(),
            provenance={"trial": spec.to_obj(), "digest": spec.digest()},
        )
    raise ValueError(f"no trial base reaches the budget: {last_err}")


def run_trials_local(
    inputs: Sequence[LeafTensor],
    target_size: float,
    specs: Sequence[TrialSpec],
    cost_model=None,
) -> list[SymbolicPlan | None]:
    """Run a spec list in-process (the single-node arm of the
    distributed-vs-local quality comparison; infeasible trials map to
    ``None``)."""
    out: list[SymbolicPlan | None] = []
    for spec in specs:
        try:
            out.append(run_trial(spec, inputs, target_size, cost_model))
        except ValueError:
            out.append(None)
    return out


def best_plan(
    plans: Sequence[SymbolicPlan | None],
) -> SymbolicPlan | None:
    """The cheapest unique candidate: dedupe by structural digest
    (identical plans found by different trials count once), then min by
    recorded cost with the digest as a deterministic tiebreak."""
    unique: dict[str, SymbolicPlan] = {}
    for plan in plans:
        if plan is None or math.isinf(plan.cost):
            continue
        key = plan.digest()
        if key not in unique or plan.cost < unique[key].cost:
            unique[key] = plan
    if not unique:
        return None
    return min(unique.values(), key=lambda p: (p.cost, p.digest()))


# -- the on-disk trial board --------------------------------------------


class TrialBoard:
    """One structure's fan-out directory: structure seed, trial specs,
    leases, results — every write atomic (unique tmp + ``os.replace``
    or exclusive-create), every read tolerant (corrupt files deleted
    and counted, never raised), exactly the
    :class:`~tnc_tpu_torch.serve.plancache.PlanCache` discipline.

    >>> import tempfile
    >>> b = TrialBoard(tempfile.mkdtemp(), owner="w0")
    >>> spec = TrialSpec(kind="greedy", seed=1, sa_steps=0, sa_rounds=0)
    >>> b.post_trial(spec), b.post_trial(spec)  # digest-deduped
    (True, False)
    >>> b.claim(spec.digest()), b.claim(spec.digest())
    (True, False)
    >>> b.done()
    False
    """

    STRUCTURE = "structure.json"

    def __init__(
        self,
        directory: str | Path,
        stale_after_s: float = 10.0,
        owner: str | None = None,
    ):
        self.directory = Path(directory)
        self.directory.mkdir(parents=True, exist_ok=True)
        self.stale_after_s = float(stale_after_s)
        self.owner = owner or f"{os.getpid()}-{uuid.uuid4().hex[:6]}"
        self.stats = {
            k: 0
            for k in (
                "posts", "dedup", "claims", "reclaims", "results",
                "failures", "corrupt",
            )
        }

    # -- atomic write helper -------------------------------------------

    def _write_atomic(self, target: Path, obj: dict) -> None:
        tmp = target.with_name(
            f"{target.name}.{os.getpid()}.{uuid.uuid4().hex[:8]}.tmp"
        )
        with open(tmp, "w", encoding="utf-8") as fh:
            json.dump(obj, fh)
            fh.flush()
            os.fsync(fh.fileno())
        os.replace(tmp, target)

    def _read_json(self, target: Path) -> dict | None:
        """Tolerant read: absent → None; corrupt → unlink + count,
        never raise (a torn or tampered board file degrades to "that
        record does not exist yet")."""
        try:
            with open(target, "r", encoding="utf-8") as fh:
                obj = json.load(fh)
            if not isinstance(obj, dict):
                raise ValueError("not a JSON object")
            return obj
        except FileNotFoundError:
            return None
        except Exception as exc:  # noqa: BLE001 — corruption → drop
            logger.warning(
                "board file %s unreadable (%s: %s); dropping it",
                target, type(exc).__name__, exc,
            )
            self.stats["corrupt"] += 1
            obs.counter_add("serve.plansvc.corrupt")
            try:
                target.unlink(missing_ok=True)
            except OSError:
                pass
            return None

    # -- structure seed -------------------------------------------------

    def publish_structure(
        self,
        inputs: Sequence[LeafTensor],
        target_size: float,
        key: str | None = None,
        extra: Mapping | None = None,
    ) -> bool:
        """Seed the board (coordinator role): the flat leaves as
        (legs, dims) lists — enough to rebuild cost-evaluation
        ``LeafTensor`` stand-ins in any process, never tensor data —
        plus the budget. First publisher wins (exclusive create)."""
        target = self.directory / self.STRUCTURE
        doc = {
            "version": WIRE_VERSION,
            "key": key,
            "target_size": float(target_size),
            "leaves": [
                [list(t.legs), [int(d) for _, d in t.edges()]]
                for t in inputs
            ],
            **dict(extra or {}),
        }
        try:
            fd = os.open(
                target, os.O_CREAT | os.O_EXCL | os.O_WRONLY, 0o644
            )
        except FileExistsError:
            return False
        with os.fdopen(fd, "w", encoding="utf-8") as fh:
            json.dump(doc, fh)
            fh.flush()
            os.fsync(fh.fileno())
        return True

    def load_structure(self) -> dict | None:
        """The seed with ``inputs`` rebuilt as ``LeafTensor`` stand-ins
        (legs + dims only), or None while unseeded."""
        doc = self._read_json(self.directory / self.STRUCTURE)
        if doc is None or doc.get("version") != WIRE_VERSION:
            return None
        try:
            doc["inputs"] = [
                LeafTensor(list(legs), list(dims))
                for legs, dims in doc["leaves"]
            ]
        except Exception:  # noqa: BLE001 — unusable seed → unseeded
            self.stats["corrupt"] += 1
            return None
        return doc

    # -- trials ---------------------------------------------------------

    def post_trial(self, spec: TrialSpec) -> bool:
        """Exclusive-create ``trial-<digest>.json`` — duplicate specs
        (same grid seeded twice) dedupe at the filesystem."""
        target = self.directory / f"trial-{spec.digest()}.json"
        try:
            fd = os.open(
                target, os.O_CREAT | os.O_EXCL | os.O_WRONLY, 0o644
            )
        except FileExistsError:
            self.stats["dedup"] += 1
            obs.counter_add("serve.plansvc.trial_dedup")
            return False
        with os.fdopen(fd, "w", encoding="utf-8") as fh:
            json.dump(spec.to_obj(), fh)
            fh.flush()
            os.fsync(fh.fileno())
        self.stats["posts"] += 1
        obs.counter_add("serve.plansvc.trial_posted")
        return True

    def trials(self) -> list[TrialSpec]:
        out = []
        for path in sorted(self.directory.glob("trial-*.json")):
            obj = self._read_json(path)
            if obj is None:
                continue
            try:
                out.append(TrialSpec.from_obj(obj))
            except Exception:  # noqa: BLE001 — bad spec → drop
                self.stats["corrupt"] += 1
                try:
                    path.unlink(missing_ok=True)
                except OSError:
                    pass
        return out

    # -- leases ---------------------------------------------------------

    def _lease_path(self, digest: str) -> Path:
        return self.directory / f"lease-{digest}.json"

    def claim(self, digest: str) -> bool:
        """Claim a trial: exclusive-create its lease, or — when the
        existing lease's mtime has gone stale (its worker died) — take
        it over atomically. Racing reclaims are benign: trials are
        deterministic, so two workers running one spec publish
        identical results that dedupe by digest."""
        target = self._lease_path(digest)
        doc = {"owner": self.owner, "pid": os.getpid(), "at": time.time()}
        try:
            fd = os.open(
                target, os.O_CREAT | os.O_EXCL | os.O_WRONLY, 0o644
            )
        except FileExistsError:
            try:
                age = time.time() - target.stat().st_mtime
            except OSError:
                return False  # vanished mid-probe: someone else acted
            if age <= self.stale_after_s:
                return False
            try:
                self._write_atomic(target, doc)
            except OSError:
                return False
            self.stats["reclaims"] += 1
            obs.counter_add("serve.plansvc.lease_reclaimed")
            return True
        with os.fdopen(fd, "w", encoding="utf-8") as fh:
            json.dump(doc, fh)
        self.stats["claims"] += 1
        obs.counter_add("serve.plansvc.lease_claimed")
        return True

    def renew(self, digest: str) -> None:
        """Refresh the lease mtime (a long trial's keep-alive)."""
        try:
            os.utime(self._lease_path(digest))
        except OSError:
            pass

    # -- results --------------------------------------------------------

    def _result_path(self, digest: str) -> Path:
        return self.directory / f"result-{digest}.json"

    def post_result(
        self, digest: str, plan: SymbolicPlan | None, error: str = ""
    ) -> None:
        """Publish a trial's outcome atomically. ``plan=None`` writes a
        failure marker — an infeasible trial *terminates* (counts as
        done) instead of being lease-reclaimed forever."""
        if plan is None:
            doc = {
                "version": WIRE_VERSION, "failed": True,
                "error": error[:500], "owner": self.owner,
            }
            self.stats["failures"] += 1
            obs.counter_add("serve.plansvc.trial_failed")
        else:
            doc = plan.to_obj()
            doc["trial"] = digest
            doc["owner"] = self.owner
            self.stats["results"] += 1
            obs.counter_add("serve.plansvc.trial_result")
        self._write_atomic(self._result_path(digest), doc)

    def results(self) -> list[SymbolicPlan]:
        """Every successful trial result, digest-validated on parse
        (a corrupt or tampered plan drops, never loads)."""
        out = []
        for path in sorted(self.directory.glob("result-*.json")):
            obj = self._read_json(path)
            if obj is None or obj.get("failed"):
                continue
            try:
                out.append(SymbolicPlan.from_obj(obj))
            except Exception as exc:  # noqa: BLE001 — bad plan → drop
                logger.warning(
                    "trial result %s rejected (%s: %s)",
                    path.name, type(exc).__name__, exc,
                )
                self.stats["corrupt"] += 1
                obs.counter_add("serve.plansvc.corrupt")
                try:
                    path.unlink(missing_ok=True)
                except OSError:
                    pass
        return out

    def result_digests(self) -> set[str]:
        return {
            p.name[len("result-"):-len(".json")]
            for p in self.directory.glob("result-*.json")
        }

    def pending(self) -> list[TrialSpec]:
        """Trials with no result yet (leased or not — the claim loop
        decides what is actually takeable)."""
        done = self.result_digests()
        return [s for s in self.trials() if s.digest() not in done]

    def done(self) -> bool:
        """True once every posted trial has an outcome (results and
        failure markers both count)."""
        trials = self.trials()
        return bool(trials) and not self.pending()


def work_board(
    board: TrialBoard,
    cost_model=None,
    max_trials: int | None = None,
    should_stop=None,
    hold_after_claim: bool = False,
) -> int:
    """The worker side of the protocol: claim pending trials, run them,
    publish results; returns the number of trials this call ran. Used
    identically by the in-service pod, the synchronous delegate path,
    and the standalone CLI — one code path, three entry points.

    ``hold_after_claim`` (tests): claim one trial, print its digest,
    then block forever — the SIGKILL target for the lease-reclaim
    lifecycle test."""
    doc = board.load_structure()
    if doc is None:
        return 0
    inputs = doc["inputs"]
    target_size = doc["target_size"]
    ran = 0
    while max_trials is None or ran < max_trials:
        if should_stop is not None and should_stop():
            break
        claimed = None
        for spec in board.pending():
            if board.claim(spec.digest()):
                claimed = spec
                break
        if claimed is None:
            break
        if hold_after_claim:
            print(f"CLAIMED {claimed.digest()}", flush=True)
            while True:  # parked until SIGKILL
                time.sleep(60.0)
        digest = claimed.digest()
        board.renew(digest)
        with obs.span("plansvc.trial") as sp:
            sp.add(kind=claimed.kind, seed=claimed.seed)
            try:
                plan = run_trial(claimed, inputs, target_size, cost_model)
            except Exception as exc:  # noqa: BLE001 — post the failure
                logger.warning(
                    "trial %s (%s) failed: %s", digest[:12], claimed.kind,
                    exc,
                )
                board.post_result(digest, None, error=str(exc))
                ran += 1
                continue
            sp.add(cost=plan.cost, num_slices=plan.num_slices)
        board.post_result(digest, plan)
        ran += 1
    return ran


# -- the in-service planner pod -----------------------------------------


class PlannerFleet:
    """The planner pod a serving replica attaches
    (:meth:`~tnc_tpu_torch.serve.service.ContractionService.enable_plansvc`):
    a daemon thread that — only while the request queue is empty —
    seeds this structure's trial board (first replica wins the
    coordinator role), claims and runs trials like any worker, and,
    once the board drains, merges the global best through the normal
    plan-cache publish + rebuild + ``swap_bound`` path, so every
    shared-cache-watching replica adopts it live.

    >>> PlannerFleet.__name__
    'PlannerFleet'
    """

    def __init__(
        self,
        service,
        plan_cache,
        directory: str | Path | None = None,
        ntrials: int = 6,
        seed: int = 42,
        margin: float = 0.98,
        cost_model=None,
        sa_steps: int = 600,
        sa_rounds: int = 2,
        poll_interval_s: float = 0.05,
        stale_after_s: float = 10.0,
        owner: str | None = None,
    ):
        """``margin``: the merged best must be strictly cheaper than
        ``margin * incumbent`` to swap (same no-churn discipline as the
        background replanner). ``directory`` defaults to a ``plansvc/``
        sibling inside the plan-cache directory, so a fleet sharing the
        cache volume shares the boards with zero extra config."""
        self.service = service
        self.plan_cache = plan_cache
        self.cost_model = cost_model
        self.objective = (
            CalibratedObjective(cost_model)
            if cost_model is not None
            else FlopsObjective()
        )
        root = (
            Path(directory)
            if directory is not None
            else Path(plan_cache.directory) / "plansvc"
        )
        self.root = root
        self.ntrials = int(ntrials)
        self.seed = int(seed)
        self.margin = float(margin)
        self.sa_steps = int(sa_steps)
        self.sa_rounds = int(sa_rounds)
        self.poll_interval_s = float(poll_interval_s)
        self.stale_after_s = float(stale_after_s)
        self.owner = owner
        self.role = "idle"
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._boards: dict[str, TrialBoard] = {}
        self._merge_lock = threading.Lock()
        self._merged_keys: set[str] = set()
        self._seeded_keys: set[str] = set()
        self._keyed_bound = None
        self._keyed_key: str | None = None
        self._counts = {
            k: 0
            for k in (
                "trials_run", "seeded", "merges", "swaps", "rejects",
                "merge_failures",
            )
        }
        self.best_cost: float | None = None
        self.best_delta: float = 0.0

    # -- lifecycle -----------------------------------------------------

    def start(self) -> "PlannerFleet":
        if self._thread is not None:
            return self
        self.service._plansvc = self
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._loop, name="tnc-serve-plansvc", daemon=True
        )
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        thread, self._thread = self._thread, None
        if thread is not None:
            thread.join(timeout=60.0)

    def __enter__(self) -> "PlannerFleet":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # -- board plumbing -------------------------------------------------

    def board_for(self, key: str) -> TrialBoard:
        board = self._boards.get(key)
        if board is None:
            board = TrialBoard(
                self.root / key,
                stale_after_s=self.stale_after_s,
                owner=self.owner,
            )
            self._boards[key] = board
        return board

    def supports(self, bound) -> bool:
        """Whether the fleet can plan this bound: the joint search
        needs a peak budget, and a swap needs the incumbent's cache
        record (the replanner's own refusal rule)."""
        return bound.target_size is not None and bool(bound.plan)

    def _bound_and_key(self):
        bound = self.service.bound
        if bound is self._keyed_bound:
            return bound, self._keyed_key
        key = self.plan_cache.key_for_network(
            bound.template.network, bound.target_size
        )
        self._keyed_bound, self._keyed_key = bound, key
        return bound, key

    def _ensure_seeded(self, board: TrialBoard, bound, key: str) -> None:
        from tnc_tpu_torch.ops.program import flat_leaf_tensors

        if key in self._seeded_keys:
            return
        self._seeded_keys.add(key)
        if board.load_structure() is None:
            leaves = flat_leaf_tensors(bound.template.network)
            if board.publish_structure(
                leaves, bound.target_size, key=key,
                extra={"seed": self.seed, "ntrials": self.ntrials},
            ):
                self.role = "coordinator"
                self._counts["seeded"] += 1
                obs.counter_add("serve.plansvc.seeded")
        elif self.role == "idle":
            self.role = "worker"
        for spec in seed_trials(
            self.ntrials, seed=self.seed,
            sa_steps=self.sa_steps, sa_rounds=self.sa_rounds,
        ):
            board.post_trial(spec)

    # -- the idle-window loop -------------------------------------------

    def _loop(self) -> None:
        while not self._stop.wait(self.poll_interval_s):
            if self.service.queue_depth() > 0:
                continue  # the replanner's idleness gate, verbatim
            try:
                self._tick()
            except Exception:  # noqa: BLE001 — the pod must survive
                logger.exception("plansvc tick failed")
                _, key = self._bound_and_key()
                with self._merge_lock:
                    self._merged_keys.add(key)

    def _tick(self) -> None:
        bound, key = self._bound_and_key()
        with self._merge_lock:
            if key in self._merged_keys:
                return
        if not self.supports(bound) or (
            bound.plan.get("finder") not in _fast_finders()
        ):
            with self._merge_lock:
                self._merged_keys.add(key)
            return
        board = self.board_for(key)
        self._ensure_seeded(board, bound, key)
        ran = work_board(
            board,
            cost_model=self.cost_model,
            max_trials=1,
            should_stop=lambda: (
                self._stop.is_set() or self.service.queue_depth() > 0
            ),
        )
        self._counts["trials_run"] += ran
        if board.done():
            self.merge(bound, key, board)

    # -- delegation (the replanner's fleet path) ------------------------

    def delegate(self, bound, key: str) -> bool:
        """Synchronous fleet search for the replanner: seed (or join)
        the structure's board, work it until every trial has an
        outcome — stale-lease reclaims bound how long a dead worker
        can stall this — then merge-and-swap. Returns True when the
        merged best was swapped in. One code path with the pod loop:
        both sides run :func:`work_board` against the same board, so a
        replanner-delegated search and an idle-window fleet search are
        indistinguishable on disk."""
        board = self.board_for(key)
        self._ensure_seeded(board, bound, key)
        while not board.done():
            if self._stop.is_set():
                return False
            ran = work_board(
                board, cost_model=self.cost_model, max_trials=1,
                should_stop=self._stop.is_set,
            )
            self._counts["trials_run"] += ran
            if ran == 0 and not board.done():
                # everything pending is validly leased elsewhere: wait
                # for results (or for the leases to go stale)
                time.sleep(min(self.poll_interval_s, 0.05))
        return self.merge(bound, key, board)

    # -- merge + publish ------------------------------------------------

    def merge(self, bound, key: str, board: TrialBoard) -> bool:
        """Merge the board's global best into the serving plan through
        the background replanner's exact publish tail: re-price the
        candidate locally (never trust wire costs for a swap), apply
        the margin, publish via ``PlanCache.record_for``/``store``,
        rebuild through the normal cache-hit path, verify the rebuilt
        signature, and stage the swap at a batch boundary."""
        with self._merge_lock:
            if key in self._merged_keys:
                return False
            self._merged_keys.add(key)
        self._counts["merges"] += 1
        obs.counter_add("serve.plansvc.merge")
        try:
            return self._merge_impl(bound, key, board)
        except Exception:  # noqa: BLE001 — a failed merge must not
            # kill the pod loop; the incumbent keeps serving
            logger.exception("plansvc merge for %s failed", key[:12])
            self._counts["merge_failures"] += 1
            obs.counter_add("serve.plansvc.merge_failed")
            return False

    def _merge_impl(self, bound, key: str, board: TrialBoard) -> bool:
        from tnc_tpu_torch.ops.program import build_program, flat_leaf_tensors
        from tnc_tpu_torch.ops.sliced import build_sliced_program
        from tnc_tpu_torch.serve.rebind import bind_template, plan_signature
        from tnc_tpu_torch.serve.replan import plan_predicted_cost

        winner = best_plan(board.results())
        if winner is None:
            logger.info("plansvc board %s drained with no usable result",
                        key[:12])
            return False
        tn = bound.template.network
        leaves = flat_leaf_tensors(tn)
        path = ssa_replace_ordering(
            ContractionPath.simple([list(p) for p in winner.pairs])
        )
        slicing = winner.slicing()
        candidate_cost = plan_predicted_cost(
            leaves, path.toplevel, slicing, self.objective
        )
        incumbent_path = ContractionPath.from_obj(bound.plan["pairs"])
        incumbent_slicing = self.plan_cache.plan_slicing(bound.plan)
        incumbent_cost = plan_predicted_cost(
            leaves, incumbent_path.toplevel, incumbent_slicing,
            self.objective,
        )
        self.best_cost = candidate_cost
        if incumbent_cost > 0:
            self.best_delta = 1.0 - candidate_cost / incumbent_cost
        if not candidate_cost < self.margin * incumbent_cost:
            self._counts["rejects"] += 1
            obs.counter_add("serve.plansvc.reject")
            logger.info(
                "plansvc merge rejected for %s: best %.3e !< %.2f * "
                "incumbent %.3e", key[:12], candidate_cost, self.margin,
                incumbent_cost,
            )
            return False
        flops, peak = contract_path_cost(leaves, path, True)
        program = build_program(tn, path)
        sliced = (
            build_sliced_program(tn, path, slicing)
            if slicing is not None
            else None
        )
        plan = self.plan_cache.record_for(
            path,
            program,
            slicing=slicing,
            sliced_program=sliced,
            flops=flops,
            peak=peak,
            finder="PlannerFleet",
            target_size=bound.target_size,
            predicted_seconds=(
                candidate_cost if self.cost_model is not None else None
            ),
        )
        self.plan_cache.store(key, plan)
        new_bound = bind_template(
            bound.template, None, self.plan_cache, bound.target_size,
            bound.reuse.store if bound.reuse is not None else None,
        )
        if plan_signature(new_bound) != program.signature_digest():
            # the store did not survive the cache round-trip (disk
            # full, dir gone): swapping the fallback rebuild in would
            # not be the plan we priced — the incumbent stands
            self._counts["merge_failures"] += 1
            obs.counter_add("serve.plansvc.store_lost")
            logger.warning(
                "plansvc swap for %s abandoned: merged plan did not "
                "survive the cache round-trip", key[:12],
            )
            return False
        self.service.swap_bound(new_bound)
        self._counts["swaps"] += 1
        obs.counter_add("serve.plansvc.swap")
        logger.info(
            "plansvc swap for %s: predicted cost %.3e -> %.3e "
            "(%d trial results merged)",
            key[:12], incumbent_cost, candidate_cost,
            len(board.results()),
        )
        return True

    # -- surfaces -------------------------------------------------------

    def stats(self) -> dict:
        """The ``stats()["plansvc"]`` block: role, event counts, the
        aggregated board counters, and the last merge's best cost and
        relative improvement."""
        boards = {
            k: 0
            for k in (
                "posts", "dedup", "claims", "reclaims", "results",
                "failures", "corrupt",
            )
        }
        for board in self._boards.values():
            for k, v in board.stats.items():
                boards[k] = boards.get(k, 0) + v
        return {
            "role": self.role,
            "counts": dict(self._counts),
            "board": boards,
            "best_cost": self.best_cost,
            "best_delta": round(self.best_delta, 6),
        }

    def heartbeat_payload(self) -> dict:
        """What rides the fleet heartbeat (read once the fleet plane is
        ported): role, trials completed here, and the last merge's
        relative cost improvement."""
        return {
            "role": self.role,
            "trials": self._counts["trials_run"],
            "best_delta": round(self.best_delta, 4),
        }


def _fast_finders() -> tuple:
    from tnc_tpu_torch.serve.replan import _FAST_FINDERS

    return _FAST_FINDERS


# -- standalone worker CLI ----------------------------------------------


def main(argv: Sequence[str] | None = None) -> int:
    """``python -m tnc_tpu_torch.serve.plansvc <board-dir>`` — a standalone
    worker: join the board, claim trials until none are takeable, exit
    with the number of trials run in the process exit status 0 path.
    ``--hold-after-claim`` parks after one claim (lease-reclaim test
    target); ``--stale-after`` tunes the reclaim threshold."""
    import argparse

    parser = argparse.ArgumentParser(description=main.__doc__)
    parser.add_argument("board", help="per-structure board directory")
    parser.add_argument("--owner", default=None)
    parser.add_argument("--stale-after", type=float, default=10.0)
    parser.add_argument("--max-trials", type=int, default=None)
    parser.add_argument("--hold-after-claim", action="store_true")
    args = parser.parse_args(argv)

    board = TrialBoard(
        args.board, stale_after_s=args.stale_after, owner=args.owner
    )
    if board.load_structure() is None:
        print("board has no structure.json", flush=True)
        return 2
    ran = work_board(
        board,
        max_trials=args.max_trials,
        hold_after_claim=args.hold_after_claim,
    )
    print(f"ran {ran} trials", flush=True)
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
