"""Anytime background replanning for the serving path (the port's copy of
``tnc_tpu.serve.replan``).

A cache miss answers from a fast greedy plan so the first request never
waits on a hyper-optimizer — but without this module that plan is
frozen: the service keeps dispatching whatever a cache miss happened to
get, even though PLANNER_QUALITY.json records multi-order-of-magnitude
flop gaps between greedy and hyper plans on hard structures.

:class:`BackgroundReplanner` closes the loop. A low-priority daemon
thread watches an attached :class:`~tnc_tpu_torch.serve.service.
ContractionService` and, **between requests** (it only works while the
queue is empty), hyper-optimizes the service's bound structure once it
is hot enough (``min_hits`` against the structure's request/cache heat;
:meth:`~tnc_tpu_torch.serve.plancache.PlanCache.hot_keys` exposes the same
ranking for multi-structure deployments and dashboards). A candidate
plan replaces the incumbent only when its predicted cost beats it by
``margin`` under the replanner's objective (predicted *seconds* under a
:class:`~tnc_tpu_torch.obs.calibrate.CalibratedCostModel` when one is given,
naive-op flops otherwise — never wall-clock luck).

Swap safety:

- the **same atomic-write path** as any plan store
  (:meth:`PlanCache.store`: temp file + ``os.replace``) publishes the
  improved plan, under the same structure digest — which embeds the
  ``target_size`` budget, so the replanner re-plans under the budget
  the entry was keyed with and can never swap an over-budget plan into
  a budget-constrained slot;
- the new plan's ``program_sig`` is recorded exactly like a fresh
  plan's, so later processes rebuild-and-validate it normally;
- the in-memory :class:`~tnc_tpu_torch.serve.rebind.BoundProgram` is rebuilt
  from the cache entry (zero pathfinding — the normal cache-hit path)
  on the replanner thread, then staged via
  :meth:`ContractionService.swap_bound`; the dispatcher adopts it at a
  batch boundary, so every request runs wholly under one plan and
  amplitudes stay correct through the swap (both plans contract the
  same network).

Threads on the card: the replanner and the watcher run on threads of
their own, and do host work only — planning, ``record_for``,
``bind_template`` and the reuse split. None of them touches CUDA: the
service's dispatcher is its only thread that does. The swapped
:class:`~tnc_tpu_torch.serve.rebind.BoundProgram` is adopted by the
dispatcher at a batch boundary, where its first call runs eagerly and its
graph is captured after, as for any bound program.

Counters: ``serve.replan.attempt`` / ``serve.replan.swap`` /
``serve.replan.reject`` (+ the service-side ``serve.replan.adopted``).

Fleet visibility: because swaps publish through the shared on-disk
store, a :class:`SharedCacheWatcher` on any OTHER replica notices the
new entry (a cheap byte-fingerprint probe) and adopts it into its own
running service through the identical rebuild-and-swap path — one
replica's background search improves every replica sharing the cache
directory (``serve.replan.shared_adopt``).

Budget-constrained structures get the Hyperoptimizer's **joint
tree+slice search** (its default with a ``target_size``): the
background search optimizes the sliced total directly and hands its
slice set to a seeded thin ``slice_and_reconfigure`` repair
(:func:`~tnc_tpu_torch.serve.rebind.plan_structure`), so the plans that
stream into live replicas through the shared cache are sliced-optimal,
not flop-optimal-then-sliced.
"""

from __future__ import annotations

import logging
import threading

from tnc_tpu_torch import obs
from tnc_tpu_torch.contractionpath.contraction_cost import (
    CalibratedObjective,
    FlopsObjective,
    PathObjective,
)
from tnc_tpu_torch.contractionpath.contraction_path import ContractionPath
from tnc_tpu_torch.ops.program import flat_leaf_tensors
from tnc_tpu_torch.serve.rebind import (
    bind_template,
    plan_signature,
    plan_structure,
)

logger = logging.getLogger(__name__)

#: finders whose plans are already search-quality: the replanner leaves
#: them alone (replanning a hyper plan with the same hyper is a no-op
#: that burns background CPU forever)
_FAST_FINDERS = (None, "", "Greedy", "Cotengrust")


def plan_predicted_cost(
    inputs, replace_pairs, slicing, objective: PathObjective
) -> float:
    """Predicted cost of a stored plan (flat replace path + optional
    slicing) under ``objective`` — the comparison key for swap
    decisions, computed identically for incumbent and candidate."""
    pairs = list(replace_pairs)
    if slicing is not None and slicing.num_slices > 1:
        return objective.sliced_path_cost(inputs, pairs, slicing)
    return objective.path_cost(inputs, ContractionPath.simple(pairs))


class SharedCacheWatcher:
    """Adopt plan-cache publishes made by OTHER replicas.

    A fleet of serving replicas shares one
    :class:`~tnc_tpu_torch.serve.plancache.PlanCache` directory; when any of
    them (usually the one running a :class:`BackgroundReplanner`)
    publishes an improved plan for this service's structure, the watcher
    sees the entry's byte fingerprint change, rebuilds a
    :class:`~tnc_tpu_torch.serve.rebind.BoundProgram` through the normal
    cache-hit path (zero pathfinding), and stages it via
    :meth:`~tnc_tpu_torch.serve.service.ContractionService.swap_bound` — the
    same batch-boundary adoption as a local replan, so amplitudes stay
    correct through the swap. An entry whose rebuilt program matches
    the serving one (a same-plan re-publish, or our own store) is
    skipped.

    >>> SharedCacheWatcher.__name__
    'SharedCacheWatcher'
    """

    def __init__(
        self,
        service,
        plan_cache,
        poll_interval_s: float = 0.25,
    ):
        self.service = service
        self.plan_cache = plan_cache
        self.poll_interval_s = float(poll_interval_s)
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        bound = service.bound
        self._key = plan_cache.key_for_network(
            bound.template.network, bound.target_size
        )
        # baseline: whatever is on disk NOW is what this service serves
        # (or close enough — adopting it immediately would be a no-op
        # swap anyway, caught by the signature check)
        self._seen = plan_cache.entry_fingerprint(self._key)
        # a publish whose adoption keeps raising (corrupt/incompatible
        # foreign entry) is abandoned after max_failures consecutive
        # attempts — the full rebuild must not re-run 4x/second forever.
        # A NEW publish (different fingerprint) re-arms the watcher.
        self.max_failures = 5
        self._fail_count = 0
        self._last_fp = None
        self.stats = {"adopts": 0, "skips": 0, "abandons": 0}

    def start(self) -> "SharedCacheWatcher":
        if self._thread is not None:
            return self
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._loop, name="tnc-serve-cachewatch", daemon=True
        )
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        thread, self._thread = self._thread, None
        if thread is not None:
            thread.join(timeout=60.0)

    def __enter__(self) -> "SharedCacheWatcher":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    def poll_once(self) -> bool:
        """One fingerprint probe; True when a foreign publish was
        adopted (exposed for deterministic tests — the thread loop is
        just this on a timer)."""
        fp = self.plan_cache.entry_fingerprint(self._key)
        self._last_fp = fp
        if fp is None or fp == self._seen:
            return False
        # _seen advances only after the publish is fully handled — a
        # rebuild/swap that raises here (transient I/O on the shared
        # volume, a rejected swap) is retried on the next poll instead
        # of being silently dropped until some future publish
        bound = self.service.bound
        new_bound = bind_template(
            bound.template, None, self.plan_cache, bound.target_size,
            bound.reuse.store if bound.reuse is not None else None,
        )
        if plan_signature(new_bound) == plan_signature(bound):
            # same plan re-published (or our own write): nothing to adopt
            self._seen = fp
            self.stats["skips"] += 1
            return False
        self.service.swap_bound(new_bound)
        self._seen = fp
        self.stats["adopts"] += 1
        obs.counter_add("serve.replan.shared_adopt")
        logger.info(
            "adopted shared-cache plan for %s (foreign publish)",
            self._key[:12],
        )
        return True

    def _loop(self) -> None:
        while not self._stop.wait(self.poll_interval_s):
            try:
                self.poll_once()
                self._fail_count = 0
            except Exception:  # noqa: BLE001 — the watcher must survive
                self._fail_count += 1
                if (
                    self._fail_count >= self.max_failures
                    and self._last_fp is not None
                ):
                    # abandon exactly the publish that kept failing:
                    # advancing _seen to its fingerprint stops the
                    # rebuild churn; any later publish re-arms
                    self._seen = self._last_fp
                    self._fail_count = 0
                    self.stats["abandons"] += 1
                    obs.counter_add("serve.replan.shared_abandon")
                    logger.exception(
                        "shared-cache publish for %s abandoned after %d "
                        "failed adoptions (re-armed by the next publish)",
                        self._key[:12], self.max_failures,
                    )
                else:
                    logger.exception("shared-cache watch poll failed")


class BackgroundReplanner:
    """Hyper-optimize hot plan-cache entries between requests.

    >>> # constructed against a running service; see tests/test_torch_planes.py
    >>> BackgroundReplanner.__name__
    'BackgroundReplanner'
    """

    def __init__(
        self,
        service,
        plan_cache,
        optimizer=None,
        cost_model=None,
        margin: float = 0.95,
        min_hits: int = 0,
        poll_interval_s: float = 0.02,
    ):
        """``optimizer``: the improving pathfinder (default: a bounded
        :class:`~tnc_tpu_torch.contractionpath.paths.hyper.Hyperoptimizer`
        sized for background work). Each structure gets ONE search:
        the optimizer is seeded/deterministic, so its verdict — swap
        or reject — is final and re-attempting would redo identical
        work ("anytime" means the service answers from the fast plan
        immediately and adopts the improvement whenever the background
        search lands, not unbounded improvement rounds; pass a larger
        ``optimizer`` for a deeper single search).
        ``cost_model``: a fitted :class:`~tnc_tpu_torch.obs.calibrate.
        CalibratedCostModel` — swap decisions then compare predicted
        seconds; without one they compare flops. ``margin``: the
        candidate must be strictly cheaper than ``margin * incumbent``
        (default 5% better) so plan churn never oscillates on noise.
        ``min_hits``: leave the structure alone until it is hot — the
        larger of its plan-cache hit count and the service's completed
        request count must reach this (a cache-missed structure has
        zero cache hits by definition, so request traffic is what
        proves it hot)."""
        self.service = service
        self.plan_cache = plan_cache
        self.cost_model = cost_model
        self.objective: PathObjective = (
            CalibratedObjective(cost_model)
            if cost_model is not None
            else FlopsObjective()
        )
        self._default_optimizer = optimizer is None
        if optimizer is None:
            from tnc_tpu_torch.contractionpath.paths.hyper import Hyperoptimizer

            optimizer = Hyperoptimizer(
                ntrials=4,
                polish_rounds=2,
                polish_steps=1000,
                reconfigure_budget=5.0,
                objective=(
                    self.objective if cost_model is not None else None
                ),
            )
        self.optimizer = optimizer
        self.margin = float(margin)
        self.min_hits = int(min_hits)
        self.poll_interval_s = float(poll_interval_s)
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._done_keys: set[str] = set()
        # memoized (bound object, its cache key): the poll loop runs
        # ~50x/s and must not recompute the full network structure
        # digest every tick just to find the key in _done_keys
        self._keyed_bound = None
        self._keyed_key: str | None = None
        self.stats = {
            "attempts": 0, "swaps": 0, "rejects": 0, "measured_margins": 0,
            "delegated": 0,
        }

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> "BackgroundReplanner":
        if self._thread is not None:
            return self
        self.service._replanner = self
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._loop, name="tnc-serve-replan", daemon=True
        )
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        thread, self._thread = self._thread, None
        if thread is not None:
            thread.join(timeout=60.0)

    def __enter__(self) -> "BackgroundReplanner":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # -- cost-truth integration --------------------------------------------

    def measured_incumbent(self) -> float | None:
        """The serving plan's measured mean dispatch seconds from the
        cost-truth scoreboard — the margin's incumbent cost when warm.
        None without a seconds objective (measured seconds are not
        comparable to a flops objective), without cost-truth, or while
        the scoreboard row is cold."""
        if self.cost_model is None:
            return None
        fn = getattr(self.service, "measured_plan_seconds", None)
        return fn() if fn is not None else None

    def adopt_cost_model(self, model) -> None:
        """Adopt a new cost-model generation (the service calls this at
        the batch boundary where it adopts one): the seconds objective
        re-prices under the new constants, and settled per-structure
        verdicts re-open — a plan rejected under stale pricing may win
        under the truth. No-op for a flops-objective replanner (its
        decisions never consumed the model)."""
        if model is None or self.cost_model is None:
            return
        self.cost_model = model
        self.objective = CalibratedObjective(model)
        if self._default_optimizer and hasattr(self.optimizer, "objective"):
            self.optimizer.objective = self.objective
        self._done_keys.clear()

    # -- worker ------------------------------------------------------------

    def _loop(self) -> None:
        while not self._stop.wait(self.poll_interval_s):
            # low priority: only think while the service is idle
            if self.service.queue_depth() > 0:
                continue
            try:
                self._attempt_once()
            except Exception:  # noqa: BLE001 — the worker must survive
                logger.exception("background replan attempt failed")
                # abandon the structure: without this a persistent
                # planning failure re-runs a full hyper search every
                # poll interval, burning a core and spamming the log
                try:
                    bound = self.service.bound
                    self._done_keys.add(
                        self.plan_cache.key_for_network(
                            bound.template.network, bound.target_size
                        )
                    )
                except Exception:  # noqa: BLE001 — key derivation too
                    pass

    def _candidate_bound(self):
        """The service's current bound, if it still deserves replanning
        work; ``None`` otherwise."""
        bound = self.service.bound
        if bound is self._keyed_bound:
            key = self._keyed_key
        else:
            key = self.plan_cache.key_for_network(
                bound.template.network, bound.target_size
            )
            self._keyed_bound, self._keyed_key = bound, key
        if key in self._done_keys:
            return None, key
        if not bound.plan:
            # no cache record: the serving plan's provenance and true
            # cost are unknown (the structure was bound without this
            # cache, e.g. an explicit bind_circuit(pathfinder=...)) —
            # pricing a greedy reconstruction as the incumbent could
            # swap OUT a better plan than it swaps in. Leave it alone.
            self._done_keys.add(key)
            return None, key
        if bound.plan.get("finder") not in _FAST_FINDERS:
            return None, key  # already search-quality
        if self.min_hits > 0:
            # heat = cache hits OR served requests: a cache-missed
            # structure never load()s again in-process, so its traffic
            # is the only signal that it is worth hyper time
            served = self.service.stats()["counts"].get("completed", 0)
            if max(self.plan_cache.hits(key), served) < self.min_hits:
                return None, key
        return bound, key

    def _attempt_once(self) -> bool:
        """One anytime improvement round; True when a swap happened."""
        bound, key = self._candidate_bound()
        if bound is None:
            return False
        self.stats["attempts"] += 1
        obs.counter_add("serve.replan.attempt")

        # with a planner fleet attached, hot-key searches fan out over
        # idle replicas instead of running one local hyper trial set —
        # one code path for replanning and fleet planning, no race on
        # the same cache key. The local search below stays the
        # no-fleet fallback.
        pod = getattr(self.service, "_plansvc", None)
        if pod is not None and pod.supports(bound):
            self.stats["delegated"] += 1
            obs.counter_add("serve.replan.delegated")
            swapped = pod.delegate(bound, key)
            if swapped:
                self.stats["swaps"] += 1
            self._done_keys.add(key)
            return swapped

        if (
            self._default_optimizer
            and getattr(self.optimizer, "target_size", None)
            != bound.target_size
        ):
            # budget-constrained structure: the default hyper must pick
            # its winner by sliced cost under the structure's budget
            # (sliced_score), not raw flops — otherwise the candidate is
            # the exact misranking its own selection warns about
            self.optimizer.target_size = bound.target_size
        tn = bound.template.network
        leaves = flat_leaf_tensors(tn)
        path, slicing, program, sliced, result = plan_structure(
            tn, self.optimizer, bound.target_size,
            cost_model=self.cost_model,
        )
        candidate_cost = plan_predicted_cost(
            leaves, path.toplevel, slicing, self.objective
        )

        # _candidate_bound guarantees a cache record: the incumbent is
        # priced from the plan actually serving, never a reconstruction
        incumbent_path = ContractionPath.from_obj(bound.plan["pairs"])
        incumbent_slicing = self.plan_cache.plan_slicing(bound.plan)
        incumbent_cost = plan_predicted_cost(
            leaves, incumbent_path.toplevel, incumbent_slicing,
            self.objective,
        )
        # cost-truth scoreboard: when the incumbent's MEASURED dispatch
        # seconds are warm, the margin compares against reality instead
        # of the prediction — a plan that predicts well but measures
        # badly becomes beatable. Seconds-objective only (a measured
        # second cannot be compared against a flop count); cold
        # scoreboard falls back to the prediction.
        measured = self.measured_incumbent()
        if measured is not None:
            incumbent_cost = measured
            self.stats["measured_margins"] += 1
            obs.counter_add("serve.replan.measured_margin")

        if not candidate_cost < self.margin * incumbent_cost:
            self.stats["rejects"] += 1
            obs.counter_add("serve.replan.reject")
            # this optimizer's verdict is in; don't spin on the key
            self._done_keys.add(key)
            logger.info(
                "replan rejected for %s: candidate %.3e !< %.2f * "
                "incumbent %.3e", key[:12], candidate_cost, self.margin,
                incumbent_cost,
            )
            return False

        # publish: the SAME atomic-write path every fresh plan uses,
        # under the same (structure, budget) key
        plan = self.plan_cache.record_for(
            path,
            program,
            slicing=slicing,
            sliced_program=sliced,
            flops=result.flops,
            peak=result.size,
            finder=type(self.optimizer).__name__,
            target_size=bound.target_size,
            predicted_seconds=(
                candidate_cost if self.cost_model is not None else None
            ),
        )
        self.plan_cache.store(key, plan)
        # rebuild the in-memory BoundProgram through the normal
        # cache-hit path (zero pathfinding) and stage the swap
        new_bound = bind_template(
            bound.template, None, self.plan_cache, bound.target_size,
            bound.reuse.store if bound.reuse is not None else None,
        )
        if plan_signature(new_bound) != program.signature_digest():
            # the store was best-effort and evidently did not stick
            # (disk full, cache dir gone): the rebuild fell back to a
            # fresh default plan, which is NOT the improvement we
            # priced — swapping it in (and counting a hyper swap)
            # would be a lie. Abandon quietly; the incumbent stands.
            self.stats["rejects"] += 1
            obs.counter_add("serve.replan.store_lost")
            self._done_keys.add(key)
            logger.warning(
                "replan swap for %s abandoned: improved plan did not "
                "survive the cache round-trip (store failed?)", key[:12],
            )
            return False
        self.service.swap_bound(new_bound)
        self._done_keys.add(key)
        self.stats["swaps"] += 1
        obs.counter_add("serve.replan.swap")
        logger.info(
            "replan swap for %s: predicted cost %.3e -> %.3e (%s)",
            key[:12], incumbent_cost, candidate_cost, self.objective.name,
        )
        return True
