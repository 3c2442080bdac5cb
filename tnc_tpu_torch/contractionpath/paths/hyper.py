"""Hyper-optimized pathfinding via recursive hypergraph bisection (the
port's copy of ``tnc_tpu.contractionpath.paths.hyper``: same trials,
seeds and tie-breaks, so both packages plan the same path).

Equivalent of TNC's cotengra ``HyperOptimizer`` bridge
(``tnc/src/contractionpath/paths/hyperoptimization.rs:36-73``, which calls
cotengra's kahypar-based search through Python). This is a native
implementation of the same algorithm family, using the framework's own
multilevel partitioner:

- Build the contraction tree **top-down**: recursively bisect the
  network's hypergraph (legs = hyperedges, weight = log2(bond dim)); the
  cut structure becomes the upper tree levels.
- Below a cutoff, finish subproblems with the greedy finder.
- Run ``ntrials`` randomized trials (different seeds and imbalance
  fractions, as cotengra samples imbalance) plus a plain-greedy baseline,
  and keep the lowest predicted cost.

On Sycamore-class circuits this produces paths orders of magnitude
cheaper than pure greedy, which is why TNC reserves this finder
for its hardest benchmark configs (``BASELINE.md`` config 3).
"""

from __future__ import annotations

import math
import os
import random

from tnc_tpu_torch.contractionpath.contraction_cost import (
    PathObjective,
    contract_path_cost,
)
from tnc_tpu_torch.contractionpath.contraction_path import (
    ContractionPath,
    ssa_replace_ordering,
)
from tnc_tpu_torch.contractionpath.paths.base import Pathfinder
from tnc_tpu_torch.contractionpath.paths.greedy import _ssa_greedy
from tnc_tpu_torch.partitioning.bisect import bisect
from tnc_tpu_torch.partitioning.hypergraph import Hypergraph
from tnc_tpu_torch.tensornetwork.tensor import LeafTensor


class Hyperoptimizer(Pathfinder):
    """Native recursive-bisection hyper-search with annealing polish.

    >>> import numpy as np
    >>> from tnc_tpu_torch.builders.connectivity import ConnectivityLayout
    >>> from tnc_tpu_torch.builders.random_circuit import random_circuit
    >>> from tnc_tpu_torch.contractionpath.paths.greedy import Greedy, OptMethod
    >>> tn = random_circuit(8, 6, 0.5, 0.5, np.random.default_rng(3),
    ...                     ConnectivityLayout.LINE)
    >>> hy = Hyperoptimizer(ntrials=2, reconfigure_budget=2.0,
    ...                     polish_rounds=1, polish_steps=200)
    >>> result = hy.find_path(tn)
    >>> result.flops <= Greedy(OptMethod.GREEDY).find_path(tn).flops
    True
    """

    def __init__(
        self,
        ntrials: int = 16,
        seed: int = 42,
        cutoff: int = 12,
        imbalance_range: tuple[float, float] = (0.02, 0.40),
        minimize: str = "flops",
        reconfigure_size: int = 12,
        reconfigure_rounds: int = 6,
        reconfigure_budget: float | None = 60.0,
        reconfigure_top: int = 4,
        target_size: float | None = None,
        polish_rounds: int = 12,
        polish_steps: int = 8000,
        polish_temps: tuple[float, float] = (0.3, 0.01),
        objective: PathObjective | None = None,
        joint_slicing: bool = True,
        joint_sa_steps: int = 1200,
        joint_sa_rounds: int = 2,
    ) -> None:
        """``objective``: a :class:`~tnc_tpu_torch.contractionpath.
        contraction_cost.PathObjective` that overrides ``minimize`` for
        candidate ranking and final selection — a
        ``CalibratedObjective`` ranks every trial, refinement result and
        polish snapshot by *predicted seconds* (and, with
        ``target_size``, prices sliced candidates with the hoist-aware
        seconds formula, launch overhead included). Tree-internal
        moves (reconfigure/anneal) keep minimizing ``minimize`` — the
        search heuristics stay in the cheap flop domain; the objective
        decides which resulting tree wins.

        ``target_size``: when set, the final candidate selection is
        slicing-aware — candidates are scored by their *total sliced
        flops* after greedy slicing to ``target_size`` peak elements,
        not by raw flops (a slightly worse raw path that slices well is
        the better plan on HBM-bound networks).

        ``joint_slicing`` (default on, engages only with a
        ``target_size``): slicing becomes a first-class dimension of
        the search instead of a post-pass. EVERY trial carries a
        greedily-maintained slice set and is ranked by its hoisted
        sliced cost under the budget (the incremental
        :class:`~tnc_tpu_torch.contractionpath.sliced_cost.
        SlicedCostEvaluator` makes that a per-trial price, not a
        per-finalist one), and finalists are refined by the joint
        tree+slice SA (:func:`~tnc_tpu_torch.contractionpath.sliced_cost.
        joint_slice_search`: rotation moves ⇄ slice-set swap moves ⇄
        exact-DP reconfiguration, all accepted under the sliced
        objective) with a classic ``slice_and_reconfigure`` repair as a
        quality floor. The winning slice set is exposed as
        ``last_slicing`` so callers seed their repair pass from it.
        ``joint_slicing=False`` forces the old optimize-then-slice
        post-pass mode (A/B comparisons). ``joint_sa_steps`` /
        ``joint_sa_rounds`` bound the per-finalist SA work.

        ``polish_rounds``: the winner gets an annealing polish — rounds
        of subtree rotations at a cooling temperature interleaved with
        exact-DP reconfiguration (the TreeAnnealing/TreeReconfigure
        combination applied to the best bisection tree instead of a
        fresh one). On Sycamore-53 m=14 the default 12×8000 polish cuts
        the final path ~4.8× beyond the refined bisection optimum
        (r3 sweep: 3.19e14 → 6.6e13 flops, sliced total 3.88e14 →
        8.4e13 at 2^29; 24 rounds reach 7.7e13 sliced) for ~1 min of
        extra planning. ``polish_rounds=0`` disables."""
        if minimize not in ("flops", "size"):
            raise ValueError("minimize must be 'flops' or 'size'")
        self.ntrials = ntrials
        self.seed = seed
        self.cutoff = cutoff
        self.imbalance_range = imbalance_range
        self.minimize = minimize
        self.reconfigure_size = reconfigure_size
        self.reconfigure_rounds = reconfigure_rounds
        self.reconfigure_budget = reconfigure_budget
        self.reconfigure_top = reconfigure_top
        self.target_size = target_size
        self.polish_rounds = polish_rounds
        self.polish_steps = polish_steps
        self.polish_temps = polish_temps
        self.objective = objective
        self.joint_slicing = joint_slicing
        self.joint_sa_steps = joint_sa_steps
        self.joint_sa_rounds = joint_sa_rounds
        #: the slice set of the most recent winning plan (joint mode
        #: only; ``None`` when the winner fits the budget unsliced) —
        #: callers seed ``slice_and_reconfigure(seed_slices=...)`` with
        #: it so the post repair is a thin pass, not a fresh search
        self.last_slicing = None
        #: how the most recent search ran its trials: ``"pool"`` (with
        #: ``workers`` spawn workers) or ``"serial"``, and the error that
        #: sent a pool search to the serial loop (same plan either way)
        self.last_trials = None

    def _solve_toplevel(self, inputs: list[LeafTensor]) -> list[tuple[int, int]]:
        self.last_slicing = None
        n = len(inputs)
        if n <= 2:
            return [(0, 1)] if n == 2 else []

        dims: dict[int, int] = {}
        for t in inputs:
            for leg, dim in t.edges():
                dims[leg] = dim

        # Preprocessing: absorb rank<=2 tensors (kets, bras, single-qubit
        # gate chains) into their neighbours. These contractions cost
        # next to nothing but shrink the graph to its rank>=3 cores,
        # which is what makes partition-based trees competitive on
        # circuit networks (cotengra's preprocessing does the same).
        prefix, legs_map, next_id = _simplify(
            {i: frozenset(t.legs) for i, t in enumerate(inputs)}, dims
        )
        core_ids = sorted(legs_map)

        candidates: list[list[tuple[int, int]]] = [
            prefix + _greedy_on(core_ids, legs_map, dims, next_id)[0]
        ]
        for path in self._run_trials(core_ids, legs_map, dims, next_id):
            candidates.append(prefix + path)

        def evaluate(candidate: list[tuple[int, int]]) -> float:
            if self.objective is not None:
                return self.objective.ssa_path_cost(inputs, candidate)
            flops, size = contract_path_cost(
                inputs,
                ssa_replace_ordering(ContractionPath.simple(candidate)),
                True,
            )
            return flops if self.minimize == "flops" else size

        sliced_cache: dict[tuple, float] = {}

        def sliced_score(candidate: list[tuple[int, int]]) -> float:
            """Cost after slicing to the HBM target *with repair*: a
            light slice-and-reconfigure pass, scored under the active
            objective (total sliced flops by default; hoist-aware
            predicted seconds under a calibrated objective). Plain
            greedy slicing without repair wildly misranks low-flops
            candidates (their naive slicing overhead is enormous, but
            reconfiguration recovers most of it). Memoized on the
            candidate path — annealing-polish snapshots repeat already
            scored trees (and the inf-fallback re-scores the winner),
            and the repair pass is far too expensive to re-run on a
            repeat."""
            from tnc_tpu_torch.contractionpath.slicing import (
                slice_and_reconfigure,
                sliced_flops,
            )

            assert self.target_size is not None
            key = tuple(candidate)
            hit = sliced_cache.get(key)
            if hit is not None:
                return hit
            try:
                # Work-bounded repair (rounds only, no wall-clock
                # deadline) so candidate ranking is reproducible
                # run-to-run and machine-to-machine.
                replace, slicing = slice_and_reconfigure(
                    inputs,
                    candidate,
                    self.target_size,
                    reconf_rounds=1,
                    step_budget=None,
                    final_rounds=2,
                    final_budget=None,
                )
            except ValueError:
                sliced_cache[key] = math.inf
                return math.inf
            if self.objective is not None:
                score = self.objective.sliced_path_cost(
                    inputs, replace, slicing
                )
            else:
                score = sliced_flops(inputs, replace, slicing)
            sliced_cache[key] = score
            return score

        use_joint = self.target_size is not None and self.joint_slicing
        cost_model = getattr(self.objective, "cost_model", None)
        # trial key -> (greedy sliced cost, greedy slice legs)
        rank_cache: dict[tuple, tuple[float, tuple[int, ...]]] = {}
        # trial key -> (refined cost, refined ssa pairs, Slicing | None)
        final_cache: dict[tuple, tuple] = {}

        def trial_sliced_rank(candidate: list[tuple[int, int]]) -> float:
            """Joint mode, stage 1: EVERY trial carries a greedily
            maintained slice set under the budget and is ranked by its
            hoisted sliced cost (seconds under a calibrated objective)
            — the incremental evaluator prices a trial in O(deltas)
            where the classic pipeline paid a full
            slice-and-reconfigure per finalist."""
            key = tuple(candidate)
            hit = rank_cache.get(key)
            if hit is not None:
                return hit[0]
            from tnc_tpu_torch.contractionpath.sliced_cost import (
                SlicedCostEvaluator,
                greedy_slice_to_target,
            )

            replace = ssa_replace_ordering(
                ContractionPath.simple(list(candidate))
            ).toplevel
            ev = SlicedCostEvaluator(inputs, replace, cost_model=cost_model)
            try:
                greedy_slice_to_target(ev, self.target_size)
                entry = (ev.cost(), tuple(sorted(ev.removed)))
            except ValueError:
                entry = (math.inf, ())
            rank_cache[key] = entry
            return entry[0]

        def joint_final(candidate: list[tuple[int, int]]) -> tuple:
            """Joint mode, stage 2 (finalists + polish snapshots):
            refine tree and slice set TOGETHER (SA rotations ⇄ slice
            swaps ⇄ sliced-objective DP reconfiguration), floored by
            the classic bounded repair so the joint mode can only match
            or beat the post-pass pipeline. Memoized like
            :func:`sliced_score`."""
            key = tuple(candidate)
            hit = final_cache.get(key)
            if hit is not None:
                return hit
            from tnc_tpu_torch.contractionpath.sliced_cost import (
                SlicedCostEvaluator,
                joint_slice_search,
            )
            from tnc_tpu_torch.contractionpath.slicing import (
                slice_and_reconfigure,
            )

            score0 = trial_sliced_rank(candidate)
            seed_legs = rank_cache[tuple(candidate)][1]
            if math.isinf(score0):
                entry = (math.inf, list(candidate), None, math.inf)
            elif not seed_legs:
                # fits the budget unsliced: nothing to search jointly
                entry = (score0, list(candidate), None, score0)
            else:
                pairs, slicing, cost = joint_slice_search(
                    inputs,
                    candidate,
                    self.target_size,
                    seed_slices=seed_legs,
                    sa_steps=self.joint_sa_steps,
                    sa_rounds=self.joint_sa_rounds,
                    seed=self.seed,
                    temps=self.polish_temps,
                    cost_model=cost_model,
                )
                legacy_floor = math.inf
                try:
                    replace2, s2 = slice_and_reconfigure(
                        inputs,
                        candidate,
                        self.target_size,
                        reconf_rounds=1,
                        step_budget=None,
                        final_rounds=2,
                        final_budget=None,
                        cost_model=cost_model,
                    )
                except ValueError:
                    replace2 = None
                if replace2 is not None:
                    from tnc_tpu_torch.contractionpath.slicing import (
                        sliced_flops,
                    )

                    ev2 = SlicedCostEvaluator(
                        inputs,
                        list(replace2),
                        removed=s2.legs,
                        cost_model=cost_model,
                    )
                    floor_cost = ev2.cost()
                    # the score the POST-PASS pipeline would have given
                    # this candidate (sliced_score's metric) — used to
                    # find the trajectory that pipeline would polish
                    legacy_floor = (
                        self.objective.sliced_path_cost(
                            inputs, replace2, s2
                        )
                        if self.objective is not None
                        else sliced_flops(inputs, replace2, s2)
                    )
                entry = (cost, pairs, slicing, legacy_floor)
                if replace2 is not None and floor_cost < cost:
                    from tnc_tpu_torch.contractionpath.contraction_path import (
                        replace_ssa_ordering,
                    )

                    entry = (
                        floor_cost,
                        replace_ssa_ordering(list(replace2), len(inputs)),
                        s2,
                        legacy_floor,
                    )
            final_cache[key] = entry
            return entry

        ranked = sorted(
            candidates, key=trial_sliced_rank if use_joint else evaluate
        )

        # Refine the best few candidates by exact-DP subtree
        # reconfiguration (TNC's TreeReconfigure capability,
        # natively): different bisection trees settle into different
        # local minima, so refining several beats refining one.
        top = max(1, self.reconfigure_top)
        finalists = ranked[:top]
        evaluate_side: list[list[tuple[int, int]]] = []
        if use_joint:
            # hedge the finalist pool with the raw-objective ranking:
            # greedy-maintained slice sets are unrepaired, and on
            # treewidth-class networks they misrank candidates whose
            # slicing overhead repair would recover — carrying the
            # post-pass pipeline's own finalists (plus its unrefined
            # guard) means the per-finalist repair floor covers every
            # candidate that pipeline could have picked
            evaluate_side = sorted(candidates, key=evaluate)[:top]
            seen_f: set[tuple] = set()
            finalists = []
            for candidate in ranked[:top] + evaluate_side:
                key = tuple(candidate)
                if key not in seen_f:
                    seen_f.add(key)
                    finalists.append(candidate)
        # the post-pass pipeline's candidate pool, rebuilt inside the
        # joint pool (refined below in lockstep): polish is strongly
        # path-dependent, so the joint mode must also anneal the exact
        # trajectory that pipeline would have polished
        post_pool: list[list[tuple[int, int]]] = []
        if self.reconfigure_rounds > 0:
            from tnc_tpu_torch.contractionpath.contraction_tree import ContractionTree

            refined: list[list[tuple[int, int]]] = []
            for candidate in finalists:
                tree = ContractionTree.from_ssa_path(inputs, candidate)
                tree.reconfigure(
                    self.reconfigure_size,
                    self.reconfigure_rounds,
                    minimize=self.minimize,
                    time_budget=self.reconfigure_budget,
                )
                refined.append(tree.to_ssa_path())
            if use_joint:
                eval_keys = {tuple(c) for c in evaluate_side}
                post_pool = [
                    r
                    for f, r in zip(finalists, refined)
                    if tuple(f) in eval_keys
                ]
                post_pool.append(evaluate_side[0])
            # The refined trees dominate their raw versions on both raw
            # and sliced scores; keep the best raw candidate as a guard.
            finalists = refined + [ranked[0]] + post_pool[-1:]
        elif use_joint:
            post_pool = list(evaluate_side)
            finalists = finalists + post_pool[:1]

        # Dedup (reconfigure often leaves a good tree unchanged) so the
        # expensive sliced_score never runs twice on the same path.
        seen: set[tuple] = set()
        unique = []
        for candidate in finalists:
            key = tuple(candidate)
            if key not in seen:
                seen.add(key)
                unique.append(candidate)

        if self.target_size is not None:
            score_fn = (
                (lambda c: joint_final(c)[0]) if use_joint else sliced_score
            )
            scored = [(score_fn(c), c) for c in unique]
            winner_score, winner = min(scored, key=lambda p: p[0])
            if math.isinf(winner_score):
                # No finalist could be sliced to the target: fall back to
                # the raw-flops ranking explicitly (an arbitrary
                # inf-scored pick would defer the failure to the caller's
                # own slicing attempt, far from this decision).
                winner = min(unique, key=evaluate)
                winner_score = score_fn(winner)
            final_score = score_fn
        else:
            winner = min(unique, key=evaluate)
            winner_score = evaluate(winner)
            final_score = evaluate

        # Annealing polish: every round's snapshot competes under the
        # SAME objective as the final selection (in slicing-aware mode a
        # raw-flops-worse tree can be the sliced-flops winner).
        polish_seeds = [winner]
        if use_joint and post_pool:
            # polish is strongly path-dependent (on treewidth-class
            # networks it cuts the final plan several-fold), so the
            # joint mode also anneals the trajectory the POST-PASS
            # pipeline would have polished: the winner of ITS OWN
            # finalist pool under ITS OWN scoring (the classic
            # bounded-repair floor). Without this hedge a
            # sliced-selection winner whose basin polishes poorly can
            # lose to the old pipeline.
            floor_winner = min(
                post_pool, key=lambda c: joint_final(c)[3]
            )
            if tuple(floor_winner) != tuple(winner):
                polish_seeds.append(floor_winner)
        best_path, best_score = winner, winner_score
        for polish_seed in polish_seeds:
            for snapshot in self._polish(inputs, polish_seed):
                s = final_score(snapshot)
                if s < best_score:
                    best_path, best_score = snapshot, s
        if use_joint:
            # the winner's *refined* tree (the joint search moved it)
            # and its slice set are the plan; expose the slice set so
            # the caller's slice_and_reconfigure is a seeded thin
            # repair instead of a fresh post-pass search
            _, refined_pairs, slicing, _ = joint_final(best_path)
            if refined_pairs is not None and not math.isinf(
                final_score(best_path)
            ):
                self.last_slicing = slicing
                return refined_pairs
        return best_path

    def _run_trials(
        self,
        core_ids: list[int],
        legs_map: dict[int, frozenset[int]],
        dims: dict[int, int],
        next_id: int,
    ) -> list[list[tuple[int, int]]]:
        """The ``ntrials`` randomized bisection trials, fanned out over a
        spawn-safe process pool when the host has cores to spare — the
        rayon-style search parallelism TNC applies to its SA
        trials (``repartitioning/simulated_annealing.rs:113-135``),
        applied to the hyper search (VERDICT r3 #8).

        Deterministic merge: trial ``t`` always uses
        ``random.Random(seed + t)``, and results come back indexed by
        trial, so the candidate list — and the winning path — is
        identical to the serial loop's at any worker count
        (``TNC_TPU_HYPER_WORKERS`` overrides; <=1 forces serial).
        """
        spec = (
            core_ids,
            legs_map,
            dims,
            next_id,
            self.cutoff,
            self.seed,
            self.imbalance_range,
        )
        env = os.environ.get("TNC_TPU_HYPER_WORKERS")
        workers = int(env) if env else (os.cpu_count() or 1)
        workers = max(1, min(workers, self.ntrials))
        # pool startup (spawn + package re-import) costs seconds; only
        # worth it when trials are individually expensive. Unless the
        # env knob explicitly asks for a pool, gate on problem size —
        # small searches (most planning calls) stay serial.
        if env is None and len(core_ids) < 64:
            workers = 1
        pool_error = None
        if workers > 1:
            import concurrent.futures
            import multiprocessing
            import pickle

            try:
                ctx = multiprocessing.get_context("spawn")
                with concurrent.futures.ProcessPoolExecutor(
                    max_workers=workers,
                    mp_context=ctx,
                    initializer=_trials_init,
                    initargs=(pickle.dumps(spec),),
                ) as pool:
                    out = list(pool.map(_trial_worker, range(self.ntrials)))
                self.last_trials = {"mode": "pool", "workers": workers,
                                    "pool_error": None}
                return out
            except Exception as exc:  # pool failure: the serial loop is law
                pool_error = f"{type(exc).__name__}: {exc}"
        self.last_trials = {"mode": "serial", "workers": 1, "pool_error": pool_error}
        return [_one_trial(spec, t) for t in range(self.ntrials)]

    def _polish(
        self, inputs: list[LeafTensor], candidate: list[tuple[int, int]]
    ) -> list[list[tuple[int, int]]]:
        """Annealing polish of the winning tree: rounds of Metropolis
        subtree rotations at a cooling temperature, each followed by
        exact-DP reconfiguration. Returns the deduplicated per-round
        snapshots that improved the raw objective at least once
        (annealing legitimately regresses between rounds); the caller
        scores them under the final-selection objective."""
        if self.polish_rounds <= 0 or len(inputs) <= 2:
            return []
        from tnc_tpu_torch.contractionpath.contraction_tree import ContractionTree
        from tnc_tpu_torch.contractionpath.paths.tree_refine import (
            _anneal,
            _tree_objective,
        )

        rng = random.Random(self.seed ^ 0x9E3779B9)
        tree = ContractionTree.from_ssa_path(inputs, list(candidate))
        t_hi, t_lo = self.polish_temps
        snapshots: list[list[tuple[int, int]]] = []
        seen: set[tuple] = {tuple(candidate)}
        best_obj = _tree_objective(tree, self.minimize)
        for _ in range(self.polish_rounds):
            _anneal(tree, rng, self.polish_steps, t_hi, t_lo, self.minimize)
            tree.reconfigure(
                self.reconfigure_size,
                2,
                minimize=self.minimize,
                time_budget=self.reconfigure_budget,
            )
            obj = _tree_objective(tree, self.minimize)
            if obj < best_obj * 1.5:  # skip clearly-regressed rounds
                best_obj = min(best_obj, obj)
                path = tree.to_ssa_path()
                key = tuple(path)
                if key not in seen:
                    seen.add(key)
                    snapshots.append(path)
        return snapshots

    def _bisection_path(
        self,
        core_ids: list[int],
        legs_map: dict[int, frozenset[int]],
        dims: dict[int, int],
        start_id: int,
        rng: random.Random,
        imbalance: float,
    ) -> list[tuple[int, int]]:
        return _bisection_path_impl(
            core_ids, legs_map, dims, start_id, rng, imbalance, self.cutoff
        )


def _bisection_path_impl(
    core_ids: list[int],
    legs_map: dict[int, frozenset[int]],
    dims: dict[int, int],
    start_id: int,
    rng: random.Random,
    imbalance: float,
    cutoff: int,
    discount_legs: frozenset[int] | None = None,
    discount_weight: float = 0.125,
) -> list[tuple[int, int]]:
    """One randomized top-down bisection trial (module-level so the
    trial pool's spawn workers can run it).

    ``discount_legs`` makes the cut slice-aware: legs in the set (a
    candidate slice set) get cut weight ``discount_weight`` instead of
    ``log2(bond dim)``, steering the partitioner toward cutting legs
    that will be sliced away anyway. An explicit weight override is
    required — dim-based discounting is a no-op on bond-dimension-2
    circuit legs, where ``log2(max(2, d))`` is 1 for every leg."""
    legs = dict(legs_map)
    next_id = start_id
    ssa_path: list[tuple[int, int]] = []

    def greedy_finish(ids: list[int]) -> int:
        """Contract a small set of (global-id) tensors with greedy."""
        nonlocal next_id
        local_tensors = [
            LeafTensor(sorted(legs[i]), [dims[l] for l in sorted(legs[i])])
            for i in ids
        ]
        local_pairs = _ssa_greedy(local_tensors)
        m = len(ids)
        local_to_global = {i: ids[i] for i in range(m)}
        last = ids[0]
        for a, b in local_pairs:
            ga = local_to_global[a]
            gb = local_to_global[b]
            ssa_path.append((ga, gb))
            legs[next_id] = legs[ga] ^ legs[gb]
            local_to_global[m] = next_id
            m += 1
            last = next_id
            next_id += 1
        return last

    def solve(ids: list[int]) -> int:
        nonlocal next_id
        if len(ids) == 1:
            return ids[0]
        if len(ids) <= cutoff:
            return greedy_finish(ids)

        # Sub-hypergraph over `ids`
        index = {v: i for i, v in enumerate(ids)}
        pin_lists: dict[int, list[int]] = {}
        for v in ids:
            for leg in legs[v]:
                pin_lists.setdefault(leg, []).append(index[v])
        edge_pins = []
        edge_weights = []
        for leg, pins in pin_lists.items():
            if len(pins) >= 2:
                edge_pins.append(pins)
                if discount_legs is not None and leg in discount_legs:
                    edge_weights.append(discount_weight)
                else:
                    edge_weights.append(math.log2(max(2, dims[leg])))
        sub = Hypergraph(len(ids), [1.0] * len(ids), edge_pins, edge_weights)
        sides = bisect(sub, imbalance, rng)
        left = [v for v, s in zip(ids, sides) if s == 0]
        right = [v for v, s in zip(ids, sides) if s == 1]
        if not left or not right:
            return greedy_finish(ids)
        a = solve(left)
        b = solve(right)
        ssa_path.append((a, b))
        legs[next_id] = legs[a] ^ legs[b]
        result = next_id
        next_id += 1
        return result

    solve(list(core_ids))
    return ssa_path


_TRIALS_SPEC = None


def _trials_init(blob: bytes) -> None:
    import pickle

    global _TRIALS_SPEC
    _TRIALS_SPEC = pickle.loads(blob)


def _trial_worker(trial: int) -> list[tuple[int, int]]:
    assert _TRIALS_SPEC is not None
    return _one_trial(_TRIALS_SPEC, trial)


def _one_trial(spec, trial: int) -> list[tuple[int, int]]:
    """Trial ``trial`` of the hyper search — identical draw discipline
    to the original serial loop (``Random(seed + trial)`` drives both
    the imbalance sample and the bisection), so serial and pooled runs
    produce byte-identical candidates."""
    core_ids, legs_map, dims, next_id, cutoff, seed, (lo, hi) = spec
    rng = random.Random(seed + trial)
    imbalance = lo + (hi - lo) * rng.random()
    return _bisection_path_impl(
        core_ids, legs_map, dims, next_id, rng, imbalance, cutoff
    )


def _simplify(
    legs: dict[int, frozenset[int]], dims: dict[int, int]
) -> tuple[list[tuple[int, int]], dict[int, frozenset[int]], int]:
    """Absorb every rank<=2 tensor into a neighbour sharing a leg.

    Returns (ssa prefix pairs, surviving id -> legs, next free ssa id).
    Tensors sharing no leg with anyone are left for the outer search's
    outer-product handling.
    """
    legs = dict(legs)
    next_id = max(legs) + 1 if legs else 0
    pairs: list[tuple[int, int]] = []

    leg_owners: dict[int, set[int]] = {}
    for i, ls in legs.items():
        for leg in ls:
            leg_owners.setdefault(leg, set()).add(i)

    from collections import deque

    queue = deque(i for i, ls in legs.items() if len(ls) <= 2)
    while queue:
        i = queue.popleft()
        if i not in legs or len(legs[i]) > 2:
            continue
        if len(legs) <= 2:
            break
        # find a neighbour (prefer the smallest) sharing any leg
        neighbour = -1
        neighbour_rank = 1 << 30
        for leg in legs[i]:
            for j in leg_owners.get(leg, ()):
                if j != i and j in legs and len(legs[j]) < neighbour_rank:
                    neighbour = j
                    neighbour_rank = len(legs[j])
        if neighbour < 0:
            continue  # disconnected scalar/vector; leave it
        merged = legs[i] ^ legs[neighbour]
        pairs.append((i, neighbour))
        for leg in legs[i] | legs[neighbour]:
            owners = leg_owners.get(leg)
            if owners is not None:
                owners.discard(i)
                owners.discard(neighbour)
        del legs[i], legs[neighbour]
        new_id = next_id
        next_id += 1
        legs[new_id] = merged
        for leg in merged:
            leg_owners.setdefault(leg, set()).add(new_id)
        if len(merged) <= 2:
            queue.append(new_id)
        # neighbours of the merged tensor may have become absorbable
        # (not strictly needed: ranks only shrink via future merges)

    return pairs, legs, next_id


def _greedy_on(
    core_ids: list[int],
    legs_map: dict[int, frozenset[int]],
    dims: dict[int, int],
    start_id: int,
) -> tuple[list[tuple[int, int]], int]:
    """Run the greedy finder over surviving cores, mapping local ssa ids
    back to global ids."""
    local_tensors = [
        LeafTensor(sorted(legs_map[i]), [dims[l] for l in sorted(legs_map[i])])
        for i in core_ids
    ]
    local_pairs = _ssa_greedy(local_tensors)
    m = len(core_ids)
    to_global = {k: core_ids[k] for k in range(m)}
    out: list[tuple[int, int]] = []
    next_id = start_id
    for a, b in local_pairs:
        out.append((to_global[a], to_global[b]))
        to_global[m] = next_id
        m += 1
        next_id += 1
    return out, next_id
