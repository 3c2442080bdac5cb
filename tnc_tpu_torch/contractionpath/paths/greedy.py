"""Greedy and random-greedy contraction pathfinding (the port's copy of
``tnc_tpu.contractionpath.paths.greedy``: same scores, seeds and
tie-breaks, so both packages emit the identical path).

Own implementation of the cotengra-style greedy algorithm the reference
reaches through the ``cotengrust`` crate
(``tnc/src/contractionpath/paths/cotengrust.rs:16-23,51-80``):

- Score every leg-sharing pair by the **memory-removed** heuristic
  ``size(out) - size(a) - size(b)`` and repeatedly contract the minimum
  (ties broken by insertion order). The heuristic is pluggable
  (``cost_fn=`` / ``alpha=``): the improved greedy cost functions of
  arXiv:2405.09644 — alpha-weighted memory-removed, its log-domain
  variant, and plain output size — come from
  :func:`~tnc_tpu_torch.contractionpath.contraction_cost.greedy_cost_fn`.
- When no connected pairs remain, combine the surviving components by
  outer products, smallest first (ties: larger ssa id first — matches the
  reference's observed path output on the outer-product fixtures).
- ``RANDOM_GREEDY`` runs ``ntrials`` jittered repetitions (Gumbel noise on
  the pair score at a fixed temperature) with a deterministic seed and
  keeps the best path by lowest flops.

Nested composites get their own recursive ``find_path`` and are replaced
by their external tensor for the top-level search, exactly as the
reference does (``cotengrust.rs:120-145``). Reported flops/size are
recomputed by the analytic cost model with naive op counting
(``cotengrust.rs:149``), so numbers are directly comparable with the
reference's fixtures (e.g. flops 600 / size 538 on the 3-tensor fixture).
"""

from __future__ import annotations

import enum
import heapq
import math
import random
from typing import Sequence

from tnc_tpu_torch.contractionpath.contraction_cost import (
    PathObjective,
    contract_path_cost,
    greedy_cost_fn,
)
from tnc_tpu_torch.contractionpath.contraction_path import (
    ContractionPath,
    ssa_replace_ordering,
)
from tnc_tpu_torch.contractionpath.paths.base import Pathfinder
from tnc_tpu_torch.tensornetwork.tensor import LeafTensor

DEFAULT_SEED = 42  # the reference pins this seed (cotengrust.rs:58,71)


class OptMethod(enum.Enum):
    GREEDY = "greedy"
    RANDOM_GREEDY = "random_greedy"


def _ssa_greedy(
    inputs: Sequence[LeafTensor],
    rng: random.Random | None = None,
    temperature: float = 0.0,
    cost_fn=None,
) -> list[tuple[int, int]]:
    """Core greedy over flat leaf tensors; returns an SSA pair path.

    ``cost_fn(out_size, size_a, size_b)`` scores candidate pairs
    (minimum contracts first); ``None`` keeps the classic
    memory-removed heuristic."""
    n = len(inputs)
    if n <= 1:
        return []

    legs: dict[int, frozenset[int]] = {}
    sizes: dict[int, float] = {}
    dims: dict[int, int] = {}
    leg_owners: dict[int, list[int]] = {}
    for i, t in enumerate(inputs):
        legs[i] = frozenset(t.legs)
        sizes[i] = t.size()
        for leg, dim in t.edges():
            dims[leg] = dim
            leg_owners.setdefault(leg, []).append(i)

    def out_size(leg_set: frozenset[int]) -> float:
        s = 1.0
        for leg in leg_set:
            s *= dims[leg]
        return s

    if cost_fn is None:
        cost_fn = greedy_cost_fn("memory-removed")

    def pair_score(i: int, j: int) -> float:
        out = legs[i] ^ legs[j]
        score = cost_fn(out_size(out), sizes[i], sizes[j])
        if temperature > 0.0 and rng is not None:
            # Gumbel perturbation: subtract T * log(-log u)
            u = rng.random()
            score -= temperature * -math.log(-math.log(u + 1e-300) + 1e-300)
        return score

    heap: list[tuple[float, int, int, int]] = []
    counter = 0
    seen_pairs: set[tuple[int, int]] = set()
    for i in range(n):
        for leg in sorted(legs[i]):
            for j in leg_owners[leg]:
                if j <= i:
                    continue
                if (i, j) in seen_pairs:
                    continue
                seen_pairs.add((i, j))
                heapq.heappush(heap, (pair_score(i, j), counter, i, j))
                counter += 1

    alive: set[int] = set(range(n))
    neighbors: dict[int, set[int]] = {i: set() for i in range(n)}
    for owners in leg_owners.values():
        for a in owners:
            for b in owners:
                if a != b:
                    neighbors[a].add(b)

    ssa_path: list[tuple[int, int]] = []
    next_id = n
    while heap:
        _, _, i, j = heapq.heappop(heap)
        if i not in alive or j not in alive:
            continue
        new_legs = legs[i] ^ legs[j]
        new_id = next_id
        next_id += 1
        ssa_path.append((i, j))

        alive.discard(i)
        alive.discard(j)
        new_neighbors = (neighbors[i] | neighbors[j]) & alive
        alive.add(new_id)
        legs[new_id] = new_legs
        sizes[new_id] = out_size(new_legs)
        neighbors[new_id] = new_neighbors
        for k in new_neighbors:
            neighbors[k].add(new_id)
            heapq.heappush(heap, (pair_score(new_id, k), counter, new_id, k))
            counter += 1

    # Outer products between remaining components: smallest size first, ties
    # broken by larger ssa id (matches the reference's output ordering).
    remaining = [(sizes[i], -i, i) for i in alive]
    heapq.heapify(remaining)
    while len(remaining) > 1:
        size_a, _, a = heapq.heappop(remaining)
        size_b, _, b = heapq.heappop(remaining)
        new_legs = legs[a] ^ legs[b]
        new_id = next_id
        next_id += 1
        ssa_path.append((a, b))
        legs[new_id] = new_legs
        new_size = out_size(new_legs)
        sizes[new_id] = new_size
        heapq.heappush(remaining, (new_size, -new_id, new_id))

    return ssa_path


class Greedy(Pathfinder):
    """Greedy / random-greedy pathfinder (cotengrust equivalent).

    >>> from tnc_tpu_torch.tensornetwork.tensor import CompositeTensor, LeafTensor
    >>> tn = CompositeTensor([LeafTensor([0, 1], [4, 4]),
    ...     LeafTensor([1, 2], [4, 4]), LeafTensor([2, 0], [4, 4])])
    >>> result = Greedy(OptMethod.GREEDY).find_path(tn)
    >>> len(result.replace_path().toplevel), result.flops > 0
    (2, True)
    """

    def __init__(
        self,
        method: OptMethod = OptMethod.GREEDY,
        ntrials: int = 32,
        seed: int = DEFAULT_SEED,
        temperature: float = 1.0,
        cost_fn: str | None = None,
        alpha: float = 1.0,
        objective: PathObjective | None = None,
    ) -> None:
        """``cost_fn``/``alpha`` select the pair heuristic
        (:func:`~tnc_tpu_torch.contractionpath.contraction_cost.greedy_cost_fn`
        names, default memory-removed); ``objective`` ranks
        ``RANDOM_GREEDY`` trials (default: naive-op flops; a calibrated
        objective keeps the trial whose *predicted seconds* are lowest)."""
        self.method = method
        self.ntrials = ntrials
        self.seed = seed
        self.temperature = temperature
        self.cost_fn = (
            greedy_cost_fn(cost_fn, alpha) if cost_fn is not None else None
        )
        self.objective = objective

    def _solve_toplevel(self, inputs: list[LeafTensor]) -> list[tuple[int, int]]:
        if self.method is OptMethod.GREEDY:
            return _ssa_greedy(inputs, cost_fn=self.cost_fn)
        return self._random_greedy(inputs)

    def _random_greedy(self, inputs: Sequence[LeafTensor]) -> list[tuple[int, int]]:
        best_path: list[tuple[int, int]] | None = None
        best_cost = math.inf
        leaf_tensors = list(inputs)
        for trial in range(self.ntrials):
            rng = random.Random(self.seed + trial)
            temp = 0.0 if trial == 0 else self.temperature
            candidate = _ssa_greedy(leaf_tensors, rng, temp, self.cost_fn)
            if self.objective is not None:
                cost = self.objective.ssa_path_cost(leaf_tensors, candidate)
            else:
                cost, _ = contract_path_cost(
                    leaf_tensors,
                    ssa_replace_ordering(ContractionPath.simple(candidate)),
                    True,
                )
            if cost < best_cost:
                best_cost = cost
                best_path = candidate
        assert best_path is not None
        return best_path


# The reference names this finder `Cotengrust` too.
Cotengrust = Greedy
