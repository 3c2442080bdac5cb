"""Branch-and-bound pathfinding (the port's copy of
``tnc_tpu.contractionpath.paths.branchbound``: same candidates, order and
pruning, so both packages find one path).

Mirror of ``tnc/src/contractionpath/paths/branchbound.rs`` and
``weighted_branchbound.rs`` (both ports of opt_einsum's branching
approach): depth-first search over pair contractions with

- candidate ordering per step: smallest intermediate size first, ties
  broken toward larger flops (TNC's ``Candidate`` ordering,
  ``candidates.rs:26-33``),
- ``nbranch`` limiting the fan-out per level,
- pruning against the best complete path found so far and a
  ``cutoff_flops_factor`` against the best partial cost at the same
  search depth (``branchbound.rs:86-97``),
- memoized pair results keyed by (i, j) with the larger tensor first.

:class:`WeightedBranchBound` searches the same space but accumulates
``flops + max(latency_i, latency_j)`` — the **critical path** including
per-input start latencies — making it a communication-schedule optimizer
(``weighted_branchbound.rs:74-80``; used by
``communication_schemes.rs:125-143``).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

from tnc_tpu_torch.contractionpath.contraction_cost import (
    PathObjective,
    contract_cost_tensors,
    contract_op_cost_tensors,
    contract_size_tensors,
)
from tnc_tpu_torch.contractionpath.paths.base import CostType, Pathfinder
from tnc_tpu_torch.tensornetwork.tensor import LeafTensor


@dataclass
class _Candidate:
    flop_cost: float
    size_cost: float
    parent_ids: tuple[int, int]
    child_id: int

    def sort_key(self):
        # smallest size first; ties toward larger flops (candidates.rs:26-33)
        return (self.size_cost, -self.flop_cost)


class _BranchSearch:
    """Shared DFS engine for both branch-and-bound variants."""

    def __init__(
        self,
        nbranch: int | None,
        cutoff_flops_factor: float,
        minimize: CostType,
        latencies: dict[int, float] | None,
        objective: PathObjective | None = None,
    ) -> None:
        self.nbranch = nbranch
        self.cutoff_flops_factor = cutoff_flops_factor
        self.minimize = minimize
        self.latencies = latencies  # None -> plain flops accumulation
        # objective overrides the per-pair cost (e.g. predicted seconds
        # under a CalibratedObjective); the accumulated "flops" and any
        # latencies are then in that objective's domain
        self.objective = objective

    def search(self, inputs: list[LeafTensor]) -> list[tuple[int, int]]:
        n = len(inputs)
        if n <= 1:
            return []

        self.tensors: dict[int, LeafTensor] = dict(enumerate(inputs))
        self.result_cache: dict[tuple[int, int], tuple[int, float, float]] = {}
        self.comm: dict[int, float] = (
            dict(self.latencies) if self.latencies is not None else {}
        )
        self.largest_latency = max(self.comm.values(), default=0.0)
        self.best_flops = math.inf
        self.best_size = math.inf
        self.best_triples: list[tuple[int, int, int]] = []
        self.best_progress: dict[int, float] = {}

        self._iterate(list(range(n)), [], 0.0, 0.0)

        # triples -> SSA (contractionpath.rs ssa_ordering semantics)
        from tnc_tpu_torch.contractionpath.contraction_path import ssa_ordering

        return ssa_ordering(self.best_triples, n).toplevel

    # -- candidate assessment ----------------------------------------------

    def _assess(
        self, i: int, j: int, flops: float, size: float, remaining_len: int
    ) -> _Candidate | None:
        if self.tensors[j].size() > self.tensors[i].size():
            i, j = j, i

        cached = self.result_cache.get((i, j))
        if cached is None:
            k12 = len(self.tensors)
            ti, tj = self.tensors[i], self.tensors[j]
            if self.objective is not None:
                flops_12 = self.objective.pair_cost(ti, tj)
            elif self.latencies is not None:
                flops_12 = contract_op_cost_tensors(ti, tj)
            else:
                flops_12 = contract_cost_tensors(ti, tj)
            size_12 = contract_size_tensors(ti, tj)
            self.tensors[k12] = ti ^ tj
            self.result_cache[(i, j)] = (k12, flops_12, size_12)
        else:
            k12, flops_12, size_12 = cached

        if self.latencies is not None:
            current_flops = self.comm.get(k12)
            if current_flops is None:
                current_flops = flops_12 + max(self.comm[i], self.comm[j])
                self.comm[k12] = current_flops
        else:
            current_flops = flops + flops_12
        current_size = max(size, size_12)

        if current_flops > self.best_flops and current_size > self.best_size:
            return None
        best_at_depth = self.best_progress.setdefault(remaining_len, current_flops)
        if current_flops < best_at_depth:
            self.best_progress[remaining_len] = current_flops
        elif current_flops > self.cutoff_flops_factor * best_at_depth + (
            self.largest_latency if self.latencies is not None else 0.0
        ):
            return None

        return _Candidate(current_flops, current_size, (i, j), k12)

    def _iterate(
        self,
        remaining: list[int],
        triples: list[tuple[int, int, int]],
        flops: float,
        size: float,
    ) -> None:
        if len(remaining) == 1:
            better = (
                self.best_flops > flops
                if self.minimize is CostType.FLOPS
                else self.best_size > size
            )
            if better:
                self.best_flops = flops
                self.best_size = size
                self.best_triples = list(triples)
            return

        candidates: list[_Candidate] = []
        for a in range(len(remaining)):
            for b in range(a + 1, len(remaining)):
                cand = self._assess(
                    remaining[a], remaining[b], flops, size, len(remaining)
                )
                if cand is not None:
                    candidates.append(cand)
        candidates.sort(key=_Candidate.sort_key)
        if self.nbranch is not None:
            candidates = candidates[: self.nbranch]

        for cand in candidates:
            i, j = cand.parent_ids
            new_remaining = [r for r in remaining if r != i and r != j]
            new_remaining.append(cand.child_id)
            triples.append((i, j, cand.child_id))
            self._iterate(new_remaining, triples, cand.flop_cost, cand.size_cost)
            triples.pop()


class BranchBound(Pathfinder):
    """DFS branch-and-bound minimizing complex-op flops (or size).

    >>> from tnc_tpu_torch.tensornetwork.tensor import CompositeTensor, LeafTensor
    >>> tn = CompositeTensor([LeafTensor([0, 1], [4, 4]),
    ...     LeafTensor([1, 2], [4, 4]), LeafTensor([2, 0], [4, 4])])
    >>> result = BranchBound().find_path(tn)
    >>> len(result.replace_path().toplevel)
    2
    """

    def __init__(
        self,
        nbranch: int | None = 10,
        cutoff_flops_factor: float = 4.0,
        minimize: CostType = CostType.FLOPS,
        objective: PathObjective | None = None,
    ) -> None:
        self.nbranch = nbranch
        self.cutoff_flops_factor = cutoff_flops_factor
        self.minimize = minimize
        self.objective = objective

    def _solve_toplevel(self, inputs: list[LeafTensor]) -> list[tuple[int, int]]:
        search = _BranchSearch(
            self.nbranch, self.cutoff_flops_factor, self.minimize, None,
            self.objective,
        )
        return search.search(list(inputs))


class WeightedBranchBound(Pathfinder):
    """Branch-and-bound over the critical path with per-input latencies.

    >>> from tnc_tpu_torch.tensornetwork.tensor import CompositeTensor, LeafTensor
    >>> tn = CompositeTensor([LeafTensor([0, 1], [4, 4]),
    ...     LeafTensor([1, 2], [4, 4]), LeafTensor([2, 0], [4, 4])])
    >>> finder = WeightedBranchBound({0: 100.0, 1: 0.0, 2: 0.0})
    >>> result = finder.find_path(tn)  # defers the latency-100 input
    >>> result.replace_path().toplevel[0]
    (1, 2)
    """

    def __init__(
        self,
        latency_map: dict[int, float],
        nbranch: int | None = 10,
        cutoff_flops_factor: float = 5.0,
        minimize: CostType = CostType.FLOPS,
        objective: PathObjective | None = None,
    ) -> None:
        """``objective`` prices each fan-in contraction (default: naive
        op count). With a :class:`~tnc_tpu_torch.contractionpath.
        contraction_cost.CalibratedObjective` the step costs are
        predicted seconds — ``latency_map`` must then be in seconds too
        (the partitions' predicted local completion times), making the
        accumulated critical path a real makespan estimate."""
        self.latency_map = dict(latency_map)
        self.nbranch = nbranch
        self.cutoff_flops_factor = cutoff_flops_factor
        self.minimize = minimize
        self.objective = objective

    def _solve_toplevel(self, inputs: list[LeafTensor]) -> list[tuple[int, int]]:
        if len(self.latency_map) != len(inputs):
            raise ValueError("latency_map must cover every input tensor")
        search = _BranchSearch(
            self.nbranch, self.cutoff_flops_factor, self.minimize,
            self.latency_map, self.objective,
        )
        return search.search(list(inputs))
