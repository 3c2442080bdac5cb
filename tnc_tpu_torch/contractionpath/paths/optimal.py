"""Optimal (exhaustive) contraction pathfinding via subset DP (the port's
copy of ``tnc_tpu.contractionpath.paths.optimal``).

Equivalent of TNC's ``OptMethod::Optimal``
(``tnc/src/contractionpath/paths/cotengrust.rs:16-23`` →
``optimize_optimal_rust``): finds the provably cheapest pairwise
contraction tree. This implementation runs dynamic programming over
tensor subsets (O(3^n) — practical to ~16 tensors), minimizing either
naive op count or peak size (``CostType``, ``paths.rs:80-85``).

Like all finders, nested composites are solved recursively and replaced by
their external tensors at the top level.
"""

from __future__ import annotations

import math

from tnc_tpu_torch.contractionpath.paths.base import CostType, Pathfinder
from tnc_tpu_torch.tensornetwork.tensor import LeafTensor


class Optimal(Pathfinder):
    """Exact subset-DP pathfinder (O(3^n); ``paths/optimal.rs``).

    >>> from tnc_tpu_torch.tensornetwork.tensor import CompositeTensor, LeafTensor
    >>> tn = CompositeTensor([LeafTensor([0, 1], [4, 4]),
    ...     LeafTensor([1, 2], [4, 4]), LeafTensor([2, 0], [4, 4])])
    >>> from tnc_tpu_torch.contractionpath.paths.greedy import Greedy, OptMethod
    >>> best = Optimal().find_path(tn)
    >>> best.flops <= Greedy(OptMethod.GREEDY).find_path(tn).flops
    True
    """

    def __init__(self, cost_type: CostType = CostType.FLOPS, max_tensors: int = 18):
        self.cost_type = cost_type
        self.max_tensors = max_tensors

    def _solve_toplevel(self, inputs: list[LeafTensor]) -> list[tuple[int, int]]:
        n = len(inputs)
        if n <= 1:
            return []
        if n > self.max_tensors:
            raise ValueError(
                f"Optimal pathfinding is limited to {self.max_tensors} tensors, got {n}"
            )

        dims: dict[int, int] = {}
        for t in inputs:
            for leg, dim in t.edges():
                dims[leg] = dim

        leg_sets = [frozenset(t.legs) for t in inputs]

        def set_size(s: frozenset[int]) -> float:
            out = 1.0
            for leg in s:
                out *= dims[leg]
            return out

        full = (1 << n) - 1
        # subset -> (cost, peak, split_lo, legs)
        legs_of: dict[int, frozenset[int]] = {}
        best: dict[int, tuple[float, float, int]] = {}
        for i in range(n):
            legs_of[1 << i] = leg_sets[i]
            best[1 << i] = (0.0, set_size(leg_sets[i]), 0)

        # Iterate subsets in increasing popcount order.
        subsets_by_count: list[list[int]] = [[] for _ in range(n + 1)]
        for mask in range(1, full + 1):
            subsets_by_count[mask.bit_count()].append(mask)

        for count in range(2, n + 1):
            for mask in subsets_by_count[count]:
                best_cost = math.inf
                best_peak = math.inf
                best_split = 0
                best_legs: frozenset[int] | None = None
                # enumerate proper sub-splits; canonicalize by requiring the
                # lowest set bit of mask to be in `lo`
                lowest = mask & (-mask)
                sub = (mask - 1) & mask
                while sub:
                    if sub & lowest:
                        lo, hi = sub, mask ^ sub
                        if hi and lo in best and hi in best:
                            cost_lo, peak_lo, _ = best[lo]
                            cost_hi, peak_hi, _ = best[hi]
                            l_lo, l_hi = legs_of[lo], legs_of[hi]
                            union = l_lo | l_hi
                            step_cost = set_size(union)
                            cost = cost_lo + cost_hi + step_cost
                            out = l_lo ^ l_hi
                            step_peak = set_size(out) + set_size(l_lo) + set_size(l_hi)
                            peak = max(peak_lo, peak_hi, step_peak)
                            key = cost if self.cost_type is CostType.FLOPS else peak
                            best_key = (
                                best_cost if self.cost_type is CostType.FLOPS else best_peak
                            )
                            if key < best_key:
                                best_cost, best_peak = cost, peak
                                best_split = lo
                                best_legs = out
                    sub = (sub - 1) & mask
                assert best_legs is not None
                best[mask] = (best_cost, best_peak, best_split)
                legs_of[mask] = best_legs

        # Reconstruct SSA path by post-order traversal of the split tree.
        ssa_path: list[tuple[int, int]] = []
        next_id = n

        def build(mask: int) -> int:
            nonlocal next_id
            if mask.bit_count() == 1:
                return mask.bit_length() - 1
            lo = best[mask][2]
            hi = mask ^ lo
            a = build(lo)
            b = build(hi)
            ssa_path.append((a, b))
            out_id = next_id
            next_id += 1
            return out_id

        build(full)
        return ssa_path
