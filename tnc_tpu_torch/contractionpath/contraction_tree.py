"""Explicit contraction-tree representation and local refinement (the
port's copy of ``tnc_tpu.contractionpath.contraction_tree``).

Parity with the Rust TNC ``ContractionTree``
(``tnc/src/contractionpath/contraction_tree.rs:20-27``): an explicit
binary tree over a flat contraction path, supporting conversion to/from
SSA paths, per-node cost weights (``tree_weights``,
``contraction_tree.rs:303-314``), and mutation.

On top of it, :meth:`ContractionTree.reconfigure` implements subtree
reconfiguration — the refinement TNC reaches through cotengra's
``subtree_reconfigure`` (``paths/tree_reconfiguration.rs:54-56``): pick
the most expensive subtrees, re-solve their local contraction order
exactly (subset DP over <= ``subtree_size`` frontier nodes), splice the
improvement back, repeat until converged.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Sequence

from tnc_tpu_torch.tensornetwork.tensor import LeafTensor


def _has_native_dp() -> bool:
    from tnc_tpu_torch.partitioning.native_binding import load_native

    return load_native() is not None


@dataclass
class _Node:
    left: int = -1
    right: int = -1
    parent: int = -1
    legs: frozenset[int] = field(default_factory=frozenset)

    @property
    def is_leaf(self) -> bool:
        return self.left < 0


class ContractionTree:
    """Binary contraction tree over ``n`` leaf tensors.

    >>> from tnc_tpu_torch.tensornetwork.tensor import LeafTensor
    >>> ts = [LeafTensor([0, 1], [4, 4]), LeafTensor([1, 2], [4, 4]),
    ...       LeafTensor([2, 0], [4, 4])]
    >>> tree = ContractionTree.from_ssa_path(ts, [(0, 1), (3, 2)])
    >>> tree.to_ssa_path()
    [(0, 1), (3, 2)]
    >>> flops, peak = tree.total_cost()
    >>> flops > 0 and peak >= 48.0
    True
    """

    def __init__(self, leaf_legs: Sequence[frozenset[int]], dims: dict[int, int]):
        self.dims = dims
        self.nodes: list[_Node] = [_Node(legs=l) for l in leaf_legs]
        self.num_leaves = len(self.nodes)
        self.root = -1

    # -- construction -------------------------------------------------------

    @classmethod
    def from_ssa_path(
        cls,
        inputs: Sequence[LeafTensor],
        ssa_pairs: Sequence[tuple[int, int]],
    ) -> "ContractionTree":
        dims: dict[int, int] = {}
        for t in inputs:
            for leg, dim in t.edges():
                dims[leg] = dim
        tree = cls([frozenset(t.legs) for t in inputs], dims)
        for a, b in ssa_pairs:
            tree._join(a, b)
        roots = [i for i, nd in enumerate(tree.nodes) if nd.parent < 0]
        if len(roots) != 1:
            raise ValueError(f"path does not form a single tree ({len(roots)} roots)")
        tree.root = roots[0]
        return tree

    def _join(self, a: int, b: int) -> int:
        new_id = len(self.nodes)
        self.nodes.append(
            _Node(left=a, right=b, legs=self.nodes[a].legs ^ self.nodes[b].legs)
        )
        self.nodes[a].parent = new_id
        self.nodes[b].parent = new_id
        return new_id

    def copy(self) -> "ContractionTree":
        """Deep copy (used by the tempering replicas)."""
        out = ContractionTree.__new__(ContractionTree)
        out.dims = self.dims
        out.nodes = [
            _Node(nd.left, nd.right, nd.parent, nd.legs) for nd in self.nodes
        ]
        out.num_leaves = self.num_leaves
        out.root = self.root
        return out

    # -- queries ------------------------------------------------------------

    def _size(self, legs: frozenset[int]) -> float:
        out = 1.0
        for leg in legs:
            out *= self.dims[leg]
        return out

    def node_cost(self, i: int) -> float:
        """Naive op cost of the contraction forming node ``i``."""
        nd = self.nodes[i]
        if nd.is_leaf:
            return 0.0
        union = self.nodes[nd.left].legs | self.nodes[nd.right].legs
        return self._size(union)

    def total_cost(self) -> tuple[float, float]:
        """(total naive flops, peak out+in1+in2 size) of the whole tree."""
        flops = 0.0
        peak = 0.0
        stack = [self.root]
        while stack:
            i = stack.pop()
            nd = self.nodes[i]
            if nd.is_leaf:
                continue
            flops += self.node_cost(i)
            step = (
                self._size(nd.legs)
                + self._size(self.nodes[nd.left].legs)
                + self._size(self.nodes[nd.right].legs)
            )
            peak = max(peak, step)
            stack.append(nd.left)
            stack.append(nd.right)
        return flops, peak

    def _postorder(self) -> list[int]:
        """Iterative post-order over the subtree of ``root`` (deep
        caterpillar trees exceed Python's recursion limit)."""
        order: list[int] = []
        stack = [self.root]
        while stack:
            i = stack.pop()
            order.append(i)
            nd = self.nodes[i]
            if not nd.is_leaf:
                stack.append(nd.left)
                stack.append(nd.right)
        order.reverse()
        return order

    def tree_weights(self) -> dict[int, float]:
        """Accumulated contraction cost per node
        (``contraction_tree.rs:303-314``)."""
        weights: dict[int, float] = {}
        for i in self._postorder():
            nd = self.nodes[i]
            if nd.is_leaf:
                weights[i] = 0.0
            else:
                weights[i] = (
                    weights[nd.left] + weights[nd.right] + self.node_cost(i)
                )
        return weights

    def to_ssa_path(self) -> list[tuple[int, int]]:
        """Post-order SSA pair emission (leaves keep their original ids)."""
        ssa_of: dict[int, int] = {}
        next_id = self.num_leaves
        pairs: list[tuple[int, int]] = []
        for i in self._postorder():
            nd = self.nodes[i]
            if nd.is_leaf:
                ssa_of[i] = i
                continue
            pairs.append((ssa_of[nd.left], ssa_of[nd.right]))
            ssa_of[i] = next_id
            next_id += 1
        return pairs

    # -- subtree reconfiguration -------------------------------------------

    def _collect_frontier(self, top: int, max_size: int) -> list[int]:
        """Expand ``top`` downward into at most ``max_size`` frontier
        nodes, preferentially splitting the most expensive nodes."""
        frontier = [top]
        while len(frontier) < max_size:
            # split the non-leaf frontier node with the largest tensor
            best = -1
            best_key = -1.0
            for idx, node_id in enumerate(frontier):
                nd = self.nodes[node_id]
                if nd.is_leaf:
                    continue
                key = self._size(nd.legs)
                if key > best_key:
                    best_key = key
                    best = idx
            if best < 0:
                break
            node_id = frontier.pop(best)
            nd = self.nodes[node_id]
            frontier.append(nd.left)
            frontier.append(nd.right)
        return frontier

    def _optimal_order(
        self,
        leg_sets: list[frozenset[int]],
        minimize: str = "flops",
        logsize_cap: float = -1.0,
    ) -> tuple[float, list[tuple[int, int]]] | None:
        """Subset-DP optimal pairwise order over ``leg_sets``; returns
        (cost, local ssa pairs) or None if too large / no order satisfies
        ``logsize_cap``. ``minimize`` is ``"flops"`` (sum of naive op
        counts) or ``"size"`` (max intermediate tensor size — a
        max-objective composes over splits just like a sum does). When
        ``logsize_cap`` >= 0, intermediates larger than ``2**logsize_cap``
        elements are forbidden (slice-aware refinement). Dispatches to the
        native C++ kernel when available."""
        n = len(leg_sets)
        if n >= 5:
            from tnc_tpu_torch.partitioning.native_binding import native_optimal_order

            native = native_optimal_order(
                leg_sets, self.dims, minimize, logsize_cap
            )
            if native is not None:
                if math.isinf(native[0]):
                    return None  # proven infeasible under the cap
                return native
        if n > 12:
            return None
        by_size = minimize == "size"
        cap_size = math.inf if logsize_cap < 0 else 2.0**logsize_cap
        full = (1 << n) - 1
        # Result legs of any subset are the XOR of its members' legs (a leg
        # joins at most two tensors) — split-independent, precompute.
        legs_of: dict[int, frozenset[int]] = {0: frozenset()}
        for mask in range(1, full + 1):
            low = mask & (-mask)
            legs_of[mask] = legs_of[mask ^ low] ^ leg_sets[low.bit_length() - 1]
        best: dict[int, tuple[float, int]] = {}
        for i in range(n):
            best[1 << i] = (0.0, 0)
        order = [[] for _ in range(n + 1)]
        for mask in range(1, full + 1):
            order[mask.bit_count()].append(mask)
        for count in range(2, n + 1):
            for mask in order[count]:
                if mask != full and self._size(legs_of[mask]) > cap_size:
                    best[mask] = (math.inf, 0)
                    continue
                lowest = mask & (-mask)
                best_cost = math.inf
                best_split = 0
                sub = (mask - 1) & mask
                while sub:
                    if sub & lowest:
                        hi = mask ^ sub
                        if hi:
                            c_lo, _ = best[sub]
                            c_hi, _ = best[hi]
                            if not (c_lo == math.inf or c_hi == math.inf):
                                if by_size:
                                    cost = max(
                                        c_lo, c_hi, self._size(legs_of[mask])
                                    )
                                else:
                                    union = legs_of[sub] | legs_of[hi]
                                    cost = c_lo + c_hi + self._size(union)
                                if cost < best_cost:
                                    best_cost = cost
                                    best_split = sub
                    sub = (sub - 1) & mask
                best[mask] = (best_cost, best_split)
        if best[full][0] == math.inf:
            return None

        pairs: list[tuple[int, int]] = []
        next_local = n

        def build(mask: int) -> int:
            nonlocal next_local
            if mask.bit_count() == 1:
                return mask.bit_length() - 1
            lo = best[mask][1]
            a = build(lo)
            b = build(mask ^ lo)
            pairs.append((a, b))
            out = next_local
            next_local += 1
            return out

        build(full)
        return best[full][0], pairs

    def _subtree_cost(
        self, top: int, frontier: set[int], minimize: str = "flops"
    ) -> float:
        """Cost of the internal nodes of ``top``'s subtree down to
        ``frontier`` (sum of flops, or max intermediate size)."""
        by_size = minimize == "size"
        cost = 0.0
        stack = [top]
        while stack:
            i = stack.pop()
            if i in frontier:
                continue
            nd = self.nodes[i]
            if by_size:
                cost = max(cost, self._size(nd.legs))
            else:
                cost += self.node_cost(i)
            stack.append(nd.left)
            stack.append(nd.right)
        return cost

    def _splice(self, top: int, frontier: list[int], pairs: list[tuple[int, int]]) -> None:
        """Replace ``top``'s subtree-internal structure with the local
        order ``pairs`` over ``frontier``."""
        local_to_node = {i: f for i, f in enumerate(frontier)}
        m = len(frontier)
        last = top
        for k, (a, b) in enumerate(pairs):
            na = local_to_node[a]
            nb = local_to_node[b]
            if k == len(pairs) - 1:
                # reuse `top` as the final node so its parent link survives
                node_id = top
                self.nodes[node_id].left = na
                self.nodes[node_id].right = nb
                self.nodes[node_id].legs = self.nodes[na].legs ^ self.nodes[nb].legs
            else:
                node_id = len(self.nodes)
                self.nodes.append(
                    _Node(
                        left=na,
                        right=nb,
                        legs=self.nodes[na].legs ^ self.nodes[nb].legs,
                    )
                )
            self.nodes[na].parent = node_id
            self.nodes[nb].parent = node_id
            local_to_node[m + k] = node_id
            last = node_id
        assert last == top

    def _local_pairs(
        self, top: int, frontier: list[int]
    ) -> list[tuple[int, int]]:
        """The subtree-internal structure of ``top`` down to
        ``frontier``, as local ssa pairs over the frontier order — the
        inverse of :meth:`_splice` (re-splicing these pairs restores
        the structure), used to revert a rejected sliced-objective
        splice."""
        local_of = {f: i for i, f in enumerate(frontier)}
        frontier_set = set(frontier)
        order: list[int] = []
        stack = [top]
        while stack:
            i = stack.pop()
            if i in frontier_set:
                continue
            order.append(i)
            stack.append(self.nodes[i].left)
            stack.append(self.nodes[i].right)
        pairs: list[tuple[int, int]] = []
        next_local = len(frontier)
        for i in reversed(order):  # children precede parents
            nd = self.nodes[i]
            pairs.append((local_of[nd.left], local_of[nd.right]))
            local_of[i] = next_local
            next_local += 1
        return pairs

    def reconfigure(
        self,
        subtree_size: int = 8,
        max_rounds: int = 4,
        minimize: str = "flops",
        time_budget: float | None = None,
        logsize_cap: float = -1.0,
        sliced=None,
    ) -> None:
        """Iterative subtree reconfiguration, in place.

        Each round walks internal nodes in descending contraction cost,
        re-solves each node's <=``subtree_size``-frontier subtree with the
        exact DP, and splices improvements. Stops when a round makes no
        improvement, or when ``time_budget`` seconds elapse (TNC
        gives its optimizers explicit time budgets too,
        ``benchmark/src/main.rs:63``).

        ``sliced``: a :class:`~tnc_tpu_torch.contractionpath.sliced_cost.
        SlicedReconfState` switches splice *acceptance* to the sliced
        objective — the DP still proposes orders in this tree's (slice-
        reduced) flop model, but a proposal is kept only when the
        attached incremental evaluator's hoisted sliced cost does not
        regress and the sliced peak stays within the budget; rejected
        splices are reverted exactly (:meth:`_local_pairs`). This is the
        "tree reconfigure move" half of the joint tree+slice search.
        """
        import time

        deadline = time.monotonic() + time_budget if time_budget else None
        for _ in range(max_rounds):
            improved = False
            internal = [
                i
                for i, nd in enumerate(self.nodes)
                if not nd.is_leaf and self._reachable(i)
            ]
            internal.sort(key=self.node_cost, reverse=True)
            # With the native DP each subtree solve is sub-millisecond, so
            # every round can afford to visit every internal node; the
            # pure-Python DP is ~1000x slower, so cap its per-round work
            # as before.
            if not _has_native_dp():
                internal = internal[: max(16, len(internal) // 4)]
            for top in internal:
                if deadline is not None and time.monotonic() > deadline:
                    return
                if not self._reachable(top):
                    continue
                frontier = self._collect_frontier(top, subtree_size)
                if len(frontier) < 3:
                    continue
                result = self._optimal_order(
                    [self.nodes[f].legs for f in frontier], minimize, logsize_cap
                )
                if result is None:
                    continue
                new_cost, pairs = result
                old_cost = self._subtree_cost(top, set(frontier), minimize)
                if not new_cost < old_cost * (1 - 1e-12):
                    continue
                if sliced is None:
                    self._splice(top, frontier, pairs)
                    improved = True
                    continue
                ev = sliced.evaluator
                old_pairs = self._local_pairs(top, frontier)
                old_internal = ev.subtree_internal(self, top, frontier)
                cost_before = ev.cost()
                peak_bound = sliced.peak_bound()
                self._splice(top, frontier, pairs)
                ev.sync_splice(self, top, frontier, old_internal)
                if ev.cost() <= cost_before and ev.peak() <= peak_bound:
                    improved = True
                else:
                    undo = ev.subtree_internal(self, top, frontier)
                    self._splice(top, frontier, old_pairs)
                    ev.sync_splice(self, top, frontier, undo)
            if not improved:
                break

    def _reachable(self, i: int) -> bool:
        """Whether node ``i`` is still part of the tree (splicing orphans
        old internal nodes)."""
        while self.nodes[i].parent >= 0:
            parent = self.nodes[i].parent
            pn = self.nodes[parent]
            if pn.left != i and pn.right != i:
                return False
            i = parent
        return i == self.root
