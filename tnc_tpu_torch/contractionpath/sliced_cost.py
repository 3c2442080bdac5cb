"""Incremental sliced-cost evaluation and the joint tree+slice search (the
port's copy of ``tnc_tpu.contractionpath.sliced_cost``).

The historical planner treated slicing as a **post-pass**: find the
lowest-flop tree, then slice it to the memory budget and repair
(:func:`tnc_tpu_torch.contractionpath.slicing.slice_and_reconfigure`). On
budget-bound networks that sequencing is the dominant waste — a tree
that slices well routinely beats the lowest-flop tree by orders of
magnitude once the slice overhead is charged (docs/future_work.md 8a;
the EinExprs observation, arXiv:2403.18030, that cheap symbolic
re-evaluation makes slicing affordable *inside* the search, and the
SA-based joint partition+slice refinement of arXiv:2507.20667).

This module makes the sliced objective cheap enough to sit in every
search loop:

- :class:`SlicedCostEvaluator` — given a contraction tree (or flat
  replace path) and a candidate slice-leg set, maintains per-step
  "does this leg touch me" masks and answers per-slice flops, the
  hoist split, the sliced peak, and the hoist-aware total (raw flops,
  or predicted seconds under a
  :class:`~tnc_tpu_torch.obs.calibrate.CalibratedCostModel`) with
  O(affected-steps) delta updates when a leg is added/removed or a
  subtree move is applied. Exact against the
  :func:`~tnc_tpu_torch.contractionpath.slicing.sliced_flops` /
  :class:`~tnc_tpu_torch.contractionpath.slicing.StemAccountant` oracles.
- :func:`greedy_slice_to_target` — the greedy slice-set maintenance
  every hyper trial can now afford (delta-trial per candidate leg
  instead of a full path replay).
- :func:`joint_slice_search` — SA-style interleaved refinement: tree
  rotation moves and slice-set swap moves accepted under the TRUE
  sliced objective, alternating with exact-DP subtree reconfiguration
  (:meth:`ContractionTree.reconfigure` with a
  :class:`SlicedReconfState`), so tree-internal refinement finally
  optimizes the sliced cost instead of staying flop-domain.

Exactness note: step costs are recomputed as products over each step's
surviving legs (never by dividing a cached product), so evaluator
counts are bitwise-identical to the replay oracles on power-of-two
bond dimensions — i.e. every circuit network this framework plans.
"""

from __future__ import annotations

import math
import random
from typing import Sequence

from tnc_tpu_torch.contractionpath.contraction_tree import ContractionTree
from tnc_tpu_torch.tensornetwork.tensor import LeafTensor


class SlicedCostEvaluator:
    """Incremental hoist-aware sliced-cost evaluator.

    One construction pass records, per contraction step, the step's
    *union* legs (which scale its cost and operand sizes) and its
    *contributed* legs (every leg of the leaves below it — the mask
    that decides slice-variance, mirroring
    :class:`~tnc_tpu_torch.contractionpath.slicing.StemAccountant`). Adding
    or removing a slice leg then touches only the steps whose masks
    contain that leg; queries are one pass over the cached per-step
    values.

    >>> ts = [LeafTensor.from_const([0, 1], 4), LeafTensor.from_const([1, 2], 4),
    ...       LeafTensor.from_const([2, 3], 4), LeafTensor.from_const([3, 0], 4)]
    >>> ev = SlicedCostEvaluator(ts, [(0, 3), (0, 1), (0, 2)])
    >>> ev.add_leg(2)
    >>> ev.num_slices, ev.per_slice_flops() < ev.total_flops
    (4, True)
    >>> ev.drop_leg(2)
    >>> ev.per_slice_flops() == ev.total_flops
    True
    """

    def __init__(
        self,
        inputs: Sequence[LeafTensor],
        replace_path: Sequence[tuple[int, int]] | None = None,
        removed: Sequence[int] = (),
        cost_model=None,
    ):
        self._cost_model = cost_model
        self._removed: set[int] = set()
        self._slot_of: dict[int, int] = {}  # tree node id -> slot
        self._contrib: dict[int, frozenset[int]] = {}  # tree mode only
        # per-slot step tables (parallel lists; freed slots inactive)
        self._active: list[bool] = []
        self._union: list[tuple[int, ...]] = []  # sorted union legs
        self._out: list[tuple[int, ...]] = []
        self._left: list[tuple[int, ...]] = []
        self._right: list[tuple[int, ...]] = []
        self._contrib_of_slot: list[frozenset[int]] = []
        self._cost: list[float] = []
        self._size: list[float] = []
        self._vcount: list[int] = []
        self._free: list[int] = []
        self._leg_cost_slots: dict[int, set[int]] = {}
        self._leg_contrib_slots: dict[int, set[int]] = {}
        self.dims: dict[int, int] = {}
        self.open_legs: set[int] = set()

        if replace_path is None:
            return  # from_tree fills the tables itself

        for t in inputs:
            for leg, dim in t.edges():
                self.dims[leg] = dim
                if leg in self.open_legs:
                    self.open_legs.discard(leg)
                else:
                    self.open_legs.add(leg)

        tensors = [frozenset(t.legs) for t in inputs]
        contrib = [frozenset(t.legs) for t in inputs]
        for i, j in replace_path:
            ti, tj = tensors[i], tensors[j]
            out = ti ^ tj
            self._new_slot(out, ti, tj, contrib[i] | contrib[j])
            tensors[i] = out
            contrib[i] = contrib[i] | contrib[j]
        for leg in removed:
            self.add_leg(leg)

    @classmethod
    def from_tree(
        cls,
        tree: ContractionTree,
        removed: Sequence[int] = (),
        cost_model=None,
        dims: dict[int, int] | None = None,
    ) -> "SlicedCostEvaluator":
        """Tree-backed evaluator: steps keyed by internal node, kept in
        sync through structural moves via :meth:`sync_nodes` /
        :meth:`sync_splice`. ``dims`` overrides ``tree.dims`` (pass the
        full dims when the tree's copy has sliced legs set to 1)."""
        ev = cls((), None, (), cost_model)
        ev.dims = dict(dims if dims is not None else tree.dims)
        for i in range(tree.num_leaves):
            legs = tree.nodes[i].legs
            ev._contrib[i] = legs
            for leg in legs:
                if leg in ev.open_legs:
                    ev.open_legs.discard(leg)
                else:
                    ev.open_legs.add(leg)
        for i in tree._postorder():
            nd = tree.nodes[i]
            if nd.is_leaf:
                continue
            contrib = ev._contrib[nd.left] | ev._contrib[nd.right]
            ev._contrib[i] = contrib
            ev._slot_of[i] = ev._new_slot(
                nd.legs, tree.nodes[nd.left].legs, tree.nodes[nd.right].legs,
                contrib,
            )
        for leg in removed:
            ev.add_leg(leg)
        return ev

    # -- slot bookkeeping ---------------------------------------------------

    def _prod(self, legs) -> float:
        out = 1.0
        dims = self.dims
        removed = self._removed
        for leg in legs:
            if leg not in removed:
                out *= dims[leg]
        return out

    def _step_values(self, slot: int) -> None:
        """Recompute the cached cost and size of ``slot`` from its leg
        tuples (always a fresh product — never a division of a cached
        value — so delta updates stay bitwise-equal to a from-scratch
        build)."""
        self._cost[slot] = self._prod(self._union[slot])
        self._size[slot] = (
            self._prod(self._out[slot])
            + self._prod(self._left[slot])
            + self._prod(self._right[slot])
        )

    def _new_slot(self, out_legs, left_legs, right_legs, contrib) -> int:
        if self._free:
            slot = self._free.pop()
        else:
            slot = len(self._active)
            self._active.append(False)
            self._union.append(())
            self._out.append(())
            self._left.append(())
            self._right.append(())
            self._contrib_of_slot.append(frozenset())
            self._cost.append(0.0)
            self._size.append(0.0)
            self._vcount.append(0)
        self._active[slot] = True
        self._union[slot] = tuple(sorted(set(left_legs) | set(right_legs)))
        self._out[slot] = tuple(sorted(out_legs))
        self._left[slot] = tuple(sorted(left_legs))
        self._right[slot] = tuple(sorted(right_legs))
        self._contrib_of_slot[slot] = frozenset(contrib)
        for leg in self._union[slot]:
            self._leg_cost_slots.setdefault(leg, set()).add(slot)
        for leg in contrib:
            self._leg_contrib_slots.setdefault(leg, set()).add(slot)
        self._vcount[slot] = sum(
            1 for leg in self._removed if leg in self._contrib_of_slot[slot]
        )
        self._step_values(slot)
        return slot

    def _free_slot(self, slot: int) -> None:
        for leg in self._union[slot]:
            self._leg_cost_slots[leg].discard(slot)
        for leg in self._contrib_of_slot[slot]:
            self._leg_contrib_slots[leg].discard(slot)
        self._active[slot] = False
        self._cost[slot] = 0.0
        self._size[slot] = 0.0
        self._vcount[slot] = 0
        self._free.append(slot)

    # -- slice-set mutation -------------------------------------------------

    @property
    def removed(self) -> frozenset[int]:
        return frozenset(self._removed)

    @property
    def num_slices(self) -> int:
        n = 1
        for leg in self._removed:
            n *= self.dims[leg]
        return n

    def sliceable(self, leg: int) -> bool:
        """Closed, dim > 1, and not already sliced."""
        return (
            leg in self.dims
            and leg not in self.open_legs
            and self.dims[leg] > 1
            and leg not in self._removed
        )

    def add_leg(self, leg: int) -> None:
        if leg in self._removed:
            raise ValueError(f"leg {leg} already sliced")
        if leg not in self.dims:
            raise ValueError(f"unknown leg {leg}")
        self._removed.add(leg)
        for slot in self._leg_cost_slots.get(leg, ()):
            self._step_values(slot)
        for slot in self._leg_contrib_slots.get(leg, ()):
            self._vcount[slot] += 1

    def drop_leg(self, leg: int) -> None:
        if leg not in self._removed:
            raise ValueError(f"leg {leg} is not sliced")
        self._removed.discard(leg)
        for slot in self._leg_cost_slots.get(leg, ()):
            self._step_values(slot)
        for slot in self._leg_contrib_slots.get(leg, ()):
            self._vcount[slot] -= 1

    # -- tree synchronization ----------------------------------------------

    def sync_nodes(self, tree: ContractionTree, nodes: Sequence[int]) -> None:
        """Re-derive the given internal nodes from their (current)
        children, bottom-up order required — the O(affected) update for
        a rotation move (pass ``[x, p]``)."""
        for i in nodes:
            nd = tree.nodes[i]
            slot = self._slot_of[i]
            self._free_slot(slot)
            contrib = self._contrib[nd.left] | self._contrib[nd.right]
            self._contrib[i] = contrib
            self._slot_of[i] = self._new_slot(
                nd.legs, tree.nodes[nd.left].legs, tree.nodes[nd.right].legs,
                contrib,
            )

    def sync_splice(
        self,
        tree: ContractionTree,
        top: int,
        frontier: Sequence[int],
        old_internal: Sequence[int],
    ) -> None:
        """Re-slot the subtree between ``top`` and ``frontier`` after a
        DP splice replaced its internal structure. ``old_internal`` is
        the pre-splice internal node set of that region (including
        ``top``)."""
        for node in old_internal:
            slot = self._slot_of.pop(node, None)
            if slot is not None:
                self._free_slot(slot)
        order = self.subtree_internal(tree, top, frontier)
        for i in reversed(order):  # children precede parents
            nd = tree.nodes[i]
            contrib = self._contrib[nd.left] | self._contrib[nd.right]
            self._contrib[i] = contrib
            self._slot_of[i] = self._new_slot(
                nd.legs, tree.nodes[nd.left].legs, tree.nodes[nd.right].legs,
                contrib,
            )

    def subtree_internal(
        self, tree: ContractionTree, top: int, frontier: Sequence[int]
    ) -> list[int]:
        """Internal nodes between ``top`` (inclusive) and ``frontier``
        (exclusive) — what a splice will orphan."""
        frontier_set = set(frontier)
        out: list[int] = []
        stack = [top]
        while stack:
            i = stack.pop()
            if i in frontier_set or tree.nodes[i].is_leaf:
                continue
            out.append(i)
            stack.append(tree.nodes[i].left)
            stack.append(tree.nodes[i].right)
        return out

    # -- queries ------------------------------------------------------------

    @property
    def total_flops(self) -> float:
        """Per-slice flops with NO legs removed (construction-time
        value for an empty slice set; recomputed honestly otherwise)."""
        saved = self._removed
        if not saved:
            return self.per_slice_flops()
        self._removed = set()
        total = 0.0
        for slot in range(len(self._active)):
            if self._active[slot]:
                total += self._prod(self._union[slot])
        self._removed = saved
        return total

    def per_slice_flops(self) -> float:
        total = 0.0
        for slot in range(len(self._active)):
            if self._active[slot]:
                total += self._cost[slot]
        return total

    def peak(self) -> float:
        peak = 0.0
        for slot in range(len(self._active)):
            if self._active[slot] and self._size[slot] > peak:
                peak = self._size[slot]
        return peak

    def hoist_split(self) -> tuple[float, float]:
        """(invariant, per-slice residual) flops — mirrors
        :meth:`~tnc_tpu_torch.contractionpath.slicing.StemAccountant.
        hoist_split` exactly, including the no-op degradation when no
        step (1-slice plans) or every step is variant."""
        n = n_var = 0
        per_slice = 0.0
        inv = 0.0
        for slot in range(len(self._active)):
            if not self._active[slot]:
                continue
            n += 1
            per_slice += self._cost[slot]
            if self._vcount[slot] > 0:
                n_var += 1
            else:
                inv += self._cost[slot]
        if n_var == 0 or n_var == n:
            return 0.0, per_slice
        return inv, max(per_slice - inv, 0.0)

    def sliced_total(self) -> float:
        """Naive total across slices (the
        :func:`~tnc_tpu_torch.contractionpath.slicing.sliced_flops` oracle:
        ``num_slices * per_slice``)."""
        return self.per_slice_flops() * self.num_slices

    def hoisted_total(self) -> float:
        """``invariant + num_slices * residual`` flops under stem
        hoisting (the :func:`~tnc_tpu_torch.contractionpath.slicing.
        hoisted_sliced_flops` total)."""
        inv, residual = self.hoist_split()
        return inv + float(self.num_slices) * residual

    def cost(self) -> float:
        """The scoring key: hoisted flops, or predicted seconds under
        the ``cost_model`` (identical formula to
        :meth:`StemAccountant.hoisted_cost`, residual launches
        included)."""
        inv, residual = self.hoist_split()
        if self._cost_model is None:
            return inv + float(self.num_slices) * residual
        n = n_var = 0
        for slot in range(len(self._active)):
            if self._active[slot]:
                n += 1
                if self._vcount[slot] > 0:
                    n_var += 1
        if n_var == 0 or n_var == n:  # no-op hoist: all steps loop
            n_var = n
        return self._cost_model.sliced_cost(
            inv,
            residual,
            self.num_slices,
            steps_per_slice=max(float(n_var), 1.0),
            prelude_steps=max(float(n - n_var), 1.0),
        )

    def peak_step_legs(self, frac: float = 0.99) -> list[int]:
        """Sliceable legs participating in the near-peak steps (the
        slice-candidate pool, mirroring ``slice_and_reconfigure``'s
        leg selection)."""
        peak = self.peak()
        legs: set[int] = set()
        for slot in range(len(self._active)):
            if self._active[slot] and self._size[slot] >= peak * frac:
                legs.update(self._union[slot])
        return sorted(leg for leg in legs if self.sliceable(leg))

    def sliceable_legs(self) -> list[int]:
        """Every currently sliceable leg (fallback candidate pool)."""
        return sorted(leg for leg in self.dims if self.sliceable(leg))


def greedy_slice_to_target(
    ev: SlicedCostEvaluator,
    target_size: float,
    max_slices: int = 1 << 26,
    max_leg_candidates: int = 48,
) -> None:
    """Greedily grow ``ev``'s slice set until the sliced peak fits
    ``target_size``, scoring each candidate leg by (post-slice peak,
    hoisted cost) through a delta add/drop trial — the per-trial slice
    maintenance of the joint hyper search. Mutates ``ev`` in place;
    raises ``ValueError`` when the target is unreachable."""
    while True:
        peak = ev.peak()
        if peak <= target_size:
            return
        candidates = ev.peak_step_legs()
        if not candidates:
            candidates = ev.sliceable_legs()
        if not candidates:
            raise ValueError(
                f"No sliceable legs left but peak {peak:.3e} > "
                f"target {target_size:.3e}"
            )
        best_leg = -1
        best_key: tuple[float, float] | None = None
        for leg in candidates[:max_leg_candidates]:
            ev.add_leg(leg)
            key = (ev.peak(), ev.cost())
            ev.drop_leg(leg)
            if best_key is None or key < best_key:
                best_key = key
                best_leg = leg
        ev.add_leg(best_leg)
        if ev.num_slices > max_slices:
            raise ValueError(
                f"Slicing needs more than {max_slices} slices to reach "
                f"target {target_size:.3e}"
            )


class SlicedReconfState:
    """Sliced-objective acceptance for
    :meth:`ContractionTree.reconfigure`: a DP-proposed splice is kept
    only when the evaluator's hoisted sliced cost improves and the
    sliced peak stays within ``target_size`` — tree-internal
    refinement under the objective the executor actually pays."""

    def __init__(
        self,
        evaluator: SlicedCostEvaluator,
        target_size: float | None = None,
    ):
        self.evaluator = evaluator
        self.target_size = target_size

    def peak_bound(self) -> float:
        """The peak a move may not exceed: the budget, or — while the
        state is transiently over budget — the current peak."""
        peak = self.evaluator.peak()
        if self.target_size is None:
            return math.inf
        return max(self.target_size, peak)


def _sa_accept(delta: float, temp: float, rng: random.Random) -> bool:
    if delta <= 0.0:
        return True
    return temp > 0.0 and rng.random() < math.exp(-delta / temp)


def _log2_delta(new: float, old: float) -> float:
    return math.log2(new + 1.0) - math.log2(old + 1.0)


def anneal_sliced(
    tree: ContractionTree,
    ev: SlicedCostEvaluator,
    rng: random.Random,
    steps: int,
    t_start: float,
    t_end: float,
    target_size: float,
    max_slices: int = 1 << 26,
    p_slice_move: float = 0.25,
    p_partition_move: float = 0.0,
) -> None:
    """SA-style interleaved refinement: tree rotation moves and
    slice-set swap moves, both accepted by Metropolis on the log2 ratio
    of the evaluator's hoisted sliced cost, under the peak budget.
    ``tree.dims`` is kept as the *reduced* model (sliced legs dim 1) so
    DP repair passes interleaved by the caller see the slice set.

    ``p_partition_move`` enables a third move kind — a leaf exchange
    between two subtrees (the partition move of the joint
    partition+slice SA, arXiv:2507.20667), which escapes basins that
    rotations alone cannot leave because a rotation never changes which
    leaves share a subtree. Off by default: the committed planner
    baselines were annealed without it."""
    internal = [i for i, nd in enumerate(tree.nodes)
                if not nd.is_leaf and i in ev._slot_of]
    if not internal:
        return
    full_dims = ev.dims
    for step in range(steps):
        frac = step / max(1, steps - 1)
        temp = t_start * (t_end / t_start) ** frac
        move_draw = rng.random()
        if move_draw < p_slice_move and ev.removed:
            _slice_move(tree, ev, rng, temp, target_size, max_slices,
                        full_dims)
            continue
        if (
            p_partition_move > 0.0
            and p_slice_move <= move_draw < p_slice_move + p_partition_move
        ):
            _partition_move(tree, ev, rng, temp, target_size)
            continue
        p = internal[rng.randrange(len(internal))]
        if not tree._reachable(p):
            continue
        candidates = list(_rotation_candidates(tree, p))
        if not candidates:
            continue
        x, a, b, c = candidates[rng.randrange(len(candidates))]
        keep, other = (a, b) if rng.random() < 0.5 else (b, a)
        old_cost = ev.cost()
        _apply_rotation(tree, p, x, keep, other, c)
        ev.sync_nodes(tree, [x, p])
        new_cost = ev.cost()
        ok = ev.peak() <= target_size and _sa_accept(
            _log2_delta(new_cost, old_cost), temp, rng
        )
        if not ok:
            _apply_rotation(tree, p, x, keep, c, other)
            ev.sync_nodes(tree, [x, p])


def _slice_move(
    tree: ContractionTree,
    ev: SlicedCostEvaluator,
    rng: random.Random,
    temp: float,
    target_size: float,
    max_slices: int,
    full_dims: dict[int, int],
) -> None:
    """One slice-set move: swap (drop one sliced leg, add a candidate),
    plain drop, or plain add — accepted like a rotation."""
    removed = sorted(ev.removed)
    kind = rng.random()
    old_cost = ev.cost()

    def settle(ok: bool, added: int | None, dropped: int | None) -> None:
        if ok:
            if added is not None:
                tree.dims[added] = 1
            if dropped is not None:
                tree.dims[dropped] = full_dims[dropped]

    if kind < 0.6:  # swap
        drop = removed[rng.randrange(len(removed))]
        pool = ev.peak_step_legs() or ev.sliceable_legs()
        pool = [leg for leg in pool if leg != drop]
        if not pool:
            return
        add = pool[rng.randrange(len(pool))]
        ev.drop_leg(drop)
        ev.add_leg(add)
        ok = (
            ev.peak() <= target_size
            and ev.num_slices <= max_slices
            and _sa_accept(_log2_delta(ev.cost(), old_cost), temp, rng)
        )
        if not ok:
            ev.drop_leg(add)
            ev.add_leg(drop)
        settle(ok, add, drop)
    elif kind < 0.8:  # drop
        drop = removed[rng.randrange(len(removed))]
        ev.drop_leg(drop)
        ok = ev.peak() <= target_size and _sa_accept(
            _log2_delta(ev.cost(), old_cost), temp, rng
        )
        if not ok:
            ev.add_leg(drop)
        settle(ok, None, drop)
    else:  # add
        pool = ev.peak_step_legs() or ev.sliceable_legs()
        if not pool:
            return
        add = pool[rng.randrange(len(pool))]
        ev.add_leg(add)
        ok = ev.num_slices <= max_slices and _sa_accept(
            _log2_delta(ev.cost(), old_cost), temp, rng
        )
        if not ok:
            ev.drop_leg(add)
        settle(ok, add, None)


def _partition_move(
    tree: ContractionTree,
    ev: SlicedCostEvaluator,
    rng: random.Random,
    temp: float,
    target_size: float,
) -> None:
    """One partition move (arXiv:2507.20667): exchange two random
    leaves that sit under different parents, re-deriving legs and
    evaluator slots only along the two parent→LCA chains (above the
    LCA the subtree leaf set — hence every leg set — is unchanged).
    Accepted like a rotation; revert is the same swap again."""
    n = tree.num_leaves
    if n < 4:
        return
    a = rng.randrange(n)
    b = rng.randrange(n)
    if a == b or tree.nodes[a].parent == tree.nodes[b].parent:
        return
    if tree.nodes[a].parent < 0 or tree.nodes[b].parent < 0:
        return
    old_cost = ev.cost()
    _swap_leaves(tree, ev, a, b)
    ok = ev.peak() <= target_size and _sa_accept(
        _log2_delta(ev.cost(), old_cost), temp, rng
    )
    if not ok:
        _swap_leaves(tree, ev, a, b)


def _swap_leaves(
    tree: ContractionTree, ev: SlicedCostEvaluator, a: int, b: int
) -> None:
    """Exchange leaves ``a`` and ``b`` in the tree and bring ``ev``
    back in sync. Self-inverse (calling it twice restores the state
    bitwise), which is what makes the SA revert trivial."""
    nodes = tree.nodes
    pa, pb = nodes[a].parent, nodes[b].parent
    if nodes[pa].left == a:
        nodes[pa].left = b
    else:
        nodes[pa].right = b
    if nodes[pb].left == b:
        nodes[pb].left = a
    else:
        nodes[pb].right = a
    nodes[a].parent, nodes[b].parent = pb, pa

    def ancestors(i: int) -> list[int]:
        out = []
        while i >= 0:
            out.append(i)
            i = nodes[i].parent
        return out

    chain_a, chain_b = ancestors(pa), ancestors(pb)
    on_a = set(chain_a)
    lca = next(i for i in chain_b if i in on_a)
    below_a = chain_a[: chain_a.index(lca)]
    below_b = chain_b[: chain_b.index(lca)]
    # legs first (chain order is bottom-up; chains are disjoint below
    # the LCA), then the evaluator — sync_nodes reads current child
    # legs. The LCA's own legs are invariant but its step cost is not.
    for i in below_a + below_b:
        nd = nodes[i]
        nd.legs = nodes[nd.left].legs ^ nodes[nd.right].legs
    ev.sync_nodes(tree, below_a + below_b + [lca])


def joint_slice_search(
    inputs: Sequence[LeafTensor],
    ssa_path: Sequence[tuple[int, int]],
    target_size: float,
    seed_slices: Sequence[int] | None = None,
    cost_model=None,
    sa_steps: int = 600,
    sa_rounds: int = 2,
    subtree_size: int = 12,
    reconf_rounds: int = 1,
    final_rounds: int = 2,
    seed: int = 42,
    max_slices: int = 1 << 26,
    temps: tuple[float, float] = (0.3, 0.01),
    p_partition_move: float = 0.0,
) -> tuple[list[tuple[int, int]], "Slicing", float]:
    """Joint tree+slice refinement of one candidate tree: greedy slice
    seeding (or ``seed_slices``), then rounds of interleaved SA
    (rotations ⇄ slice swaps, sliced-objective acceptance) and exact-DP
    reconfiguration under :class:`SlicedReconfState`, tracking the best
    (peak-feasible) state seen — the initial seeded state included, so
    the result never scores worse than its greedy seed.

    Returns ``(ssa_pairs, slicing, cost)`` with ``cost`` in the
    evaluator's domain (hoisted flops, or seconds under
    ``cost_model``). Deterministic for a fixed seed (work-bounded, no
    wall-clock deadlines). Raises ``ValueError`` when the target is
    unreachable."""
    from tnc_tpu_torch.contractionpath.slicing import Slicing

    tree = ContractionTree.from_ssa_path(inputs, list(ssa_path))
    full_dims = dict(tree.dims)
    tree.dims = dict(tree.dims)  # private copy: sliced legs become dim 1
    ev = SlicedCostEvaluator.from_tree(tree, cost_model=cost_model,
                                       dims=full_dims)
    if seed_slices:
        for leg in seed_slices:
            if ev.sliceable(leg):
                ev.add_leg(leg)
    greedy_slice_to_target(ev, target_size, max_slices)
    for leg in ev.removed:
        tree.dims[leg] = 1

    rng = random.Random(seed ^ 0x51CE5)
    best_cost = ev.cost()
    best_pairs = tree.to_ssa_path()
    best_removed = ev.removed

    def track() -> None:
        nonlocal best_cost, best_pairs, best_removed
        if ev.peak() <= target_size:
            c = ev.cost()
            if c < best_cost:
                best_cost = c
                best_pairs = tree.to_ssa_path()
                best_removed = ev.removed

    state = SlicedReconfState(ev, target_size)
    for _ in range(max(0, sa_rounds)):
        anneal_sliced(
            tree, ev, rng, sa_steps, temps[0], temps[1], target_size,
            max_slices, p_partition_move=p_partition_move,
        )
        track()
        if reconf_rounds > 0:
            tree.reconfigure(subtree_size, reconf_rounds, sliced=state)
            track()
    if final_rounds > 0:
        tree.reconfigure(subtree_size, final_rounds, sliced=state)
        track()

    ordered = sorted(best_removed)
    slicing = Slicing(
        tuple(ordered), tuple(full_dims[leg] for leg in ordered)
    )
    return best_pairs, slicing, best_cost


def _rotation_candidates(tree: ContractionTree, p: int):
    from tnc_tpu_torch.contractionpath.paths.tree_refine import (
        _rotation_candidates as impl,
    )

    return impl(tree, p)


def _apply_rotation(tree, p, x, keep, other, c):
    from tnc_tpu_torch.contractionpath.paths.tree_refine import (
        _apply_rotation as impl,
    )

    return impl(tree, p, x, keep, other, c)
