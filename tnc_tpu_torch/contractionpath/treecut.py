"""Fan-in-aware partitioning by cutting a descent-refined contraction tree
(the port's copy of ``tnc_tpu.contractionpath.treecut``: the same plan for
the same seed).

The hypergraph partitioners (``tnc_tpu_torch.tensornetwork.partitioning``,
mirroring ``tnc/src/tensornetwork/partitioning.rs:31-160``) optimize a
*cut* objective (km1 / communication volume) that is blind to how the
contraction work distributes over partitions: on deep circuit networks a
min-cut assignment can leave one partition holding nearly all the flops,
and rebalancing the *assignment* cannot fix an objective that does not
see the work. The partition-then-path pipeline also re-paths each block
greedily, which can cost far more in total than one good serial tree.

This module takes the opposite route — cutting the contraction **tree**
top-down so fan-in latencies balance:

1. Start from one good *serial* tree over the whole network (the caller
   brings the path — greedy or the hyper-optimizer).
2. A partition plan is a **frontier**: ``k`` disjoint subtrees covering
   every leaf, found by repeatedly splitting the frontier node with the
   most accumulated contraction cost. Each device contracts one
   subtree exactly as the serial plan would have; the tree *above* the
   frontier is the fan-in schedule.
3. The plan's cost model is its critical path: ``time(node) =
   node_cost + max(time(children))`` above the frontier, ``time =
   subtree cost`` at it. Randomized strict-descent local search over
   the standard tree rotations (the
   :mod:`~tnc_tpu_torch.contractionpath.paths.tree_refine` move set)
   minimizes THIS — rotations migrate work across the future cut,
   trading serial-optimal association for frontier balance the global
   objective actually pays for. Descent accepts strictly-improving
   rotations only (log2-cost plateaus dominate the move space, where
   Metropolis acceptance wanders off the narrow improving region).

Because partitions are contiguous pieces of one serial tree, the cut
tensors are intermediates the serial plan would have formed anyway
(no min-cut-style leg explosion), and the per-block local paths come
from the tree itself — no lossy greedy re-pathing of each block.
"""

from __future__ import annotations

import heapq
import random
from dataclasses import dataclass
from typing import Sequence

from tnc_tpu_torch.contractionpath.contraction_path import (
    ContractionPath,
    ssa_replace_ordering,
)
from tnc_tpu_torch.contractionpath.contraction_tree import ContractionTree
from tnc_tpu_torch.contractionpath.paths.tree_refine import (
    _apply_rotation,
    _rotation_candidates,
)
from tnc_tpu_torch.tensornetwork.tensor import LeafTensor


def _to_replace(ssa_pairs, num_inputs: int) -> list[tuple[int, int]]:
    """SSA → replace-left via the canonical converter."""
    return ssa_replace_ordering(
        ContractionPath.simple(list(ssa_pairs)), num_inputs
    ).toplevel


@dataclass
class TreecutPlan:
    """A k-way plan cut from a serial contraction tree.

    ``assignment``: partition id per input tensor (dense, ordered by
    first appearance — the ``partition_tensor_network`` convention).
    ``local_paths``: per-block replace-format path over the block's
    tensors in original input order (the
    :func:`~tnc_tpu_torch.contractionpath.repartitioning.compute_solution_with_paths`
    contract).
    ``toplevel``: the serial tree's top region as a replace-format
    fan-in over block indices — a latency-aware communication schedule
    by construction (pass to ``compute_solution_with_paths``'s
    ``communication_path``).
    ``critical_estimate`` / ``serial_estimate``: the tree cost model's
    critical-path and total flops (naive op counts, same units as
    ``ContractionTree.total_cost``).
    """

    assignment: list[int]
    local_paths: list[list[tuple[int, int]]]
    toplevel: list[tuple[int, int]]
    critical_estimate: float
    serial_estimate: float

    @property
    def speedup_estimate(self) -> float:
        return self.serial_estimate / max(self.critical_estimate, 1.0)


def _subtree_ssa(tree, top, base_of, num_bases):
    """Post-order SSA pairs over the region below ``top``, stopping at
    nodes present in ``base_of`` (their values are the SSA base ids);
    returns replace-format pairs over ``num_bases`` inputs."""
    ssa_of: dict[int, int] = {}
    next_id = num_bases
    ssa: list[tuple[int, int]] = []
    stack = [(top, False)]
    while stack:
        i, expanded = stack.pop()
        if i in base_of:
            ssa_of[i] = base_of[i]
            continue
        nd = tree.nodes[i]
        if expanded:
            ssa.append((ssa_of[nd.left], ssa_of[nd.right]))
            ssa_of[i] = next_id
            next_id += 1
            continue
        stack.append((i, True))
        stack.append((nd.right, False))
        stack.append((nd.left, False))
    return _to_replace(ssa, num_bases)


def _frontier_critical(
    tree: ContractionTree, k: int
) -> tuple[float, list[int]]:
    """(critical-path cost, frontier node ids) of the best k-frontier
    found by heaviest-first splitting."""
    weights = tree.tree_weights()
    frontier: list[tuple[float, int]] = [(-weights[tree.root], tree.root)]
    atoms: list[tuple[float, int]] = []
    while frontier and len(frontier) + len(atoms) < k:
        w, i = heapq.heappop(frontier)
        nd = tree.nodes[i]
        if nd.is_leaf:
            atoms.append((w, i))
            continue
        heapq.heappush(frontier, (-weights[nd.left], nd.left))
        heapq.heappush(frontier, (-weights[nd.right], nd.right))
    pieces = [i for _, i in frontier + atoms]
    cut = set(pieces)

    # critical path of the fan-in above the frontier: post-order over
    # the top region only
    time: dict[int, float] = {i: weights[i] for i in cut}
    stack = [(tree.root, False)]
    while stack:
        i, expanded = stack.pop()
        if i in time:
            continue
        nd = tree.nodes[i]
        if expanded:
            time[i] = tree.node_cost(i) + max(time[nd.left], time[nd.right])
            continue
        stack.append((i, True))
        stack.append((nd.left, False))
        stack.append((nd.right, False))
    return time[tree.root], pieces


def plan_treecut(
    inputs: Sequence[LeafTensor],
    ssa_pairs: Sequence[tuple[int, int]],
    k: int,
    steps: int = 4000,
    seed: int = 0,
    patience: int = 1000,
) -> TreecutPlan:
    """Cut (and descent-refine) the contraction tree of ``ssa_pairs``
    into a ``k``-device plan minimizing the fan-in critical path.
    ``patience``: stop after this many consecutive rotation PROPOSALS
    without improvement (scaled up to the tree size, so small patience
    cannot starve big trees).

    >>> from tnc_tpu_torch.tensornetwork.tensor import LeafTensor
    >>> ts = [LeafTensor.from_const([0, 1], 4), LeafTensor.from_const([1, 2], 4),
    ...       LeafTensor.from_const([2, 3], 4), LeafTensor.from_const([3, 0], 4)]
    >>> plan = plan_treecut(ts, [(0, 1), (2, 3), (4, 5)], 2, steps=0)
    >>> sorted(set(plan.assignment)), plan.speedup_estimate > 1.0
    ([0, 1], True)
    """
    n = len(inputs)
    if k <= 1:
        # one block holding everything: the local path IS the serial
        # path (replace-format), both estimates the tree total
        tree = ContractionTree.from_ssa_path(inputs, ssa_pairs)
        total = tree.total_cost()[0]
        return TreecutPlan(
            [0] * n, [_to_replace(ssa_pairs, n)], [], total, total
        )
    if n <= k:
        # every tensor its own single-leaf block: no local steps, the
        # whole tree is fan-in
        tree = ContractionTree.from_ssa_path(inputs, ssa_pairs)
        critical, _ = _frontier_critical(tree, n)
        return TreecutPlan(
            list(range(n)),
            [[] for _ in range(n)],
            _to_replace(ssa_pairs, n),
            max(critical, 1.0),
            max(tree.total_cost()[0], 1.0),
        )

    tree = ContractionTree.from_ssa_path(inputs, ssa_pairs)
    rng = random.Random(seed)

    score, _ = _frontier_critical(tree, k)
    internal = [i for i, nd in enumerate(tree.nodes) if not nd.is_leaf]
    # non-moves (unreachable picks, candidate-less nodes) count toward
    # patience, so scale it with the proposal space: a fixed cutoff
    # would starve large trees long before `steps`
    patience = max(patience, 8 * len(internal))
    since_improve = 0
    for _step in range(steps):
        if since_improve >= patience:
            break
        p = internal[rng.randrange(len(internal))]
        if not tree._reachable(p):
            since_improve += 1
            continue
        candidates = list(_rotation_candidates(tree, p))
        if not candidates:
            since_improve += 1
            continue
        x, a, b, c = candidates[rng.randrange(len(candidates))]
        keep, other = (a, b) if rng.random() < 0.5 else (b, a)
        _apply_rotation(tree, p, x, keep, other, c)
        new_score, _ = _frontier_critical(tree, k)
        if new_score < score:
            score = new_score
            since_improve = 0
        else:  # revert: the rotation is its own inverse modulo naming
            _apply_rotation(tree, p, x, keep, c, other)
            since_improve += 1
    critical, pieces = _frontier_critical(tree, k)
    serial = tree.total_cost()[0]

    # leaves under each frontier piece -> assignment (dense ids by
    # first appearance over original input order)
    piece_of: dict[int, int] = {}
    for pi, top in enumerate(pieces):
        stack = [top]
        while stack:
            i = stack.pop()
            nd = tree.nodes[i]
            if nd.is_leaf:
                piece_of[i] = pi
            else:
                stack.append(nd.left)
                stack.append(nd.right)
    remap: dict[int, int] = {}
    assignment = []
    for leaf in range(n):
        pi = piece_of[leaf]
        if pi not in remap:
            remap[pi] = len(remap)
        assignment.append(remap[pi])

    # per-block local paths straight from the tree (replace format over
    # the block's tensors in original input order)
    by_block: dict[int, int] = {}  # piece index -> block id
    for pi, b in ((pi, remap[pi]) for pi in range(len(pieces)) if pi in remap):
        by_block[b] = pi
    local_paths: list[list[tuple[int, int]]] = []
    for b in range(len(remap)):
        top = pieces[by_block[b]]
        leaves = sorted(i for i, pp in piece_of.items() if pp == by_block[b])
        pos = {leaf: j for j, leaf in enumerate(leaves)}
        local_paths.append(_subtree_ssa(tree, top, pos, len(leaves)))

    # the top region as a fan-in over pieces, then block indices
    piece_block = {pieces[pi]: remap[pi] for pi in remap}
    toplevel = _subtree_ssa(tree, tree.root, piece_block, len(remap))

    return TreecutPlan(assignment, local_paths, toplevel, critical, serial)
