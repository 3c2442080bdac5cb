"""Greedy iterative partition balancing by contraction-tree surgery (the
port's copy of ``tnc_tpu.contractionpath.balancing``).

Mirror of ``tnc/src/contractionpath/contraction_tree/balancing.rs`` (the
``balance_partitions_iter`` entry point, ``:98-210``; node shifting
``:517-613``) and its scheme catalogue
(``balancing/balancing_schemes.rs:83-613``): each iteration picks a
donor/receiver pair of partition subtrees, selects the leaf *or
intermediate* node whose move maximizes the objective, detaches that
node's leaves from the donor subtree, re-runs Greedy on both touched
partitions, rebuilds their subtrees in the tree, re-schedules the fan-in
with a :class:`CommunicationScheme`, and scores the critical path.

The tree here is a **forest of partition subtrees** over persistent leaf
nodes (leaf node ids survive rebuilds, internal nodes are replaced —
exactly TNC's ``remove_subtree`` + ``add_path_as_subtree``
behavior, ``contraction_tree.rs:160-222``). The fan-in levels above the
partition roots are represented as the communication path itself rather
than as tree nodes; TNC rebuilds those nodes every iteration
anyway (``replace_communication_path``, ``contraction_tree.rs:234-258``).
Divergence from TNC (deliberate): the returned path's toplevel
is the *recomputed* communication path of the best iteration — TNC
returns the original toplevel while scoring with the new one
(``balancing.rs:192-196``).

Schemes (``balancing_schemes.rs:12-68``):

- ``BEST_WORST`` — best leaf of the costliest subtree vs leaves of the
  cheapest subtree.
- ``TENSOR`` — best leaf of the costliest subtree vs *all nodes* of every
  other subtree (receiver chosen by objective).
- ``TENSORS`` — the ``TENSOR`` shift, plus the symmetric shift into the
  cheapest subtree from the best middle donor.
- ``ALTERNATING_TENSORS`` — odd iterations: leaf out of the costliest
  subtree (receiver = externals only); even: leaf into the cheapest.
- ``INTERMEDIATE_TENSORS`` — like ``TENSORS`` but donor candidates are
  height-limited *intermediate* nodes: whole subtrees move at once.
- ``ALTERNATING_INTERMEDIATE_TENSORS`` — odd/even halves of the above.
- ``ALTERNATING_TREE_TENSORS`` — intermediate moves scored against the
  receiver's external only, with a required positive objective.
"""

from __future__ import annotations

import logging
import random
from dataclasses import dataclass, field
from typing import Callable, Sequence

from tnc_tpu_torch.contractionpath.communication_schemes import CommunicationScheme
from tnc_tpu_torch.contractionpath.contraction_cost import (
    communication_path_op_costs,
)
from tnc_tpu_torch.contractionpath.contraction_path import ContractionPath
from tnc_tpu_torch.contractionpath.paths.greedy import Greedy, OptMethod
from tnc_tpu_torch.tensornetwork.tensor import CompositeTensor, LeafTensor

logger = logging.getLogger(__name__)


class BalancingScheme:
    """Scheme tags; the intermediate schemes honor ``height_limit``."""

    BEST_WORST = "best_worst"
    TENSOR = "tensor"
    TENSORS = "tensors"
    ALTERNATING_TENSORS = "alternating_tensors"
    INTERMEDIATE_TENSORS = "intermediate_tensors"
    ALTERNATING_INTERMEDIATE_TENSORS = "alternating_intermediate_tensors"
    ALTERNATING_TREE_TENSORS = "alternating_tree_tensors"


def _default_objective(shifted: LeafTensor, target: LeafTensor) -> float:
    """Memory-reduction objective, maximized
    (``benchmark/src/main.rs:689-691``): how much total size shrinks when
    ``shifted`` merges into ``target``."""
    return shifted.size() + target.size() - (shifted ^ target).size()


@dataclass
class BalanceSettings:
    """Mirror of ``BalanceSettings`` (``balancing.rs:27-86``)."""

    iterations: int = 20
    scheme: str = BalancingScheme.BEST_WORST
    height_limit: int | None = 4  # for intermediate-subtree schemes
    communication_scheme: CommunicationScheme = CommunicationScheme.GREEDY
    # Peak memory bound in ELEMENTS over the fan-in of partition externals
    # (TNC compares ``communication_path_op_costs``'s mem_cost
    # and stops balancing when exceeded, ``balancing.rs:198-200``)
    memory_limit: float | None = None
    objective: Callable[[LeafTensor, LeafTensor], float] = field(
        default=_default_objective
    )
    weighted_random_top: int | None = None  # pick randomly among top-N moves
    # a CalibratedCostModel: fan-in latencies and the iteration score
    # move to predicted seconds (dispatch overhead per local step)
    cost_model: object | None = None


# ---------------------------------------------------------------------------
# Partition forest


@dataclass
class _BNode:
    id: int
    left: int = -1
    right: int = -1
    parent: int = -1
    legs: frozenset = frozenset()
    leaf_index: int | None = None  # global tensor index for leaves

    @property
    def is_leaf(self) -> bool:
        return self.left < 0


class _PartitionForest:
    """One binary subtree per partition over persistent leaf nodes.

    Leaf node ids survive subtree rebuilds; internal node ids are fresh
    per rebuild (``contraction_tree.rs:160-222`` semantics).
    """

    def __init__(self, tensor: CompositeTensor):
        self.tensor = tensor
        self.nodes: dict[int, _BNode] = {}
        self._next_id = 0
        # leaf node id per global tensor index
        self.leaf_of: list[int] = []
        for g, t in enumerate(tensor.tensors):
            node = _BNode(
                id=self._fresh(), legs=frozenset(t.legs), leaf_index=g
            )
            self.nodes[node.id] = node
            self.leaf_of.append(node.id)

    def _fresh(self) -> int:
        self._next_id += 1
        return self._next_id - 1

    def build_subtree(
        self, leaf_node_ids: Sequence[int], local_path: Sequence[tuple[int, int]]
    ) -> int:
        """Create internal nodes for ``local_path`` (replace-path over the
        positions of ``leaf_node_ids``); returns the subtree root id."""
        if not leaf_node_ids:
            raise ValueError("cannot build a subtree over zero leaves")
        slots = list(leaf_node_ids)
        for nid in slots:
            self.nodes[nid].parent = -1
        for a, b in local_path:
            na, nb = slots[a], slots[b]
            node = _BNode(
                id=self._fresh(),
                left=na,
                right=nb,
                legs=self.nodes[na].legs ^ self.nodes[nb].legs,
            )
            self.nodes[node.id] = node
            self.nodes[na].parent = node.id
            self.nodes[nb].parent = node.id
            slots[a] = node.id
        # replace-path: the result replaces the last pair's left slot
        return slots[local_path[-1][0]] if local_path else slots[0]

    def remove_internal(self, root: int) -> None:
        """Drop the internal nodes of ``root``'s subtree, keep leaves."""
        stack = [root]
        while stack:
            i = stack.pop()
            nd = self.nodes[i]
            if nd.is_leaf:
                nd.parent = -1
                continue
            stack.append(nd.left)
            stack.append(nd.right)
            del self.nodes[i]

    def leaf_ids(self, node_id: int) -> list[int]:
        out: list[int] = []
        stack = [node_id]
        while stack:
            i = stack.pop()
            nd = self.nodes[i]
            if nd.is_leaf:
                out.append(i)
            else:
                stack.append(nd.right)
                stack.append(nd.left)
        out.reverse()
        return out

    def node_tensor(self, node_id: int) -> LeafTensor:
        """The (symbolic) tensor a node represents, from its legs."""
        nd = self.nodes[node_id]
        if nd.is_leaf:
            return self.tensor.tensors[nd.leaf_index]
        out = LeafTensor()
        for lid in self.leaf_ids(node_id):
            out = out ^ self.tensor.tensors[self.nodes[lid].leaf_index]
        return out

    def leaf_node_tensor_map(self, root: int) -> dict[int, LeafTensor]:
        """``populate_leaf_node_tensor_map``
        (``contraction_tree.rs:476-489``)."""
        return {
            lid: self.tensor.tensors[self.nodes[lid].leaf_index]
            for lid in self.leaf_ids(root)
        }

    def subtree_tensor_map(
        self, root: int, height_limit: int | None
    ) -> dict[int, LeafTensor]:
        """All leaf + intermediate node tensors of ``root``'s subtree, an
        intermediate included only when both children's heights are below
        ``height_limit`` (``contraction_tree.rs:393-465``)."""
        out: dict[int, LeafTensor] = {}

        def walk(i: int) -> tuple[LeafTensor, int]:
            nd = self.nodes[i]
            if nd.is_leaf:
                t = self.tensor.tensors[nd.leaf_index]
                out[i] = t
                return t, 0
            t1, h1 = walk(nd.left)
            t2, h2 = walk(nd.right)
            t12 = t1 ^ t2
            if height_limit is None or (h1 < height_limit and h2 < height_limit):
                out[i] = t12
            return t12, max(h1, h2) + 1

        walk(root)
        return out


@dataclass
class _PartitionData:
    """Per-partition bookkeeping (``balancing.rs:88-96``)."""

    id: int  # subtree root node id
    flop_cost: float
    mem_cost: float
    contraction: list[tuple[int, int]]  # local replace path over `leaves`
    local_tensor: LeafTensor  # external tensor of the partition
    # leaf node ids in the exact order `contraction` was built over —
    # tree-traversal order is a different permutation, so the path must
    # always be paired with this list
    leaves: list[int] = field(default_factory=list)


@dataclass
class _Shift:
    """A move of leaves between subtrees (``balancing_schemes.rs:72-80``)."""

    from_subtree_id: int
    to_subtree_id: int
    moved_leaf_ids: list[int]


# ---------------------------------------------------------------------------
# Node selection


def _find_rebalance_node(
    rng: random.Random | None,
    weighted_random_top: int | None,
    larger_nodes: dict[int, LeafTensor],
    smaller_nodes: dict[int, LeafTensor],
    objective: Callable[[LeafTensor, LeafTensor], float],
) -> tuple[int, float]:
    """Best-objective node of ``larger_nodes`` against any of
    ``smaller_nodes`` (``balancing.rs:482-513``); optionally a weighted
    random pick among the top-N."""
    comparisons = [
        (larger_id, objective(larger_tensor, smaller_tensor))
        for larger_id, larger_tensor in larger_nodes.items()
        for smaller_tensor in smaller_nodes.values()
    ]
    if weighted_random_top and rng is not None:
        options = sorted(comparisons, key=lambda c: -c[1])[:weighted_random_top]
        top = options[0][1]
        if top <= 0:
            return options[0]
        weights = [max(c[1] / top, 0.0) for c in options]
        total = sum(weights)
        pick = rng.random() * total
        acc = 0.0
        for option, w in zip(options, weights):
            acc += w
            if pick <= acc:
                return option
        return options[-1]
    return max(comparisons, key=lambda c: c[1])


# ---------------------------------------------------------------------------
# The ten scheme functions (``balancing_schemes.rs:83-613``).
# ``partition_data`` is sorted ascending by flop cost on entry: first =
# cheapest ("smaller"), last = costliest ("larger").


def _best_worst(data, forest, settings, rng) -> list[_Shift]:
    larger = data[-1].id
    smaller = data[0].id
    node, _ = _find_rebalance_node(
        rng,
        settings.weighted_random_top,
        forest.leaf_node_tensor_map(larger),
        forest.leaf_node_tensor_map(smaller),
        settings.objective,
    )
    return [_Shift(larger, smaller, forest.leaf_ids(node))]


def _best_receiver(data, forest, settings, rng, donor_id, donor_nodes):
    """Scan receivers (all but the donor): receiver subtree scored with
    its full node map; returns (receiver_id, node, objective)."""
    best = None
    for part in data:
        if part.id == donor_id:
            continue
        receiver_nodes = forest.subtree_tensor_map(part.id, None)
        node, obj = _find_rebalance_node(
            rng,
            settings.weighted_random_top,
            donor_nodes,
            receiver_nodes,
            settings.objective,
        )
        if best is None or obj > best[2]:
            best = (part.id, node, obj)
    return best


def _best_tensor(data, forest, settings, rng) -> list[_Shift]:
    larger = data[-1].id
    donor_nodes = forest.leaf_node_tensor_map(larger)
    best = _best_receiver(data[:-1], forest, settings, rng, larger, donor_nodes)
    if best is None:
        return []
    receiver, node, _ = best
    return [_Shift(larger, receiver, forest.leaf_ids(node))]


def _best_donor_into(data, forest, settings, rng, receiver_id, receiver_nodes, donor_map):
    """Scan donors (all but the receiver): returns (donor_id, node, obj).
    ``donor_map(part)`` yields the donor's candidate node map."""
    best = None
    for part in data:
        if part.id == receiver_id:
            continue
        donor_nodes = donor_map(part)
        if not donor_nodes:
            continue
        node, obj = _find_rebalance_node(
            rng,
            settings.weighted_random_top,
            donor_nodes,
            receiver_nodes,
            settings.objective,
        )
        if best is None or obj > best[2]:
            best = (part.id, node, obj)
    return best


def _best_tensors(data, forest, settings, rng) -> list[_Shift]:
    shifts = _best_tensor(data, forest, settings, rng)
    smaller = data[0].id
    receiver_nodes = forest.subtree_tensor_map(smaller, None)
    best = _best_donor_into(
        data[1:-1],
        forest,
        settings,
        rng,
        smaller,
        receiver_nodes,
        lambda part: forest.leaf_node_tensor_map(part.id),
    )
    if best is not None:
        donor, node, _ = best
        shifts.append(_Shift(donor, smaller, forest.leaf_ids(node)))
    return shifts


def _tensors_odd(data, forest, settings, rng) -> list[_Shift]:
    larger = data[-1].id
    donor_nodes = forest.leaf_node_tensor_map(larger)
    best = None
    for part in data[:-1]:
        node, obj = _find_rebalance_node(
            rng,
            settings.weighted_random_top,
            donor_nodes,
            {0: part.local_tensor},
            settings.objective,
        )
        if best is None or obj > best[2]:
            best = (part.id, node, obj)
    if best is None:
        return []
    receiver, node, _ = best
    return [_Shift(larger, receiver, forest.leaf_ids(node))]


def _tensors_even(data, forest, settings, rng) -> list[_Shift]:
    smaller = data[0]
    receiver_nodes = {0: smaller.local_tensor}
    best = _best_donor_into(
        data[1:],
        forest,
        settings,
        rng,
        smaller.id,
        receiver_nodes,
        lambda part: forest.leaf_node_tensor_map(part.id),
    )
    if best is None:
        return []
    donor, node, _ = best
    return [_Shift(donor, smaller.id, forest.leaf_ids(node))]


def _intermediate_donor_nodes(forest, root, height_limit):
    nodes = forest.subtree_tensor_map(root, height_limit)
    nodes.pop(root, None)  # never move the whole partition
    return nodes


def _best_intermediate_tensors(data, forest, settings, rng) -> list[_Shift]:
    shifts = _intermediate_tensors_odd(data, forest, settings, rng)
    smaller = data[0].id
    receiver_nodes = forest.subtree_tensor_map(smaller, None)
    best = _best_donor_into(
        data[1:-1],
        forest,
        settings,
        rng,
        smaller,
        receiver_nodes,
        lambda part: _intermediate_donor_nodes(
            forest, part.id, settings.height_limit
        ),
    )
    if best is not None:
        donor, node, _ = best
        shifts.append(_Shift(donor, smaller, forest.leaf_ids(node)))
    return shifts


def _intermediate_tensors_odd(data, forest, settings, rng) -> list[_Shift]:
    larger = data[-1].id
    donor_nodes = _intermediate_donor_nodes(forest, larger, settings.height_limit)
    if not donor_nodes:
        return []
    best = _best_receiver(data[:-1], forest, settings, rng, larger, donor_nodes)
    if best is None:
        return []
    receiver, node, _ = best
    return [_Shift(larger, receiver, forest.leaf_ids(node))]


def _intermediate_tensors_even(data, forest, settings, rng) -> list[_Shift]:
    smaller = data[0].id
    receiver_nodes = forest.subtree_tensor_map(smaller, None)
    best = _best_donor_into(
        data[1:],
        forest,
        settings,
        rng,
        smaller,
        receiver_nodes,
        lambda part: _intermediate_donor_nodes(
            forest, part.id, settings.height_limit
        ),
    )
    if best is None:
        return []
    donor, node, _ = best
    return [_Shift(donor, smaller, forest.leaf_ids(node))]


def _tree_tensors_odd(data, forest, settings, rng) -> list[_Shift]:
    """Intermediate move vs receiver externals; requires objective > 0
    (``balancing_schemes.rs:496-546``)."""
    larger = data[-1].id
    donor_nodes = _intermediate_donor_nodes(forest, larger, settings.height_limit)
    if not donor_nodes:
        return []
    best = None
    for part in data[:-1]:
        node = None
        objective = 0.0
        for node_id, node_tensor in donor_nodes.items():
            obj = settings.objective(node_tensor, part.local_tensor)
            if obj > objective:
                objective = obj
                node = node_id
        if node is not None and (best is None or objective > best[2]):
            best = (part.id, node, objective)
    if best is None:
        return []
    receiver, node, _ = best
    return [_Shift(larger, receiver, forest.leaf_ids(node))]


def _tree_tensors_even(data, forest, settings, rng) -> list[_Shift]:
    smaller = data[0]
    best = None
    for part in data[1:]:
        donor_nodes = _intermediate_donor_nodes(
            forest, part.id, settings.height_limit
        )
        if not donor_nodes:
            continue
        node = None
        objective = 0.0
        for node_id, node_tensor in donor_nodes.items():
            obj = settings.objective(node_tensor, smaller.local_tensor)
            if obj > objective:
                objective = obj
                node = node_id
        if node is not None and (best is None or objective > best[2]):
            best = (part.id, node, objective)
    if best is None:
        return []
    donor, node, _ = best
    return [_Shift(donor, smaller.id, forest.leaf_ids(node))]


def _scheme_shifts(data, forest, settings, rng, iteration) -> list[_Shift]:
    """Dispatch (``balancing.rs:258-367``): data sorted ascending by
    flop cost; alternating schemes switch on iteration parity."""
    scheme = settings.scheme
    odd = iteration % 2 == 1
    if scheme == BalancingScheme.BEST_WORST:
        return _best_worst(data, forest, settings, rng)
    if scheme == BalancingScheme.TENSOR:
        return _best_tensor(data, forest, settings, rng)
    if scheme == BalancingScheme.TENSORS:
        return _best_tensors(data, forest, settings, rng)
    if scheme == BalancingScheme.ALTERNATING_TENSORS:
        return (
            _tensors_odd(data, forest, settings, rng)
            if odd
            else _tensors_even(data, forest, settings, rng)
        )
    if scheme == BalancingScheme.INTERMEDIATE_TENSORS:
        return _best_intermediate_tensors(data, forest, settings, rng)
    if scheme == BalancingScheme.ALTERNATING_INTERMEDIATE_TENSORS:
        return (
            _intermediate_tensors_odd(data, forest, settings, rng)
            if odd
            else _intermediate_tensors_even(data, forest, settings, rng)
        )
    if scheme == BalancingScheme.ALTERNATING_TREE_TENSORS:
        return (
            _tree_tensors_odd(data, forest, settings, rng)
            if odd
            else _tree_tensors_even(data, forest, settings, rng)
        )
    raise ValueError(f"unknown balancing scheme {scheme!r}")


# ---------------------------------------------------------------------------
# Shift application


def _apply_shift(
    forest: _PartitionForest, shift: _Shift
) -> tuple[_PartitionData, _PartitionData]:
    """``shift_node_between_subtrees`` (``balancing.rs:517-613``): move
    leaves, re-Greedy both partitions, rebuild both subtrees. Returns the
    new (donor, receiver) partition data."""
    donor_leaves = forest.leaf_ids(shift.from_subtree_id)
    receiver_leaves = forest.leaf_ids(shift.to_subtree_id)
    moved = set(shift.moved_leaf_ids)
    assert moved and moved.issubset(set(donor_leaves))
    assert not moved & set(receiver_leaves)
    donor_leaves = [l for l in donor_leaves if l not in moved]
    receiver_leaves = receiver_leaves + shift.moved_leaf_ids
    if not donor_leaves:
        raise ValueError("shift would empty the donor partition")

    forest.remove_internal(shift.from_subtree_id)
    forest.remove_internal(shift.to_subtree_id)

    out = []
    for leaves in (donor_leaves, receiver_leaves):
        tensors = [
            forest.tensor.tensors[forest.nodes[l].leaf_index] for l in leaves
        ]
        if len(tensors) > 1:
            result = Greedy(OptMethod.GREEDY).find_path(
                CompositeTensor(tensors)
            )
            local = list(result.replace_path().toplevel)
            flops, mem = result.flops, result.size
            root = forest.build_subtree(leaves, local)
        else:
            local, flops, mem = [], 0.0, tensors[0].size()
            root = leaves[0]
            forest.nodes[root].parent = -1
        external = LeafTensor()
        for t in tensors:
            external = external ^ t
        out.append(
            _PartitionData(root, flops, mem, local, external, list(leaves))
        )
    return out[0], out[1]


# ---------------------------------------------------------------------------
# Main loop


def balance_partitions_iter(
    tensor: CompositeTensor,
    partitioning: Sequence[int],
    settings: BalanceSettings | None = None,
    rng: random.Random | None = None,
) -> tuple[int, CompositeTensor, ContractionPath, list[float]]:
    """Iteratively rebalance ``partitioning``; returns
    (best iteration, best partitioned network, best path, cost history)
    (``balancing.rs:98-210``).

    >>> import random
    >>> from tnc_tpu_torch.tensornetwork.tensor import CompositeTensor, LeafTensor
    >>> tn = CompositeTensor([LeafTensor([0, 1], [2, 2]),
    ...     LeafTensor([1, 2], [2, 2]), LeafTensor([2, 3], [2, 2]),
    ...     LeafTensor([3, 0], [2, 2])])
    >>> it, ptn, path, history = balance_partitions_iter(
    ...     tn, [0, 0, 0, 1], BalanceSettings(iterations=3),
    ...     random.Random(0))
    >>> len(ptn) >= 1 and len(history) >= 1
    True
    """
    settings = settings or BalanceSettings()
    rng = rng or random.Random(42)

    forest = _PartitionForest(tensor)
    blocks: dict[int, list[int]] = {}
    for g, b in enumerate(partitioning):
        blocks.setdefault(b, []).append(g)
    if len(blocks) < 2:
        raise ValueError("balancing needs at least two partitions")

    data: list[_PartitionData] = []
    for b in sorted(blocks):
        leaves = [forest.leaf_of[g] for g in blocks[b]]
        part = _characterize_from_leaves(forest, leaves)
        data.append(part)

    def score(current: list[_PartitionData]) -> tuple[float, list[tuple[int, int]], float]:
        children = [p.local_tensor for p in current]
        latency = {i: p.flop_cost for i, p in enumerate(current)}
        fanin_cost = None
        if settings.cost_model is not None:
            from tnc_tpu_torch.contractionpath.communication_schemes import (
                calibrated_latency_map,
            )
            from tnc_tpu_torch.contractionpath.contraction_cost import (
                CalibratedObjective,
            )

            latency = calibrated_latency_map(
                latency,
                settings.cost_model,
                {i: float(len(p.contraction)) for i, p in enumerate(current)},
            )
            fanin_cost = CalibratedObjective(settings.cost_model).pair_cost
        communication_path = settings.communication_scheme.communication_path(
            children, latency, rng, cost_model=settings.cost_model
        )
        costs = [latency[i] for i in range(len(current))]
        (parallel, _), mem = communication_path_op_costs(
            children, communication_path, True, costs,
            cost_function=fanin_cost,
        )
        return parallel, communication_path, mem

    def snapshot(current: list[_PartitionData], communication_path):
        # p.contraction was built over p.leaves order — never re-derive
        # the order from the tree (traversal order is a different
        # permutation of the same leaf set).
        ordered = []
        nested: dict[int, ContractionPath] = {}
        for i, p in enumerate(current):
            tensors = [
                forest.tensor.tensors[forest.nodes[l].leaf_index]
                for l in p.leaves
            ]
            ordered.append(CompositeTensor(tensors))
            nested[i] = ContractionPath.simple(list(p.contraction))
        return CompositeTensor(ordered), ContractionPath(
            nested, list(communication_path)
        )

    cost, communication_path, _ = score(data)
    history = [cost]
    best_cost = cost
    best_iteration = 0
    best_tn, best_path = snapshot(data, communication_path)

    for iteration in range(1, settings.iterations + 1):
        data.sort(key=lambda p: p.flop_cost)
        logger.debug(
            "balancing iteration %d scheme=%s donor_cost=%.3e",
            iteration,
            settings.scheme,
            data[-1].flop_cost,
        )
        shifts = _scheme_shifts(data, forest, settings, rng, iteration)
        if not shifts:
            break
        id_remap: dict[int, int] = {}
        applied = False
        for shift in shifts:
            from_id = id_remap.get(shift.from_subtree_id, shift.from_subtree_id)
            to_id = id_remap.get(shift.to_subtree_id, shift.to_subtree_id)
            if from_id == to_id:
                continue
            shift = _Shift(from_id, to_id, shift.moved_leaf_ids)
            donor_leaves = set(forest.leaf_ids(from_id))
            if not set(shift.moved_leaf_ids).issubset(donor_leaves):
                continue  # an earlier shift in this round moved these leaves
            if len(shift.moved_leaf_ids) >= len(donor_leaves):
                continue  # would empty the donor
            new_donor, new_receiver = _apply_shift(forest, shift)
            id_remap[shift.from_subtree_id] = new_donor.id
            id_remap[shift.to_subtree_id] = new_receiver.id
            for k, p in enumerate(data):
                if p.id == from_id:
                    data[k] = new_donor
                elif p.id == to_id:
                    data[k] = new_receiver
            applied = True
        if not applied:
            break

        data.sort(key=lambda p: p.flop_cost)
        cost, communication_path, mem = score(data)
        history.append(cost)
        if settings.memory_limit is not None and mem > settings.memory_limit:
            break
        if cost < best_cost:
            best_cost = cost
            best_iteration = iteration
            best_tn, best_path = snapshot(data, communication_path)

    return best_iteration, best_tn, best_path, history


def _characterize_from_leaves(
    forest: _PartitionForest, leaves: list[int]
) -> _PartitionData:
    """Initial characterization: Greedy path + subtree build per block."""
    tensors = [
        forest.tensor.tensors[forest.nodes[l].leaf_index] for l in leaves
    ]
    if len(tensors) > 1:
        result = Greedy(OptMethod.GREEDY).find_path(CompositeTensor(tensors))
        local = list(result.replace_path().toplevel)
        flops, mem = result.flops, result.size
        root = forest.build_subtree(leaves, local)
    else:
        local, flops, mem = [], 0.0, tensors[0].size()
        root = leaves[0]
    external = LeafTensor()
    for t in tensors:
        external = external ^ t
    return _PartitionData(root, flops, mem, local, external, list(leaves))
