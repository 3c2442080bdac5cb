"""Tree-refinement pathfinders: annealing, reconfiguration, tempering (the
port's copy of ``tnc_tpu.contractionpath.paths.tree_refine``).

Native implementations of the three cotengra tree-refinement methods the
Rust TNC bridges to Python through rustengra (all runtime-gated on a
cotengra install there, ``cotengra_check()``):

- :class:`TreeAnnealing` — simulated annealing over local tree rotations
  (``tnc/src/contractionpath/paths/tree_annealing.rs:63-71``,
  cotengra's ``simulated_anneal_tree``).
- :class:`TreeReconfigure` — iterative exact re-solving of the most
  expensive subtrees (``tree_reconfiguration.rs:54-56``,
  ``subtree_reconfigure``); thin wrapper over
  :meth:`ContractionTree.reconfigure`.
- :class:`TreeTempering` — parallel tempering: several annealing replicas
  at different temperatures with Metropolis replica exchange
  (``tree_tempering.rs:53-55``, ``parallel_temper_tree``).

Like TNC's trio these are flat single-level refiners, but they
inherit the shared nested-composite recursion from :class:`Pathfinder`,
so they also work on partitioned networks. All are deterministic for a
fixed seed.

The SA move set is the standard contraction-tree rotation: for a node
``p = (A∘B)∘C`` the two alternative associations ``(A∘C)∘B`` and
``(B∘C)∘A`` re-use the same nodes, so a move only changes one
intermediate's legs and the local cost; acceptance is Metropolis on the
log2 cost ratio, matching TNC's SA acceptance shape
(``repartitioning/simulated_annealing.rs:122-127``).
"""

from __future__ import annotations

import math
import random
from typing import Sequence

from tnc_tpu_torch.contractionpath.contraction_tree import ContractionTree
from tnc_tpu_torch.contractionpath.paths.base import Pathfinder
from tnc_tpu_torch.contractionpath.paths.greedy import DEFAULT_SEED, _ssa_greedy
from tnc_tpu_torch.tensornetwork.tensor import LeafTensor


def _initial_tree(inputs: Sequence[LeafTensor]) -> ContractionTree:
    ssa = _ssa_greedy(inputs)
    return ContractionTree.from_ssa_path(inputs, ssa)


def _check_minimize(minimize: str) -> str:
    if minimize not in ("flops", "size"):
        raise ValueError("minimize must be 'flops' or 'size'")
    return minimize


def _tree_objective(tree: ContractionTree, minimize: str) -> float:
    """Global objective matching the SA accept rule: total flops, or the
    largest intermediate tensor size."""
    if minimize == "size":
        return max(
            (tree._size(nd.legs) for nd in tree.nodes if not nd.is_leaf),
            default=0.0,
        )
    return tree.total_cost()[0]


def _local_cost(tree: ContractionTree, i: int, minimize: str) -> float:
    nd = tree.nodes[i]
    if nd.is_leaf:
        return 0.0
    if minimize == "size":
        return tree._size(nd.legs)
    return tree.node_cost(i)


def _rotation_candidates(tree: ContractionTree, p: int):
    """Yield (x, a, b, c) for p's two rotation variants: p has children
    (x, c) with x internal over (a, b); variants contract (a,c) or (b,c)
    first, re-using node x."""
    nd = tree.nodes[p]
    if nd.is_leaf:
        return
    left, right = nd.left, nd.right
    for x, c in ((left, right), (right, left)):
        xn = tree.nodes[x]
        if xn.is_leaf:
            continue
        yield x, xn.left, xn.right, c


def _apply_rotation(
    tree: ContractionTree, p: int, x: int, keep: int, other: int, c: int
) -> None:
    """Rewire ``p = (keep∘other)∘c`` into ``p = (keep∘c)∘other`` where
    ``x`` is the intermediate node (re-used for ``keep∘c``)."""
    xn = tree.nodes[x]
    xn.left, xn.right = keep, c
    xn.legs = tree.nodes[keep].legs ^ tree.nodes[c].legs
    tree.nodes[keep].parent = x
    tree.nodes[c].parent = x
    pn = tree.nodes[p]
    pn.left, pn.right = x, other
    tree.nodes[other].parent = p
    tree.nodes[x].parent = p


def _anneal(
    tree: ContractionTree,
    rng: random.Random,
    steps: int,
    t_start: float,
    t_end: float,
    minimize: str,
) -> None:
    """In-place simulated annealing over rotations; keeps the best state
    implicitly (pure improvement moves dominate at low temperature)."""
    internal = [i for i, nd in enumerate(tree.nodes) if not nd.is_leaf]
    if not internal:
        return
    for step in range(steps):
        frac = step / max(1, steps - 1)
        # log-interpolated temperature, as in TNC's SA engine
        # (simulated_annealing.rs: temp from 2.0 -> 0.05)
        temp = t_start * (t_end / t_start) ** frac
        p = internal[rng.randrange(len(internal))]
        if not tree._reachable(p):
            continue
        candidates = list(_rotation_candidates(tree, p))
        if not candidates:
            continue
        x, a, b, c = candidates[rng.randrange(len(candidates))]
        keep, other = (a, b) if rng.random() < 0.5 else (b, a)

        old_cost = _local_cost(tree, x, minimize) + _local_cost(tree, p, minimize)
        new_x_legs = tree.nodes[keep].legs ^ tree.nodes[c].legs
        if minimize == "size":
            new_x_cost = tree._size(new_x_legs)
        else:
            new_x_cost = tree._size(tree.nodes[keep].legs | tree.nodes[c].legs)
        new_p_cost_legs = new_x_legs | tree.nodes[other].legs
        if minimize == "size":
            new_p_cost = tree._size(tree.nodes[p].legs)
        else:
            new_p_cost = tree._size(new_p_cost_legs)
        new_cost = new_x_cost + new_p_cost

        delta = math.log2(new_cost + 1.0) - math.log2(old_cost + 1.0)
        if delta <= 0.0 or (
            temp > 0.0 and rng.random() < math.exp(-delta / temp)
        ):
            _apply_rotation(tree, p, x, keep, other, c)


class TreeAnnealing(Pathfinder):
    """Simulated-annealing tree refinement
    (``tree_annealing.rs``; greedy init + rotation SA).

    >>> from tnc_tpu_torch.tensornetwork.tensor import CompositeTensor, LeafTensor
    >>> tn = CompositeTensor([LeafTensor([0, 1], [4, 4]),
    ...     LeafTensor([1, 2], [4, 4]), LeafTensor([2, 0], [4, 4])])
    >>> result = TreeAnnealing(iterations=5, seed=1).find_path(tn)
    >>> len(result.replace_path().toplevel), result.flops > 0
    (2, True)
    """

    def __init__(
        self,
        iterations: int = 40,
        t_start: float = 2.0,
        t_end: float = 0.05,
        minimize: str = "flops",
        seed: int = DEFAULT_SEED,
    ):
        self.iterations = iterations
        self.t_start = t_start
        self.t_end = t_end
        self.minimize = _check_minimize(minimize)
        self.seed = seed

    def _solve_toplevel(self, inputs: list) -> list[tuple[int, int]]:
        if len(inputs) <= 1:
            return []
        rng = random.Random(self.seed)
        tree = _initial_tree(inputs)
        best = tree.copy()
        best_cost = _tree_objective(tree, self.minimize)
        steps = max(64, self.iterations * len(inputs))
        chunks = 8
        for _ in range(chunks):
            _anneal(
                tree, rng, steps // chunks, self.t_start, self.t_end,
                self.minimize,
            )
            cost = _tree_objective(tree, self.minimize)
            if cost < best_cost:
                best_cost = cost
                best = tree.copy()
        return best.to_ssa_path()


class TreeReconfigure(Pathfinder):
    """Subtree reconfiguration (``tree_reconfiguration.rs``): exact
    re-solving of the most expensive <=``subtree_size`` subtrees."""

    def __init__(
        self,
        subtree_size: int = 8,
        max_rounds: int = 4,
        minimize: str = "flops",
    ):
        # no seed: reconfiguration is fully deterministic (exact DP walk)
        self.subtree_size = subtree_size
        self.max_rounds = max_rounds
        self.minimize = _check_minimize(minimize)

    def _solve_toplevel(self, inputs: list) -> list[tuple[int, int]]:
        if len(inputs) <= 1:
            return []
        tree = _initial_tree(inputs)
        tree.reconfigure(
            subtree_size=self.subtree_size,
            max_rounds=self.max_rounds,
            minimize=self.minimize,
        )
        return tree.to_ssa_path()


class TreeTempering(Pathfinder):
    """Parallel tempering (``tree_tempering.rs``): annealing replicas on
    a temperature ladder with Metropolis replica exchange between
    rounds; the coldest replica's best tree wins."""

    def __init__(
        self,
        num_replicas: int = 4,
        rounds: int = 8,
        steps_per_round: int | None = None,
        t_min: float = 0.05,
        t_max: float = 2.0,
        minimize: str = "flops",
        seed: int = DEFAULT_SEED,
    ):
        self.num_replicas = max(2, num_replicas)
        self.rounds = rounds
        self.steps_per_round = steps_per_round
        self.t_min = t_min
        self.t_max = t_max
        self.minimize = _check_minimize(minimize)
        self.seed = seed

    def _solve_toplevel(self, inputs: list) -> list[tuple[int, int]]:
        if len(inputs) <= 1:
            return []
        rng = random.Random(self.seed)
        r = self.num_replicas
        temps = [
            self.t_min * (self.t_max / self.t_min) ** (i / (r - 1))
            for i in range(r)
        ]
        replicas = [_initial_tree(inputs) for _ in range(r)]
        steps = self.steps_per_round or max(32, 10 * len(inputs))

        best = replicas[0].copy()
        best_cost = _tree_objective(best, self.minimize)
        for _ in range(self.rounds):
            costs = []
            for i in range(r):
                # constant temperature within a round (t_start == t_end)
                _anneal(
                    replicas[i], rng, steps, temps[i], temps[i], self.minimize
                )
                cost = _tree_objective(replicas[i], self.minimize)
                costs.append(cost)
                if cost < best_cost:
                    best_cost = cost
                    best = replicas[i].copy()
            # Metropolis replica exchange between temperature neighbors,
            # on log2 cost (the same scale the acceptance rule uses)
            for i in range(r - 1):
                li = math.log2(costs[i] + 1.0)
                lj = math.log2(costs[i + 1] + 1.0)
                arg = (1.0 / temps[i] - 1.0 / temps[i + 1]) * (li - lj)
                if arg >= 0.0 or rng.random() < math.exp(arg):
                    replicas[i], replicas[i + 1] = replicas[i + 1], replicas[i]
                    costs[i], costs[i + 1] = costs[i + 1], costs[i]
        return best.to_ssa_path()
