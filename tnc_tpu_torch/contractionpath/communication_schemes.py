"""Communication scheduling for partitioned contraction (the port's copy
of ``tnc_tpu.contractionpath.communication_schemes``: the same fan-in for
the same seed).

Mirror of ``tnc/src/contractionpath/communication_schemes.rs:19-73``: once
each partition has contracted locally, the partitions' result tensors must
be combined. The pair order of that fan-in *is* the inter-device
communication schedule (``mpi/communication.rs:199-249``; in this
framework it drives mesh collectives instead of MPI sends), and the right
objective is the **critical path** including each partition's local
completion latency.

Six schemes, as in TNC:

- ``GREEDY`` / ``RANDOM_GREEDY`` — the greedy pathfinders over the
  partition result tensors (latencies ignored).
- ``BIPARTITION`` — recursive 2-cut of the result tensors, larger tensor
  kept left (``communication_schemes.rs:147-212``).
- ``BIPARTITION_SWEEP`` — 20 random imbalances in [0.01, 0.5], keep the
  best critical-path cost (``communication_schemes.rs:91-123``).
- ``WEIGHTED_BRANCH_BOUND`` — latency-aware branch-and-bound.
- ``BRANCH_BOUND`` — same engine with zero latencies.

All schemes return a **replace-format** flat path over the partition
indices.
"""

from __future__ import annotations

import enum
import random
from typing import Sequence

from tnc_tpu_torch.contractionpath.contraction_cost import (
    CalibratedObjective,
    communication_path_cost,
)
from tnc_tpu_torch.contractionpath.contraction_path import SimplePath  # noqa: F401
from tnc_tpu_torch.contractionpath.paths.branchbound import WeightedBranchBound
from tnc_tpu_torch.contractionpath.paths.greedy import Greedy, OptMethod
from tnc_tpu_torch.partitioning.bisect import bisect
from tnc_tpu_torch.partitioning.hypergraph import hypergraph_from_tensors
from tnc_tpu_torch.tensornetwork.tensor import CompositeTensor, LeafTensor


def calibrated_latency_map(
    local_flops: dict[int, float],
    cost_model,
    local_steps: dict[int, float] | None = None,
) -> dict[int, float]:
    """Per-partition fan-in latencies in predicted **seconds**.

    ``local_flops[i]`` is partition ``i``'s local contraction op count
    and ``local_steps[i]`` its step count (dispatch overhead is charged
    per step; defaults to 1). The result is what the latency-aware
    schemes should receive instead of raw flop counts once a
    :class:`~tnc_tpu_torch.obs.calibrate.CalibratedCostModel` is available —
    mixing flop latencies with seconds step costs (or vice versa) makes
    the critical path meaningless.

    >>> from tnc_tpu_torch.obs.calibrate import CalibratedCostModel
    >>> m = CalibratedCostModel(flops_per_s=1e9, dispatch_s=1e-3)
    >>> calibrated_latency_map({0: 1e6, 1: 0.0}, m)[0]
    0.002
    """
    out: dict[int, float] = {}
    for i, flops in local_flops.items():
        steps = 1.0 if local_steps is None else max(local_steps.get(i, 1.0), 1.0)
        out[i] = cost_model.op_seconds(flops, dispatches=steps)
    return out


def fanin_levels(
    toplevel: Sequence[tuple[int, int]],
) -> list[list[tuple[int, int]]]:
    """Group a replace-format fan-in path into dependency **levels**:
    every pair within a level touches disjoint indices, so all of a
    level's contractions are independent and may dispatch concurrently;
    a pair lands one level past the deepest level either operand was
    last produced in. This is the overlap schedule the pod executor
    runs (``intermediate_reduce``): same-level pairs dispatch without
    intervening host synchronization, levels execute in order.

    The schedule is derived from the communication scheme's path, so a
    latency-aware scheme (priced with the calibrated latency map) still
    controls WHICH pairs exist and their tree shape — levels only make
    the independence that was already in the tree explicit.

    Disjointness within a level holds by construction: a pair at level
    ``L`` bumps its surviving index ``x`` to depth ``L+1``, so any later
    pair touching ``x`` is scheduled at ``L+1`` or deeper, and consumed
    ``y`` indices never reappear (``_fanin_survivor`` validates that).

    >>> fanin_levels([(0, 1), (2, 3), (0, 2)])
    [[(0, 1), (2, 3)], [(0, 2)]]
    >>> fanin_levels([(0, 1), (0, 2), (0, 3)])
    [[(0, 1)], [(0, 2)], [(0, 3)]]
    """
    depth: dict[int, int] = {}
    levels: list[list[tuple[int, int]]] = []
    for x, y in toplevel:
        level = max(depth.get(x, 0), depth.get(y, 0))
        if level == len(levels):
            levels.append([])
        levels[level].append((x, y))
        depth[x] = level + 1
    return levels


class CommunicationScheme(enum.Enum):
    GREEDY = "greedy"
    RANDOM_GREEDY = "random_greedy"
    BIPARTITION = "bipartition"
    BIPARTITION_SWEEP = "bipartition_sweep"
    WEIGHTED_BRANCH_BOUND = "weightedbranchbound"
    BRANCH_BOUND = "branchbound"

    def communication_path(
        self,
        children_tensors: Sequence[LeafTensor],
        latency_map: dict[int, float] | None = None,
        rng: random.Random | None = None,
        cost_model=None,
    ) -> list[tuple[int, int]]:
        """Replace-format fan-in path over the partition tensors.

        ``cost_model`` (a :class:`~tnc_tpu_torch.obs.calibrate.
        CalibratedCostModel`) switches the latency-aware schemes to the
        seconds domain: fan-in steps are priced as predicted step
        seconds, and ``latency_map`` is expected in seconds too
        (:func:`calibrated_latency_map`).

        >>> from tnc_tpu_torch.tensornetwork.tensor import LeafTensor
        >>> parts = [LeafTensor([0, 1], [4, 4]), LeafTensor([1, 2], [4, 4]),
        ...          LeafTensor([2, 0], [4, 4])]
        >>> sorted(CommunicationScheme.GREEDY.communication_path(parts))
        [(0, 1), (0, 2)]
        >>> CommunicationScheme.WEIGHTED_BRANCH_BOUND.communication_path(
        ...     parts, {0: 1000.0, 1: 0.0, 2: 0.0})[0]  # defer latency-1000
        (1, 2)
        """
        if latency_map is None:
            latency_map = {i: 0.0 for i in range(len(children_tensors))}
        if len(children_tensors) <= 1:
            return []

        if self is CommunicationScheme.GREEDY:
            return _greedy_path(children_tensors, OptMethod.GREEDY)
        if self is CommunicationScheme.RANDOM_GREEDY:
            return _greedy_path(children_tensors, OptMethod.RANDOM_GREEDY)
        if self is CommunicationScheme.BIPARTITION:
            return _tensor_bipartition(list(enumerate(children_tensors)), 0.03)
        if self is CommunicationScheme.BIPARTITION_SWEEP:
            if rng is None:
                raise ValueError("BIPARTITION_SWEEP requires a random generator")
            return _bipartition_sweep(
                children_tensors, latency_map, rng, cost_model=cost_model
            )
        if self is CommunicationScheme.WEIGHTED_BRANCH_BOUND:
            return _branchbound_path(
                children_tensors, latency_map, cost_model
            )
        if self is CommunicationScheme.BRANCH_BOUND:
            zero = {i: 0.0 for i in range(len(children_tensors))}
            return _branchbound_path(children_tensors, zero, cost_model)
        raise ValueError(self)  # pragma: no cover


def _greedy_path(
    children_tensors: Sequence[LeafTensor], method: OptMethod
) -> list[tuple[int, int]]:
    tn = CompositeTensor([t.copy() for t in children_tensors])
    result = Greedy(method).find_path(tn)
    return result.replace_path().toplevel


def _branchbound_path(
    children_tensors: Sequence[LeafTensor],
    latency_map: dict[int, float],
    cost_model=None,
) -> list[tuple[int, int]]:
    tn = CompositeTensor([t.copy() for t in children_tensors])
    objective = (
        CalibratedObjective(cost_model) if cost_model is not None else None
    )
    finder = WeightedBranchBound(
        latency_map, nbranch=10, cutoff_flops_factor=5.0, objective=objective
    )
    return finder.find_path(tn).replace_path().toplevel


def _bipartition_sweep(
    children_tensors: Sequence[LeafTensor],
    latency_map: dict[int, float],
    rng: random.Random,
    sweeps: int = 20,
    cost_model=None,
) -> list[tuple[int, int]]:
    latencies = [latency_map[i] for i in sorted(latency_map)]
    pair_cost = (
        CalibratedObjective(cost_model).pair_cost
        if cost_model is not None
        else None
    )
    best_cost = float("inf")
    best_path: list[tuple[int, int]] = []
    for _ in range(sweeps):
        imbalance = 0.01 + rng.random() * 0.49
        path = _tensor_bipartition(list(enumerate(children_tensors)), imbalance, rng)
        cost, _ = communication_path_cost(
            children_tensors, path, True, True, latencies,
            cost_function=pair_cost,
        )
        if cost < best_cost:
            best_cost = cost
            best_path = path
    return best_path


def _tensor_bipartition(
    children: list[tuple[int, LeafTensor]],
    imbalance: float,
    rng: random.Random | None = None,
) -> list[tuple[int, int]]:
    """Recursive bipartition fan-in; result replaces the larger side's id
    (``communication_schemes.rs:147-212``)."""
    _, _, path = _tensor_bipartition_recursive(children, imbalance, rng)
    return path


def _tensor_bipartition_recursive(
    children: list[tuple[int, LeafTensor]],
    imbalance: float,
    rng: random.Random | None,
) -> tuple[int, LeafTensor, list[tuple[int, int]]]:
    if len(children) == 1:
        return children[0][0], children[0][1], []
    if len(children) == 2:
        (ia, ta), (ib, tb) = children
        if tb.size() > ta.size():
            ia, ib = ib, ia
        return ia, ta ^ tb, [(ia, ib)]

    hg = hypergraph_from_tensors([t for _, t in children])
    sides = bisect(hg, imbalance, rng or random.Random(42))
    left = [c for c, s in zip(children, sides) if s == 0]
    right = [c for c, s in zip(children, sides) if s == 1]
    if not left or not right:
        half = len(children) // 2
        left, right = children[:half], children[half:]

    id1, t1, path1 = _tensor_bipartition_recursive(left, imbalance, rng)
    id2, t2, path2 = _tensor_bipartition_recursive(right, imbalance, rng)
    out = t1 ^ t2
    if t2.size() > t1.size():
        id1, id2 = id2, id1
    combined = path1 + path2
    combined.append((id1, id2))
    return id1, out, combined
