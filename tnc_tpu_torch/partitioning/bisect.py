"""Multilevel hypergraph bisection — the native KaHyPar replacement (the
port's copy of ``tnc_tpu.partitioning.bisect``: same moves, same draws
from the same ``random.Random``, so both packages give one partition).

TNC links the KaHyPar C++ library for min-cut hypergraph
partitioning (``tnc/src/tensornetwork/partitioning.rs:6,76-89``). This is
an original multilevel implementation of the same algorithm family:

1. **Coarsening** — heavy-edge matching: repeatedly merge the pair of
   vertices sharing the heaviest connection until the graph is small.
2. **Initial partitioning** — BFS region growing from random seeds,
   several attempts, keep the best cut.
3. **Uncoarsening + FM refinement** — project the partition back up,
   running Fiduccia–Mattheyses passes (gain-ordered boundary moves with a
   balance constraint, best-prefix rollback) at every level.

k-way partitioning is recursive bisection with proportional target
weights, as KaHyPar's recursive-bisection mode does.
"""

from __future__ import annotations

import heapq
import random
from dataclasses import dataclass

from tnc_tpu_torch.partitioning.hypergraph import Hypergraph


@dataclass
class _CoarseLevel:
    graph: Hypergraph
    # map from coarse vertex -> list of fine vertices
    members: list[list[int]]


def _coarsen_once(hg: Hypergraph, rng: random.Random) -> _CoarseLevel | None:
    """One round of heavy-edge matching. Returns None when no progress."""
    n = hg.num_vertices
    # connection weight between vertex pairs via shared (small) hyperedges
    order = list(range(n))
    rng.shuffle(order)
    matched = [-1] * n
    for v in order:
        if matched[v] >= 0:
            continue
        best_u = -1
        best_w = 0.0
        conn: dict[int, float] = {}
        for e in hg.vertex_edges[v]:
            pins = hg.edge_pins[e]
            if len(pins) > 8:  # skip huge hyperedges during matching
                continue
            w = hg.edge_weights[e] / (len(pins) - 1)
            for u in pins:
                if u != v and matched[u] < 0:
                    conn[u] = conn.get(u, 0.0) + w
        for u, w in conn.items():
            if w > best_w:
                best_w, best_u = w, u
        if best_u >= 0:
            matched[v] = best_u
            matched[best_u] = v

    # build coarse graph
    coarse_id = [-1] * n
    members: list[list[int]] = []
    for v in range(n):
        if coarse_id[v] >= 0:
            continue
        u = matched[v]
        cid = len(members)
        if u >= 0 and u != v:
            members.append([v, u])
            coarse_id[v] = coarse_id[u] = cid
        else:
            members.append([v])
            coarse_id[v] = cid

    if len(members) >= n:  # no progress
        return None

    vertex_weights = [
        sum(hg.vertex_weights[v] for v in group) for group in members
    ]
    edge_map: dict[tuple[int, ...], float] = {}
    for pins, w in zip(hg.edge_pins, hg.edge_weights):
        coarse_pins = tuple(sorted({coarse_id[v] for v in pins}))
        if len(coarse_pins) < 2:
            continue
        edge_map[coarse_pins] = edge_map.get(coarse_pins, 0.0) + w
    edge_pins = [list(p) for p in edge_map]
    edge_weights = list(edge_map.values())
    coarse = Hypergraph(len(members), vertex_weights, edge_pins, edge_weights)
    return _CoarseLevel(coarse, members)


def _initial_partition(
    hg: Hypergraph, target0: float, imbalance: float, rng: random.Random, attempts: int = 8
) -> list[int]:
    """BFS region growing: grow block 0 from a random seed to its target
    weight; best cut over several attempts wins."""
    best: list[int] | None = None
    best_cut = float("inf")
    max0 = target0 * (1.0 + imbalance)
    for _ in range(max(1, attempts)):
        part = [1] * hg.num_vertices
        seed = rng.randrange(hg.num_vertices)
        weight0 = 0.0
        frontier = [seed]
        seen = {seed}
        while frontier and weight0 < target0:
            v = frontier.pop()
            if weight0 + hg.vertex_weights[v] > max0:
                continue
            part[v] = 0
            weight0 += hg.vertex_weights[v]
            for e in hg.vertex_edges[v]:
                for u in hg.edge_pins[e]:
                    if u not in seen:
                        seen.add(u)
                        frontier.insert(0, u)
        cut = hg.cut_weight(part)
        if cut < best_cut:
            best_cut = cut
            best = part
    assert best is not None
    return best


def _fm_refine(
    hg: Hypergraph,
    part: list[int],
    target0: float,
    imbalance: float,
    max_passes: int = 8,
) -> None:
    """Fiduccia–Mattheyses boundary refinement, in place."""
    n = hg.num_vertices
    total = hg.total_vertex_weight()
    min0 = target0 * (1.0 - imbalance)
    max0 = target0 * (1.0 + imbalance)

    # per-edge pin counts in each block
    for _pass in range(max_passes):
        pins_in: list[list[int]] = [[0, 0] for _ in hg.edge_pins]
        for e, pins in enumerate(hg.edge_pins):
            for v in pins:
                pins_in[e][part[v]] += 1
        weight0 = sum(w for v, w in enumerate(hg.vertex_weights) if part[v] == 0)

        def gain(v: int) -> float:
            g = 0.0
            side = part[v]
            other = 1 - side
            for e in hg.vertex_edges[v]:
                if pins_in[e][side] == 1:
                    g += hg.edge_weights[e]  # edge becomes uncut
                if pins_in[e][other] == 0:
                    g -= hg.edge_weights[e]  # edge becomes cut
            return g

        heap: list[tuple[float, int]] = []
        for v in range(n):
            heapq.heappush(heap, (-gain(v), v))

        locked = [False] * n
        moves: list[int] = []
        cum_gain = 0.0
        best_gain = 0.0
        best_prefix = 0

        while heap:
            neg_g, v = heapq.heappop(heap)
            if locked[v]:
                continue
            g = gain(v)
            if -neg_g != g:  # stale entry: reinsert with fresh gain
                heapq.heappush(heap, (-g, v))
                continue
            # balance check for the move
            w = hg.vertex_weights[v]
            new_weight0 = weight0 - w if part[v] == 0 else weight0 + w
            if not (min0 <= new_weight0 <= max0) and total > w:
                locked[v] = True  # cannot move this pass
                continue
            # apply move
            side = part[v]
            for e in hg.vertex_edges[v]:
                pins_in[e][side] -= 1
                pins_in[e][1 - side] += 1
            part[v] = 1 - side
            weight0 = new_weight0
            locked[v] = True
            cum_gain += g
            moves.append(v)
            if cum_gain > best_gain + 1e-12:
                best_gain = cum_gain
                best_prefix = len(moves)
            # refresh neighbors
            for e in hg.vertex_edges[v]:
                for u in hg.edge_pins[e]:
                    if not locked[u]:
                        heapq.heappush(heap, (-gain(u), u))

        # roll back past the best prefix
        for v in moves[best_prefix:]:
            part[v] = 1 - part[v]
        if best_gain <= 1e-12:
            break


def bisect(
    hg: Hypergraph,
    imbalance: float = 0.03,
    rng: random.Random | None = None,
    target_fraction: float = 0.5,
    coarsen_to: int = 80,
) -> list[int]:
    """Multilevel 2-way partition of ``hg``; returns block ids (0/1).

    >>> import random
    >>> from tnc_tpu_torch.tensornetwork.tensor import LeafTensor
    >>> from tnc_tpu_torch.partitioning.hypergraph import hypergraph_from_tensors
    >>> ring = [LeafTensor([i, (i + 1) % 6], [2, 2]) for i in range(6)]
    >>> blocks = bisect(hypergraph_from_tensors(ring), rng=random.Random(0))
    >>> sorted(set(blocks)), len(blocks)
    ([0, 1], 6)
    """
    if rng is None:
        rng = random.Random(42)
    if hg.num_vertices <= 1:
        return [0] * hg.num_vertices

    target0 = hg.total_vertex_weight() * target_fraction

    # Coarsening phase
    levels: list[_CoarseLevel] = []
    current = hg
    while current.num_vertices > coarsen_to:
        level = _coarsen_once(current, rng)
        if level is None:
            break
        levels.append(level)
        current = level.graph

    # Initial partition at the coarsest level
    part = _initial_partition(current, target0, imbalance, rng)
    _fm_refine(current, part, target0, imbalance)

    # Uncoarsen + refine
    for i in range(len(levels) - 1, -1, -1):
        level = levels[i]
        fine_graph = hg if i == 0 else levels[i - 1].graph
        fine_part = [0] * fine_graph.num_vertices
        for cid, group in enumerate(level.members):
            for v in group:
                fine_part[v] = part[cid]
        part = fine_part
        _fm_refine(fine_graph, part, target0, imbalance)

    return part


def kway_refine_km1(
    hg: Hypergraph,
    part: list[int],
    k: int,
    imbalance: float = 0.03,
    max_passes: int = 8,
) -> None:
    """Direct k-way move-based refinement under the connectivity (km1)
    objective ``sum_e w_e * (lambda_e - 1)``, in place.

    This is where the km1 preset genuinely diverges from cut-based
    recursive bisection: in any 2-way split ``lambda - 1`` equals the
    cut indicator, so only a k-way pass can tell the objectives apart —
    the same reason KaHyPar ships cut and km1 as distinct configs
    (``tnc/src/tensornetwork/partition_config.rs:12-36``). Python
    oracle of the native ``kway_refine_km1`` (``native/partitioner.cpp``).
    """
    n = hg.num_vertices
    if k <= 1 or n <= 1:
        return
    maxb = hg.total_vertex_weight() / k * (1.0 + imbalance)
    pins_in = [[0] * k for _ in hg.edge_pins]
    for e, pins in enumerate(hg.edge_pins):
        for v in pins:
            pins_in[e][part[v]] += 1
    block_w = [0.0] * k
    for v in range(n):
        block_w[part[v]] += hg.vertex_weights[v]

    for _pass in range(max_passes):
        moved = False
        for v in range(n):
            a = part[v]
            remove_gain = sum(
                hg.edge_weights[e]
                for e in hg.vertex_edges[v]
                if pins_in[e][a] == 1
            )
            best_b = -1
            best_gain = 1e-12
            tried = {a}
            for e in hg.vertex_edges[v]:
                for u in hg.edge_pins[e]:
                    b = part[u]
                    if b in tried:
                        continue
                    tried.add(b)
                    gain = remove_gain - sum(
                        hg.edge_weights[e2]
                        for e2 in hg.vertex_edges[v]
                        if pins_in[e2][b] == 0
                    )
                    if (
                        gain > best_gain
                        and block_w[b] + hg.vertex_weights[v] <= maxb
                    ):
                        best_gain = gain
                        best_b = b
            if best_b < 0:
                continue
            for e in hg.vertex_edges[v]:
                pins_in[e][a] -= 1
                pins_in[e][best_b] += 1
            block_w[a] -= hg.vertex_weights[v]
            block_w[best_b] += hg.vertex_weights[v]
            part[v] = best_b
            moved = True
        if not moved:
            break


def partition_kway(
    hg: Hypergraph,
    k: int,
    imbalance: float = 0.03,
    rng: random.Random | None = None,
    objective: str = "cut",
    refine_passes: int = 8,
) -> list[int]:
    """Recursive-bisection k-way partitioning (KaHyPar's RB mode).

    Dispatches to the native C++ partitioner when available (same
    algorithm family, much faster on large networks); this Python
    implementation is the oracle and fallback. ``objective='km1'``
    appends a direct k-way connectivity-refinement pass — the two
    presets TNC embeds as distinct KaHyPar configs.
    """
    if objective not in ("cut", "km1"):
        raise ValueError(f"unknown partition objective {objective!r}")
    if rng is None:
        rng = random.Random(42)

    from tnc_tpu_torch.partitioning.native_binding import (
        native_kway_refine_km1,
        native_partition_kway,
    )

    native = native_partition_kway(hg, k, imbalance, rng.getrandbits(63))
    if native is not None:
        if objective == "km1":
            refined = native_kway_refine_km1(
                hg, native, k, imbalance, max_passes=refine_passes
            )
            if refined is not None:
                return refined
            kway_refine_km1(hg, native, k, imbalance, max_passes=refine_passes)
        return native

    part = [0] * hg.num_vertices

    def recurse(vertices: list[int], k_local: int, base: int) -> None:
        if k_local <= 1 or len(vertices) <= 1:
            for v in vertices:
                part[v] = base
            return
        k_left = k_local // 2
        k_right = k_local - k_left
        # build sub-hypergraph
        index = {v: i for i, v in enumerate(vertices)}
        sub_edges = []
        sub_weights = []
        for pins, w in zip(hg.edge_pins, hg.edge_weights):
            sub_pins = [index[v] for v in pins if v in index]
            if len(sub_pins) >= 2:
                sub_edges.append(sub_pins)
                sub_weights.append(w)
        sub = Hypergraph(
            len(vertices),
            [hg.vertex_weights[v] for v in vertices],
            sub_edges,
            sub_weights,
        )
        sides = bisect(
            sub, imbalance, rng, target_fraction=k_left / k_local
        )
        left = [v for v, s in zip(vertices, sides) if s == 0]
        right = [v for v, s in zip(vertices, sides) if s == 1]
        if not left or not right:  # degenerate split: force non-empty
            half = max(1, len(vertices) * k_left // k_local)
            left, right = vertices[:half], vertices[half:]
        recurse(left, k_left, base)
        recurse(right, k_right, base + k_left)

    recurse(list(range(hg.num_vertices)), k, 0)
    if objective == "km1":
        kway_refine_km1(hg, part, k, imbalance, max_passes=refine_passes)
    return part
