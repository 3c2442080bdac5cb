"""Hypergraph representation of a tensor network (the port's copy of
``tnc_tpu.partitioning.hypergraph``).

TNC hands this job to KaHyPar (C++), building a hypergraph with
tensors as vertices and legs as hyperedges, edge weight
``1e5 * log2(bond_dim)`` — log because KaHyPar minimizes weight *sums*
while cut cost is a *product* of bond dims
(``tnc/src/tensornetwork/partitioning.rs:19,66-68``). This module is the
native replacement's data model; the partitioner itself lives in
``bisect.py``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Sequence

from tnc_tpu_torch.tensornetwork.tensor import CompositeTensor, LeafTensor


@dataclass
class Hypergraph:
    """Vertices 0..n-1 with weights; hyperedges as pin lists with weights."""

    num_vertices: int
    vertex_weights: list[float]
    edge_pins: list[list[int]]  # per edge: vertices it connects
    edge_weights: list[float]
    vertex_edges: list[list[int]] = field(default_factory=list)  # incidence

    def __post_init__(self) -> None:
        if not self.vertex_edges:
            self.vertex_edges = [[] for _ in range(self.num_vertices)]
            for e, pins in enumerate(self.edge_pins):
                for v in pins:
                    self.vertex_edges[v].append(e)

    def total_vertex_weight(self) -> float:
        return sum(self.vertex_weights)

    def cut_weight(self, partition: Sequence[int]) -> float:
        """Total weight of hyperedges spanning more than one block."""
        cut = 0.0
        for pins, w in zip(self.edge_pins, self.edge_weights):
            first = partition[pins[0]]
            if any(partition[v] != first for v in pins[1:]):
                cut += w
        return cut

    def km1_weight(self, partition: Sequence[int]) -> float:
        """Connectivity metric ``sum_e w_e * (lambda_e - 1)`` where
        ``lambda_e`` counts the blocks edge ``e`` touches — KaHyPar's
        km1 objective, the second preset TNC embeds
        (``tnc/src/tensornetwork/partition_config.rs:12-36``). Equals
        :meth:`cut_weight` for 2 blocks; diverges for k > 2, where it
        additionally penalizes edges *scattered across many* blocks
        (each extra block touched is one more fan-in transfer of that
        bond in the distributed runtime)."""
        total = 0.0
        for pins, w in zip(self.edge_pins, self.edge_weights):
            lam = len({partition[v] for v in pins})
            if lam > 1:
                total += w * (lam - 1)
        return total


def hypergraph_from_tensors(
    tensors: Sequence[LeafTensor | CompositeTensor],
    weight_scale: float = 1e5,
    unit_vertex_weights: bool = True,
) -> Hypergraph:
    """Build the partitioning hypergraph of a network: one vertex per
    (externalized) tensor, one hyperedge per shared leg, edge weight
    ``weight_scale * log2(bond_dim)`` (``partitioning.rs:40-68``).

    Legs appearing in a single tensor (open legs) produce no hyperedge.
    With ``unit_vertex_weights`` False, vertex weight = log2(tensor size),
    so balance constrains memory rather than tensor count.

    >>> from tnc_tpu_torch.tensornetwork.tensor import LeafTensor
    >>> hg = hypergraph_from_tensors([LeafTensor([0, 1], [2, 2]),
    ...     LeafTensor([1, 2], [2, 2]), LeafTensor([2, 3], [2, 2])])
    >>> hg.num_vertices, len(hg.edge_pins)   # legs 1 and 2 are shared
    (3, 2)
    """
    leaves = [
        t.external_tensor() if isinstance(t, CompositeTensor) else t for t in tensors
    ]
    leg_pins: dict[int, list[int]] = {}
    leg_dims: dict[int, int] = {}
    for v, leaf in enumerate(leaves):
        for leg, dim in leaf.edges():
            leg_pins.setdefault(leg, []).append(v)
            leg_dims[leg] = dim

    edge_pins = []
    edge_weights = []
    for leg in sorted(leg_pins):
        pins = leg_pins[leg]
        if len(pins) < 2:
            continue
        edge_pins.append(pins)
        edge_weights.append(weight_scale * math.log2(max(2, leg_dims[leg])))

    if unit_vertex_weights:
        vertex_weights = [1.0] * len(leaves)
    else:
        vertex_weights = [max(1.0, math.log2(max(2.0, t.size()))) for t in leaves]

    return Hypergraph(len(leaves), vertex_weights, edge_pins, edge_weights)
