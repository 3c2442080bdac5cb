"""Shared data structures (the port's copy of ``tnc_tpu.utils.datastructures``).

``UnionFind`` with path-splitting + union-by-rank, the connectivity helper
used by ``Tensor.is_connected`` (reference:
``tnc/src/utils/datastructures.rs:9-80``).
"""

from __future__ import annotations


class UnionFind:
    """Path-halving union-find (``utils/datastructures.rs``).

    >>> uf = UnionFind(4)
    >>> uf.union(0, 1), uf.union(2, 3), uf.union(1, 2)
    (True, True, True)
    >>> uf.union(0, 3)   # already one set
    False
    >>> uf.find(0) == uf.find(3)
    True
    """

    __slots__ = ("parent", "rank")

    def __init__(self, n: int) -> None:
        self.parent = list(range(n))
        self.rank = [0] * n

    def find(self, x: int) -> int:
        parent = self.parent
        while parent[x] != x:
            parent[x], x = parent[parent[x]], parent[x]
        return x

    def union(self, a: int, b: int) -> bool:
        """Union the sets of ``a`` and ``b``; returns True if they were disjoint."""
        ra, rb = self.find(a), self.find(b)
        if ra == rb:
            return False
        if self.rank[ra] < self.rank[rb]:
            ra, rb = rb, ra
        self.parent[rb] = ra
        if self.rank[ra] == self.rank[rb]:
            self.rank[ra] += 1
        return True

    def num_sets(self) -> int:
        return sum(1 for i, p in enumerate(self.parent) if self.find(i) == i)
