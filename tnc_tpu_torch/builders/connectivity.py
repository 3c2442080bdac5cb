"""Hard-coded device coupling graphs (the port's copy of
``tnc_tpu.builders.connectivity``).

Mirror of ``tnc/src/builders/connectivity.rs``: coupling maps of IBM heavy-hex
devices (Eagle/Osprey/Condor, generated by the same hexagon construction),
Google Sycamore (explicit 1-based edge table + the per-round activation
patterns a/b/c/d used by the Sycamore circuit generator), plus ``all(n)``
and ``line(n)`` topologies.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass
from itertools import cycle


class ConnectivityLayout(enum.Enum):
    CONDOR = "condor"
    EAGLE = "eagle"
    OSPREY = "osprey"
    SYCAMORE = "sycamore"
    ALL = "all"
    LINE = "line"


@dataclass
class Connectivity:
    """A device coupling graph (``connectivity.rs:4-9``).

    >>> Connectivity.new(ConnectivityLayout.LINE, 4).connectivity
    [(0, 1), (1, 2), (2, 3)]
    >>> len(Connectivity.new(ConnectivityLayout.ALL, 4).connectivity)
    6
    >>> len(Connectivity.new(ConnectivityLayout.SYCAMORE).connectivity)
    86
    """

    connectivity: list[tuple[int, int]]
    name: ConnectivityLayout

    @classmethod
    def new(cls, layout: ConnectivityLayout, n: int | None = None) -> "Connectivity":
        if layout is ConnectivityLayout.CONDOR:
            edges = condor_connect()
        elif layout is ConnectivityLayout.EAGLE:
            edges = eagle_connect()
        elif layout is ConnectivityLayout.OSPREY:
            edges = osprey_connect()
        elif layout is ConnectivityLayout.SYCAMORE:
            edges = sycamore_connect()
        elif layout is ConnectivityLayout.ALL:
            if n is None:
                raise ValueError("ALL layout needs a qubit count")
            edges = all_connect(n)
        elif layout is ConnectivityLayout.LINE:
            if n is None:
                raise ValueError("LINE layout needs a qubit count")
            edges = line_connect(n)
        else:  # pragma: no cover
            raise ValueError(layout)
        return cls(edges, layout)


def all_connect(n: int) -> list[tuple[int, int]]:
    if n <= 0:
        raise ValueError("need at least one qubit")
    return [(i, j) for i in range(n - 1) for j in range(i + 1, n)]


def line_connect(n: int) -> list[tuple[int, int]]:
    return [(i, i + 1) for i in range(n - 1)]


# Google Sycamore coupling graph, 1-based qubit labels
# (``connectivity.rs:59-148`` sycamore_connect).
def sycamore_connect() -> list[tuple[int, int]]:
    return [
        (52, 32), (32, 31), (31, 24), (24, 29), (29, 26), (26, 40), (40, 44),
        (44, 53), (37, 32), (32, 21), (21, 24), (24, 18), (18, 26), (26, 25),
        (25, 44), (44, 48), (37, 22), (22, 21), (21, 7), (7, 18), (18, 15),
        (15, 25), (25, 42), (42, 48), (35, 22), (22, 8), (8, 7), (7, 5),
        (5, 15), (15, 16), (16, 42), (42, 46), (35, 11), (11, 8), (8, 1),
        (1, 5), (5, 6), (6, 16), (16, 51), (51, 46), (11, 4), (4, 1), (1, 2),
        (2, 6), (6, 12), (12, 51), (51, 47), (14, 4), (4, 3), (3, 2), (2, 10),
        (10, 12), (12, 41), (41, 47), (36, 14), (14, 13), (13, 3), (3, 9),
        (9, 10), (10, 20), (20, 41), (41, 50), (36, 27), (27, 13), (13, 17),
        (17, 9), (9, 19), (19, 20), (20, 43), (43, 50), (38, 27), (27, 28),
        (28, 17), (17, 23), (23, 19), (19, 34), (34, 43), (43, 49), (38, 39),
        (39, 28), (28, 30), (30, 23), (23, 33), (33, 34), (34, 45), (45, 49),
    ]


# Per-round Sycamore two-qubit activation patterns (1-based labels,
# ``connectivity.rs:150-253`` sycamore_a..d).
def sycamore_a() -> list[tuple[int, int]]:
    return [
        (31, 32), (29, 24), (40, 26), (53, 44), (21, 22), (18, 7), (25, 15),
        (48, 42), (8, 11), (5, 1), (16, 6), (46, 51), (14, 4), (2, 3),
        (12, 10), (47, 41), (13, 27), (9, 17), (20, 19), (50, 43), (28, 39),
        (23, 30), (34, 33), (49, 45),
    ]


def sycamore_b() -> list[tuple[int, int]]:
    return [
        (32, 37), (24, 21), (26, 18), (44, 25), (22, 35), (7, 8), (15, 5),
        (42, 16), (1, 4), (6, 2), (51, 12), (14, 36), (3, 13), (10, 9),
        (41, 20), (27, 38), (17, 28), (19, 23), (43, 34),
    ]


def sycamore_c() -> list[tuple[int, int]]:
    return [
        (52, 32), (31, 24), (29, 26), (40, 44), (37, 22), (21, 7), (18, 15),
        (25, 42), (35, 11), (8, 1), (5, 6), (16, 51), (4, 3), (2, 10),
        (12, 41), (36, 27), (13, 17), (9, 19), (20, 43), (38, 39), (28, 30),
        (23, 33), (34, 45),
    ]


def sycamore_d() -> list[tuple[int, int]]:
    return [
        (32, 21), (24, 18), (26, 25), (44, 48), (22, 8), (7, 5), (15, 16),
        (42, 46), (11, 4), (1, 2), (6, 12), (51, 47), (14, 13), (3, 9),
        (10, 20), (41, 50), (27, 28), (17, 23), (19, 34), (43, 49),
    ]


def _hexagon_connectivity(
    row_length: int,
    stride: int,
    bridge_values: list[int],
    bridges: int,
    rows: int,
) -> list[tuple[int, int]]:
    """Heavy-hex lattice construction (``connectivity.rs:380-436``)."""
    connectivity: list[tuple[int, int]] = []
    bridge_prev = cycle(bridge_values)
    bridge_next = cycle(bridge_values)

    count = 0
    next_last = row_length - 2
    for i in range(row_length - 2):
        connectivity.append((i, i + 1))
        if i % stride == 0:
            connectivity.append((i, next_last + next(bridge_prev)))
    count += row_length - 1 + bridges

    for row in range(rows):
        prev_last = next_last
        next_last = count + row_length - 1
        for i in range(row_length - 1):
            if (i + 2 * (row % 2)) % 4 == 0:
                connectivity.append((prev_last + next(bridge_prev), count + i))
            connectivity.append((count + i, count + i + 1))
            if (i + 2 * ((row + 1) % 2)) % 4 == 0:
                connectivity.append((count + i, next_last + next(bridge_next)))
        if row % 2 == 0:
            connectivity.append((next_last, next_last + next(bridge_next)))
        count += row_length + bridges

    prev_last = next_last
    next_last = count + row_length - 2
    for i in range(row_length - 2):
        if (i + 3) % stride == 0:
            connectivity.append((prev_last + next(bridge_next), count + i))
        connectivity.append((count + i, count + i + 1))
    connectivity.append((prev_last + next(bridge_next), next_last))
    return connectivity


def eagle_connect() -> list[tuple[int, int]]:
    return _hexagon_connectivity(15, 4, list(range(1, 5)), 4, 5)


def osprey_connect() -> list[tuple[int, int]]:
    return _hexagon_connectivity(27, 4, list(range(1, 8)), 7, 11)


def condor_connect() -> list[tuple[int, int]]:
    return _hexagon_connectivity(43, 4, list(range(1, 12)), 11, 19)
