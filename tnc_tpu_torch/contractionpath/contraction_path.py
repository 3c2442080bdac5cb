"""Contraction path types and format conversions (the port's copy of
``tnc_tpu.contractionpath.contraction_path``).

Mirror of ``tnc/src/contractionpath.rs``: a (possibly nested)
``ContractionPath`` holds per-child nested paths for composite tensors plus
a flat ``toplevel`` pair list. In a partitioned/distributed network, the
``toplevel`` path doubles as the inter-device communication schedule
(``mpi/communication.rs:199-249``).

Two path formats:

- **SSA**: each contraction output gets the next fresh id (``n``, ``n+1``,
  ...); inputs are referenced by ssa id.
- **replace-left**: the output replaces the *left* input's position; no
  positions are compacted (executor keeps a list of optionals).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Sequence

SimplePath = list  # list[tuple[int, int]]
# read-only view alias (``SimplePathRef``, ``contractionpath.rs:22``) —
# Python callers accept any sequence of pairs where Rust takes a slice
SimplePathRef = Sequence  # Sequence[tuple[int, int]]


@dataclass
class ContractionPath:
    """A nested contraction path (``contractionpath.rs:30-35``)."""

    nested: dict[int, "ContractionPath"] = field(default_factory=dict)
    toplevel: list[tuple[int, int]] = field(default_factory=list)

    @classmethod
    def simple(cls, toplevel: Sequence[tuple[int, int]]) -> "ContractionPath":
        """A flat (un-nested) path.

        >>> p = ContractionPath.simple([(0, 1), (0, 2)])
        >>> p.is_simple(), len(p)
        (True, 2)
        """
        return cls({}, list(toplevel))

    def is_simple(self) -> bool:
        return not self.nested

    def __len__(self) -> int:
        return len(self.toplevel)

    def total_len(self) -> int:
        return len(self.toplevel) + sum(p.total_len() for p in self.nested.values())


def ssa_replace_ordering(
    ssa: ContractionPath, num_inputs: int | None = None
) -> ContractionPath:
    """SSA → replace-left, recursing into nested paths
    (``contractionpath.rs:197-215``). ``num_inputs`` defaults to
    ``len(toplevel) + 1`` (a fully-contracting path).

    >>> ssa = ContractionPath.simple([(0, 1), (3, 2), (4, 5)])
    >>> ssa_replace_ordering(ssa, num_inputs=4).toplevel
    [(0, 1), (3, 2), (0, 3)]
    """
    nested = {i: ssa_replace_ordering(p) for i, p in ssa.nested.items()}
    n = num_inputs if num_inputs is not None else len(ssa.toplevel) + 1
    position: dict[int, int] = {}
    toplevel = []
    for step, (t0, t1) in enumerate(ssa.toplevel):
        new_t0 = position.get(t0, t0)
        new_t1 = position.get(t1, t1)
        position[n + step] = new_t0
        toplevel.append((new_t0, new_t1))
    return ContractionPath(nested, toplevel)
