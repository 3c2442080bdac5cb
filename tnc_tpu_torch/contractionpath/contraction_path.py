"""Contraction path types and format conversions (the port's copy of
``tnc_tpu.contractionpath.contraction_path``).

Mirror of ``tnc/src/contractionpath.rs``: a (possibly nested)
``ContractionPath`` holds per-child nested paths for composite tensors plus
a flat ``toplevel`` pair list. In a partitioned/distributed network, the
``toplevel`` path doubles as the inter-device communication schedule
(``mpi/communication.rs:199-249``).

Path formats:

- **SSA**: each contraction output gets the next fresh id (``n``, ``n+1``,
  ...); inputs are referenced by ssa id.
- **replace-left**: the output replaces the *left* input's position; no
  positions are compacted (executor keeps a list of optionals).
- **linear/opt-einsum**: not used internally; see :func:`ssa_ordering` for
  converting optimizer triple output.
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

    def to_obj(self) -> list[list[int]]:
        """JSON-able form of a *flat* path (the serving plan cache stores
        paths as plain JSON). Nested paths are an in-memory planning
        artifact and are not serialized here."""
        if self.nested:
            raise ValueError("only flat paths serialize to_obj")
        return [[int(i), int(j)] for i, j in self.toplevel]

    @classmethod
    def from_obj(cls, obj) -> "ContractionPath":
        """Inverse of :meth:`to_obj`.

        >>> ContractionPath.from_obj([[0, 1], [0, 2]]).toplevel
        [(0, 1), (0, 2)]
        """
        return cls.simple([(int(i), int(j)) for i, j in obj])


def path(*items) -> ContractionPath:
    """Convenience constructor mirroring TNC's ``path!`` macro.

    ``path((0, 1), (3, 2))`` builds a simple path; nested children are given
    as ``path({2: path((0, 1))}, (0, 1))`` — a leading dict maps child index
    to its nested path.
    """
    nested: dict[int, ContractionPath] = {}
    toplevel: list[tuple[int, int]] = []
    for item in items:
        if isinstance(item, dict):
            nested.update(item)
        else:
            toplevel.append((int(item[0]), int(item[1])))
    return ContractionPath(nested, toplevel)


def ssa_ordering(triples: Sequence[tuple[int, int, int]], n: int) -> ContractionPath:
    """Convert optimizer triple output ``(in1, in2, out)`` with arbitrary
    intermediate ids into strict SSA format (``contractionpath.rs:180-192``).
    """
    remap: dict[int, int] = {}
    next_id = n
    ssa_path = []
    for u1, u2, u3 in triples:
        t1 = remap[u1] if u1 >= n else u1
        t2 = remap[u2] if u2 >= n else u2
        if u3 not in remap:
            remap[u3] = next_id
        next_id += 1
        ssa_path.append((t1, t2))
    return ContractionPath.simple(ssa_path)


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


def replace_ssa_ordering(
    replace: Sequence[tuple[int, int]], num_inputs: int
) -> list[tuple[int, int]]:
    """Replace-left → SSA pairs (inverse of :func:`ssa_replace_ordering`
    for a flat path): slot ``a`` holds a fresh ssa id after each step
    that writes it.

    >>> replace_ssa_ordering([(0, 1), (3, 2), (0, 3)], 4)
    [(0, 1), (3, 2), (4, 5)]
    """
    current = list(range(num_inputs))
    out: list[tuple[int, int]] = []
    nxt = num_inputs
    for a, b in replace:
        out.append((current[a], current[b]))
        current[a] = nxt
        nxt += 1
    return out


def validate_path(path_: ContractionPath, num_tensors: int) -> bool:
    """Sanity-check a replace-left path fully contracts ``num_tensors``
    tensors into one (``paths.rs:87-100``): every step consumes a live
    position and exactly one survivor remains.
    """
    alive = set(range(num_tensors))
    for i, j in path_.toplevel:
        if i not in alive or j not in alive or i == j:
            return False
        alive.discard(j)
    return len(alive) == 1 or (num_tensors == 1 and not path_.toplevel)
