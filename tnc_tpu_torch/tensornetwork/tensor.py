"""Tensor and tensor-network structure (the port's copy of
``tnc_tpu.tensornetwork.tensor``).

Host-side metadata mirror of the reference's tensor core
(``tnc/src/tensornetwork/tensor.rs:20-63``): a tensor network *is* a tensor.
``Tensor`` is either a ``LeafTensor`` (ordered legs + bond dims + lazy data)
or a ``CompositeTensor`` (a list of child tensors, arbitrarily nested). The
recursive structure directly encodes the parallel decomposition: top-level
children of a partitioned network are one partition per device, each child a
local tensor network.

Legs are *ordered* integer edge ids; the set-algebra operators preserve
order the same way the reference does (``tensor.rs:629-725``):

- ``a - b``  : legs in ``a`` not in ``b`` (order of ``a``)
- ``a | b``  : legs of ``a`` then legs of ``b`` not in ``a``
- ``a & b``  : legs of ``a`` that are in ``b``
- ``a ^ b``  : ``(a - b)`` then ``(b - a)`` — **the shape of a pairwise
  contraction result**, used everywhere.

Data never lives here; ``TensorData`` materializes lazily at contraction
time (``tensordata.rs:37-56``).
"""

from __future__ import annotations

import enum
from typing import Iterable, Iterator, Mapping, Sequence, Union

from tnc_tpu_torch.tensornetwork.tensordata import TensorData
from tnc_tpu_torch.utils.datastructures import UnionFind

EdgeIndex = int
TensorIndex = int

Tensor = Union["LeafTensor", "CompositeTensor"]
# any sequence of tensors (the ``TensorList`` trait, ``tensor.rs:134``)
TensorList = Sequence["Tensor"]


class TensorType(enum.Enum):
    """The type of a tensor (``tensor.rs:37-41``)."""

    COMPOSITE = "composite"
    LEAF = "leaf"


class LeafTensor:
    """A single tensor: ordered legs, bond dimensions, and (lazy) data.

    Mirrors ``LeafTensor`` in ``tensor.rs`` including ``new_from_map`` /
    ``new_from_const`` constructors (``tensor.rs:476-495``) and the
    ``size()`` product-of-dims metric computed in float to avoid overflow
    (``tensor.rs:571-573``).
    """

    __slots__ = ("legs", "bond_dims", "data")

    def __init__(
        self,
        legs: Sequence[EdgeIndex] = (),
        bond_dims: Sequence[int] = (),
        data: TensorData | None = None,
    ) -> None:
        if len(legs) != len(bond_dims):
            raise ValueError(
                f"legs ({len(legs)}) and bond_dims ({len(bond_dims)}) differ in length"
            )
        self.legs: list[EdgeIndex] = list(legs)
        self.bond_dims: list[int] = list(bond_dims)
        self.data: TensorData = data if data is not None else TensorData.none()

    # -- constructors ------------------------------------------------------

    @classmethod
    def from_map(
        cls, legs: Sequence[EdgeIndex], bond_dims_map: Mapping[EdgeIndex, int]
    ) -> "LeafTensor":
        """Build from a ``{leg: dim}`` map (``tensor.rs:476`` new_from_map).

        >>> t = LeafTensor.from_map([0, 2], {0: 2, 2: 4})
        >>> t.shape
        (2, 4)
        >>> t.size()
        8.0
        """
        return cls(legs, [bond_dims_map[leg] for leg in legs])

    @classmethod
    def from_const(cls, legs: Sequence[EdgeIndex], bond_dim: int) -> "LeafTensor":
        """Build with all legs sharing one dim (``tensor.rs:492`` new_from_const)."""
        return cls(legs, [bond_dim] * len(legs))

    # -- basic queries -----------------------------------------------------

    @property
    def shape(self) -> tuple[int, ...]:
        return tuple(self.bond_dims)

    def dims(self) -> int:
        """Number of legs (tensor order)."""
        return len(self.legs)

    def size(self) -> float:
        """Number of elements, as float (large networks overflow ints)."""
        out = 1.0
        for d in self.bond_dims:
            out *= d
        return out

    def edges(self) -> Iterator[tuple[EdgeIndex, int]]:
        return zip(self.legs, self.bond_dims)

    def kind(self) -> TensorType:
        return TensorType.LEAF

    def copy(self) -> "LeafTensor":
        return LeafTensor(self.legs, self.bond_dims, self.data)

    # -- leg set algebra (order-preserving, tensor.rs:629-777) -------------

    def difference(self, other: "LeafTensor") -> "LeafTensor":
        other_legs = set(other.legs)
        legs, dims = [], []
        for leg, dim in self.edges():
            if leg not in other_legs:
                legs.append(leg)
                dims.append(dim)
        return LeafTensor(legs, dims)

    def union(self, other: "LeafTensor") -> "LeafTensor":
        self_legs = set(self.legs)
        legs = list(self.legs)
        dims = list(self.bond_dims)
        for leg, dim in other.edges():
            if leg not in self_legs:
                legs.append(leg)
                dims.append(dim)
        return LeafTensor(legs, dims)

    def intersection(self, other: "LeafTensor") -> "LeafTensor":
        other_legs = set(other.legs)
        legs, dims = [], []
        for leg, dim in self.edges():
            if leg in other_legs:
                legs.append(leg)
                dims.append(dim)
        return LeafTensor(legs, dims)

    def symmetric_difference(self, other: "LeafTensor") -> "LeafTensor":
        """``(self - other) ++ (other - self)`` — the contraction-result legs.

        >>> a = LeafTensor.from_const([0, 1, 2], 2)
        >>> b = LeafTensor.from_const([1, 2, 3], 2)
        >>> (a ^ b).legs   # contraction result of a·b
        [0, 3]
        >>> (a & b).legs   # shared (contracted) legs
        [1, 2]
        """
        self_legs = set(self.legs)
        other_legs = set(other.legs)
        legs, dims = [], []
        for leg, dim in self.edges():
            if leg not in other_legs:
                legs.append(leg)
                dims.append(dim)
        for leg, dim in other.edges():
            if leg not in self_legs:
                legs.append(leg)
                dims.append(dim)
        return LeafTensor(legs, dims)

    __sub__ = difference
    __or__ = union
    __and__ = intersection
    __xor__ = symmetric_difference

    # -- equality / repr ---------------------------------------------------

    def allclose(
        self,
        other: "LeafTensor",
        rtol: float = 1e-8,
        atol: float = 1e-12,
    ) -> bool:
        """Approximate equality: same legs/bond dims AND elementwise-close
        materialized data — the ``AbsDiffEq``/``RelativeEq`` surface the
        reference implements for tensors
        (``tnc/src/tensornetwork/tensor.rs:417-435,779-820``). Tensors
        whose data is symbolic (:class:`~tnc_tpu_torch.tensornetwork.tensordata.
        TensorData` gate/file refs) are materialized for the comparison;
        two data-less tensors compare by structure alone.
        """
        if not isinstance(other, LeafTensor):
            return False
        if self.legs != other.legs or self.bond_dims != other.bond_dims:
            return False
        import numpy as np

        from tnc_tpu_torch.tensornetwork.tensordata import DataKind

        a_none = self.data.kind is DataKind.NONE
        b_none = other.data.kind is DataKind.NONE
        if a_none or b_none:
            return a_none and b_none  # metadata-only: structure decides
        a = np.asarray(self.data.into_data())
        b = np.asarray(other.data.into_data())
        return a.shape == b.shape and bool(
            np.allclose(a, b, rtol=rtol, atol=atol)
        )

    def __eq__(self, other: object) -> bool:
        if not isinstance(other, LeafTensor):
            return NotImplemented
        return self.legs == other.legs and self.bond_dims == other.bond_dims

    def __hash__(self) -> int:
        return hash((tuple(self.legs), tuple(self.bond_dims)))

    def __repr__(self) -> str:
        return f"LeafTensor(legs={self.legs}, bond_dims={self.bond_dims})"


class CompositeTensor:
    """A tensor network: an ordered list of child tensors (leaf or composite).

    Mirrors ``CompositeTensor`` in ``tensor.rs``; supports arbitrary nesting.
    Top-level children of a partitioned network map one-to-one onto devices.
    """

    __slots__ = ("tensors",)

    def __init__(self, tensors: Iterable[Tensor] = ()) -> None:
        self.tensors: list[Tensor] = list(tensors)

    # -- collection interface ----------------------------------------------

    def __len__(self) -> int:
        return len(self.tensors)

    def __iter__(self) -> Iterator[Tensor]:
        return iter(self.tensors)

    def __getitem__(self, index: int) -> Tensor:
        return self.tensors[index]

    def push_tensor(self, tensor: Tensor) -> None:
        self.tensors.append(tensor)

    def push_tensors(self, tensors: Iterable[Tensor]) -> None:
        self.tensors.extend(tensors)

    def kind(self) -> TensorType:
        return TensorType.COMPOSITE

    def copy(self) -> "CompositeTensor":
        """Deep copy of the nesting structure (leaf data shared)."""
        return CompositeTensor(t.copy() for t in self.tensors)

    def nested_tensor(self, index_path: Sequence[int]) -> Tensor:
        """Hierarchical indexing (``tensor.rs:303-309``)."""
        tensor: Tensor = self
        for idx in index_path:
            if not isinstance(tensor, CompositeTensor):
                raise TypeError("nested_tensor path descends through a leaf")
            tensor = tensor.tensors[idx]
        return tensor

    def total_num_tensors(self) -> int:
        """Count of all leaf tensors, recursively (``tensor.rs:312-321``)."""
        total = 0
        for t in self.tensors:
            total += t.total_num_tensors() if isinstance(t, CompositeTensor) else 1
        return total

    # -- network-level queries ---------------------------------------------

    def external_tensor(self) -> LeafTensor:
        """Open legs of the network, as a leaf: fold ``^`` over all children
        (``tensor.rs:392-402``). Legs shared by an *even* number of children
        cancel; the rest are external.
        """
        result = LeafTensor()
        for t in self.tensors:
            leaf = t.external_tensor() if isinstance(t, CompositeTensor) else t
            result = result ^ leaf
        return result

    def is_connected(self) -> bool:
        """Whether the network's leg-sharing graph is connected, via
        union-find (``tensor.rs:368-389``).
        """
        n = len(self.tensors)
        if n <= 1:
            return True
        uf = UnionFind(n)
        leg_owner: dict[EdgeIndex, int] = {}
        for i, t in enumerate(self.tensors):
            leaf = t.external_tensor() if isinstance(t, CompositeTensor) else t
            for leg in leaf.legs:
                if leg in leg_owner:
                    uf.union(leg_owner[leg], i)
                else:
                    leg_owner[leg] = i
        root = uf.find(0)
        return all(uf.find(i) == root for i in range(1, n))

    def bond_dims_map(self) -> dict[EdgeIndex, int]:
        """All ``{leg: dim}`` pairs appearing anywhere in the network."""
        out: dict[EdgeIndex, int] = {}
        stack: list[Tensor] = list(self.tensors)
        while stack:
            t = stack.pop()
            if isinstance(t, CompositeTensor):
                stack.extend(t.tensors)
            else:
                for leg, dim in t.edges():
                    out[leg] = dim
        return out

    def __eq__(self, other: object) -> bool:
        if not isinstance(other, CompositeTensor):
            return NotImplemented
        return self.tensors == other.tensors

    def __repr__(self) -> str:
        return f"CompositeTensor({len(self.tensors)} tensors)"
