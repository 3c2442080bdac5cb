"""Lazy tensor data (the port's copy of ``tnc_tpu.tensornetwork.tensordata``).

Tensor payloads are symbolic until contraction touches them. A payload is
one of

- ``NONE``   — metadata-only tensor (pathfinding, cost models)
- ``GATE``   — (name, angles, adjoint) resolved through the gate registry
- ``FILE``   — (path, tensor-id, adjoint) resolved through HDF5 loading
  (:mod:`tnc_tpu_torch.io.hdf5`, host only: ``h5py`` is imported when a
  payload is materialized)
- ``MATRIX`` — an actual ndarray

``adjoint()`` is symbolic (flips a flag) except for ``MATRIX``, where it is
an eager conjugate-transpose.

Materialized data is ``numpy.complex128`` on host; the torch backend moves
it to the device and optionally down-casts to ``complex64``.
"""

from __future__ import annotations

import enum
from typing import Any

import numpy as np

# Materialized tensor payload type.
DataTensor = np.ndarray


class DataKind(enum.Enum):
    NONE = "none"
    GATE = "gate"
    FILE = "file"
    MATRIX = "matrix"


def matrix_transpose(data: np.ndarray) -> np.ndarray:
    """Transpose a matrix-like tensor of shape ``(2^n, 2^n)`` or split
    ``(2,2,...)`` by swapping the first half of dims with the second half.
    """
    if data.ndim <= 1:
        return data  # scalars and kets: the half-swap is the identity
    if data.ndim % 2:
        raise ValueError(f"matrix transpose needs an even ndim, got {data.ndim}")
    half = data.ndim // 2
    perm = tuple(range(half, data.ndim)) + tuple(range(half))
    return np.transpose(data, perm)


def matrix_adjoint(data: np.ndarray) -> np.ndarray:
    """Conjugate transpose with the half-dims-swap convention."""
    return np.conj(matrix_transpose(data))


class TensorData:
    """Tagged union of lazy tensor payloads."""

    __slots__ = ("kind", "payload")

    def __init__(self, kind: DataKind, payload: Any) -> None:
        self.kind = kind
        self.payload = payload

    # -- constructors ------------------------------------------------------

    @classmethod
    def none(cls) -> "TensorData":
        return cls(DataKind.NONE, None)

    @classmethod
    def gate(cls, name: str, angles: tuple[float, ...] = (), adjoint: bool = False) -> "TensorData":
        """Lazy named-gate payload (materialized via the gate library).

        >>> import numpy as np
        >>> TensorData.gate("h").into_data().shape
        (2, 2)
        >>> x = TensorData.gate("x")
        >>> np.allclose(x.adjoint().into_data(), x.into_data())  # X is Hermitian
        True
        """
        return cls(DataKind.GATE, (name, tuple(angles), adjoint))

    @classmethod
    def file(cls, path: str, tensor_id: int, adjoint: bool = False) -> "TensorData":
        """Lazy HDF5 payload: dataset ``tensor_id`` of the file at ``path``
        (:func:`tnc_tpu_torch.io.hdf5.load_data`), read when materialized."""
        return cls(DataKind.FILE, (path, tensor_id, adjoint))

    @classmethod
    def matrix(cls, array: np.ndarray) -> "TensorData":
        return cls(DataKind.MATRIX, np.asarray(array, dtype=np.complex128))

    @classmethod
    def from_values(cls, shape: tuple[int, ...], values: list[complex]) -> "TensorData":
        return cls.matrix(np.asarray(values, dtype=np.complex128).reshape(shape))

    # -- queries -----------------------------------------------------------

    def is_none(self) -> bool:
        return self.kind is DataKind.NONE

    # -- lazy resolution ---------------------------------------------------

    def into_data(self) -> np.ndarray:
        """Materialize to a complex128 ndarray."""
        if self.kind is DataKind.MATRIX:
            return self.payload
        if self.kind is DataKind.GATE:
            from tnc_tpu_torch.gates import load_gate, load_gate_adjoint

            name, angles, adj = self.payload
            return load_gate_adjoint(name, angles) if adj else load_gate(name, angles)
        if self.kind is DataKind.FILE:
            from tnc_tpu_torch.io.hdf5 import load_data

            path, tensor_id, adj = self.payload
            data = load_data(path, tensor_id)
            return matrix_adjoint(data) if adj else data
        raise ValueError("Cannot materialize TensorData.none()")

    def adjoint(self) -> "TensorData":
        """Symbolic adjoint: flip the flag; eager only for MATRIX."""
        if self.kind is DataKind.MATRIX:
            return TensorData.matrix(matrix_adjoint(self.payload))
        if self.kind is DataKind.GATE:
            name, angles, adj = self.payload
            return TensorData(DataKind.GATE, (name, angles, not adj))
        if self.kind is DataKind.FILE:
            path, tensor_id, adj = self.payload
            return TensorData(DataKind.FILE, (path, tensor_id, not adj))
        return TensorData.none()

    def __eq__(self, other: object) -> bool:
        if not isinstance(other, TensorData):
            return NotImplemented
        if self.kind is not other.kind:
            return False
        if self.kind is DataKind.MATRIX:
            return bool(np.array_equal(self.payload, other.payload))
        return self.payload == other.payload

    def __repr__(self) -> str:
        if self.kind is DataKind.MATRIX:
            return f"TensorData.matrix(shape={self.payload.shape})"
        return f"TensorData.{self.kind.value}({self.payload})"
