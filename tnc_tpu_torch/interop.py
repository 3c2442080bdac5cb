"""Carrying state between the JAX package and the port.

For a contraction the "weights" are the network's leaf tensors and the
contraction path. Both cross over as plain Python and numpy values, so the
port never imports ``tnc_tpu``:

- :func:`network_from_arrays` takes ``(legs, dims, ndarray)`` triples — what
  ``[(l.legs, l.bond_dims, l.data.into_data()) for l in
  tnc_tpu.ops.program.flat_leaf_tensors(tn)]`` gives — and returns the
  port's flat :class:`~tnc_tpu_torch.tensornetwork.tensor.CompositeTensor`;
- :func:`path_from_pairs` takes replace-left pairs (``path.toplevel`` of a
  flat path) and returns the port's
  :class:`~tnc_tpu_torch.contractionpath.contraction_path.ContractionPath`.
"""

from __future__ import annotations

from typing import Iterable, Sequence

import numpy as np

from tnc_tpu_torch.contractionpath.contraction_path import ContractionPath
from tnc_tpu_torch.tensornetwork.tensor import CompositeTensor, LeafTensor
from tnc_tpu_torch.tensornetwork.tensordata import TensorData


def network_from_arrays(
    leaves: Iterable[tuple[Sequence[int], Sequence[int], np.ndarray]],
) -> CompositeTensor:
    """A flat network of leaf tensors with the given legs, bond dims and
    data (in the given order, which is the program's slot order).

    >>> tn = network_from_arrays([([0], [2], np.array([1.0, 2.0])),
    ...                           ([0], [2], np.array([3.0, 4.0]))])
    >>> [l.legs for l in tn.tensors]
    [[0], [0]]
    """
    tensors = []
    for legs, dims, data in leaves:
        data = np.asarray(data)
        if tuple(data.shape) != tuple(int(d) for d in dims):
            raise ValueError(
                f"leaf data shape {data.shape} does not match bond dims {tuple(dims)}"
            )
        tensors.append(
            LeafTensor([int(l) for l in legs], [int(d) for d in dims],
                       TensorData.matrix(data))
        )
    return CompositeTensor(tensors)


def path_from_pairs(pairs: Iterable[tuple[int, int]]) -> ContractionPath:
    """A flat replace-left path from its pairs.

    >>> path_from_pairs([(0, 1), (0, 2)]).toplevel
    [(0, 1), (0, 2)]
    """
    return ContractionPath.simple([(int(i), int(j)) for i, j in pairs])
