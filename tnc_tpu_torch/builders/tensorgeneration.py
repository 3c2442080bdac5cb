"""Random sparse tensor data generation (the port's copy of
``tnc_tpu.builders.tensorgeneration``).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

from tnc_tpu_torch.tensornetwork.tensordata import TensorData


def random_sparse_tensor_data_with_rng(
    dims: Sequence[int],
    sparsity: float | None,
    rng: np.random.Generator,
) -> TensorData:
    """Fill random complex entries at random locations until the fill
    fraction reaches ``sparsity`` (default 0.5)
    (``tensorgeneration.rs:19-55``).

    >>> import numpy as np
    >>> data = random_sparse_tensor_data_with_rng(
    ...     [2, 2], 0.5, np.random.default_rng(0))
    >>> arr = data.into_data()
    >>> arr.shape, int((arr != 0).sum())
    ((2, 2), 2)
    """
    if sparsity is None:
        sparsity = 0.5
    if not 0.0 <= sparsity <= 1.0:
        raise ValueError("sparsity must be in [0, 1]")

    size = 1
    for d in dims:
        size *= d
    tensor = np.zeros(tuple(dims), dtype=np.complex128)
    nnz = 0
    while size and nnz / size < sparsity:
        loc = tuple(int(rng.integers(0, d)) for d in dims)
        if tensor[loc] != 0:
            continue
        tensor[loc] = complex(rng.random(), rng.random())
        nnz += 1
    return TensorData.matrix(tensor)


def random_sparse_tensor_data(
    dims: Sequence[int], sparsity: float | None = None
) -> TensorData:
    return random_sparse_tensor_data_with_rng(dims, sparsity, np.random.default_rng())
