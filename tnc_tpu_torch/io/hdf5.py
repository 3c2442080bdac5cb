"""HDF5 tensor and tensor-network IO (the port's copy of
``tnc_tpu.io.hdf5``).

The file schema is the reference's: a group ``/tensors`` with one dataset
per tensor named by its tensor id, each carrying a ``bids`` attribute
listing its leg (bond) ids. A dataset named ``-1`` holds an output tensor
and is skipped when loading a network. So either package reads the
other's files.

This is host code: ``h5py`` is imported only inside the functions, and
the data it reads is complex128 numpy.
"""

from __future__ import annotations

import contextlib

import numpy as np

from tnc_tpu_torch.tensornetwork.tensor import CompositeTensor, LeafTensor
from tnc_tpu_torch.tensornetwork.tensordata import TensorData

TENSORS_GROUP = "tensors"
OUTPUT_TENSOR_NAME = "-1"


def memory_file(name: str | None = None):
    """An in-memory core-backed HDF5 file (no disk IO: the core driver
    with no backing store). Pass the returned handle anywhere a path is
    accepted.

    >>> import numpy as np
    >>> from tnc_tpu_torch.tensornetwork.tensor import LeafTensor
    >>> from tnc_tpu_torch.tensornetwork.tensordata import TensorData
    >>> f = memory_file()
    >>> t = LeafTensor([0, 1], [2, 2],
    ...     TensorData.matrix(np.eye(2, dtype=np.complex128)))
    >>> store_data(f, 0, t)
    >>> np.allclose(load_data(f, 0), np.eye(2))
    True
    >>> f.close()
    """
    import uuid

    import h5py

    # HDF5 tracks open files by name even for the core driver, so a
    # fixed default would make a second concurrent in-memory file fail
    if name is None:
        name = f"tnc-mem-{uuid.uuid4().hex}.h5"
    return h5py.File(name, "w", driver="core", backing_store=False)


@contextlib.contextmanager
def _open(src, mode: str):
    """Accept a path (opened/closed here) or an already-open h5py.File
    (left open for the caller)."""
    import h5py

    if isinstance(src, h5py.File):
        yield src
    else:
        with h5py.File(src, mode) as f:
            yield f


def roundtrip_example():
    """Store/load a tensor through the reference HDF5 schema.

    >>> import tempfile, os, numpy as np
    >>> from tnc_tpu_torch.tensornetwork.tensor import LeafTensor
    >>> from tnc_tpu_torch.tensornetwork.tensordata import TensorData
    >>> path = os.path.join(tempfile.mkdtemp(), "t.h5")
    >>> t = LeafTensor([0, 1], [2, 2],
    ...     TensorData.matrix(np.eye(2, dtype=np.complex128)))
    >>> store_data(path, 0, t)
    >>> np.allclose(load_data(path, 0), np.eye(2))
    True
    """


def load_data(path, tensor_id: int) -> np.ndarray:
    """Load a single tensor's data as complex128.
    ``path`` may be a filename or an open ``h5py.File``."""
    with _open(path, "r") as f:
        dataset = f[TENSORS_GROUP][str(tensor_id)]
        return np.asarray(dataset[()], dtype=np.complex128)


def load_tensor(path, lazy: bool = True) -> CompositeTensor:
    """Load a whole tensor network.

    With ``lazy`` (default), leaf data stays a FILE reference and is
    materialized at contraction time. ``path`` may be a filename or an open
    ``h5py.File``; in-memory files have no filename for a lazy
    reference to point at, so they always load eagerly.
    """
    import h5py

    if isinstance(path, h5py.File):
        lazy = False  # nothing durable for a FILE reference to resolve
    tensors: list[LeafTensor] = []
    with _open(path, "r") as f:
        group = f[TENSORS_GROUP]
        for name in sorted(group, key=lambda s: int(s)):
            if name == OUTPUT_TENSOR_NAME:
                continue
            dataset = group[name]
            legs = [int(b) for b in dataset.attrs["bids"]]
            shape = list(dataset.shape)
            if len(legs) != len(shape):
                raise ValueError(
                    f"tensor {name}: {len(legs)} leg ids but rank {len(shape)}"
                )
            data = (
                TensorData.file(path, int(name))
                if lazy
                else TensorData.matrix(np.asarray(dataset[()], dtype=np.complex128))
            )
            tensors.append(LeafTensor(legs, shape, data))
    return CompositeTensor(tensors)


def store_data(path, tensor_id: int, tensor: LeafTensor) -> None:
    """Store a single tensor under ``tensor_id``.
    ``path`` may be a filename or an open ``h5py.File``."""
    data = tensor.data.into_data()
    with _open(path, "a") as f:
        group = f.require_group(TENSORS_GROUP)
        name = str(tensor_id)
        if name in group:
            del group[name]
        dataset = group.create_dataset(name, data=data)
        dataset.attrs["bids"] = np.asarray(tensor.legs, dtype=np.int64)
