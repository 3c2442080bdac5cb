"""Leaf data for metadata-only networks (the part of
``tnc_tpu.tensornetwork.approximate`` the port needs so far).

Builder networks such as :func:`tnc_tpu_torch.builders.peps.peps` carry no
data; :func:`attach_random_data` fills them with seeded complex Gaussian
entries, drawing the same numbers from the same ``numpy`` Generator as the
reference, so both packages contract identical networks. The boundary-MPS
contractor of the reference module is not ported yet.
"""

from __future__ import annotations

import math

import numpy as np

from tnc_tpu_torch.ops.program import flat_leaf_tensors
from tnc_tpu_torch.tensornetwork.tensor import CompositeTensor
from tnc_tpu_torch.tensornetwork.tensordata import DataKind, TensorData


def attach_random_data(
    tn: CompositeTensor, rng: np.random.Generator, scale: float | None = None
) -> CompositeTensor:
    """Fill every metadata-only leaf of ``tn`` (in place, nested networks
    included) with ``(N(0,1) + i·N(0,1)) · scale`` entries; ``scale``
    defaults to each leaf's ``1/sqrt(size)``. Leaves that already carry
    data are left as they are, after checking that their payload has the
    leaf's declared size. Returns ``tn``.

    >>> from tnc_tpu_torch.builders.peps import peps
    >>> tn = attach_random_data(peps(2, 2, 2, 2, 0), np.random.default_rng(0))
    >>> tn.tensors[0].data.into_data().shape
    (2, 2, 2)
    """
    for i, leaf in enumerate(tn.tensors):
        if isinstance(leaf, CompositeTensor):
            attach_random_data(leaf, rng, scale)
            continue
        if leaf.data.kind is not DataKind.NONE:
            have = int(np.asarray(leaf.data.into_data()).size)
            want = int(np.prod(leaf.shape, initial=1))
            if have != want:
                raise ValueError(
                    f"attach_random_data: leaf {i} (legs {list(leaf.legs)}) "
                    f"carries data of {have} elements but its declared "
                    f"shape {leaf.shape} needs {want}"
                )
            continue
        shape = leaf.shape
        s = scale if scale is not None else 1.0 / np.sqrt(
            max(1.0, float(np.prod(shape)))
        )
        data = (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)) * s
        leaf.data = TensorData.matrix(data.astype(np.complex128))
    return tn


def unit_scale(tn: CompositeTensor) -> float:
    """The per-leaf ``scale`` for :func:`attach_random_data` that keeps the
    expected magnitude of the closed network's contraction of order one:
    ``(2 · (∏ bond dims)^(1/n))^(-1/2)`` over the network's ``n`` leaves and
    each bond once (an entry ``N(0,1) + i·N(0,1)`` has ``E|z|² = 2``). The
    default ``1/sqrt(size)`` per leaf shrinks the result geometrically with
    the bond dims: for ``peps(4, 4, 2, 32, 0)`` to about 2^-112, at the edge
    of float32's range; this rule gives 2^-4.5 there.

    >>> from tnc_tpu_torch.builders.peps import peps
    >>> unit_scale(peps(4, 4, 2, 32, 0)) == 2 ** -4.5
    True
    """
    leaves = flat_leaf_tensors(tn)
    dims: dict[int, int] = {}
    for leaf in leaves:
        dims.update(zip(leaf.legs, leaf.bond_dims))
    log2_prod = sum(math.log2(d) for d in dims.values())
    return (2.0 * 2.0 ** (log2_prod / len(leaves))) ** -0.5
