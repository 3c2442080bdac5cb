"""Tensor-network contraction (the port's copy of
``tnc_tpu.tensornetwork.contraction``).

``contract_tensor_network(tn, path, backend)`` fully contracts a (possibly
nested) network along a replace-left path and returns the resulting leaf
tensor. The path is first compiled to a static
:class:`~tnc_tpu_torch.ops.program.ContractionProgram` and then executed by
a backend — ``numpy`` (the complex128 host oracle) or ``torch``
(:class:`~tnc_tpu_torch.ops.backends.TorchBackend`, on the GPU unless told
otherwise). Leaf data (gates) is materialized lazily here, at the
host→device boundary.
"""

from __future__ import annotations

import logging

import numpy as np

from tnc_tpu_torch.contractionpath.contraction_path import ContractionPath
from tnc_tpu_torch.ops.backends import Backend, get_backend
from tnc_tpu_torch.ops.program import build_program, flat_leaf_tensors
from tnc_tpu_torch.tensornetwork.tensor import CompositeTensor, LeafTensor
from tnc_tpu_torch.tensornetwork.tensordata import TensorData

logger = logging.getLogger(__name__)


def contract_tensor_network(
    tn: CompositeTensor,
    contract_path: ContractionPath,
    backend: str | Backend | None = None,
) -> LeafTensor:
    """Fully contract ``tn`` along ``contract_path`` (replace-left format).

    ``backend`` is a backend name (``"numpy"``, ``"torch"``), a
    :class:`~tnc_tpu_torch.ops.backends.Backend`
    instance, or ``None`` for :class:`TorchBackend` on the GPU (which
    raises without CUDA; the numpy oracle runs only when named). Returns a
    :class:`LeafTensor` whose legs carry the same ids as the reference's
    ``^``-fold, in that canonical order.

    >>> a = LeafTensor([0], [2]); a.data = TensorData.matrix(np.array([1.0, 2.0]))
    >>> b = LeafTensor([0], [2]); b.data = TensorData.matrix(np.array([3.0, 4.0]))
    >>> out = contract_tensor_network(
    ...     CompositeTensor([a, b]), ContractionPath.simple([(0, 1)]), "numpy")
    >>> complex(out.data.into_data())   # 1*3 + 2*4
    (11+0j)
    """
    backend_obj = get_backend(backend)
    program = build_program(tn, contract_path)
    logger.debug(
        "contract: %d steps, backend=%s", len(program.steps), backend_obj.name
    )
    arrays = [leaf.data.into_data() for leaf in flat_leaf_tensors(tn)]
    result = backend_obj.execute(program, arrays)
    return _canonical_result(program, result)


def contract_tensor_network_sliced(
    tn: CompositeTensor,
    contract_path: ContractionPath,
    slicing,
    backend: str | Backend | None = None,
) -> LeafTensor:
    """Contract a flat network with ``slicing.legs`` sliced: the path runs
    once per slice-index combination and the results are summed
    (:meth:`~tnc_tpu_torch.ops.backends.Backend.execute_sliced`). Peak
    memory drops by about the product of the sliced dims. ``backend`` as
    in :func:`contract_tensor_network`: ``None`` is
    :class:`~tnc_tpu_torch.ops.backends.TorchBackend` on the GPU with its
    defaults — the slice-invariant stem hoisted and run once, the residual
    chunked and batched over slices, as the reference runs it.

    >>> from tnc_tpu_torch.contractionpath.slicing import Slicing
    >>> a = LeafTensor([0], [2]); a.data = TensorData.matrix(np.array([1.0, 2.0]))
    >>> b = LeafTensor([0], [2]); b.data = TensorData.matrix(np.array([3.0, 4.0]))
    >>> out = contract_tensor_network_sliced(CompositeTensor([a, b]),
    ...     ContractionPath.simple([(0, 1)]), Slicing((0,), (2,)), "numpy")
    >>> complex(out.data.into_data())   # slice 0 gives 1*3, slice 1 gives 2*4
    (11+0j)
    """
    from tnc_tpu_torch.ops.sliced import build_sliced_program

    backend_obj = get_backend(backend)
    sp = build_sliced_program(tn, contract_path, slicing)
    logger.debug(
        "contract sliced: %d steps x %d slices, backend=%s",
        len(sp.program.steps), slicing.num_slices, backend_obj.name,
    )
    arrays = [leaf.data.into_data() for leaf in flat_leaf_tensors(tn)]
    result = backend_obj.execute_sliced(sp, arrays)
    return _canonical_result(sp.program, result)


def _canonical_result(program, result) -> LeafTensor:
    """Permute a result buffer to the reference's ``^``-fold leg order
    (host-side; the device buffer keeps the compiler's order)."""
    perm = program.canonical_perm()
    if perm is not None:
        result = np.transpose(np.asarray(result), perm)
    dim_of = dict(zip(program.result_legs, program.result_shape))
    return LeafTensor(
        list(program.canonical_legs),
        [dim_of[leg] for leg in program.canonical_legs],
        TensorData.matrix(result),
    )
