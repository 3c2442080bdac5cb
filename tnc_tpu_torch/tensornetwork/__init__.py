"""Tensors, lazy tensor data and contraction.

The exported names resolve on first use, so that a process that imports
one module of the package (a planner's spawn worker) loads no other."""

from tnc_tpu_torch.utils.lazy import lazy_getattr

__getattr__ = lazy_getattr(__name__, {
    "CompositeTensor": "tnc_tpu_torch.tensornetwork.tensor",
    "LeafTensor": "tnc_tpu_torch.tensornetwork.tensor",
    "Tensor": "tnc_tpu_torch.tensornetwork.tensor",
    "TensorData": "tnc_tpu_torch.tensornetwork.tensordata",
    "amplitude_sweep": "tnc_tpu_torch.tensornetwork.sweep",
    "sweep": None,
})
