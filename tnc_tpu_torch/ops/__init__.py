"""Compiled contraction programs, backends and the CUDA kernels.

The reference's names (and :class:`TorchBackend`, the port's counterpart of
its ``JaxBackend``) resolve on first use: the backends import torch, and a
process that imports only the program compiler must not."""

from tnc_tpu_torch.utils.lazy import lazy_getattr

__getattr__ = lazy_getattr(__name__, {
    "ContractionProgram": "tnc_tpu_torch.ops.program",
    "PairStep": "tnc_tpu_torch.ops.program",
    "build_program": "tnc_tpu_torch.ops.program",
    "Backend": "tnc_tpu_torch.ops.backends",
    "NumpyBackend": "tnc_tpu_torch.ops.backends",
    "TorchBackend": "tnc_tpu_torch.ops.backends",
    "get_backend": "tnc_tpu_torch.ops.backends",
    "HoistedProgram": "tnc_tpu_torch.ops.hoist",
    "hoist_sliced_program": "tnc_tpu_torch.ops.hoist",
})
