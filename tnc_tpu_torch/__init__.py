"""tnc_tpu_torch — the PyTorch/CUDA port of ``tnc_tpu``.

A second package beside the JAX reference: it keeps its own copies of the
host layers it needs (tensors, builders, greedy pathfinding, the program
compiler, the kernel policy) and imports nothing of ``tnc_tpu`` and nothing
of JAX. Contraction runs through
:class:`~tnc_tpu_torch.ops.backends.TorchBackend` on an NVIDIA GPU, with the
TPU's Pallas kernels replaced by CUDA kernels written by hand for Hopper
(:mod:`tnc_tpu_torch.ops.cuda_complex`).

At import, ``TNC_TPU_LOG`` attaches a stderr handler to the
``tnc_tpu_torch`` logger and ``TNC_TPU_PLATFORM=cpu`` pins the host as the
device that ``device=None`` means (:mod:`tnc_tpu_torch.utils.logging_config`).
"""

from tnc_tpu_torch.utils.lazy import lazy_getattr
from tnc_tpu_torch.utils.logging_config import (
    configure_from_env as _configure_logging,
    pin_platform_from_env as _pin_platform,
)

_configure_logging()
_pin_platform()

# the reference's top-level names and the serving and resilience surface,
# importable from the top level without importing them (and torch) with the
# package: ``from tnc_tpu_torch import SliceYield``
_LAZY = {
    "ContractionService": "tnc_tpu_torch.serve.service",
    "FidelityRouter": "tnc_tpu_torch.serve.service",
    "ApproxAnswer": "tnc_tpu_torch.serve.service",
    "PlanCache": "tnc_tpu_torch.serve.plancache",
    "IntermediateStore": "tnc_tpu_torch.serve.reuse",
    "RetryPolicy": "tnc_tpu_torch.resilience.retry",
    "fault_point": "tnc_tpu_torch.resilience.faultinject",
    "faults": "tnc_tpu_torch.resilience.faultinject",
    "SliceCheckpoint": "tnc_tpu_torch.resilience.checkpoint",
    "SliceYield": "tnc_tpu_torch.ops.sliced",
    # the reference's top-level names: tensors and paths
    "CompositeTensor": "tnc_tpu_torch.tensornetwork.tensor",
    "LeafTensor": "tnc_tpu_torch.tensornetwork.tensor",
    "Tensor": "tnc_tpu_torch.tensornetwork.tensor",
    "TensorData": "tnc_tpu_torch.tensornetwork.tensordata",
    "ContractionPath": "tnc_tpu_torch.contractionpath.contraction_path",
    "path": "tnc_tpu_torch.contractionpath.contraction_path",
}

__getattr__ = lazy_getattr(__name__, _LAZY)
