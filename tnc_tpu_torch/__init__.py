"""tnc_tpu_torch — the PyTorch/CUDA port of ``tnc_tpu``.

A second package beside the JAX reference: it keeps its own copies of the
host layers it needs (tensors, builders, greedy pathfinding, the program
compiler, the kernel policy) and imports nothing of ``tnc_tpu`` and nothing
of JAX. Contraction runs through
:class:`~tnc_tpu_torch.ops.backends.TorchBackend` on an NVIDIA GPU, with the
TPU's Pallas kernels replaced by CUDA kernels written by hand for Hopper
(:mod:`tnc_tpu_torch.ops.cuda_complex`).
"""

# the serving and resilience surface, importable from the top level without
# importing it (and torch) with the package
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
}


def __getattr__(name: str):
    """``from tnc_tpu_torch import ContractionService`` (and the other
    names of ``_LAZY``), imported on first use.

    >>> from tnc_tpu_torch import SliceYield
    >>> SliceYield(3).cursor
    3
    """
    module = _LAZY.get(name)
    if module is None:
        raise AttributeError(f"module 'tnc_tpu_torch' has no attribute {name!r}")
    import importlib

    return getattr(importlib.import_module(module), name)
