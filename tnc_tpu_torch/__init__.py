"""tnc_tpu_torch — the PyTorch/CUDA port of ``tnc_tpu``.

A second package beside the JAX reference: it keeps its own copies of the
host layers it needs (tensors, builders, greedy pathfinding, the program
compiler, the kernel policy) and imports nothing of ``tnc_tpu`` and nothing
of JAX. Contraction runs through
:class:`~tnc_tpu_torch.ops.backends.TorchBackend` on an NVIDIA GPU, with the
TPU's Pallas kernels replaced by CUDA kernels written by hand for Hopper
(:mod:`tnc_tpu_torch.ops.cuda_complex`).
"""
