"""Compiled contraction programs, backends and the CUDA kernels."""
