"""Tensors, lazy tensor data and contraction."""
