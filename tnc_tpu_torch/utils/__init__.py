"""Shared data structures."""

from tnc_tpu_torch.utils.datastructures import UnionFind  # noqa: F401
