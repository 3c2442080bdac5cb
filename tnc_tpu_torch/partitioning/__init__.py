"""Hypergraph partitioning for the planner (the port's copy of
``tnc_tpu.partitioning``): the multilevel bisection in Python and its
native C++ engine behind a ctypes binding."""

from tnc_tpu_torch.partitioning.hypergraph import Hypergraph  # noqa: F401
from tnc_tpu_torch.partitioning.bisect import bisect, partition_kway  # noqa: F401
