"""Contraction paths, cost models and path finders.

The exported names resolve on first use, so that a process that imports
one module of the package (a planner's spawn worker) loads no other."""

from tnc_tpu_torch.utils.lazy import lazy_getattr

__getattr__ = lazy_getattr(__name__, {
    name: "tnc_tpu_torch.contractionpath.contraction_path"
    for name in ("ContractionPath", "SimplePath", "SimplePathRef", "path",
                 "replace_ssa_ordering", "ssa_ordering", "ssa_replace_ordering")
})
