"""Pathfinder interface and result types (the port's copy of
``tnc_tpu.contractionpath.paths.base``): a ``Pathfinder``
turns a (possibly nested) tensor network into a contraction path plus its
predicted flops/size; results carry the SSA path and convert to
replace-left format on demand.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass

from tnc_tpu_torch.contractionpath.contraction_path import (
    ContractionPath,
    ssa_replace_ordering,
)
from tnc_tpu_torch.tensornetwork.tensor import CompositeTensor


class CostType(enum.Enum):
    FLOPS = "flops"
    SIZE = "size"


@dataclass
class BasicContractionPathResult:
    """SSA path + predicted cost (``paths.rs:47-76``).

    >>> from tnc_tpu_torch.contractionpath.contraction_path import ContractionPath
    >>> r = BasicContractionPathResult(
    ...     ContractionPath.simple([(0, 1), (2, 3)]), 100.0, 16.0)
    >>> r.replace_path().toplevel   # ssa ids -> replace-left slots
    [(0, 1), (2, 0)]
    """

    ssa_path: ContractionPath
    flops: float
    size: float

    def replace_path(self) -> ContractionPath:
        return ssa_replace_ordering(self.ssa_path)


class Pathfinder:
    """Base class: ``find_path(tn) -> BasicContractionPathResult``.

    ``find_path`` handles the nested-composite recursion shared by every
    finder (``cotengrust.rs:120-145``): each composite child gets its own
    recursive ``find_path`` and is replaced by its external tensor for the
    top-level search, which subclasses implement in
    :meth:`_solve_toplevel`. Reported flops/size are recomputed by the
    analytic cost model with naive op counting (``cotengrust.rs:149``).
    """

    def find_path(self, tn: CompositeTensor) -> BasicContractionPathResult:
        from tnc_tpu_torch.contractionpath.contraction_cost import contract_path_cost

        nested: dict[int, ContractionPath] = {}
        flat_inputs = []
        for i, child in enumerate(tn.tensors):
            if isinstance(child, CompositeTensor):
                sub = self.find_path(child)
                nested[i] = sub.ssa_path
                flat_inputs.append(child.external_tensor())
            else:
                flat_inputs.append(child)

        toplevel = self._solve_toplevel(flat_inputs)
        ssa_path = ContractionPath(nested, toplevel)
        flops, size = contract_path_cost(
            tn.tensors, ssa_replace_ordering(ssa_path), True
        )
        return BasicContractionPathResult(ssa_path, flops, size)

    def _solve_toplevel(self, inputs: list) -> list[tuple[int, int]]:
        """Find an SSA pair path over flat leaf tensors."""
        raise NotImplementedError


# Alias used by the reference's public API surface (``paths.rs:31-43``).
ContractionPathResult = BasicContractionPathResult
