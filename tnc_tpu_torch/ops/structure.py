"""Structured-leaf analysis: how much gate structure a plan could exploit
(the port's copy of ``tnc_tpu.ops.structure``).

Gate tensors are rarely dense: CZ/CP are diagonal, CX/SWAP/X are
permutations, many single-qubit gates are monomial (one nonzero per
row/column). A contraction step against such an operand needs no GEMM
at all — a diagonal contraction is an elementwise broadcast
multiply, a permutation contraction a gather. This module MEASURES that
opportunity without touching the executor:
:func:`program_structure_report` classifies every leaf and attributes
the program's step flops to the strongest structure class involved
(contracting against a diagonal operand is elementwise no matter what
the other side is), giving the honest ceiling for a structure-aware
compiler.

Classification is on materialized data (exact zero tests with a relative
tolerance), so user-supplied matrices classify identically to registry
gates.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from tnc_tpu_torch.tensornetwork.tensor import CompositeTensor

#: structure classes, strongest (cheapest to contract) first
CLASSES = ("identity_scaled", "permutation_scaled", "diagonal", "monomial", "dense")


def classify_array(arr, tol: float = 1e-12) -> str:
    """Structure class of a (gate-like) tensor, viewed as a matrix over
    its balanced in/out split. Odd-rank or unbalanced tensors (vectors,
    rectangular maps) classify as 'dense' — a contraction against them
    is never one of the cheap special cases.

    >>> import numpy as np
    >>> classify_array(np.diag([1.0, 2.0]))
    'diagonal'
    >>> classify_array(np.array([[0.0, 1.0], [1.0, 0.0]]))  # X gate
    'permutation_scaled'
    >>> classify_array(np.ones((2, 2)) / 2)
    'dense'
    """
    a = np.asarray(arr)
    if a.ndim < 2 or a.ndim % 2 != 0:
        return "dense"
    half = a.ndim // 2
    rows = int(np.prod(a.shape[:half]))
    cols = int(np.prod(a.shape[half:]))
    if rows != cols:
        return "dense"
    side = rows
    m = a.reshape(side, side)
    scale = float(np.max(np.abs(m)))
    if scale == 0.0:
        return "diagonal"
    t = tol * scale
    nz = np.abs(m) > t
    row_counts = nz.sum(axis=1)
    col_counts = nz.sum(axis=0)
    eye = np.eye(side, dtype=bool)
    if np.all(nz == eye):
        diag = np.diag(m)
        # identity requires equal complex VALUES, not just magnitudes
        # (CZ/T/RZ are diagonal-with-phases, not c*I)
        if np.all(np.abs(diag - diag[0]) <= t):
            return "identity_scaled"
        return "diagonal"
    if np.all(nz == np.diag(np.diag(nz))):
        return "diagonal"
    if np.all(row_counts <= 1) and np.all(col_counts <= 1):
        vals = m[nz]
        # c*P needs one shared complex value; differing phases (iSWAP)
        # make it a general monomial D*P
        if (
            np.all(row_counts == 1)
            and np.all(col_counts == 1)
            and np.all(np.abs(vals - vals[0]) <= t)
        ):
            return "permutation_scaled"
        return "monomial"
    return "dense"


@dataclass
class StructureReport:
    leaf_classes: dict[str, int]
    step_flops: dict[str, float]
    total_flops: float

    @property
    def exploitable_fraction(self) -> float:
        """Fraction of step flops whose weaker operand is structured
        (non-dense) — the ceiling a structure-aware step compiler could
        remove from the GEMMs."""
        if self.total_flops <= 0:
            return 0.0
        dense = self.step_flops.get("dense", 0.0)
        return 1.0 - dense / self.total_flops


def program_structure_report(
    tn: CompositeTensor, replace_path, tol: float = 1e-12
) -> StructureReport:
    """Classify every leaf and attribute each step's naive flops to the
    STRONGEST class among its two operands — contracting against a
    diagonal operand is elementwise no matter what the other side is
    (an intermediate counts as dense: structure rarely survives a
    contraction). The result is a ceiling, not a plan: leg alignment
    decides what a compiler could actually lower."""
    from tnc_tpu_torch.contractionpath.contraction_cost import contract_cost_tensors
    from tnc_tpu_torch.ops.program import flat_leaf_tensors
    from tnc_tpu_torch.tensornetwork.tensordata import DataKind

    leaves = flat_leaf_tensors(tn)
    if len(list(tn.tensors)) != len(leaves):
        # replace-path indices address TOP-LEVEL slots (composites
        # collapse to one); indexing them into the flat leaf list would
        # silently misattribute — same guard as flat_replace_path
        raise ValueError(
            "program_structure_report expects a flat network/path; "
            "flatten partitioned networks first"
        )
    classes: list[str] = []
    counts: dict[str, int] = {c: 0 for c in CLASSES}
    for leaf in leaves:
        if leaf.data.kind is DataKind.NONE:
            cls = "dense"  # metadata-only: assume nothing
        else:
            cls = classify_array(leaf.data.into_data(), tol)
        classes.append(cls)
        counts[cls] += 1

    order = {c: i for i, c in enumerate(CLASSES)}
    tensors = list(leaves)  # slots are rebound, never mutated
    step_flops: dict[str, float] = {c: 0.0 for c in CLASSES}
    total = 0.0
    for i, j in replace_path:
        ti, tj = tensors[i], tensors[j]
        flops = contract_cost_tensors(ti, tj)
        # the stronger operand decides: a dense x diagonal step is an
        # elementwise multiply, dense x dense needs a GEMM
        best = min(classes[i], classes[j], key=lambda c: order[c])
        step_flops[best] += flops
        total += flops
        tensors[i] = ti ^ tj
        classes[i] = "dense"
    return StructureReport(counts, step_flops, total)
