"""Closed-form pricing of boundary-MPS sweeps (the port's copy of
``tnc_tpu.approx.cost``).

Admission control quotes latency for the exact tier from a plan's step
flops through :class:`~tnc_tpu_torch.obs.calibrate.CalibratedCostModel`; this
module gives the approximate tier the same treatment. A sweep's cost is
a pure function of the grid geometry and ``chi`` — no site data, no
trial contraction: :func:`sweep_cost` walks the boundary shapes row by
row through the SAME counting helpers the live sweep attaches to its
``approx.row`` spans (:func:`tnc_tpu_torch.tensornetwork.approximate.
row_cost`), so predicted and measured rows line up one-to-one in a
trace.

:func:`exact_chi_bound` is the geometry's exact boundary rank bound —
the ``chi`` above which truncation cannot happen — and
:func:`default_chis` turns it into the ladder's doubling rung schedule.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

from tnc_tpu_torch.tensornetwork.approximate import (
    _ELEM_BYTES,
    close_cost,
    grid_site_dims,
    row_cost,
)

__all__ = [
    "SweepCost",
    "default_chis",
    "exact_chi_bound",
    "ladder_seconds",
    "rung_seconds",
    "sweep_cost",
]

#: clamp for bond-dim products (anything above is "unreachably large")
_DIM_CAP = 1 << 62


def _dims_of(grid_or_dims):
    """Accept a grid of leaf tensors, an :class:`~tnc_tpu_torch.approx.
    program.ApproxProgram`, or a precomputed ``grid_site_dims``
    result."""
    site_dims = getattr(grid_or_dims, "site_dims", None)
    if callable(site_dims):
        return site_dims()
    if (
        grid_or_dims
        and grid_or_dims[0]
        and isinstance(grid_or_dims[0][0], tuple)
    ):
        return grid_or_dims
    return grid_site_dims(grid_or_dims)


@dataclass(frozen=True)
class SweepCost:
    """One sweep's predicted totals plus the per-row breakdown
    (``rows[i] = (flops, bytes, ops)`` for interior row ``i+1``; the
    final entry is the bottom-row close)."""

    flops: float
    nbytes: float
    ops: int
    rows: tuple[tuple[float, float, int], ...]


def sweep_cost(grid_or_dims, chi: int, itemsize: int = _ELEM_BYTES) -> SweepCost:
    """Closed-form cost of one boundary sweep at ``chi``, its bytes at
    ``itemsize`` bytes an element (complex128 by default;
    :func:`~tnc_tpu_torch.tensornetwork.approximate.elem_bytes`)."""
    dims = _dims_of(grid_or_dims)
    if chi < 1:
        raise ValueError("chi must be >= 1")
    mps = [(l, d, r) for (l, r, _u, d) in dims[0]]
    rows: list[tuple[float, float, int]] = []
    flops = nbytes = 0.0
    ops = 0
    for row in dims[1:-1]:
        mpo = [(l, r, u, d) for (l, r, u, d) in row]
        f, b, o, mps = row_cost(mps, mpo, chi, itemsize)
        rows.append((f, b, o))
        flops += f
        nbytes += b
        ops += o
    bottom = [(l, u, r) for (l, r, u, _d) in dims[-1]]
    f, b, o = close_cost(mps, bottom, itemsize)
    rows.append((f, b, o))
    return SweepCost(flops + f, nbytes + b, ops + o, tuple(rows))


def rung_seconds(
    grid_or_dims, chi: int, cost_model, itemsize: int = _ELEM_BYTES
) -> float:
    """Predicted seconds of ONE sweep at ``chi`` under a
    :class:`~tnc_tpu_torch.obs.calibrate.CalibratedCostModel` — the unit
    admission control quotes per ladder rung — with its bytes at
    ``itemsize`` as in :func:`sweep_cost`. An
    :class:`~tnc_tpu_torch.approx.program.ApproxProgram` answers from its
    per-``chi`` memo (geometry is frozen; only leaf data rebinds)."""
    memo = getattr(grid_or_dims, "sweep_cost", None)
    cost = (memo(chi, itemsize) if callable(memo)
            else sweep_cost(grid_or_dims, chi, itemsize))
    return cost_model.op_seconds(
        cost.flops, cost.nbytes, dispatches=max(cost.ops, 1)
    )


def ladder_seconds(
    grid_or_dims, chis: Sequence[int], cost_model
) -> float:
    """Predicted seconds of a full ladder climb (the worst case a
    tolerant request can cost before converging or escalating)."""
    return float(
        sum(rung_seconds(grid_or_dims, chi, cost_model) for chi in chis)
    )


def exact_chi_bound(grid_or_dims, cap: int = _DIM_CAP) -> int:
    """The geometry's exact boundary rank bound: the smallest ``chi``
    at which no sweep truncation can discard weight. For each boundary
    (rows ``0..r`` absorbed) and each vertical cut, the rank is bounded
    by the smaller of the open (downward) dims on either side and the
    product of horizontal bonds crossing the cut; the bound is the max
    over boundaries and cuts, clamped to ``cap``."""
    dims = _dims_of(grid_or_dims)
    cols = len(dims[0])
    if cols < 2:
        return 1
    best = 1
    hprod = [1] * (cols - 1)
    for row in dims[:-1]:
        for c in range(cols - 1):
            hprod[c] = min(hprod[c] * row[c][1], cap)  # right-dim
        left = 1
        down = [site[3] for site in row]
        total = 1
        for d in down:
            total = min(total * d, cap)
        for c in range(cols - 1):
            left = min(left * down[c], cap)
            right = max(total // max(left, 1), 1)
            best = max(best, min(left, right, hprod[c]))
            if best >= cap:
                return cap
    return best


def default_chis(
    grid_or_dims, chi_start: int = 2, chi_cap: int = 64
) -> tuple[int, ...]:
    """The ladder's default rung schedule: double from ``chi_start``
    up to ``min(exact_chi_bound, chi_cap)``, always ending on that
    bound — so when the exact rank fits under the cap the top rung is
    truncation-free and every tolerance converges.

    >>> import numpy as np
    >>> from tnc_tpu_torch.builders.peps import peps
    >>> from tnc_tpu_torch.tensornetwork.approximate import (
    ...     attach_random_data, collapse_peps_sandwich)
    >>> tn = attach_random_data(peps(4, 4, 2, 2, 0),
    ...                         np.random.default_rng(0))
    >>> grid = collapse_peps_sandwich(tn, 4, 4, 0)
    >>> default_chis(grid)
    (2, 4, 8, 16)
    """
    bound = exact_chi_bound(_dims_of(grid_or_dims))
    top = min(bound, chi_cap)
    chis = []
    chi = min(chi_start, top)
    while chi < top:
        chis.append(chi)
        chi *= 2
    chis.append(top)
    return tuple(chis)
