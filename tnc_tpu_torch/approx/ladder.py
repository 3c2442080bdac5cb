"""Chi-ladder execution: ascending-``chi`` sweeps with per-answer
error estimates.

A request runs at ascending ``chi`` rungs; each rung's sweep reports
its accumulated relative discarded SVD weight
(:func:`~tnc_tpu_torch.tensornetwork.approximate.boundary_contract_with_weight`),
and the ladder derives an **error estimate** per rung:

- weight ≤ :data:`~tnc_tpu_torch.tensornetwork.approximate.EXACT_WEIGHT`:
  nothing was truncated — the sweep is the exact contraction up to
  roundoff, ``err = fp_floor · max(|v|, scale)`` where ``fp_floor`` is
  the sweep's precision (:data:`EXACT_ERR_REL` for complex128,
  :data:`COMPLEX64_ERR_REL` for a complex64 ``torch`` sweep — a float32
  sweep must never claim a float64 bar); every
  finite estimate below is floored by the same term;
- first truncated rung: ``err = inf`` — a single truncated sweep
  carries no convergence evidence, so the estimate refuses to vouch
  for it (the ladder always climbs at least one more rung);
- later rungs: ``err = safety · (|v_k − v_{k−1}| +
  max(|v_k|, scale) · √weight_k)`` — the observed inter-rung movement
  plus the truncation-weight bound on the state error, inflated by
  ``safety``. The weight term scales with ``max(|v|, scale)``: under
  heavy truncation the approximate value itself can collapse toward
  zero, and an error bar proportional to the collapsed value would
  vouch for exactly the answers it should distrust.

Convergence: ``err ≤ rtol · max(|v|, scale)`` — ``scale`` anchors the
tolerance for answers whose magnitude is legitimately tiny (an
amplitude's natural scale is ``2^(-n/2)``, a probability's is 1).
Converged answers stop climbing; a ladder that exhausts its rungs
without converging reports ``converged=False`` (the reference's serving
router then escalates to the exact pipeline; the router is not ported
yet).

>>> from tnc_tpu_torch.approx.program import ApproxProgram
>>> from tnc_tpu_torch.builders.circuit_builder import Circuit
>>> from tnc_tpu_torch.tensornetwork.tensordata import TensorData
>>> c = Circuit(); reg = c.allocate_register(2)
>>> c.append_gate(TensorData.gate("h"), [reg.qubit(0)])
>>> c.append_gate(TensorData.gate("cx"), [reg.qubit(0), reg.qubit(1)])
>>> res = ChiLadder().run(ApproxProgram.from_circuit(c).rebind_bits("00"),
...                       rtol=1e-6, scale=0.5, backend="numpy")
>>> res.converged, res.chi_used, round(abs(res.value), 6)
(True, 2, 0.707107)
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Sequence

from tnc_tpu_torch import obs
from tnc_tpu_torch.tensornetwork.approximate import EXACT_WEIGHT, elem_bytes

__all__ = [
    "ChiLadder", "LadderResult", "Rung",
    "COMPLEX64_ERR_REL", "EXACT_ERR_REL",
]

#: relative error attributed to an untruncated (exact) complex128
#: sweep — pure floating-point margin vs a differently-ordered exact
#: contraction
EXACT_ERR_REL = 1e-9

#: the same margin when the sweep ran in single precision (a ``torch``
#: sweep in ``complex64``): unit roundoff ~1e-7 compounds
#: over the row products, so every rung's bar is floored here —
#: without it an untruncated complex64 sweep would claim a 1e-9 bar
#: while carrying ~1e-7-scale error (caught against the dense oracle)
COMPLEX64_ERR_REL = 1e-4


def _fp_floor(backend: str, dtype: str = "complex64") -> float:
    """The sweep's floating-point error floor (relative): the host sweep
    runs complex128; a ``torch`` sweep runs in ``dtype``.

    >>> _fp_floor("torch"), _fp_floor("torch", "complex128"), _fp_floor("numpy")
    (0.0001, 1e-09, 1e-09)
    """
    if backend == "torch" and str(dtype) in ("complex64", "torch.complex64"):
        return COMPLEX64_ERR_REL
    return EXACT_ERR_REL


@dataclass(frozen=True)
class Rung:
    """One executed rung: the sweep's value, its accumulated discarded
    SVD weight, the derived error estimate, and (when a cost model
    priced the ladder) the rung's predicted seconds."""

    chi: int
    value: complex
    weight: float
    err: float
    predicted_s: float | None = None


@dataclass(frozen=True)
class LadderResult:
    """The ladder's answer: ``value`` with error estimate ``err`` at
    bond dimension ``chi_used``; ``converged`` says whether ``err`` met
    the requested tolerance (the router escalates when it didn't);
    ``rungs`` records the whole climb."""

    value: complex
    err: float
    chi_used: int
    converged: bool
    rungs: tuple[Rung, ...]

    @property
    def sweeps(self) -> int:
        return len(self.rungs)


class ChiLadder:
    """Run requests up a ``chi`` ladder until the error estimate meets
    the requested tolerance.

    ``chis`` pins the rungs explicitly; otherwise they double from
    ``chi_start`` up to ``min(exact boundary rank, chi_cap)`` per grid
    (:func:`tnc_tpu_torch.approx.cost.default_chis`) — when the exact rank
    fits under the cap the top rung is truncation-free, so every
    tolerance converges; when it doesn't, tight tolerances can exhaust
    the ladder and escalate. ``safety`` inflates the error estimate
    (larger = more honest bars, more escalations).
    """

    def __init__(
        self,
        chis: Sequence[int] | None = None,
        chi_start: int = 2,
        chi_cap: int = 64,
        safety: float = 4.0,
    ) -> None:
        if chis is not None:
            chis = tuple(int(c) for c in chis)
            if not chis or any(c < 1 for c in chis):
                raise ValueError("chis must be a non-empty list of >= 1")
            if list(chis) != sorted(chis):
                raise ValueError("chis must ascend")
        if chi_start < 1 or chi_cap < chi_start:
            raise ValueError("need 1 <= chi_start <= chi_cap")
        if safety <= 0.0:
            raise ValueError("safety must be > 0")
        self.chis = chis
        self.chi_start = int(chi_start)
        self.chi_cap = int(chi_cap)
        self.safety = float(safety)

    def rungs_for(self, program) -> tuple[int, ...]:
        """The rung schedule for one program's grid."""
        if self.chis is not None:
            return self.chis
        from tnc_tpu_torch.approx.cost import default_chis

        # pass the program, not its grid: the bound is derived from the
        # memoized site_dims geometry
        return default_chis(
            program, chi_start=self.chi_start, chi_cap=self.chi_cap
        )

    def estimate(
        self,
        value: complex,
        weight: float,
        prev: complex | None,
        scale: float = 0.0,
        fp_floor: float = EXACT_ERR_REL,
    ) -> float:
        """The per-rung error estimate (module docstring semantics).
        ``fp_floor`` is the executing backend's relative roundoff
        floor — every finite estimate is floored by it, so a
        single-precision sweep never claims a double-precision bar."""
        floor = fp_floor * max(abs(value), scale)
        if weight <= EXACT_WEIGHT:
            return floor
        if prev is None:
            return math.inf
        return floor + self.safety * (
            abs(value - prev) + max(abs(value), scale) * math.sqrt(weight)
        )

    def run(
        self,
        program,
        rtol: float,
        scale: float = 0.0,
        backend: str = "torch",
        cost_model=None,
        dtype: str = "complex64",
        device=None,
    ) -> LadderResult:
        """Climb the ladder for the program's CURRENT binding.

        ``backend``, ``dtype`` and ``device`` select the sweep
        (:meth:`~tnc_tpu_torch.approx.program.ApproxProgram.contract`):
        the default ``backend="torch"`` runs on the card unless ``device``
        says otherwise, and raises without CUDA; ``dtype`` and ``device``
        apply to it alone, ``backend="numpy"`` is the host's complex128.
        ``rtol`` is relative to ``max(|value|, scale)``;
        ``cost_model`` (a
        :class:`~tnc_tpu_torch.obs.calibrate.CalibratedCostModel`) prices
        each executed rung in predicted seconds on its
        :class:`Rung`, the sweep's bytes at its element width."""
        if rtol <= 0.0:
            raise ValueError("rtol must be > 0")
        chis = self.rungs_for(program)
        fp_floor = _fp_floor(backend, dtype)
        itemsize = elem_bytes(backend, dtype)
        rungs: list[Rung] = []
        prev: complex | None = None
        value, err, chi = 0.0 + 0.0j, math.inf, chis[0]
        with obs.span(
            "approx.ladder", rtol=rtol, max_rungs=len(chis),
            kind=program.kind,
        ) as sp:
            for chi in chis:
                predicted = None
                if cost_model is not None:
                    from tnc_tpu_torch.approx.cost import rung_seconds

                    predicted = rung_seconds(program, chi, cost_model, itemsize)
                value, weight = program.contract(
                    chi, backend=backend, dtype=dtype, device=device)
                err = self.estimate(value, weight, prev, scale, fp_floor)
                rungs.append(Rung(chi, value, weight, err, predicted))
                if err <= rtol * max(abs(value), scale):
                    sp.set(rungs=len(rungs))
                    return LadderResult(value, err, chi, True, tuple(rungs))
                prev = value
            sp.set(rungs=len(rungs))
        return LadderResult(value, err, chi, False, tuple(rungs))
