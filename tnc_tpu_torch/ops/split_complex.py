"""Split-complex execution: complex tensors as (real, imag) float pairs (the
port's counterpart of ``tnc_tpu.ops.split_complex``).

On the GPU every complex tensor of a contraction is held as two float32
tensors, and each pairwise step is a few real products. The default
lowering is the Gauss/Karatsuba identity (three real products instead of
four):

    k1 = (ar + ai) @ br
    k2 = ar @ (bi - br)
    k3 = ai @ (br + bi)
    real = k1 - k3,  imag = k1 + k2

A :class:`KernelPolicy` chooses per step between that lowering (``gauss``),
the four-product one (``naive``), the single-step hand kernel
(``fused`` — :func:`~tnc_tpu_torch.ops.cuda_complex.fused_complex_dot`),
the hand kernel that reads both operands in their raw stored views and
applies the macro permutation while fetching tiles (``fused_transpose``
— :func:`~tnc_tpu_torch.ops.cuda_complex.fused_transpose_dot`), one
Strassen level (``strassen``), and chains of small steps that run as one
launch of :func:`~tnc_tpu_torch.ops.cuda_complex.fused_chain`. The policy
is planned exactly as the reference plans it (:func:`plan_kernel_steps`),
with no cost model or with one fitted to measured step times
(:mod:`tnc_tpu_torch.obs.calibrate`), so both packages make the same
choice for every step under the same model. ``fused`` runs only when
``TNC_TPU_COMPLEX_MULT`` forces it; ``fused_transpose`` also where a fitted
bandwidth term says it pays.

Products outside the hand kernels are ``torch.matmul`` in full FP32:
:class:`~tnc_tpu_torch.ops.backends.TorchBackend` turns TF32 off.
"""

from __future__ import annotations

import functools
import logging
import math
import os
from dataclasses import dataclass, field
from typing import Any

import numpy as np

from tnc_tpu_torch.ops.program import ContractionProgram, batch_rows, prep_kl

logger = logging.getLogger(__name__)

#: kernel modes a single step can execute under. ``chain`` is not a
#: per-step mode — chained steps run ``naive`` arithmetic inside one fused
#: multi-step launch (see :class:`KernelPolicy`).
KERNEL_MODES = (
    "naive", "gauss", "fused", "fused_transpose", "strassen", "chain", "auto",
)

#: real-multiply credit of each kernel mode relative to the naive 4-dot
#: complex lowering: Gauss runs 3 of the 4 dots, one Strassen level on top
#: of Gauss runs 21 half-size sub-GEMMs against naive's 32 half-units.
EFFECTIVE_FLOP_FACTOR = {
    "naive": 1.0,
    "fused": 1.0,  # naive arithmetic in one kernel
    "fused_transpose": 1.0,  # naive arithmetic, no transposed copy
    "gauss": 0.75,
    "strassen": 21.0 / 32.0,  # gauss × one Strassen level
}

#: dot-precision rungs a policy can record per step. The reference maps
#: them onto bf16 MXU passes; on the GPU every rung runs full FP32 (TF32
#: stays off), so in this port the rung is carried but changes nothing.
DOT_PRECISION_MODES = ("highest", "high")

#: the reference's documented per-dot relative error of its ``high`` rung;
#: :func:`plan_precision_modes` promotes only when the run's parity budget
#: clears it with 2× headroom (the port runs the rung in FP32 all the same).
HIGH_PRECISION_STEP_REL = 2.0 ** -18

#: steps routed away from the fused kernel by their shape, per reason —
#: the port of the reference's ``ops.fused_fallback{reason}`` counter.
#: Routing is the policy's semantics (a rejected step runs naive dots);
#: a kernel that fails to build or launch raises instead.
FUSED_ROUTED: dict[str, int] = {}

#: steps routed away from the fused transpose-dot kernel, per reason — the
#: port of the reference's ``ops.fused_transpose_fallback{reason}``
#: counter; a routed step runs the prep + naive dots.
FUSED_TRANSPOSE_ROUTED: dict[str, int] = {}


def reset_routed() -> None:
    """Clear :data:`FUSED_ROUTED` and :data:`FUSED_TRANSPOSE_ROUTED`."""
    FUSED_ROUTED.clear()
    FUSED_TRANSPOSE_ROUTED.clear()


def complex_mult_env() -> str:
    """The per-step complex-multiply base mode, ``gauss`` unless
    ``TNC_TPU_COMPLEX_MULT`` forces one (read as the reference reads it).
    The forcing values are ``naive``, ``gauss``, ``fused``,
    ``fused_transpose``, ``strassen``, ``chain`` and ``auto`` (the unforced
    promotion ladder)."""
    return os.environ.get("TNC_TPU_COMPLEX_MULT", "gauss")


def complex_mult_forced() -> str | None:
    """The forcing override, or ``None`` when the env knob is unset (the
    promotion ladder decides per step). ``auto`` explicitly requests the
    ladder, so it is NOT a forced mode."""
    mode = os.environ.get("TNC_TPU_COMPLEX_MULT")
    if mode is None or mode == "auto":
        return None
    return mode


def complex_mult_key() -> str:
    """Cache-key form of the env knob: the forced mode, or ``auto``."""
    return os.environ.get("TNC_TPU_COMPLEX_MULT", "auto")


def dot_precision_forced() -> str | None:
    """The ``TNC_TPU_DOT_PRECISION`` forcing override (``high`` /
    ``highest``), or ``None`` when unset or ``auto``. A value outside
    :data:`DOT_PRECISION_MODES` raises, as in the reference."""
    mode = os.environ.get("TNC_TPU_DOT_PRECISION")
    if mode in (None, "", "auto"):
        return None
    if mode not in DOT_PRECISION_MODES:
        raise ValueError(
            f"TNC_TPU_DOT_PRECISION={mode!r}: expected one of "
            f"{DOT_PRECISION_MODES} or 'auto'"
        )
    return mode


def dot_precision_key() -> str:
    """Cache-key form of ``TNC_TPU_DOT_PRECISION``."""
    return os.environ.get("TNC_TPU_DOT_PRECISION", "auto")


def resolved_step_mode(step, mode: str | None = None) -> str:
    """The arithmetic :func:`apply_step_split` runs for a requested mode
    (``strassen`` below the crossover → gauss; ``fused_transpose`` on a
    step its gate rejects → naive; ``chain`` / ``auto`` outside a policy →
    gauss; unknown → gauss)."""
    if mode is None:
        mode = complex_mult_env()
    if mode == "strassen":
        return "strassen" if _strassen_step_eligible(step) else "gauss"
    if mode == "fused_transpose":
        return (
            "fused_transpose"
            if fused_transpose_ineligible_reason(step) is None
            else "naive"
        )
    if mode in ("naive", "fused"):
        return mode
    return "gauss"


def split_array(array: np.ndarray, dtype: str = "float32") -> tuple[np.ndarray, np.ndarray]:
    """Complex array -> contiguous (real, imag) float pair.

    >>> re, im = split_array(np.array([1 + 2j, 3 - 4j]))
    >>> re.tolist(), im.tolist()
    ([1.0, 3.0], [2.0, -4.0])
    >>> np.allclose(combine_array(re, im), [1 + 2j, 3 - 4j])
    True
    """
    array = np.asarray(array)
    return (
        np.ascontiguousarray(array.real, dtype=dtype),
        np.ascontiguousarray(array.imag, dtype=dtype),
    )


def combine_array(re: Any, im: Any) -> np.ndarray:
    """(real, imag) pair (tensors on any device, or arrays) -> complex
    numpy array."""
    import torch

    if isinstance(re, torch.Tensor):
        return torch.complex(re, im).cpu().numpy()
    return np.asarray(re) + 1j * np.asarray(im)


def gauss_matmul(ar, ai, br, bi):
    """Complex matmul on split 2-D parts with 3 real matmuls."""
    k1 = (ar + ai) @ br
    k2 = ar @ (bi - br)
    k3 = ai @ (br + bi)
    return k1 - k3, k1 + k2


def _step_operands(apair, bpair, step, a_batched=False, b_batched=False):
    """The step's four operands as ``(k, free)`` matrices (``(B, k, free)``
    on a batched side): ``(ar, ai, br, bi)`` in program order, for the
    Gauss sums (``swap`` is applied by the dot)."""
    ar, ai = prep_kl(apair, step.a_view, step.a_perm, step.a_dot, step.a_cfirst,
                     a_batched)
    br, bi = prep_kl(bpair, step.b_view, step.b_perm, step.b_dot, step.b_cfirst,
                     b_batched)
    return ar, ai, br, bi


def apply_step_split(
    apair, bpair, step, precision=None, mode=None, precision_mode=None,
    a_batched=False, b_batched=False,
):
    """Split-complex analogue of ``backends.apply_step``: one pairwise
    contraction of (real, imag) tensor pairs, the single step kernel of
    every split-mode executor. ``mode`` overrides the env mode for this
    step — the :class:`KernelPolicy` hook; ``None`` falls back to
    :func:`complex_mult_env` (``gauss``). ``precision`` and
    ``precision_mode`` are accepted for the reference's signature; every
    rung runs full FP32 here.

    ``a_batched`` / ``b_batched``: that side's buffers are ``(B,
    *stored)``, a leading slice-batch axis (the reference's ``vmap``,
    written out). The result is then ``(B, *out_store)``. An unbatched
    side is never copied ``B`` times: its Gauss sums are formed once and
    the products broadcast it over the batch (``torch.matmul`` folds it
    or reads it with a zero batch stride)."""
    if mode is None:
        mode = complex_mult_env()
    lead = ((batch_rows(apair[0], bpair[0], a_batched, b_batched),)
            if a_batched or b_batched else ())
    out_shape = lead + tuple(step.out_store)
    if mode == "fused_transpose":
        # the kernel reads the RAW stored pairs, so it runs before any
        # operand is prepped (the transposed copy is what it avoids)
        out = _try_fused_transpose_step(apair, bpair, step, a_batched, b_batched)
        if out is not None:
            return out
        mode = "naive"  # routed: the prep + naive dots below
    if mode == "strassen" and not _strassen_step_eligible(step):
        mode = "gauss"  # forced-strassen steps below the crossover
    ar, ai, br, bi = _step_operands(apair, bpair, step, a_batched, b_batched)

    def dot(x, y):
        # x from the a side, y from the b side; swap issues (y, x)
        return y.mT @ x if step.swap else x.mT @ y

    if mode == "strassen":
        from tnc_tpu_torch.ops.strassen import gauss_strassen_dot_kl

        if step.swap:
            re, im = gauss_strassen_dot_kl(br, bi, ar, ai)
        else:
            re, im = gauss_strassen_dot_kl(ar, ai, br, bi)
        return re.reshape(out_shape), im.reshape(out_shape)
    if mode == "fused":
        out = _try_fused_step(ar, ai, br, bi, step, lead[0] if lead else 1)
        if out is not None:
            return out[0].reshape(out_shape), out[1].reshape(out_shape)
        mode = "naive"  # routed by shape: same arithmetic as the kernel
    if mode == "naive":
        re = dot(ar, br)
        re -= dot(ai, bi)
        im = dot(ar, bi)
        im += dot(ai, br)
        return re.reshape(out_shape), im.reshape(out_shape)
    # gauss, with each full-size product freed as early as the identity
    # allows (k1 - k3 and k1 + k2, in the reference's order)
    k1 = dot(ar + ai, br)
    im = dot(ar, bi - br)
    im += k1
    k3 = dot(ai, br + bi)
    re = k1
    re -= k3
    del k3
    return re.reshape(out_shape), im.reshape(out_shape)


def _strassen_step_eligible(step) -> bool:
    from tnc_tpu_torch.ops.program import step_dims
    from tnc_tpu_torch.ops.strassen import strassen_eligible

    m, k, n = step_dims(step)
    return strassen_eligible(m, k, n)


def auto_step_mode(step) -> str | None:
    """Per-step promotion for executors outside a full
    :class:`KernelPolicy` plan (the hoisted prelude, whose stem GEMMs are
    exactly the Strassen regime): ``strassen`` when the step clears the
    crossover and no forcing override is set; ``None`` defers to the env
    default. Eligibility-gated only, as in the reference: it never consults
    a fitted cost model (:func:`_strassen_saving_s`);
    ``TNC_TPU_COMPLEX_MULT=gauss`` disables it."""
    if complex_mult_forced() is not None:
        return None
    if _strassen_step_eligible(step):
        return "strassen"
    return None


def _note_fused_routed(reason: str, k: int, m: int, n: int, slices: int = 1) -> None:
    """Count a step the fused kernel's gate sent to the naive dots, once
    per slice its product stands for (``slices``: the batch)."""
    FUSED_ROUTED[reason] = FUSED_ROUTED.get(reason, 0) + slices
    logger.debug(
        "fused complex kernel: step (K=%d, M=%d, N=%d) runs naive dots: %s",
        k, m, n, reason,
    )


def _try_fused_step(ar, ai, br, bi, step, slices: int = 1):
    """Route one step through the fused kernel when its gate admits it
    (both operands contract-first, over the flop floor — judged on one
    slice's ``(K, M, N)``, as under the reference's ``vmap``); ``None``
    means 'run the naive dots'. Every routed step is counted in
    :data:`FUSED_ROUTED` with its reason, ``slices`` times (the batch it
    stands for). Batched operands launch the kernel once for the whole
    batch. A kernel error propagates."""
    from tnc_tpu_torch.ops.cuda_complex import fused_complex_dot, ineligible_reason
    from tnc_tpu_torch.ops.program import step_dims

    m, k, n = step_dims(step)
    if step.swap:
        m, n = n, m
    if not (step.a_cfirst and step.b_cfirst):
        _note_fused_routed("layout", k, m, n, slices)
        return None
    reason = ineligible_reason(k, m, n)
    if reason is not None:
        _note_fused_routed(reason, k, m, n, slices)
        return None
    if step.swap:
        return fused_complex_dot(br, bi, ar, ai)
    return fused_complex_dot(ar, ai, br, bi)


# -- fused transpose-dot step glue ------------------------------------------


def _fused_transpose_layouts(step):
    """``(first, second)`` :class:`~tnc_tpu_torch.ops.cuda_complex.
    OperandLayout` pair of one step with ``swap`` folded out (the first
    operand supplies the output rows); ``None`` on a side whose layout
    cannot be described."""
    from tnc_tpu_torch.ops.cuda_complex import operand_layout

    a = operand_layout(step.a_view, step.a_perm, step.a_dot, step.a_cfirst)
    b = operand_layout(step.b_view, step.b_perm, step.b_dot, step.b_cfirst)
    return (b, a) if step.swap else (a, b)


def fused_transpose_ineligible_reason(step) -> str | None:
    """Why the fused transpose-dot should not take one step — ``None``
    when it should (the static half of the gate, as in the reference).
    ``staged_prep`` rejects operands that carry a staged op plan: the
    reference keeps them off the kernel, and so does the port (whose
    executors ignore the staged plans)."""
    from tnc_tpu_torch.ops.cuda_complex import transpose_dot_ineligible_reason
    from tnc_tpu_torch.ops.program import step_dims

    if step.a_ops is not None or step.b_ops is not None:
        return "staged_prep"
    m, k, n = step_dims(step)
    first, second = _fused_transpose_layouts(step)
    return transpose_dot_ineligible_reason(first, second, k, m, n)


def fused_transpose_step_eligible(step) -> bool:
    """Does the static gate admit this step to the fused transpose-dot?"""
    return fused_transpose_ineligible_reason(step) is None


def fused_transpose_runtime_ineligible_reason(
    apair, bpair, step, a_batched=False, b_batched=False
) -> str | None:
    """The half of the gate that needs live buffers: parts that are not
    float32 (``dtype``) and buffers carrying an extra leading batch axis
    (``batch``: a side the executor batched, or a buffer larger than its
    view)."""
    import torch

    ar, br = apair[0], bpair[0]
    if ar.dtype != torch.float32 or br.dtype != torch.float32:
        return "dtype"
    if (a_batched or b_batched or ar.numel() != math.prod(step.a_view)
            or br.numel() != math.prod(step.b_view)):
        return "batch"
    return None


def _note_fused_transpose_routed(reason: str, k: int, m: int, n: int,
                                 slices: int = 1) -> None:
    """Count a step the transpose-dot's gate sent to prep + naive dots,
    once per slice its product stands for."""
    FUSED_TRANSPOSE_ROUTED[reason] = FUSED_TRANSPOSE_ROUTED.get(reason, 0) + slices
    logger.debug(
        "fused transpose-dot kernel: step (K=%d, M=%d, N=%d) runs prep + "
        "naive dots: %s", k, m, n, reason,
    )


def _try_fused_transpose_step(apair, bpair, step, a_batched=False, b_batched=False):
    """Route one step through :func:`~tnc_tpu_torch.ops.cuda_complex.
    fused_transpose_dot` on its RAW stored (real, imag) pairs when the gate
    admits it; ``None`` means 'run the prep + naive dots'. Every routed
    step is counted in :data:`FUSED_TRANSPOSE_ROUTED` with its reason. A
    kernel error propagates."""
    from tnc_tpu_torch.ops.cuda_complex import fused_transpose_dot
    from tnc_tpu_torch.ops.program import step_dims

    reason = fused_transpose_ineligible_reason(
        step
    ) or fused_transpose_runtime_ineligible_reason(
        apair, bpair, step, a_batched, b_batched)
    if reason is not None:
        m, k, n = step_dims(step)
        _note_fused_transpose_routed(
            reason, k, m, n, batch_rows(apair[0], bpair[0], a_batched, b_batched))
        return None
    first_lay, second_lay = _fused_transpose_layouts(step)
    a = tuple(p.reshape(step.a_view) for p in apair)
    b = tuple(p.reshape(step.b_view) for p in bpair)
    first, second = (b, a) if step.swap else (a, b)
    re, im = fused_transpose_dot(*first, *second, first_lay, second_lay)
    return re.reshape(step.out_store), im.reshape(step.out_store)


# -- kernel promotion ladder --------------------------------------------


@dataclass(frozen=True)
class KernelPolicy:
    """Per-step kernel choice for one program.

    ``modes[i]`` is the lowering of step ``i`` (``naive`` / ``gauss`` /
    ``fused`` / ``fused_transpose`` / ``strassen``); ``chains`` are ``(start, end)`` step spans
    that execute as ONE fused multi-step launch
    (:func:`tnc_tpu_torch.ops.cuda_complex.fused_chain`). Chained steps
    carry mode ``naive`` — the chain kernel's arithmetic.
    ``precision_modes[i]`` is step ``i``'s dot-precision rung (empty
    tuple: none recorded). ``chain_runs`` keeps each chain's launch,
    planned once per span and slice batch by :func:`run_chain_split` (not
    part of the policy's identity).
    """

    modes: tuple[str, ...]
    chains: tuple[tuple[int, int], ...] = ()
    precision_modes: tuple[str, ...] = ()
    chain_runs: dict = field(default_factory=dict, compare=False, repr=False)

    def signature(self) -> tuple:
        return (self.modes, self.chains, self.precision_modes)

    def precision_mode(self, i: int) -> str:
        """Step ``i``'s dot-precision rung ('' = defer)."""
        return self.precision_modes[i] if self.precision_modes else ""

    def chained_steps(self) -> set[int]:
        return {i for s, e in self.chains for i in range(s, e)}

    def dispatch_count(self) -> int:
        """Device launches of step kernels this policy issues: one per
        unchained step, one per chain."""
        return len(self.modes) - len(self.chained_steps()) + len(self.chains)


def _chain_pays(cost_model, steps) -> bool:
    """Is fusing this run of steps into one launch a predicted win? Saves
    ``len(steps) - 1`` launch overheads; costs the naive-vs-gauss flop
    difference (the chain kernel runs 4 dots where the default ladder would
    run 3). With no fitted model the grouping pass's own size bound (steps
    under the fused kernel's flop floor) already selects launch-dominated
    steps — accept."""
    if cost_model is None:
        return True
    from tnc_tpu_torch.ops.program import step_flops

    flops = sum(step_flops(st) for st in steps)
    # complex k*m*n units → real-multiply units: naive 8x, gauss 6x, so
    # fusing costs 2 extra units per k*m*n; each saved launch is worth its
    # flop-equivalent under the fitted model
    extra_flops = 2.0 * flops
    saved_flops = (
        len(steps) - 1
    ) * cost_model.dispatch_equivalent_flops()
    return saved_flops > extra_flops


def _strassen_saving_s(cost_model, m: int, k: int, n: int) -> float:
    """Predicted seconds one Strassen level saves over gauss on an eligible
    step (negative = loses): the saved multiplies (0.75 → 21/32 of naive)
    against the 15 extra quadrant-sized elementwise passes per real GEMM
    (bandwidth). With no fitted model the margin is ``+inf`` — eligibility
    alone decides."""
    if cost_model is None:
        return float("inf")
    from tnc_tpu_torch.ops.strassen import GAUSS_STRASSEN_FLOP_FACTOR

    naive_real_flops = 8.0 * m * k * n
    saved_s = (
        0.75 - GAUSS_STRASSEN_FLOP_FACTOR
    ) * naive_real_flops / cost_model.flops_per_s
    if not cost_model.bytes_per_s:
        return saved_s
    # ~15 add/sub passes over (m/2, k/2)+(k/2, n/2) quadrants, 3 Gauss
    # products, f32 in + out
    quad_bytes = 4.0 * ((m * k + k * n) / 4.0) * 2.0
    extra_s = 3.0 * 15.0 * quad_bytes / cost_model.bytes_per_s
    return saved_s - extra_s


def _fused_transpose_saving_s(cost_model, step) -> float:
    """Predicted seconds the fused transpose-dot saves over the default
    prep+gauss path on one eligible step (negative = loses): the deleted
    transposed copy (read + write of every permuted operand's (real, imag)
    pair — :func:`tnc_tpu_torch.ops.program.step_prep_elems`) against the
    naive-vs-gauss flop difference (the kernel runs 4 dots where gauss runs
    3). A missing model, or one without a bandwidth term, means NO
    promotion (``-inf``): the rung's whole case is bandwidth —
    ``TNC_TPU_COMPLEX_MULT=fused_transpose`` is the A/B path."""
    if cost_model is None or not cost_model.bytes_per_s:
        return float("-inf")
    from tnc_tpu_torch.ops.program import step_flops, step_prep_elems

    prep = step_prep_elems(step)
    if prep <= 0.0:
        return float("-inf")  # no transpose pass to save
    # f32 split pairs: 8 bytes per complex element, the device width
    saved_s = prep * 8.0 / cost_model.bytes_per_s
    # naive 8 vs gauss 6 real-multiply units per k*m*n (same convention as
    # _chain_pays); the fitted flops_per_s is per k*m*n unit
    extra_s = 2.0 * step_flops(step) / cost_model.flops_per_s
    return saved_s - extra_s


def chain_flop_ceiling(cost_model) -> float:
    """Chain-candidate step-size ceiling in the fused kernel's ``2*k*m*n``
    units, priced in calibrated seconds: a step is worth chaining while its
    compute time is within ~one launch overhead (:meth:`~tnc_tpu_torch.obs.
    calibrate.CalibratedCostModel.dispatch_equivalent_flops`), so the
    ceiling rises above the static ``MIN_FLOPS`` small-step bucket exactly
    when the fitted overhead says bigger steps are still launch-bound.
    Never *below* ``MIN_FLOPS``: the static bound is the no-model floor."""
    from tnc_tpu_torch.ops.cuda_complex import MIN_FLOPS

    if cost_model is None:
        return float(MIN_FLOPS)
    return max(float(MIN_FLOPS), 2.0 * cost_model.dispatch_equivalent_flops())


def plan_precision_modes(
    steps,
    cost_model=None,
    force: str | None = None,
    parity_budget: float = 1e-5,
) -> tuple[str, ...]:
    """Per-step dot-precision rungs for :func:`plan_kernel_steps`.

    ``force`` (default: the ``TNC_TPU_DOT_PRECISION`` override via
    :func:`dot_precision_forced`) pins every step. Unforced, the ladder
    promotes a step to ``high`` only when ALL of:

    - a fitted cost model with a bandwidth term exists and predicts the
      step *compute*-dominated (flop time > byte time);
    - the step is in the ``stem`` bucket;
    - the ``parity_budget`` (the run's amplitude-parity target, 1e-5 by
      default) clears the documented ``high`` rung
      (:data:`HIGH_PRECISION_STEP_REL`) with 2× headroom.

    Returns ``()`` (no rungs) when nothing promotes. The rung is the
    reference's decision; in the port every rung runs FP32, so a ``high``
    step changes the policy's key, not its numbers.
    """
    steps = tuple(steps)
    if force is None:
        force = dot_precision_forced()
    if force is not None:
        return (force,) * len(steps)
    if cost_model is None or not cost_model.bytes_per_s:
        return ()
    if parity_budget < 2.0 * HIGH_PRECISION_STEP_REL:
        return ()
    from tnc_tpu_torch.ops.program import step_elems, step_flops

    out = []
    for st in steps:
        promote = False
        if step_bucket(st) == "stem":
            flop_s = step_flops(st) / cost_model.flops_per_s
            elems_in, elems_out = step_elems(st)
            byte_s = (elems_in + elems_out) * 8.0 / cost_model.bytes_per_s
            promote = flop_s > byte_s
        out.append("high" if promote else "")
    if not any(out):
        return ()
    return tuple(out)


def plan_kernels(
    program: ContractionProgram,
    cost_model=None,
    force: str | None = None,
    chain_max_flops: float | None = None,
) -> KernelPolicy:
    """The kernel promotion ladder for one program — thin wrapper over
    :func:`plan_kernel_steps` (the chunked executor plans per chunk with the
    same rules)."""
    return plan_kernel_steps(
        program.steps, cost_model, force, chain_max_flops
    )


def plan_kernel_steps(
    steps,
    cost_model=None,
    force: str | None = None,
    chain_max_flops: float | None = None,
    precision_force: str | None = None,
    parity_budget: float = 1e-5,
) -> KernelPolicy:
    """Plan modes, chains and precision rungs over a bare step sequence, as
    the reference's ``plan_kernel_steps`` plans them (chain spans and modes
    indexed relative to ``steps[0]``).

    ``force`` (default: the ``TNC_TPU_COMPLEX_MULT`` override) pins the
    decision: ``naive``/``gauss``/``fused``/``fused_transpose`` uniformly
    (the fused rungs route steps their gates reject to naive dots,
    counted); ``strassen`` promotes every step over the crossover (others
    run gauss); ``chain`` fuses every groupable run (others run gauss).
    Unforced, the ladder is driven by ``cost_model`` (a
    :class:`~tnc_tpu_torch.obs.calibrate.CalibratedCostModel` or ``None``):

    - runs of consecutive steps under :func:`chain_flop_ceiling`
      (``MIN_FLOPS`` without a model, rising with the fitted launch
      overhead) whose fusion saves more launch overhead than the
      naive-vs-gauss flop difference costs (:func:`_chain_pays`) → one
      **chain** launch each;
    - transpose-carrying steps the fused transpose-dot's gate admits where
      the deleted transposed copy beats the extra naive dot
      (:func:`_fused_transpose_saving_s`, which needs a fitted bandwidth
      term) → **fused_transpose**;
    - steps whose matricized shape clears the Strassen crossover where the
      multiply saving beats the extra passes (:func:`_strassen_saving_s`,
      ``+inf`` without a model) → **strassen** (the larger predicted saving
      wins where both rungs pay);
    - everything else → **gauss**;
    - compute-bound stem steps also get the ``high`` dot-precision rung
      under the parity budget (:func:`plan_precision_modes`), never stacked
      on a Strassen step unless forced.
    """
    from tnc_tpu_torch.ops.program import chain_groups, step_dims
    from tnc_tpu_torch.ops.strassen import strassen_eligible

    steps = tuple(steps)
    n = len(steps)
    if force is None:
        force = complex_mult_forced()
    pmodes = plan_precision_modes(
        steps, cost_model, precision_force, parity_budget
    )
    if force in ("naive", "gauss", "fused", "fused_transpose"):
        return KernelPolicy((force,) * n, (), pmodes)
    if force == "strassen":
        modes = tuple(
            "strassen" if _strassen_step_eligible(st) else "gauss"
            for st in steps
        )
        if pmodes and dot_precision_forced() is None and precision_force is None:
            # see the auto branch below: no auto `high` on strassen
            pmodes = tuple(
                "" if modes[i] == "strassen" else p
                for i, p in enumerate(pmodes)
            )
            if not any(pmodes):
                pmodes = ()
        return KernelPolicy(modes, (), pmodes)

    if chain_max_flops is None and force != "chain":
        chain_max_flops = chain_flop_ceiling(cost_model)
    chains = chain_groups(steps, max_flops=chain_max_flops)
    if force != "chain":  # auto: keep only the chains the model likes
        chains = tuple(
            (s, e) for s, e in chains if _chain_pays(cost_model, steps[s:e])
        )
    chained = {i for s, e in chains for i in range(s, e)}
    modes = []
    for i, st in enumerate(steps):
        if i in chained:
            modes.append("naive")  # the chain kernel's arithmetic
            continue
        if force == "chain":
            modes.append("gauss")
            continue
        m, k, nn = step_dims(st)
        strassen_gain = (
            _strassen_saving_s(cost_model, m, k, nn)
            if strassen_eligible(m, k, nn)
            else float("-inf")
        )
        transpose_gain = (
            _fused_transpose_saving_s(cost_model, st)
            if fused_transpose_step_eligible(st)
            else float("-inf")
        )
        if strassen_gain <= 0.0 and transpose_gain <= 0.0:
            modes.append("gauss")
        elif strassen_gain >= transpose_gain:
            modes.append("strassen")
        else:
            modes.append("fused_transpose")
    if pmodes and dot_precision_forced() is None and precision_force is None:
        # never STACK the auto `high` rung on a Strassen step: the budget
        # check models the plain-dot rung only, and Strassen's extra add/sub
        # passes amplify the error past it. A forced TNC_TPU_DOT_PRECISION
        # is the explicit A/B and stays global.
        pmodes = tuple(
            "" if modes[i] == "strassen" else p
            for i, p in enumerate(pmodes)
        )
        if not any(pmodes):
            pmodes = ()
    return KernelPolicy(tuple(modes), chains, pmodes)


def step_bucket(step) -> str:
    """Shape bucket of one step: ``stem`` (clears the Strassen crossover),
    ``small`` (under the fused kernel's flop floor, the launch-dominated
    regime), ``medium`` (the rest)."""
    from tnc_tpu_torch.ops.cuda_complex import MIN_FLOPS
    from tnc_tpu_torch.ops.program import step_dims, step_flops
    from tnc_tpu_torch.ops.strassen import strassen_eligible

    m, k, n = step_dims(step)
    if strassen_eligible(m, k, n):
        return "stem"
    if 2 * step_flops(step) < MIN_FLOPS:
        return "small"
    return "medium"


def effective_step_flops(step, mode: str) -> float:
    """A step's flop count credited for the kernel mode that ran it."""
    from tnc_tpu_torch.ops.program import step_flops

    return step_flops(step) * EFFECTIVE_FLOP_FACTOR.get(mode, 1.0)


def kernel_plan_summary(
    program: ContractionProgram,
    policy: KernelPolicy | None = None,
    dtype_bytes: float = 8.0,
) -> dict:
    """JSON-able per-bucket summary of a program under a policy: step
    counts, naive vs effective (mode-credited) flops, the mode and
    dot-precision mixes, predicted bytes (operands in, their prep pass,
    result out), and the launch count (chains collapse to one)."""
    if policy is None:
        policy = plan_kernels(program)
    from tnc_tpu_torch.ops.program import step_elems, step_flops, step_prep_elems

    buckets: dict[str, dict] = {}
    for i, st in enumerate(program.steps):
        b = buckets.setdefault(
            step_bucket(st),
            {
                "steps": 0,
                "flops": 0.0,
                "effective_flops": 0.0,
                "modes": {},
                "precision": {},
                "transpose_steps": 0,
                "pred_bytes": 0.0,
            },
        )
        mode = policy.modes[i]
        b["steps"] += 1
        b["flops"] += step_flops(st)
        b["effective_flops"] += effective_step_flops(
            st, resolved_step_mode(st, mode)
        )
        b["modes"][mode] = b["modes"].get(mode, 0) + 1
        rung = policy.precision_mode(i) or "default"
        b["precision"][rung] = b["precision"].get(rung, 0) + 1
        if step_prep_elems(st) > 0.0:
            b["transpose_steps"] += 1
        elems_in, elems_out = step_elems(st)
        b["pred_bytes"] += (elems_in + elems_out) * dtype_bytes
    return {
        "buckets": buckets,
        "dispatches": policy.dispatch_count(),
        "chains": len(policy.chains),
        "chained_steps": len(policy.chained_steps()),
    }


def _chain_specs(steps):
    """The operands of one chain group in the kernel's order, each as the
    slot it is read from and its prep ``(slot, view, perm, dot, cfirst)``
    (the head's two in product order, then one per link), and the
    :class:`~tnc_tpu_torch.ops.cuda_complex.ChainLink` of every link."""
    from tnc_tpu_torch.ops.cuda_complex import ChainLink

    head = steps[0]
    a = (head.lhs, head.a_view, head.a_perm, head.a_dot, head.a_cfirst)
    b = (head.rhs, head.b_view, head.b_perm, head.b_dot, head.b_cfirst)
    specs = [b, a] if head.swap else [a, b]
    links = []
    run_slot = head.lhs
    for st in steps[1:]:
        carried_a = st.lhs == run_slot
        if carried_a:
            specs.append((st.rhs, st.b_view, st.b_perm, st.b_dot, st.b_cfirst))
            carried_dot, carried_cfirst = st.a_dot, st.a_cfirst
        else:
            specs.append((st.lhs, st.a_view, st.a_perm, st.a_dot, st.a_cfirst))
            carried_dot, carried_cfirst = st.b_dot, st.b_cfirst
        k = int(carried_dot[0]) if carried_cfirst else int(carried_dot[-1])
        f = int(math.prod(carried_dot)) // max(k, 1)
        carried_shape = (k, f) if carried_cfirst else (f, k)
        k_axis = 0 if carried_cfirst else 1
        carried_first = (not carried_a) if st.swap else carried_a
        links.append(ChainLink(carried_first, carried_shape, k_axis))
        run_slot = st.lhs
    return specs, links


def _prep_spec(spec, buffers, batched):
    slot, view, perm, dot, cfirst = spec
    return prep_kl(buffers[slot], view, perm, dot, cfirst, slot in batched)


def chain_operands(steps, buffers, batched=frozenset()):
    """The operands of one chain group, ready for
    :func:`~tnc_tpu_torch.ops.cuda_complex.fused_chain`: ``(first_ops,
    link_ops, links)``. Non-carried operands are prepped to
    contract-dim-leading 2-D ``(K, X)`` (a transposed view where the
    contract dim is last), or ``(B, K, X)`` when their slot is in
    ``batched`` (its buffer has a leading slice-batch axis); the carried
    value is described by a :class:`~tnc_tpu_torch.ops.cuda_complex.
    ChainLink`."""
    specs, links = _chain_specs(steps)
    ops = [_prep_spec(spec, buffers, batched) for spec in specs]
    first_ops = (ops[0][0], ops[0][1], ops[1][0], ops[1][1])
    return first_ops, [tuple(op) for op in ops[2:]], links


class _ChainRun:
    """One chain group on the card, planned once for a span and a slice
    batch: the kernel's :class:`~tnc_tpu_torch.ops.cuda_complex._ChainPlan`
    (its output in the last step's stored shape) and, for each operand part
    the kernel reads, the buffer part it is a view of and the byte offset
    there, or ``None`` where its prep copies (then redone each call).
    ``layout`` is every source part's ``(shape, stride, dtype, device)`` and
    ``batched`` whether its slot is batched, when planned; a call whose
    buffers differ is planned anew."""

    __slots__ = ("plan", "specs", "reads", "sources", "layout", "batched")

    def __init__(self, steps, buffers, batched):
        from tnc_tpu_torch.ops.cuda_complex import chain_plan

        self.specs, links = _chain_specs(steps)
        ops = [_prep_spec(spec, buffers, batched) for spec in self.specs]
        first_ops = (ops[0][0], ops[0][1], ops[1][0], ops[1][1])
        lead = next((tuple(op[0].shape[:1]) for op in ops if op[0].dim() == 3), ())
        self.plan = chain_plan(first_ops, [tuple(op) for op in ops[2:]], links,
                               out_shape=lead + tuple(steps[-1].out_store))
        self.sources = tuple(sorted({spec[0] for spec in self.specs}))
        self.layout = tuple((t.shape, t.stride(), t.dtype, t.device)
                            for slot in self.sources for t in buffers[slot])
        self.batched = tuple(slot in batched for slot in self.sources)
        reads = []
        for spec, op in zip(self.specs, ops):
            parts = buffers[spec[0]]
            view = all(t.untyped_storage().data_ptr() == src.untyped_storage().data_ptr()
                       for t, src in zip(op, parts))
            reads.append(tuple(t.data_ptr() - src.data_ptr() for t, src in zip(op, parts))
                         if view else None)
        self.reads = tuple(reads)

    def matches(self, buffers, batched) -> bool:
        """Whether ``buffers`` hold the source parts the run was planned for."""
        at = 0
        for slot, was in zip(self.sources, self.batched):
            if (slot in batched) != was:
                return False
            for t in buffers[slot]:
                if (t.shape, t.stride(), t.dtype, t.device) != self.layout[at]:
                    return False
                at += 1
        return True

    def __call__(self, buffers, batched):
        """Launch the chain on ``buffers``; returns ``(re, im)``."""
        ptrs = []
        keep = []  # the copies stay alive until their launch is queued
        for spec, read in zip(self.specs, self.reads):
            if read is None:
                op = _prep_spec(spec, buffers, batched)
                keep.append(op)
                ptrs.extend(t.data_ptr() for t in op)
            else:
                re, im = buffers[spec[0]]
                ptrs.append(re.data_ptr() + read[0])
                ptrs.append(im.data_ptr() + read[1])
        return self.plan.launch_ptrs(ptrs)


def run_chain_split(steps, buffers, batched=None, runs=None, key=None):
    """Execute one chain group as ONE :func:`~tnc_tpu_torch.ops.
    cuda_complex.fused_chain` launch, with the sequential loop's buffer
    bookkeeping (every consumed slot freed, the result in the last step's
    ``lhs`` slot, in its ``out_store`` shape — after a leading batch axis
    when any operand's slot is in the set ``batched``, which then gains
    that slot).

    ``runs``: where CUDA launches are kept planned (a policy's
    ``chain_runs``), under ``key`` (the span's start): a call then only
    checks its buffers' layout and fills pointers. Without it, or on the
    CPU, the call preps the operands and calls ``fused_chain``."""
    from tnc_tpu_torch.ops import cuda_complex

    batched = set() if batched is None else batched
    first = buffers[steps[0].lhs][0]
    if runs is not None and first.device.type == "cuda":
        run = runs.get(key)
        if run is None or not run.matches(buffers, batched):
            run = _ChainRun(steps, buffers, batched)
            runs[key] = run
        re, im = run(buffers, batched)
        lead = () if run.plan.batch is None else (run.plan.batch,)
    else:
        re, im = cuda_complex.fused_chain(*chain_operands(steps, buffers, batched))
        lead = tuple(re.shape[:1]) if re.dim() == 3 else ()
        out_store = lead + tuple(steps[-1].out_store)
        re, im = re.reshape(out_store), im.reshape(out_store)
    for st in steps:
        buffers[st.rhs] = None
    buffers[steps[-1].lhs] = (re, im)
    if lead:
        batched.add(steps[-1].lhs)
    return re, im


def run_split_units(
    steps,
    buffers: list,
    precision=None,
    policy: KernelPolicy | None = None,
    on_unit=None,
    batched: set[int] | None = None,
) -> None:
    """Run a step sequence on (real, imag) buffer pairs in place:
    ``policy`` (spans relative to ``steps``) promotes steps per the kernel
    ladder; ``None`` runs every step under the env mode. Consumed buffers
    are freed at once. ``batched``: the slots whose buffers carry a
    leading slice-batch axis; it gains every slot a step writes from a
    batched operand. ``on_unit(start, end, run)``, where given, is called
    for each launch unit instead of running it: steps ``start..end-1``
    (one step, or one fused chain), launched by calling ``run()`` once."""
    batched = set() if batched is None else batched
    chain_end = (
        {s: e for s, e in policy.chains} if policy is not None else {}
    )

    def run_unit(start: int, end: int) -> None:
        if start in chain_end:
            run_chain_split(steps[start:end], buffers, batched,
                            policy.chain_runs, start)
            return
        step = steps[start]
        a_b, b_b = step.lhs in batched, step.rhs in batched
        buffers[step.lhs] = apply_step_split(
            buffers[step.lhs], buffers[step.rhs], step, precision,
            mode=policy.modes[start] if policy is not None else None,
            precision_mode=(
                policy.precision_mode(start) if policy is not None else None
            ),
            a_batched=a_b, b_batched=b_b,
        )
        buffers[step.rhs] = None
        if a_b or b_b:
            batched.add(step.lhs)

    i = 0
    while i < len(steps):
        end = chain_end.get(i, i + 1)
        if on_unit is None:
            run_unit(i, end)
        else:
            on_unit(i, end, functools.partial(run_unit, i, end))
        i = end


def run_steps_split(
    program: ContractionProgram,
    buffers: list[tuple[Any, Any] | None],
    precision=None,
    policy: KernelPolicy | None = None,
    on_unit=None,
):
    """Run a whole program on (real, imag) buffer pairs
    (:func:`run_split_units`); returns the result pair in **stored**
    shape."""
    run_split_units(program.steps, buffers, precision, policy, on_unit)
    return buffers[program.result_slot]
