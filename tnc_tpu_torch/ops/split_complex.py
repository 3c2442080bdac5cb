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
one Strassen level (``strassen``), and chains of small steps that run as
one launch of :func:`~tnc_tpu_torch.ops.cuda_complex.fused_chain`. The
policy is planned exactly as the reference plans it with no fitted cost
model, so both packages make the same choice for every step.

Products outside the hand kernels are ``torch.matmul`` in full FP32:
:class:`~tnc_tpu_torch.ops.backends.TorchBackend` turns TF32 off.
"""

from __future__ import annotations

import logging
import math
import os
from dataclasses import dataclass
from typing import Any

import numpy as np

from tnc_tpu_torch.ops.program import ContractionProgram

logger = logging.getLogger(__name__)

#: real-multiply credit of each kernel mode relative to the naive 4-dot
#: complex lowering: Gauss runs 3 of the 4 dots, one Strassen level on top
#: of Gauss runs 21 half-size sub-GEMMs against naive's 32 half-units.
EFFECTIVE_FLOP_FACTOR = {
    "naive": 1.0,
    "fused": 1.0,  # naive arithmetic in one kernel
    "gauss": 0.75,
    "strassen": 21.0 / 32.0,  # gauss × one Strassen level
}

#: dot-precision rungs a policy can record per step. The reference maps
#: them onto bf16 MXU passes; on the GPU every rung runs full FP32 (TF32
#: stays off), so in this port the rung is carried but changes nothing.
DOT_PRECISION_MODES = ("highest", "high")

#: steps routed away from the fused kernel by their shape, per reason —
#: the port of the reference's ``ops.fused_fallback{reason}`` counter.
#: Routing is the policy's semantics (a rejected step runs naive dots);
#: a kernel that fails to build or launch raises instead.
FUSED_ROUTED: dict[str, int] = {}


def reset_routed() -> None:
    """Clear :data:`FUSED_ROUTED`."""
    FUSED_ROUTED.clear()


def complex_mult_env() -> str:
    """The per-step complex-multiply base mode, ``gauss`` unless
    ``TNC_TPU_COMPLEX_MULT`` forces one (read as the reference reads it).
    The forcing values are ``naive``, ``gauss``, ``fused``, ``strassen``,
    ``chain`` and ``auto`` (the unforced promotion ladder)."""
    return os.environ.get("TNC_TPU_COMPLEX_MULT", "gauss")


def complex_mult_forced() -> str | None:
    """The forcing override, or ``None`` when the env knob is unset (the
    promotion ladder decides per step). ``auto`` explicitly requests the
    ladder, so it is NOT a forced mode."""
    mode = os.environ.get("TNC_TPU_COMPLEX_MULT")
    if mode is None or mode == "auto":
        return None
    if mode == "fused_transpose":
        raise NotImplementedError(
            "TNC_TPU_COMPLEX_MULT=fused_transpose: the fused transpose-dot "
            "kernel is not ported to the GPU yet"
        )
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
    (``strassen`` below the crossover → gauss; ``chain`` / ``auto``
    outside a policy → gauss; unknown → gauss)."""
    if mode is None:
        mode = complex_mult_env()
    if mode == "strassen":
        return "strassen" if _strassen_step_eligible(step) else "gauss"
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


def _prep_operand(buf, view, perm, dot_shape):
    """Stored buffer → dot operand: view, one macro permute, reshape to
    ``dot_shape`` (the reference's host-oracle prep; its staged
    ``a_ops``/lanemix plans exist for TPU tiling and compute the same)."""
    v = buf.reshape(view)
    if perm is not None:
        v = v.permute(perm)
    return v.reshape(dot_shape)


def _as_kl(part, dot_shape, cfirst):
    """Post-prep operand (shaped ``dot_shape``) → contract-dim-leading 2-D
    ``(k, frees)`` matrix (a transposed view when the contract dim is
    last)."""
    if cfirst:
        return part.reshape(int(dot_shape[0]), -1)
    k = int(dot_shape[-1])
    return part.reshape(-1, k).T


def _step_operands(apair, bpair, step):
    """The step's four operands as ``(k, free)`` matrices in product
    order (``swap`` folded out): ``(fr, fi, sr, si)``, plus the a-side
    and b-side pairs in program order for the Gauss sums."""
    ar = _as_kl(_prep_operand(apair[0], step.a_view, step.a_perm, step.a_dot),
                step.a_dot, step.a_cfirst)
    ai = _as_kl(_prep_operand(apair[1], step.a_view, step.a_perm, step.a_dot),
                step.a_dot, step.a_cfirst)
    br = _as_kl(_prep_operand(bpair[0], step.b_view, step.b_perm, step.b_dot),
                step.b_dot, step.b_cfirst)
    bi = _as_kl(_prep_operand(bpair[1], step.b_view, step.b_perm, step.b_dot),
                step.b_dot, step.b_cfirst)
    return ar, ai, br, bi


def apply_step_split(
    apair, bpair, step, precision=None, mode=None, precision_mode=None
):
    """Split-complex analogue of ``backends.apply_step``: one pairwise
    contraction of (real, imag) tensor pairs, the single step kernel of
    every split-mode executor. ``mode`` overrides the env mode for this
    step — the :class:`KernelPolicy` hook; ``None`` falls back to
    :func:`complex_mult_env` (``gauss``). ``precision`` and
    ``precision_mode`` are accepted for the reference's signature; every
    rung runs full FP32 here."""
    if mode is None:
        mode = complex_mult_env()
    if mode == "strassen" and not _strassen_step_eligible(step):
        mode = "gauss"  # forced-strassen steps below the crossover
    ar, ai, br, bi = _step_operands(apair, bpair, step)

    def dot(x, y):
        # x from the a side, y from the b side; swap issues (y, x)
        return y.T @ x if step.swap else x.T @ y

    if mode == "strassen":
        from tnc_tpu_torch.ops.strassen import gauss_strassen_dot_kl

        if step.swap:
            re, im = gauss_strassen_dot_kl(br, bi, ar, ai)
        else:
            re, im = gauss_strassen_dot_kl(ar, ai, br, bi)
        return re.reshape(step.out_store), im.reshape(step.out_store)
    if mode == "fused":
        out = _try_fused_step(ar, ai, br, bi, step)
        if out is not None:
            return out
        mode = "naive"  # routed by shape: same arithmetic as the kernel
    if mode == "naive":
        re = dot(ar, br)
        re -= dot(ai, bi)
        im = dot(ar, bi)
        im += dot(ai, br)
        return re.reshape(step.out_store), im.reshape(step.out_store)
    # gauss, with each full-size product freed as early as the identity
    # allows (k1 - k3 and k1 + k2, in the reference's order)
    k1 = dot(ar + ai, br)
    im = dot(ar, bi - br)
    im += k1
    k3 = dot(ai, br + bi)
    re = k1
    re -= k3
    del k3
    return re.reshape(step.out_store), im.reshape(step.out_store)


def _strassen_step_eligible(step) -> bool:
    from tnc_tpu_torch.ops.program import step_dims
    from tnc_tpu_torch.ops.strassen import strassen_eligible

    m, k, n = step_dims(step)
    return strassen_eligible(m, k, n)


def _note_fused_routed(reason: str, k: int, m: int, n: int) -> None:
    """Count one step the fused kernel's gate sent to the naive dots."""
    FUSED_ROUTED[reason] = FUSED_ROUTED.get(reason, 0) + 1
    logger.debug(
        "fused complex kernel: step (K=%d, M=%d, N=%d) runs naive dots: %s",
        k, m, n, reason,
    )


def _try_fused_step(ar, ai, br, bi, step):
    """Route one step through the fused kernel when its gate admits it
    (both operands contract-first, over the flop floor); ``None`` means
    'run the naive dots'. Every routed step is counted in
    :data:`FUSED_ROUTED` with its reason. A kernel error propagates."""
    from tnc_tpu_torch.ops.cuda_complex import fused_complex_dot, ineligible_reason
    from tnc_tpu_torch.ops.program import step_dims

    m, k, n = step_dims(step)
    if step.swap:
        m, n = n, m
    if not (step.a_cfirst and step.b_cfirst):
        _note_fused_routed("layout", k, m, n)
        return None
    reason = ineligible_reason(k, m, n)
    if reason is not None:
        _note_fused_routed(reason, k, m, n)
        return None
    if step.swap:
        re, im = fused_complex_dot(br, bi, ar, ai)
    else:
        re, im = fused_complex_dot(ar, ai, br, bi)
    return re.reshape(step.out_store), im.reshape(step.out_store)


# -- kernel promotion ladder --------------------------------------------


@dataclass(frozen=True)
class KernelPolicy:
    """Per-step kernel choice for one program.

    ``modes[i]`` is the lowering of step ``i`` (``naive`` / ``gauss`` /
    ``fused`` / ``strassen``); ``chains`` are ``(start, end)`` step spans
    that execute as ONE fused multi-step launch
    (:func:`tnc_tpu_torch.ops.cuda_complex.fused_chain`). Chained steps
    carry mode ``naive`` — the chain kernel's arithmetic.
    ``precision_modes[i]`` is step ``i``'s dot-precision rung (empty
    tuple: none recorded).
    """

    modes: tuple[str, ...]
    chains: tuple[tuple[int, int], ...] = ()
    precision_modes: tuple[str, ...] = ()

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


def plan_precision_modes(steps, force: str | None = None) -> tuple[str, ...]:
    """Per-step dot-precision rungs: the ``TNC_TPU_DOT_PRECISION``
    override (or ``force``) pins every step; with no fitted cost model
    the reference promotes nothing, so unforced this is ``()``."""
    steps = tuple(steps)
    if force is None:
        force = dot_precision_forced()
    if force is not None:
        return (force,) * len(steps)
    return ()


def plan_kernels(
    program: ContractionProgram,
    cost_model=None,
    force: str | None = None,
) -> KernelPolicy:
    """The kernel promotion ladder for one program — thin wrapper over
    :func:`plan_kernel_steps`."""
    return plan_kernel_steps(program.steps, cost_model, force)


def plan_kernel_steps(
    steps,
    cost_model=None,
    force: str | None = None,
    precision_force: str | None = None,
) -> KernelPolicy:
    """Plan modes and chains over a bare step sequence, as the reference's
    ``plan_kernel_steps`` plans them with no fitted cost model (the port
    has no calibration layer; ``cost_model`` must be ``None``).

    ``force`` (default: the ``TNC_TPU_COMPLEX_MULT`` override) pins the
    decision: ``naive``/``gauss``/``fused`` uniformly (``fused`` routes
    steps its gate rejects to naive dots, counted); ``strassen`` promotes
    every step over the crossover (others run gauss); ``chain`` fuses
    every groupable run (others run gauss). Unforced:

    - runs of consecutive steps under ``MIN_FLOPS`` that
      :func:`~tnc_tpu_torch.ops.program.chain_groups` groups → one
      **chain** launch each;
    - steps whose matricized shape clears the Strassen crossover →
      **strassen**;
    - everything else → **gauss**.
    """
    from tnc_tpu_torch.ops.program import chain_groups

    if cost_model is not None:
        raise NotImplementedError("the port plans without a fitted cost model")
    steps = tuple(steps)
    n = len(steps)
    if force is None:
        force = complex_mult_forced()
    pmodes = plan_precision_modes(steps, precision_force)
    if force in ("naive", "gauss", "fused"):
        return KernelPolicy((force,) * n, (), pmodes)
    if force == "strassen":
        modes = tuple(
            "strassen" if _strassen_step_eligible(st) else "gauss"
            for st in steps
        )
        return KernelPolicy(modes, (), pmodes)

    chains = chain_groups(steps)
    chained = {i for s, e in chains for i in range(s, e)}
    modes = []
    for i, st in enumerate(steps):
        if i in chained:
            modes.append("naive")  # the chain kernel's arithmetic
        elif force != "chain" and _strassen_step_eligible(st):
            modes.append("strassen")
        else:
            modes.append("gauss")
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


def chain_operands(steps, buffers):
    """The operands of one chain group, ready for
    :func:`~tnc_tpu_torch.ops.cuda_complex.fused_chain`: ``(first_ops,
    link_ops, links)``. Non-carried operands are prepped to
    contract-dim-leading 2-D ``(K, X)`` (a transposed view where the
    contract dim is last); the carried value is described by a
    :class:`~tnc_tpu_torch.ops.cuda_complex.ChainLink`."""
    from tnc_tpu_torch.ops.cuda_complex import ChainLink

    def prep_kl(pair, view, perm, dot_shape, cfirst):
        return tuple(
            _as_kl(_prep_operand(p, view, perm, dot_shape), dot_shape, cfirst)
            for p in pair
        )

    head = steps[0]
    a = prep_kl(buffers[head.lhs], head.a_view, head.a_perm, head.a_dot,
                head.a_cfirst)
    b = prep_kl(buffers[head.rhs], head.b_view, head.b_perm, head.b_dot,
                head.b_cfirst)
    first, second = (b, a) if head.swap else (a, b)
    first_ops = (first[0], first[1], second[0], second[1])

    link_ops = []
    links = []
    run_slot = head.lhs
    for st in steps[1:]:
        carried_a = st.lhs == run_slot
        if carried_a:
            link_ops.append(prep_kl(buffers[st.rhs], st.b_view, st.b_perm,
                                    st.b_dot, st.b_cfirst))
            carried_dot, carried_cfirst = st.a_dot, st.a_cfirst
        else:
            link_ops.append(prep_kl(buffers[st.lhs], st.a_view, st.a_perm,
                                    st.a_dot, st.a_cfirst))
            carried_dot, carried_cfirst = st.b_dot, st.b_cfirst
        k = int(carried_dot[0]) if carried_cfirst else int(carried_dot[-1])
        f = int(math.prod(carried_dot)) // max(k, 1)
        carried_shape = (k, f) if carried_cfirst else (f, k)
        k_axis = 0 if carried_cfirst else 1
        carried_first = (not carried_a) if st.swap else carried_a
        links.append(ChainLink(carried_first, carried_shape, k_axis))
        run_slot = st.lhs
    return first_ops, link_ops, links


def run_chain_split(steps, buffers):
    """Execute one chain group as ONE :func:`~tnc_tpu_torch.ops.
    cuda_complex.fused_chain` call, with the sequential loop's buffer
    bookkeeping (every consumed slot freed, the result in the last step's
    ``lhs`` slot, in its ``out_store`` shape)."""
    from tnc_tpu_torch.ops.cuda_complex import fused_chain

    re, im = fused_chain(*chain_operands(steps, buffers))
    out_store = steps[-1].out_store
    out = (re.reshape(out_store), im.reshape(out_store))
    for st in steps:
        buffers[st.rhs] = None
    buffers[steps[-1].lhs] = out
    return out


def run_steps_split(
    program: ContractionProgram,
    buffers: list[tuple[Any, Any] | None],
    precision=None,
    policy: KernelPolicy | None = None,
):
    """Run a whole program on (real, imag) buffer pairs; returns the
    result pair in **stored** shape. ``policy`` promotes steps per the
    kernel ladder; ``None`` runs every step under the env mode
    (``gauss`` default). Buffers are freed as soon as a step consumed
    them."""
    steps = program.steps
    chain_end = (
        {s: e for s, e in policy.chains} if policy is not None else {}
    )
    i = 0
    while i < len(steps):
        end = chain_end.get(i)
        if end is not None:
            run_chain_split(steps[i:end], buffers)
            i = end
            continue
        step = steps[i]
        buffers[step.lhs] = apply_step_split(
            buffers[step.lhs], buffers[step.rhs], step, precision,
            mode=policy.modes[i] if policy is not None else None,
            precision_mode=(
                policy.precision_mode(i) if policy is not None else None
            ),
        )
        buffers[step.rhs] = None
        i += 1
    return buffers[program.result_slot]
