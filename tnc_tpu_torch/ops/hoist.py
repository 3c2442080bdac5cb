"""Slice-invariant stem hoisting for sliced contraction programs (the
port's copy of ``tnc_tpu.ops.hoist``).

A :class:`~tnc_tpu_torch.ops.sliced.SlicedProgram` re-runs its whole step
list once per slice-index combination, yet every step whose operands
contain no sliced leg (transitively — a value computed *from* a sliced
leaf is per-slice even after the sliced leg itself is contracted away)
produces the same output in all ``num_slices`` iterations. This module
splits the program into:

- an **invariant prelude** — the steps reachable only from unsliced
  inputs, executed exactly once; and
- a **per-slice residual** — a standard :class:`SlicedProgram` whose
  extra input slots are the prelude's cached intermediates, so every
  sliced executor (numpy oracle, the device loop, the chunked executor)
  runs it unchanged.

The marking pass is linear in the step count. Replace-path semantics
guarantee each intermediate value is consumed by exactly one step, so
the prelude/residual interface is a flat list of cached buffers.

Cost model: naive sliced execution costs ``num_slices * total_flops``;
hoisted execution costs ``invariant_flops + num_slices *
residual_flops``.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from functools import lru_cache
from typing import Any, Sequence

from tnc_tpu_torch.ops.program import ContractionProgram, PairStep, steps_flops
from tnc_tpu_torch.ops.sliced import SlicedProgram


@dataclass(frozen=True)
class PreludeStep:
    """One invariant contraction, remapped into the prelude slot space.

    ``step`` carries the shape metadata only — its baked-in ``lhs``/
    ``rhs`` slot ids refer to the *original* program and must not be
    used; ``out``/``lhs``/``rhs`` here are prelude slots. ``free_rhs``
    is False when the rhs value is a residual source and must survive
    the step (never the case for tree paths, kept for safety)."""

    out: int
    lhs: int
    rhs: int
    free_rhs: bool
    step: PairStep


@dataclass(frozen=True)
class HoistedProgram:
    """A sliced program split into (once-only prelude, per-slice residual).

    ``residual`` is a self-contained :class:`SlicedProgram` over a fresh
    input slot space; ``residual_sources[slot]`` says where each residual
    input comes from: ``("leaf", original_input_slot)`` for inputs the
    variant steps read directly (sliced leaves keep their slice-indexing
    info, unsliced leaves pass through), or ``("cached", prelude_slot)``
    for prelude intermediates. When the hoist degrades to a no-op
    (``prelude_steps == ()``), ``residual`` is the original program and
    every source is a pass-through leaf."""

    residual: SlicedProgram
    prelude_steps: tuple[PreludeStep, ...]
    prelude_num_slots: int
    # (prelude_slot, original_input_slot) for each prelude input
    prelude_inputs: tuple[tuple[int, int], ...]
    residual_sources: tuple[tuple[str, int], ...]

    @property
    def is_noop(self) -> bool:
        return not self.prelude_steps

    def signature(self) -> tuple:
        return (
            self.residual.signature(),
            self.prelude_steps,
            self.prelude_num_slots,
            self.prelude_inputs,
            self.residual_sources,
        )


@lru_cache(maxsize=128)
def hoist_sliced_program(sp: SlicedProgram) -> HoistedProgram:
    """Split ``sp`` into an invariant prelude and a per-slice residual.

    Degrades to a no-op (empty prelude, residual ``is`` the original
    program) when every step depends on a sliced leg, when no step does
    (``num_slices == 1`` programs), or when the program has no steps.

    >>> import numpy as np
    >>> from tnc_tpu_torch.contractionpath.contraction_path import ContractionPath
    >>> from tnc_tpu_torch.contractionpath.slicing import Slicing
    >>> from tnc_tpu_torch.ops.sliced import build_sliced_program
    >>> from tnc_tpu_torch.tensornetwork.tensor import CompositeTensor, LeafTensor
    >>> from tnc_tpu_torch.tensornetwork.tensordata import TensorData
    >>> rng = np.random.default_rng(0)
    >>> mk = lambda legs: LeafTensor(
    ...     legs, [4] * len(legs),
    ...     TensorData.matrix(rng.standard_normal([4] * len(legs))))
    >>> ring = CompositeTensor([mk([0, 1]), mk([1, 2]), mk([2, 3]),
    ...                         mk([3, 0])])
    >>> path = ContractionPath.simple([(0, 3), (0, 1), (0, 2)])
    >>> sp = build_sliced_program(ring, path, Slicing((2,), (4,)))
    >>> hp = hoist_sliced_program(sp)  # (0, 3) touches no sliced leg
    >>> len(hp.prelude_steps), len(hp.residual.program.steps)
    (1, 2)
    """
    prog = sp.program
    steps = prog.steps
    n = prog.num_inputs

    # --- marking pass: value-level variant propagation ------------------
    # value ids: ("leaf", slot) | ("step", index)
    variant: dict[tuple, bool] = {
        ("leaf", s): bool(sp.slot_slices[s]) for s in range(n)
    }
    cur: dict[int, tuple] = {s: ("leaf", s) for s in range(n)}
    operands: list[tuple[tuple, tuple]] = []
    step_variant: list[bool] = []
    for i, st in enumerate(steps):
        va, vb = cur[st.lhs], cur[st.rhs]
        is_var = variant[va] or variant[vb]
        operands.append((va, vb))
        step_variant.append(is_var)
        out = ("step", i)
        variant[out] = is_var
        cur[st.lhs] = out
        cur[st.rhs] = ("dead", i)

    if not steps or all(step_variant) or not any(step_variant):
        return HoistedProgram(
            residual=sp,
            prelude_steps=(),
            prelude_num_slots=0,
            prelude_inputs=(),
            residual_sources=tuple(("leaf", s) for s in range(n)),
        )

    # --- residual: variant steps remapped onto a fresh slot space -------
    res_slot_of: dict[tuple, int] = {}
    res_sources: list[tuple[str, Any]] = []
    res_slot_slices: list[tuple] = []
    res_steps: list[PairStep] = []

    def res_input(v: tuple) -> int:
        slot = len(res_sources)
        res_slot_of[v] = slot
        if v[0] == "leaf":
            res_sources.append(("leaf", v[1]))
            res_slot_slices.append(sp.slot_slices[v[1]])
        else:  # invariant intermediate: cached by the prelude
            res_sources.append(("cached", v))
            res_slot_slices.append(())
        return slot

    for i, st in enumerate(steps):
        if not step_variant[i]:
            continue
        va, vb = operands[i]
        la = res_slot_of.get(va)
        if la is None:
            la = res_input(va)
        lb = res_slot_of.get(vb)
        if lb is None:
            lb = res_input(vb)
        res_steps.append(replace(st, lhs=la, rhs=lb))
        res_slot_of[("step", i)] = la

    final_val = cur[prog.result_slot]
    if not variant[final_val]:
        raise AssertionError("variant steps exist, so the result is variant")
    residual_program = ContractionProgram(
        num_inputs=len(res_sources),
        steps=tuple(res_steps),
        result_slot=res_slot_of[final_val],
        result_legs=prog.result_legs,
        result_shape=prog.result_shape,
        stored_result_shape=prog.stored_result_shape,
        canonical_legs=prog.canonical_legs,
    )
    residual = SlicedProgram(
        residual_program, sp.slicing, tuple(res_slot_slices)
    )

    # --- prelude: invariant steps, replace-left over a compact space ----
    needed = {v for kind, v in res_sources if kind == "cached"}
    pslot: dict[tuple, int] = {}
    prelude_inputs: list[tuple[int, int]] = []
    prelude_steps: list[PreludeStep] = []
    nslots = 0

    def palloc() -> int:
        nonlocal nslots
        nslots += 1
        return nslots - 1

    for i, st in enumerate(steps):
        if step_variant[i]:
            continue
        va, vb = operands[i]
        for v in (va, vb):
            if v not in pslot:
                # every non-step operand of an invariant step is a leaf
                if v[0] != "leaf":
                    raise AssertionError(f"invariant step reads {v}")
                s = palloc()
                pslot[v] = s
                prelude_inputs.append((s, v[1]))
        la, lb = pslot[va], pslot[vb]
        # replace-left reuses la unless the consumed value must survive
        # for the residual (impossible on tree paths — defensive only)
        out_slot = palloc() if va in needed else la
        prelude_steps.append(
            PreludeStep(out_slot, la, lb, vb not in needed, st)
        )
        pslot[("step", i)] = out_slot

    patched_sources = tuple(
        (kind, pslot[ref] if kind == "cached" else ref)
        for kind, ref in res_sources
    )
    return HoistedProgram(
        residual=residual,
        prelude_steps=tuple(prelude_steps),
        prelude_num_slots=nslots,
        prelude_inputs=tuple(prelude_inputs),
        residual_sources=patched_sources,
    )


def run_prelude_steps(
    hp: HoistedProgram,
    prelude_buffers: Sequence[Any],
    split_complex: bool = False,
    precision=None,
) -> list[Any]:
    """Execute the prelude steps over ``prelude_buffers`` (one buffer per
    ``hp.prelude_inputs`` entry, in that order: (real, imag) tensor pairs
    in split mode, else complex numpy arrays or tensors) and return the
    cached intermediates in the order the ``("cached", …)`` entries appear
    in ``hp.residual_sources``.

    Split-mode prelude steps ride the kernel promotion ladder: the
    slice-invariant stem GEMMs this pass isolates are the big, square-ish
    shapes one Strassen level pays off on, so each step over the crossover
    runs gauss+strassen
    (:func:`tnc_tpu_torch.ops.split_complex.auto_step_mode`) unless a
    ``TNC_TPU_COMPLEX_MULT`` forcing override pins the mode."""
    if split_complex:
        from tnc_tpu_torch.ops.split_complex import apply_step_split, auto_step_mode

        def kernel(a, b, step):
            return apply_step_split(a, b, step, precision, mode=auto_step_mode(step))

    else:
        from tnc_tpu_torch.ops.backends import apply_step

        def kernel(a, b, step):
            return apply_step(a, b, step)

    buf: list[Any] = [None] * hp.prelude_num_slots
    for (slot, _), val in zip(hp.prelude_inputs, prelude_buffers):
        buf[slot] = val
    for ps in hp.prelude_steps:
        out = kernel(buf[ps.lhs], buf[ps.rhs], ps.step)
        if ps.free_rhs:
            buf[ps.rhs] = None
        buf[ps.out] = out
    return [
        buf[ref] for kind, ref in hp.residual_sources if kind == "cached"
    ]


def run_prelude(
    hp: HoistedProgram,
    arrays: Sequence[Any],
    split_complex: bool = False,
    precision=None,
) -> list[Any]:
    """Execute the prelude once and assemble the residual input buffers.

    ``arrays`` are the *original* program's full input buffers ((real,
    imag) pairs in split mode). Returns one buffer per residual input
    slot: pass-through leaves by reference, cached prelude intermediates
    freshly computed."""
    if hp.is_noop:
        return list(arrays)
    cached = iter(
        run_prelude_steps(
            hp,
            [arrays[orig] for _, orig in hp.prelude_inputs],
            split_complex,
            precision,
        )
    )
    return [
        arrays[ref] if kind == "leaf" else next(cached)
        for kind, ref in hp.residual_sources
    ]


def hoisted(
    sp: SlicedProgram,
    buffers: Sequence[Any],
    split_complex: bool = False,
    precision=None,
) -> tuple[SlicedProgram, list[Any]]:
    """``(program, buffers)`` for the slice loop of every sliced executor:
    the residual program and its input buffers, with the slice-invariant
    stem run once over ``buffers`` (the original program's full leaves,
    never consumed); a program with no stem to hoist comes back as it
    was."""
    hp = hoist_sliced_program(sp)
    if hp.is_noop:
        return sp, list(buffers)
    return hp.residual, run_prelude(hp, list(buffers), split_complex, precision)


def hoist_split_counts(sp: SlicedProgram) -> dict:
    """JSON-able summary of the hoist split — how many steps run once
    (prelude) vs per slice (residual), and the flops on each side."""
    hp = hoist_sliced_program(sp)
    invariant, residual = hoist_step_flops(sp)
    return {
        "prelude_steps": len(hp.prelude_steps),
        "residual_steps": len(hp.residual.program.steps),
        "invariant_flops": invariant,
        "residual_flops": residual,
    }


def hoist_step_flops(sp: SlicedProgram) -> tuple[float, float]:
    """(invariant_flops, per-slice residual_flops) of the compiled
    program, from the steps' dot shapes (naive multiply-add count per
    step: ``k * m * n``). Hoisted total cost is ``invariant + num_slices
    * residual``; the naive executor pays ``num_slices * (invariant +
    residual)``."""
    hp = hoist_sliced_program(sp)
    return (
        steps_flops(ps.step for ps in hp.prelude_steps),
        steps_flops(hp.residual.program.steps),
    )
