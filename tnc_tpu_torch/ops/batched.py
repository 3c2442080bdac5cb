"""Batch-leg threading through compiled contraction programs (the port's
counterpart of ``tnc_tpu.ops.batched``).

Given a :class:`~tnc_tpu_torch.ops.program.ContractionProgram` and a set
of input slots that carry a leading batch axis, :func:`thread_batch`
marks, per :class:`~tnc_tpu_torch.ops.program.PairStep`, which operands
carry the axis (exactly the steps downstream of a batched slot), and
:func:`run_steps_batched` executes the program with each touched step
issued as ONE stacked matmul — the unbatched operand broadcast, never
copied per row — and the steps the axis never reaches run once.

The step is the port's :func:`~tnc_tpu_torch.ops.backends.apply_step`,
which takes the batch flags itself, on numpy arrays and native complex
torch tensors alike. On numpy it forms the same views and issues the
same matmuls as the reference's ``apply_step_batched``, so a batch of B
bit-compares to the reference's batched run (and, per row, to B
sequential executions) — the contract ``NumpyBackend.execute_batched``
and the serving layer (:mod:`tnc_tpu_torch.serve.rebind`) rely on.
Split-complex (real, imag) buffers take the kernel ladder instead
(:meth:`~tnc_tpu_torch.ops.backends.TorchBackend.execute_batched`).
"""

from __future__ import annotations

from typing import Any, Iterable, Sequence

import numpy as np

from tnc_tpu_torch.ops.backends import apply_step
from tnc_tpu_torch.ops.program import ContractionProgram


def thread_batch(
    program: ContractionProgram, batched_slots: Iterable[int]
) -> tuple[tuple[tuple[bool, bool], ...], bool]:
    """Propagate the batch leg through the program's steps.

    Returns ``(flags, feasible)``: ``flags[i] = (lhs_batched,
    rhs_batched)`` for step ``i``, and ``feasible`` is False when some
    step's batched operand has a staged prep plan (``a_ops``/``b_ops``),
    as in the reference. The port's executors ignore the staged plans, so
    only :class:`~tnc_tpu_torch.ops.backends.NumpyBackend` reads
    ``feasible`` (to keep the reference's fallback and its bits).

    >>> from tnc_tpu_torch.contractionpath.contraction_path import ContractionPath
    >>> from tnc_tpu_torch.ops.program import build_program
    >>> from tnc_tpu_torch.tensornetwork.tensor import CompositeTensor, LeafTensor
    >>> tn = CompositeTensor([LeafTensor.from_const([0], 2),
    ...                       LeafTensor.from_const([0], 2)])
    >>> program = build_program(tn, ContractionPath.simple([(0, 1)]))
    >>> thread_batch(program, [1])   # slot 1 carries the batch axis
    (((False, True),), True)
    """
    carried = set(batched_slots)
    flags: list[tuple[bool, bool]] = []
    feasible = True
    for st in program.steps:
        ab, bb = st.lhs in carried, st.rhs in carried
        if (ab and st.a_ops is not None) or (bb and st.b_ops is not None):
            feasible = False
        flags.append((ab, bb))
        if ab or bb:
            carried.add(st.lhs)
        else:
            carried.discard(st.lhs)
        carried.discard(st.rhs)
    return tuple(flags), feasible


def run_steps_batched(
    program: ContractionProgram,
    buffers: list[Any],
    flags: Sequence[tuple[bool, bool]],
) -> Any:
    """Execute all steps with the batch leg threaded per ``flags`` on
    native (complex) buffers, numpy arrays or torch tensors; the result in
    ``(B,) + stored`` shape. Consumed buffers are freed at once."""
    for st, (ab, bb) in zip(program.steps, flags):
        buffers[st.lhs] = apply_step(buffers[st.lhs], buffers[st.rhs], st, ab, bb)
        buffers[st.rhs] = None  # free eagerly
    return buffers[program.result_slot]


def stacked_rows(execute, buffers, batched_slots, b, result_shape):
    """Sequential stacked dispatch: run ``execute`` once per batch
    entry, selecting row ``i`` of each batched slot, and stack the
    results as ``(B,) + result_shape``. The one per-row loop, shared by
    the numpy executor's non-threadable fallback and the serving layer's
    sliced and generic-backend paths."""
    bset = set(batched_slots)
    rows = [
        np.asarray(
            execute([x[i] if s in bset else x for s, x in enumerate(buffers)])
        )
        for i in range(b)
    ]
    return np.stack(rows).reshape((b,) + tuple(result_shape))
