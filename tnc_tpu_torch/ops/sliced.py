"""Sliced contraction execution (the port's copy of ``tnc_tpu.ops.sliced``).

A :class:`SlicedProgram` pairs a reduced-metadata
:class:`~tnc_tpu_torch.ops.program.ContractionProgram` (sliced legs
removed) with indexing instructions describing, for each input, which
axes are fixed per slice. Execution sums the program's result over all
slice index combinations.

On the GPU :meth:`~tnc_tpu_torch.ops.backends.TorchBackend.execute_sliced`
runs it: by default the slice-invariant stem once
(:mod:`tnc_tpu_torch.ops.hoist`), then the residual chunked and batched
over slices (:mod:`tnc_tpu_torch.ops.chunked`); or, as the ``loop``
strategy, one slice at a time. Either way the full leaves stay resident
on the card and the partial results are summed with Kahan compensation.
:func:`execute_sliced_numpy` is the complex128 host oracle; it and the
chunked executor checkpoint their cursor and accumulator under
``TNC_TPU_CKPT`` (:mod:`tnc_tpu_torch.resilience.checkpoint`) and resume
bit-identically.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

import numpy as np

from tnc_tpu_torch.contractionpath.contraction_path import ContractionPath
from tnc_tpu_torch.contractionpath.slicing import Slicing
from tnc_tpu_torch.ops.backends import _run_steps
from tnc_tpu_torch.ops.program import ContractionProgram, build_program
from tnc_tpu_torch.tensornetwork.tensor import CompositeTensor, LeafTensor


@dataclass(frozen=True)
class SlicedProgram:
    program: ContractionProgram  # over slice-reduced shapes
    slicing: Slicing
    # per input slot: ((axis_in_original_tensor, slice_position), ...)
    # ordered by axis, where slice_position indexes slicing.legs
    slot_slices: tuple[tuple[tuple[int, int], ...], ...]

    def signature(self) -> tuple:
        return (self.program.signature(), self.slicing, self.slot_slices)

    def signature_digest(self) -> str:
        """Stable hex digest of :meth:`signature` (the shared canonical
        encoder) — what a plan-cache record persists on disk."""
        from tnc_tpu_torch.utils.digest import stable_digest

        return stable_digest(self.signature())


class SliceYield(Exception):
    """A sliced execution yielded voluntarily at a checkpoint boundary
    (``on_slice`` returned True): the partial accumulator is persisted
    (when a checkpoint is armed) and ``cursor`` names the next slice to
    run. Re-invoking the same call resumes bit-identically from the
    checkpoint. Not an error: the caller chose to be interrupted."""

    def __init__(self, cursor: int):
        super().__init__(f"sliced execution yielded at slice {cursor}")
        self.cursor = int(cursor)


def build_sliced_program(
    tn: CompositeTensor, contract_path: ContractionPath, slicing: Slicing
) -> SlicedProgram:
    """Compile ``tn``'s path with ``slicing.legs`` removed from every leaf."""
    removed = set(slicing.legs)
    position = {leg: k for k, leg in enumerate(slicing.legs)}

    slot_slices: list[tuple[tuple[int, int], ...]] = []

    def reduce_tensor(t: LeafTensor) -> LeafTensor:
        info = tuple(
            (axis, position[leg])
            for axis, leg in enumerate(t.legs)
            if leg in removed
        )
        slot_slices.append(info)
        return LeafTensor(
            [l for l in t.legs if l not in removed],
            [d for l, d in t.edges() if l not in removed],
            t.data,
        )

    def reduce_network(tensors: Sequence) -> CompositeTensor:
        out = CompositeTensor()
        # First pass: leaves in order (matching build_program slot order),
        # composites recursed afterwards in index order.
        reduced_children: list = []
        for child in tensors:
            if isinstance(child, CompositeTensor):
                reduced_children.append(None)
            else:
                reduced_children.append(reduce_tensor(child))
        for idx, child in enumerate(tensors):
            if isinstance(child, CompositeTensor):
                reduced_children[idx] = reduce_network(child.tensors)
        for c in reduced_children:
            out.push_tensor(c)
        return out

    if contract_path.nested:
        raise ValueError("Sliced execution expects a flat path")

    reduced_tn = reduce_network(tn.tensors)
    program = build_program(reduced_tn, contract_path)
    return SlicedProgram(program, slicing, tuple(slot_slices))


def kahan_add(s, c, x):
    """One compensated (Kahan) accumulation step over arrays or tensors.

    Returns ``(s', c')`` with ``s' + c'`` carrying the running sum to ~2
    ulp *independent of the number of steps* — the slice loop adds up
    contributions whose total cancels to orders of magnitude below the
    individual terms (a single Sycamore amplitude vs per-slice partial
    sums), where plain float32 accumulation loses the 1e-5 parity target.
    PyTorch runs each operation eagerly as written, so nothing
    reassociates the compensation away.

    >>> import numpy as np
    >>> s = c = np.float32(1.0)
    >>> c = np.float32(0.0)
    >>> for _ in range(100):          # plain f32 sum would stay at 1.0
    ...     s, c = kahan_add(s, c, np.float32(1e-8))
    >>> 9e-07 < float(s + c) - 1.0 < 1.1e-06
    True
    """
    y = x + c
    t = s + y
    return t, y - (t - s)


def kahan_step(s, c, x) -> None:
    """:func:`kahan_add` written into the tensors ``s`` and ``c`` in place,
    so the same bits: a captured executor accumulates into static tensors
    this way.

    >>> import torch
    >>> s, c = torch.ones(()), torch.zeros(())
    >>> for _ in range(100):
    ...     kahan_step(s, c, torch.tensor(1e-8))
    >>> want = (torch.ones(()), torch.zeros(()))
    >>> for _ in range(100):
    ...     want = kahan_add(*want, torch.tensor(1e-8))
    >>> bool(s == want[0]) and bool(c == want[1])
    True
    """
    t, comp = kahan_add(s, c, x)
    c.copy_(comp)
    s.copy_(t)


def index_buffer(arr, info, indices):
    """Pin ``arr``'s sliced axes to the given slice ``indices`` — a numpy
    array or a torch tensor, by basic indexing (a view of ``arr``).

    ``info`` is the slot's ``slot_slices`` entry: ((axis, slice_pos), …)
    ordered by axis.

    >>> index_buffer(np.arange(8).reshape(2, 2, 2), ((0, 1), (2, 0)), [1, 0]).tolist()
    [1, 3]
    """
    view = arr
    for offset, (axis, pos) in enumerate(info):
        view = view[(slice(None),) * (axis - offset) + (int(indices[pos]),)]
    return view


def _slice_indices(slicing: Slicing, s: int) -> list[int]:
    """Mixed-radix decomposition of flat slice id ``s``."""
    idx = []
    for d in reversed(slicing.dims):
        idx.append(s % d)
        s //= d
    idx.reverse()
    return idx


def slice_bounds(
    num_slices: int,
    max_slices: int | None = None,
    slice_range: tuple[int, int] | None = None,
) -> tuple[int, int]:
    """``(lo, hi)``: the slice ids a sliced run sums, ``[lo, hi)``.
    ``max_slices`` keeps the first slices (at most ``num_slices``, at least
    one); ``slice_range`` a contiguous shard, clamped to the slices there
    are. The two exclude each other.

    >>> slice_bounds(128), slice_bounds(128, max_slices=8), slice_bounds(4, slice_range=(2, 9))
    ((0, 128), (0, 8), (2, 4))
    """
    if slice_range is not None:
        if max_slices is not None:
            raise ValueError("slice_range and max_slices are exclusive")
        return max(0, int(slice_range[0])), min(int(slice_range[1]), num_slices)
    if max_slices is not None:
        return 0, max(1, min(num_slices, int(max_slices)))
    return 0, num_slices


def execute_sliced_numpy(
    sp: SlicedProgram,
    arrays: Sequence[np.ndarray],
    max_slices: int | None = None,
    hoist: bool = False,
    slice_range: tuple[int, int] | None = None,
    ckpt: str | None = None,
    on_slice=None,
) -> np.ndarray:
    """CPU oracle: python loop over slices, sum of the program's complex128
    results.

    ``max_slices`` caps the loop (partial sum over the first slices).
    ``slice_range=(lo, hi)``: partial sum over slice ids ``[lo, hi)``
    only; mutually exclusive with ``max_slices``. ``hoist=True`` computes
    the slice-invariant stem once and loops only the residual program (the
    same steps in the same order, just not once per slice).

    ``ckpt`` (or ``TNC_TPU_CKPT``) arms slice-range checkpointing: the
    partial sum and cursor persist (``TNC_TPU_CKPT_EVERY`` slices or
    ``TNC_TPU_CKPT_SECS`` seconds apart) and an interrupted run resumes
    bit-identically (:mod:`tnc_tpu_torch.resilience.checkpoint`); the
    signature covers the program, the summed slices, ``hoist`` and the
    input data, so a range shard or another bitstring never resumes this
    one. ``on_slice``: optional ``cb(next_cursor) -> bool`` called after
    every slice but the last; returning True saves a checkpoint (when
    armed) and raises :class:`SliceYield` — cooperative preemption at a
    slice boundary. The fault point ``sliced.slice`` (``s=``) precedes
    every slice.
    """
    from tnc_tpu_torch.resilience import checkpoint as _ckpt
    from tnc_tpu_torch.resilience.faultinject import fault_point

    lo, hi = slice_bounds(sp.slicing.num_slices, max_slices, slice_range)
    full = [np.asarray(a, dtype=np.complex128) for a in arrays]
    if hoist:
        from tnc_tpu_torch.ops.hoist import hoisted

        sp, full = hoisted(sp, full)
    acc = np.zeros(sp.program.stored_result_shape, dtype=np.complex128)
    mgr = None
    start = lo
    ckpt_path = _ckpt.resolve_ckpt(ckpt)
    if ckpt_path is not None:
        # arrays_digest: the program signature is structural — the same
        # circuit with other leaf data (another bitstring) must not
        # cross-resume; a range shard carries its bounds
        if slice_range is not None:
            sig = _ckpt.signature_hash(
                "numpy-range-v1", sp.signature(), "complex128", lo, hi, hoist,
                _ckpt.arrays_digest(arrays),
            )
        else:
            sig = _ckpt.signature_hash(
                "numpy-v1", sp.signature(), "complex128", hi, hoist,
                _ckpt.arrays_digest(arrays),
            )
        mgr = _ckpt.SliceCheckpoint(ckpt_path, sig)
        loaded = mgr.load()
        if loaded is not None:
            start, (saved,) = loaded
            start = max(lo, min(int(start), hi))
            acc = np.asarray(saved, dtype=np.complex128)
    for s in range(start, hi):
        fault_point("sliced.slice", s=s)
        indices = _slice_indices(sp.slicing, s)
        buffers = [
            index_buffer(arr, info, indices)
            for arr, info in zip(full, sp.slot_slices)
        ]
        acc = acc + _run_steps(sp.program, buffers)
        if mgr is not None:
            mgr.maybe_save(s + 1, lambda _a=acc: [_a])
        if on_slice is not None and s + 1 < hi and on_slice(s + 1):
            if mgr is not None:
                mgr.save(s + 1, [acc])
            raise SliceYield(s + 1)
    if mgr is not None:
        mgr.finalize()
    return acc.reshape(sp.program.result_shape)
