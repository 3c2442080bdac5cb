"""Chunked, slice-batched execution of sliced contraction programs (the
port's copy of ``tnc_tpu.ops.chunked``, the reference's default sliced
executor).

- The program is **split into chunks** of at most ``chunk_steps`` steps,
  and each chunk gets its own kernel policy: chains of small steps are
  planned within a chunk (a chain never crosses a chunk boundary).
- Slices run in **batches of B**: every buffer that depends on a sliced
  leaf carries a leading batch axis ``(B, *stored)``, so each product is
  one batched product for B slices and the host issues each step once
  per batch instead of once per slice. Buffers that depend on no sliced
  leaf (unsliced leaves, the hoisted prelude's cached values) stay
  unbatched and are broadcast, never copied B times. The reference writes
  this with ``jax.vmap``; here the batch axis is explicit, because the
  hand kernels are launched through ``ctypes``, which ``torch.func.vmap``
  cannot batch.
- The batch sum is folded after the last chunk and accumulated across
  batches with Kahan compensation, on the real and imaginary parts apart.

Memory: a batch keeps B copies of each live batched intermediate, so B is
clamped to the device's memory (:mod:`tnc_tpu_torch.ops.budget`) and
then to the largest divisor of the slice count at or under it.

A plan (the chunks, their policies, which slots carry the batch axis and
which sliced leaves each chunk gathers) is built once per program and
cached. On the card each chunk is then captured as a CUDA graph for the
call's batch shape, the counterpart of the reference's per-chunk
``jax.jit`` (:mod:`tnc_tpu_torch.ops.graphs`): the first batch runs
eagerly, every later batch replays the chunks' graphs. A batch's slice
indices go into a static device buffer before it runs, and the last
chunk folds in the batch sum and the Kahan step, written into static
accumulators in place. The graphs live for the call.

Resilience (the reference's, ``tnc_tpu/ops/chunked.py:590-760``): each
batch is one retryable dispatch behind the ``chunked.batch`` fault point;
an out-of-memory error halves the batch (the failed shape's graphs and
their pool released first); ``TNC_TPU_CKPT`` checkpoints the Kahan
accumulator and the slice cursor between batches, and a restarted call
resumes from them bitwise (:func:`run_sliced_chunked_placed`).
"""

from __future__ import annotations

import logging
import threading
from collections import OrderedDict
from dataclasses import dataclass
from typing import Any, Sequence

import numpy as np

from tnc_tpu_torch.ops.program import ContractionProgram, PairStep
from tnc_tpu_torch.ops.sliced import SlicedProgram, kahan_step
from tnc_tpu_torch.resilience import checkpoint as _ckpt
from tnc_tpu_torch.resilience import retry as _retry
from tnc_tpu_torch.resilience.faultinject import fault_point

logger = logging.getLogger(__name__)


@dataclass(frozen=True)
class ProgramChunk:
    steps: tuple[PairStep, ...]
    in_slots: tuple[int, ...]  # slots read by this chunk (alive at entry)
    out_slots: tuple[int, ...]  # slots written here and still alive at exit


def split_program(
    program: ContractionProgram, chunk_steps: int
) -> list[ProgramChunk]:
    """Split ``program.steps`` into chunks with entry/exit slot lists.

    A slot is alive at step ``i`` if it will still be *read* at some step
    >= ``i`` (or it is the result slot).

    >>> from tnc_tpu_torch.builders.circuit_builder import Circuit
    >>> from tnc_tpu_torch.tensornetwork.tensordata import TensorData
    >>> from tnc_tpu_torch.contractionpath.paths import Greedy, OptMethod
    >>> c = Circuit(); reg = c.allocate_register(3)
    >>> c.append_gate(TensorData.gate("h"), [reg.qubit(0)])
    >>> for i in range(2):
    ...     c.append_gate(TensorData.gate("cx"), [reg.qubit(i), reg.qubit(i + 1)])
    >>> tn, _ = c.into_amplitude_network("111")
    >>> path = Greedy(OptMethod.GREEDY).find_path(tn).replace_path()
    >>> from tnc_tpu_torch.ops.program import build_program
    >>> program = build_program(tn, path)
    >>> chunks = split_program(program, 3)
    >>> len(chunks), sum(len(ch.steps) for ch in chunks) == len(program.steps)
    (3, True)
    """
    steps = program.steps
    n = len(steps)
    last_read: dict[int, int] = {program.result_slot: n}
    for i, st in enumerate(steps):
        last_read[st.lhs] = max(last_read.get(st.lhs, -1), i)
        last_read[st.rhs] = max(last_read.get(st.rhs, -1), i)
    last_read[program.result_slot] = n

    chunks: list[ProgramChunk] = []
    for a in range(0, n, chunk_steps):
        b = min(a + chunk_steps, n)
        read_here: list[int] = []
        written: set[int] = set()
        seen: set[int] = set()
        for i in range(a, b):
            st = steps[i]
            # a read is "from outside" if the slot wasn't written earlier
            # in this same chunk
            for slot in (st.lhs, st.rhs):
                if slot not in written and slot not in seen:
                    read_here.append(slot)
                    seen.add(slot)
            written.add(st.lhs)
        outs = tuple(
            sorted(s for s in written if last_read.get(s, -1) >= b)
        )
        chunks.append(ProgramChunk(steps[a:b], tuple(read_here), outs))
    return chunks


def _run_chunk(chunk: ProgramChunk, buffers: list, batched: set[int]) -> None:
    """Native-complex steps of one chunk, in place over ``buffers``;
    ``batched`` (the slots with a batch axis) gains every slot written
    from a batched operand."""
    from tnc_tpu_torch.ops.backends import apply_step

    for step in chunk.steps:
        a_b, b_b = step.lhs in batched, step.rhs in batched
        buffers[step.lhs] = apply_step(
            buffers[step.lhs], buffers[step.rhs], step, a_b, b_b)
        buffers[step.rhs] = None
        if a_b or b_b:
            batched.add(step.lhs)


@dataclass(frozen=True)
class ChunkPlan:
    """How one chunk runs for a batch of slices: its steps and kernel
    policy (``None`` outside split mode), the sliced leaves it gathers
    for the batch's slice indices (``leaf_in``: the slots it is the first
    to read), the slots that carry the batch axis when it starts
    (``batched_in``, the gathered leaves among them) and when it ends
    (``batched_out``). A chunk none of whose inputs is batched touches no
    sliced data: it runs once per batch, unbatched."""

    chunk: ProgramChunk
    policy: Any
    leaf_in: tuple[int, ...]
    batched_in: frozenset[int]
    batched_out: frozenset[int]


# plan cache: key -> list[ChunkPlan]. Locked: callers may run chunked
# executors from several threads.
_PLAN_CACHE: "OrderedDict[tuple, list[ChunkPlan]]" = OrderedDict()
_PLAN_CACHE_MAX = 64
_PLAN_CACHE_LOCK = threading.Lock()


def chunk_plan(
    sp: SlicedProgram,
    batch: int,
    chunk_steps: int,
    split_complex: bool,
    precision: str | None,
) -> list[ChunkPlan]:
    """The chunks of ``sp`` with their policies and batch bookkeeping,
    cached by the reference's key (program signature, batch, chunk size,
    split mode, precision, and the ``TNC_TPU_COMPLEX_MULT`` /
    ``TNC_TPU_DOT_PRECISION`` overrides in split mode)."""
    from tnc_tpu_torch.ops.split_complex import (
        complex_mult_key,
        dot_precision_key,
        plan_kernel_steps,
    )

    key = (
        sp.signature(),
        batch,
        chunk_steps,
        split_complex,
        precision,
        complex_mult_key() if split_complex else None,
        dot_precision_key() if split_complex else None,
    )
    with _PLAN_CACHE_LOCK:
        hit = _PLAN_CACHE.get(key)
        if hit is not None:
            _PLAN_CACHE.move_to_end(key)
            return hit

    fault_point("chunked.plan")
    chunks = split_program(sp.program, chunk_steps)
    num_inputs = sp.program.num_inputs
    # which slots carry a batch axis: sliced leaves, and anything computed
    # from a batched slot
    current = {slot for slot, info in enumerate(sp.slot_slices) if info}
    written_before: set[int] = set()
    plans = []
    for chunk in chunks:
        # a sliced-leaf slot read here for the first time is gathered for
        # the batch; a slot id below num_inputs that an earlier chunk
        # already wrote holds an intermediate (slots are reused as result
        # holders) and must not be gathered again
        leaf_in = tuple(
            slot
            for slot in chunk.in_slots
            if slot < num_inputs
            and sp.slot_slices[slot]
            and slot not in written_before
        )
        written_before.update(step.lhs for step in chunk.steps)
        batched_in = frozenset(s for s in chunk.in_slots if s in current)
        for step in chunk.steps:
            if step.lhs in current or step.rhs in current:
                current.add(step.lhs)
        policy = plan_kernel_steps(chunk.steps) if split_complex else None
        plans.append(ChunkPlan(chunk, policy, leaf_in, batched_in,
                               frozenset(current)))
    with _PLAN_CACHE_LOCK:
        _PLAN_CACHE[key] = plans
        while len(_PLAN_CACHE) > _PLAN_CACHE_MAX:
            _PLAN_CACHE.popitem(last=False)
    return plans


def slice_index_rows(slicing, lo: int, hi: int) -> np.ndarray:
    """``[hi - lo, n_sliced_legs]`` mixed-radix indices of slices
    ``lo..hi-1`` (the last sliced leg varies fastest).

    >>> from tnc_tpu_torch.contractionpath.slicing import Slicing
    >>> slice_index_rows(Slicing((7, 9), (2, 3)), 2, 5).tolist()
    [[0, 2], [1, 0], [1, 1]]
    """
    dims = slicing.dims
    rows = np.zeros((hi - lo, len(dims)), dtype=np.int64)
    s = np.arange(lo, hi)
    for pos in range(len(dims) - 1, -1, -1):
        rows[:, pos] = s % dims[pos]
        s //= dims[pos]
    return rows


def gather_slices(buf, info, rows):
    """The batch of slices of one sliced leaf: ``buf`` with its sliced axes
    (``info``: ((axis, slice_position), …)) pinned to each row of ``rows``
    (a ``(B, n_sliced_legs)`` index tensor on ``buf``'s device), as one
    dense ``(B, *remaining)`` tensor. Works on a (real, imag) pair too.

    >>> import torch
    >>> x = torch.arange(8).reshape(2, 2, 2)
    >>> gather_slices(x, ((0, 1), (2, 0)), torch.tensor([[1, 0], [0, 1]])).tolist()
    [[1, 3], [4, 6]]
    """
    if isinstance(buf, tuple):
        return tuple(gather_slices(p, info, rows) for p in buf)
    axes = [axis for axis, _ in info]
    rest = [d for d in range(buf.dim()) if d not in axes]
    return buf.permute(axes + rest)[tuple(rows[:, pos] for _, pos in info)]


def run_sliced_chunked_placed(
    sp: SlicedProgram,
    device_full: Sequence[Any],
    batch: int = 8,
    chunk_steps: int = 64,
    split_complex: bool = True,
    precision: str | None = "float32",
    dtype: str = "complex64",
    device=None,
    max_slices: int | None = None,
    hoist: bool = False,
    slice_range: tuple[int, int] | None = None,
    graphs: bool = True,
    ckpt: str | None = None,
    ckpt_data_digest: str | None = None,
):
    """Chunked slice-batched execution over already-placed device buffers
    (:func:`~tnc_tpu_torch.ops.backends.place_buffers`, never consumed);
    returns the accumulated result in stored shape, on the device (a
    (real, imag) pair in split mode).

    ``hoist=True`` computes the slice-invariant stem once (eagerly) and
    runs the chunked slice loop over the residual program only. ``batch``
    is clamped to the device's memory and then to the largest divisor of
    the summed slice count at or under it. ``max_slices`` keeps the first
    slices; ``slice_range=(lo, hi)`` sums the shard ``[lo, hi)``; the two
    exclude each other. ``graphs`` (on the card): replay one CUDA graph
    per chunk for every batch after the first; ``False`` runs every batch
    eagerly, with the same bits.

    Resilience, as the reference's executor has it. Each batch is one
    retryable dispatch (the ``chunked.batch`` fault point with ``start=``
    and ``batch=``, then the default
    :class:`~tnc_tpu_torch.resilience.retry.RetryPolicy`); an
    out-of-memory error halves the batch (``resilience.degrade.batch_shrink``),
    after releasing the graphs of the failed batch shape and their pool,
    and the same slices run again. ``ckpt`` (or ``TNC_TPU_CKPT``) arms
    slice-range checkpoints: the Kahan accumulator (sum and compensation
    of each part) is copied to the host after a batch when due
    (``TNC_TPU_CKPT_EVERY`` / ``TNC_TPU_CKPT_SECS``), a later call with the
    same signature (program, chunk size, split mode, precision, dtype,
    slice count, device and ``ckpt_data_digest``, the input data) writes
    it back into the static accumulators before its first batch and
    resumes at the saved cursor, bitwise equal to the uninterrupted run at
    the same batch; a finished run deletes its checkpoint. ``slice_range``
    excludes an explicit ``ckpt`` (an armed ``TNC_TPU_CKPT`` is ignored for
    a shard)."""
    import torch

    with torch.inference_mode():
        if hoist:
            from tnc_tpu_torch.ops.hoist import hoisted

            sp, device_full = hoisted(sp, device_full, split_complex, precision)
        return _run_chunked(sp, list(device_full), batch, chunk_steps, split_complex,
                            precision, dtype, device, max_slices, slice_range, graphs,
                            ckpt, ckpt_data_digest)


def resolve_batch(
    sp: SlicedProgram,
    batch: int,
    split_complex: bool = True,
    dtype: str = "complex64",
    device=None,
    max_slices: int | None = None,
    slice_range: tuple[int, int] | None = None,
) -> tuple[int, int, int]:
    """``(batch, lo, hi)``: the slice batch a chunked run of ``sp`` uses
    for the slices ``[lo, hi)`` it sums — the request clamped to the
    device's memory, then to the largest divisor of ``hi - lo`` at or
    under it."""
    from tnc_tpu_torch.ops.budget import clamp_slice_batch

    num = sp.slicing.num_slices
    batch = clamp_slice_batch(
        sp.program,
        batch,
        device=device,
        split_complex=split_complex,
        dtype_bytes=8 if "128" in str(dtype) else 4,
    )
    lo = 0
    if slice_range is not None:
        if max_slices is not None:
            raise ValueError("slice_range and max_slices are exclusive")
        lo = max(0, int(slice_range[0]))
        num = min(int(slice_range[1]), num)
        lo = min(lo, num)
    elif max_slices is not None:
        num = max(1, min(num, max_slices))
    span = max(num - lo, 1)
    batch = max(1, min(batch, span))
    while span % batch:  # largest divisor <= requested (dims are tiny)
        batch -= 1
    return batch, lo, num


def _flatten_acc(acc) -> list:
    """The Kahan accumulator (a (sum, compensation) pair per part: real
    and imaginary in split mode) → the checkpoint payload, host arrays
    ``[sum, comp, ...]`` part by part (the reference's ``[sr, cr, si,
    ci]``)."""
    return [t.cpu().numpy() for pair in acc for t in pair]


def _restore_acc(acc, arrays) -> None:
    """Write a checkpoint payload (:func:`_flatten_acc`) back into the
    static accumulators, in place."""
    import torch

    flat = [t for pair in acc for t in pair]
    if len(arrays) != len(flat):
        raise ValueError(f"checkpoint holds {len(arrays)} arrays for {len(flat)} accumulators")
    for t, a in zip(flat, arrays):
        t.copy_(torch.from_numpy(np.ascontiguousarray(a)).reshape(t.shape))


def _run_chunked(sp, device_full, batch, chunk_steps, split_complex, precision,
                 dtype, device, max_slices, slice_range, graphs=True, ckpt=None,
                 ckpt_data_digest=None):
    import torch

    from tnc_tpu_torch import obs
    from tnc_tpu_torch.ops import graphs as _graphs
    from tnc_tpu_torch.ops.backends import _run_steps
    from tnc_tpu_torch.ops.split_complex import run_split_units

    if sp.slicing.num_slices <= 1:
        # a program of one slice has no batch axis to reduce over: run it
        # straight, under its own kernel policy
        buffers = list(device_full)
        if split_complex:
            from tnc_tpu_torch.ops.split_complex import plan_kernels, run_steps_split

            return run_steps_split(sp.program, buffers, precision,
                                   policy=plan_kernels(sp.program))
        return _run_steps(sp.program, buffers)
    if slice_range is not None and ckpt is not None:
        raise ValueError("slice_range and ckpt are exclusive")
    batch, lo, num = resolve_batch(sp, batch, split_complex, dtype, device,
                                   max_slices, slice_range)
    first = device_full[0][0] if split_complex else device_full[0]
    rows_all = torch.from_numpy(slice_index_rows(sp.slicing, lo, num)).to(first.device)
    stored_shape = sp.program.stored_result_shape
    result_slot = sp.program.result_slot

    # slice-range checkpointing: the signature covers everything that
    # changes the accumulation except the batch (the cursor is a slice
    # index, valid at any batch alignment)
    ckpt_path = _ckpt.resolve_ckpt(ckpt) if slice_range is None else None
    mgr = None
    resumed = None
    cursor = lo
    if ckpt_path is not None:
        sig = _ckpt.signature_hash(
            "chunked-v1", sp.signature(), chunk_steps, split_complex,
            precision, str(dtype), num, str(first.device), ckpt_data_digest,
        )
        mgr = _ckpt.SliceCheckpoint(ckpt_path, sig)
        loaded = mgr.load()
        if loaded is not None:
            cursor, resumed = loaded
            cursor = max(lo, min(int(cursor), num))

    plans = chunk_plan(sp, batch, chunk_steps, split_complex, precision)
    if not plans:
        # zero-step program: the result is the (sliced) leaf itself — sum
        # its slices
        leaf = device_full[result_slot]
        info = sp.slot_slices[result_slot]
        parts = leaf if split_complex else (leaf,)
        total = tuple(gather_slices(p, info, rows_all).sum(0).reshape(stored_shape)
                      for p in parts)
        return total if split_complex else total[0]

    parts = [p.dtype for p in device_full[0]] if split_complex else [first.dtype]
    # static state every batch updates in place: a (sum, compensation)
    # pair per part (real and imaginary in split mode)
    acc = [(torch.zeros(stored_shape, dtype=dt, device=first.device),
            torch.zeros(stored_shape, dtype=dt, device=first.device)) for dt in parts]
    if resumed is not None:
        _restore_acc(acc, resumed)

    def units(b: int, rows, plans_b):
        """One batch of ``b`` slices as a unit per chunk, reading the
        batch's slice indices from the static ``rows``."""
        res_batched = result_slot in plans_b[-1].batched_out
        buffers: list = []

        def chunk(ci: int, cp: ChunkPlan):
            def run() -> None:
                if ci == 0:  # every batch starts from the resident leaves
                    buffers[:] = device_full
                for slot in cp.leaf_in:
                    buffers[slot] = gather_slices(device_full[slot], sp.slot_slices[slot],
                                                  rows)
                batched = set(cp.batched_in)
                if split_complex:
                    # the chunk's policy spans are relative to the chunk: a
                    # chain is one fused_chain launch for the whole batch
                    run_split_units(cp.chunk.steps, buffers, precision, cp.policy,
                                    batched=batched)
                else:
                    _run_chunk(cp.chunk, buffers, batched)
                if ci == len(plans_b) - 1:
                    out = buffers[result_slot]
                    buffers[result_slot] = None
                    # the batch sum in the working precision, then one Kahan
                    # step a batch: the batches' partial sums cancel far
                    # below each term
                    for (s, c), x in zip(acc, out if split_complex else (out,)):
                        kahan_step(s, c, (x.sum(0) if res_batched else x * b)
                                   .reshape(stored_shape))

            return run

        return [(f"chunk {ci}", chunk(ci, cp)) for ci, cp in enumerate(plans_b)]

    # one runner per batch shape: the planned batch, a tail after an
    # unaligned resume, a halved batch after an out-of-memory error
    runners: dict[int, tuple] = {}

    def runner_for(b: int):
        got = runners.get(b)
        if got is None:
            rows = torch.empty_like(rows_all[:b])
            plans_b = plans if b == batch else chunk_plan(
                sp, b, chunk_steps, split_complex, precision)
            got = runners[b] = (rows, _graphs.BatchRunner(first.device,
                                                          units(b, rows, plans_b), graphs))
        return got

    sync = _retry.sync_dispatch() and first.device.type == "cuda"
    while cursor < num:
        b = min(batch, num - cursor)
        rows, runner = runner_for(b)
        start = _graphs.mark(first.device)

        def one_batch(_cursor=cursor, _b=b, _rows=rows, _runner=runner) -> str:
            fault_point("chunked.batch", start=_cursor, batch=_b)
            _rows.copy_(rows_all[_cursor - lo:_cursor - lo + _b])
            tag = _runner.run()
            if sync:
                torch.cuda.synchronize(first.device)
            return tag

        try:
            # a transient failure retries the same batch: nothing is
            # accumulated until the last chunk's Kahan step
            tag = _retry.retry_call(one_batch, label="chunked.batch")
        except Exception as exc:  # noqa: BLE001 — classified below
            if (_retry.classify_exception(exc) is _retry.FailureClass.RESOURCE
                    and batch > 1):
                # OOM rung: release the failed shapes' graphs and pool,
                # halve the batch, run the same slices again
                for _, dead in runners.values():
                    dead.release()
                runners.clear()
                if first.device.type == "cuda":
                    torch.cuda.empty_cache()
                batch = max(1, batch // 2)
                logger.warning("chunked batch hit a resource error (%s); degrading the "
                               "slice batch to %d", exc, batch)
                obs.counter_add("resilience.degrade.batch_shrink")
                obs.gauge_set("resilience.degrade.batch", batch)
                plans = chunk_plan(sp, batch, chunk_steps, split_complex, precision)
                continue
            raise
        if start is not None:
            _graphs.BATCH_EVENTS.append((tag, start, _graphs.mark(first.device)))
        cursor += b
        if mgr is not None:
            mgr.maybe_save(cursor, lambda: _flatten_acc(acc))
    if mgr is not None:
        mgr.finalize()
    total = tuple(s + c for s, c in acc)
    return total if split_complex else total[0]


def execute_sliced_batched(
    sp: SlicedProgram,
    arrays: Sequence[Any],
    batch: int = 8,
    chunk_steps: int = 64,
    split_complex: bool = True,
    precision: str | None = "float32",
    dtype: str = "complex64",
    device=None,
    max_slices: int | None = None,
    host: bool = True,
    hoist: bool = False,
    slice_range: tuple[int, int] | None = None,
    graphs: bool = True,
    ckpt: str | None = None,
):
    """Run a sliced program as chunked, slice-batched steps on ``device``.

    Places the host ``arrays`` on the device and returns the accumulated
    result: a complex numpy array in ``result_shape``, or with
    ``host=False`` the device-resident accumulator in **stored** shape (a
    (real, imag) pair in split mode). Arguments as in
    :func:`run_sliced_chunked_placed`; a checkpoint's data digest is taken
    from the host ``arrays``."""
    from tnc_tpu_torch.ops.backends import place_buffers

    if sp.slicing.num_slices <= 1:
        raise ValueError(
            "execute_sliced_batched expects a sliced program; "
            "use TorchBackend.execute for unsliced networks"
        )
    # the input data's digest from the HOST arrays: a structurally
    # identical program over other leaf data must not cross-resume
    digest = (_ckpt.arrays_digest(arrays)
              if slice_range is None and _ckpt.resolve_ckpt(ckpt) is not None else None)
    device_full = place_buffers(arrays, dtype, split_complex, device)
    acc = run_sliced_chunked_placed(
        sp, device_full, batch=batch, chunk_steps=chunk_steps,
        split_complex=split_complex, precision=precision, dtype=dtype,
        device=device, max_slices=max_slices, hoist=hoist, slice_range=slice_range,
        graphs=graphs, ckpt=ckpt, ckpt_data_digest=digest,
    )
    if not host:
        return acc
    if split_complex:
        from tnc_tpu_torch.ops.split_complex import combine_array

        return combine_array(acc[0], acc[1]).reshape(sp.program.result_shape)
    return acc.cpu().numpy().reshape(sp.program.result_shape)
