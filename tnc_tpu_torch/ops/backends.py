"""Execution backends for compiled contraction programs (the port's
counterpart of ``tnc_tpu.ops.backends``):

- :class:`NumpyBackend` — the host oracle, complex128 numpy.
- :class:`TorchBackend` — PyTorch on the GPU (or, when asked, the CPU):
  the steps run eagerly, each intermediate freed as soon as its step
  consumed it (the placed leaves live until the dispatch ends, so that a
  retried dispatch can run again). On the GPU the default is
  split-complex mode — every tensor a (real, imag) float32 pair, steps
  planned by the kernel ladder of
  :mod:`tnc_tpu_torch.ops.split_complex` (chains of small steps through
  the hand-written ``fused_chain`` kernel, the stem step through Strassen,
  the rest through the Gauss identity).

Both run sliced programs (:meth:`Backend.execute_sliced`): the numpy
oracle loops on the host; :class:`TorchBackend` keeps the full leaves on
the device and, by default, runs the reference's default sliced path —
the slice-invariant stem once (:mod:`tnc_tpu_torch.ops.hoist`), then the
residual in chunks batched over slices (:mod:`tnc_tpu_torch.ops.chunked`)
— or, with ``sliced_strategy="loop"``, one slice at a time. Both run a
program over a leading batch axis carried by some slots
(:meth:`~TorchBackend.execute_batched`; the amplitude sweeps and the
serving layer's bra batches).

Every :class:`TorchBackend` run is one retryable dispatch
(:meth:`TorchBackend._dispatch`: the ``backend.dispatch`` fault point and
the shared :class:`~tnc_tpu_torch.resilience.retry.RetryPolicy`); the
chunked executor retries each slice batch, halves the batch on an
out-of-memory error and checkpoints under ``TNC_TPU_CKPT``.
"""

from __future__ import annotations

import logging
from typing import Any, Sequence

import numpy as np

from tnc_tpu_torch.ops.program import ContractionProgram, batch_rows, prep_kl

logger = logging.getLogger(__name__)


class Backend:
    name: str = "base"
    #: ``execute_sliced`` takes ``ckpt=`` and ``on_slice=`` (per-slice
    #: checkpoints and cooperative preemption): the numpy oracle only
    supports_slice_hooks: bool = False

    def execute(self, program: ContractionProgram, arrays: Sequence[Any]) -> np.ndarray:
        raise NotImplementedError

    def execute_sliced(
        self,
        sp,
        arrays: Sequence[Any],
        max_slices: int | None = None,
        host: bool = True,
        hoist: bool | None = None,
        slice_range: tuple[int, int] | None = None,
    ):
        """Sum a :class:`~tnc_tpu_torch.ops.sliced.SlicedProgram` over its
        slices. ``max_slices`` caps the sum to the first slices;
        ``slice_range=(lo, hi)`` sums only that contiguous shard (the two
        exclude each other). ``host=False`` returns the result in
        **stored** shape, where it was computed. ``hoist=True`` runs the
        slice-invariant stem once and loops only the residual program;
        ``None`` takes the backend's own setting."""
        raise NotImplementedError


def apply_step(a: Any, b: Any, step, a_batched: bool = False, b_batched: bool = False) -> Any:
    """One pairwise contraction of native (complex) arrays — numpy arrays
    or torch tensors alike: prep each operand (view + macro permute +
    reshape), fold it to a ``(k, free)`` matrix, one matmul.
    ``a_batched`` / ``b_batched`` (torch tensors only): that side is
    ``(B, *stored)``, a leading slice-batch axis, and so is the result;
    an unbatched side is broadcast over the batch, not copied."""
    (x,) = prep_kl((a,), step.a_view, step.a_perm, step.a_dot, step.a_cfirst, a_batched)
    (y,) = prep_kl((b,), step.b_view, step.b_perm, step.b_dot, step.b_cfirst, b_batched)
    out = (y.swapaxes(-1, -2) @ x) if step.swap else (x.swapaxes(-1, -2) @ y)
    lead = (batch_rows(a, b, a_batched, b_batched),) if a_batched or b_batched else ()
    return out.reshape(lead + tuple(step.out_store))


def _run_steps(program: ContractionProgram, buffers: list[Any]) -> Any:
    """Execute all steps; returns the result in **stored** shape."""
    for step in program.steps:
        buffers[step.lhs] = apply_step(buffers[step.lhs], buffers[step.rhs], step)
        buffers[step.rhs] = None  # free eagerly
    return buffers[program.result_slot]


def dtype_width(dtype) -> float:
    """Element width in bytes of a backend dtype (a name, a numpy dtype,
    anything ``np.dtype`` accepts, or a torch dtype): the one rule the
    predicted-bytes counts share (step spans, prelude and residual bytes).
    Split-complex pairs carry the bytes of the complex dtype they stand
    for, so no special case.

    >>> dtype_width("complex64"), dtype_width(np.complex128)
    (8.0, 16.0)
    """
    try:
        return float(np.dtype(dtype).itemsize)
    except TypeError:
        return 16.0 if "128" in str(dtype) else 8.0


def run_steps_timed(
    program: ContractionProgram,
    buffers: list[Any],
    policy=None,
    sync: bool = False,
    precision=None,
    dtype_bytes: float | None = None,
    split_complex: bool | None = None,
) -> tuple[Any, list[dict]]:
    """Run a program one launch unit at a time, timing each: one record per
    step, and one per fused chain (whose record sums its steps' flops).
    Returns ``(result, records)``; the result in stored shape. Buffers are
    (real, imag) pairs, run through :func:`~tnc_tpu_torch.ops.split_complex.
    run_steps_split` under ``policy``, or native complex tensors or numpy
    arrays, run step by step (``policy`` then ignored). ``split_complex``
    says which of the two the buffers are; ``None`` reads it from them, and
    a value that disagrees with them raises.

    A record holds ``label`` (``step[i] MxK·KxN``, or ``step[s..e] chain
    xN``), ``mode`` (the arithmetic that ran: ``chain``, or what
    :func:`~tnc_tpu_torch.ops.split_complex.resolved_step_mode` gives;
    ``naive`` for native complex), the predicted ``flops`` (complex
    multiply-adds), ``bytes_in`` and ``bytes_out`` at ``dtype_bytes`` bytes
    per complex element (``None``: the buffers' own width; operands read,
    their prep pass, the result written; a chain reads its operands and
    writes its last result), ``ms`` and
    ``host_ms``. ``host_ms`` is the host's time to issue the unit. On a CUDA
    buffer ``ms`` is the time between CUDA events recorded on the current
    stream before and after the unit — device time when the stream is ahead
    of the host (a caller that queues ``torch.cuda._sleep`` first makes it
    so), else the host's issue time shows in it — read after one
    synchronise at the end; on the host it is wall time, as ``host_ms``.

    While :func:`tnc_tpu_torch.obs.enabled`, each unit also runs inside one
    ``obs`` span named by the record's label and carrying the reference's
    arguments: ``executor`` (``"numpy"`` for numpy arrays, else
    ``"torch"``), ``flops``, ``bytes_in``, ``bytes_out``, ``bucket``,
    ``mode``, ``precision``, ``flops_effective`` and, for a chain,
    ``steps``. These are the samples :mod:`tnc_tpu_torch.obs.calibrate`
    fits. ``sync`` closes each span after ``torch.cuda.synchronize()`` on a
    CUDA buffer, so its time is the host's wall for issuing the unit plus
    the device's for running it (the reference's ``block_until_ready``
    span); a record's ``ms`` and ``host_ms`` are taken before that
    synchronise.
    """
    import functools
    import math
    import time

    from tnc_tpu_torch import obs
    from tnc_tpu_torch.ops.program import step_elems, step_flops, step_label
    from tnc_tpu_torch.ops.split_complex import (
        effective_step_flops,
        fused_transpose_runtime_ineligible_reason,
        resolved_step_mode,
        run_steps_split,
        step_bucket,
    )

    first = next(b for b in buffers if b is not None)
    split = isinstance(first, tuple)
    part = first[0] if split else first
    if isinstance(part, np.ndarray):
        executor, on_cuda = "numpy", False
        complex_bytes = float(part.itemsize)
    else:
        import torch

        executor, on_cuda = "torch", part.device.type == "cuda"
        complex_bytes = float(part.element_size())
    if split_complex is not None and bool(split_complex) != split:
        raise ValueError(
            f"split_complex={split_complex} but the buffers are "
            f"{'(real, imag) pairs' if split else 'complex arrays'}")
    if split:
        complex_bytes *= 2
    else:
        policy = None
    if dtype_bytes is not None:
        complex_bytes = float(dtype_bytes)
    steps = program.steps
    chains = set(policy.chains) if policy is not None else set()

    def mark():
        if on_cuda:
            event = torch.cuda.Event(enable_timing=True)
            event.record()
            return event
        return time.perf_counter()

    def operand_elems(view, perm, ops) -> float:
        return (3.0 if perm is not None or ops else 1.0) * float(math.prod(view))

    def record_of(start: int, end: int) -> tuple[dict, dict]:
        """The unit's record and its span's other arguments."""
        rung = (policy.precision_mode(start) if policy is not None else "") or "default"
        if (start, end) in chains:
            group = steps[start:end]
            head = group[0]
            elems_in = operand_elems(head.a_view, head.a_perm, head.a_ops) + operand_elems(
                head.b_view, head.b_perm, head.b_ops)
            run_slot = head.lhs
            for st in group[1:]:
                if st.lhs == run_slot:
                    elems_in += operand_elems(st.b_view, st.b_perm, st.b_ops)
                else:
                    elems_in += operand_elems(st.a_view, st.a_perm, st.a_ops)
                run_slot = st.lhs
            flops = sum(step_flops(st) for st in group)
            return ({"label": f"step[{start}..{end - 1}] chain x{len(group)}",
                     "mode": "chain", "flops": flops,
                     "bytes_in": elems_in * complex_bytes,
                     "bytes_out": step_elems(group[-1])[1] * complex_bytes},
                    # the calibrated chain ceiling can pull medium-bucket
                    # steps into a chain: the heaviest member's bucket
                    {"bucket": step_bucket(max(group, key=step_flops)),
                     "precision": rung, "flops_effective": flops,
                     "steps": len(group)})
        step = steps[start]
        if not split:
            resolved = "naive"
        else:
            resolved = resolved_step_mode(
                step, policy.modes[start] if policy is not None else None)
            if resolved == "fused_transpose" and fused_transpose_runtime_ineligible_reason(
                    buffers[step.lhs], buffers[step.rhs], step) is not None:
                resolved = "naive"  # the kernel's runtime gate routes it
        elems_in, elems_out = step_elems(step, mode=resolved)
        return ({"label": step_label(start, step), "mode": resolved,
                 "flops": step_flops(step), "bytes_in": elems_in * complex_bytes,
                 "bytes_out": elems_out * complex_bytes},
                {"bucket": step_bucket(step), "precision": rung,
                 "flops_effective": effective_step_flops(step, resolved)})

    pending = []

    def on_unit(start: int, end: int, run) -> None:
        record, extra = record_of(start, end)
        with obs.span(record["label"], executor=executor, flops=record["flops"],
                      bytes_in=record["bytes_in"], bytes_out=record["bytes_out"],
                      mode=record["mode"], **extra):
            h0, t0 = time.perf_counter(), mark()
            run()
            t1, host_s = mark(), time.perf_counter() - h0
            if sync and on_cuda:
                torch.cuda.synchronize(part.device)
        pending.append((record, t0, t1, host_s))

    if split:
        out = run_steps_split(program, buffers, precision, policy=policy, on_unit=on_unit)
    else:
        def run_one(i: int) -> None:
            step = steps[i]
            buffers[step.lhs] = apply_step(buffers[step.lhs], buffers[step.rhs], step)
            buffers[step.rhs] = None  # free eagerly

        for i in range(len(steps)):
            on_unit(i, i + 1, functools.partial(run_one, i))
        out = buffers[program.result_slot]
    if on_cuda:
        torch.cuda.synchronize(part.device)
    records = []
    for record, t0, t1, host_s in pending:
        record["ms"] = t0.elapsed_time(t1) if on_cuda else (t1 - t0) * 1e3
        record["host_ms"] = host_s * 1e3
        records.append(record)
    return out, records


def place_buffers(
    arrays: Sequence[Any],
    dtype,
    split_complex: bool,
    device,
) -> list[Any]:
    """Host arrays → device tensors: complex tensors as-is, or (real,
    imag) float pairs in split mode (float64 parts for complex128)."""
    import torch

    complex_dtype = _complex_dtype(dtype)
    if split_complex:
        part = torch.float64 if complex_dtype == torch.complex128 else torch.float32
        out = []
        for a in arrays:
            a = np.asarray(a)
            out.append((
                torch.from_numpy(np.ascontiguousarray(a.real)).to(device=device, dtype=part),
                torch.from_numpy(np.ascontiguousarray(a.imag)).to(device=device, dtype=part),
            ))
        return out
    return [
        torch.from_numpy(np.asarray(a)).to(device=device, dtype=complex_dtype)
        for a in arrays
    ]


def resolve_device(device=None, who: str = "TorchBackend"):
    """The ``torch.device`` an entry point runs on: ``None`` means
    ``"cuda"``, or the host when the caller asked for it with
    ``TNC_TPU_PLATFORM=cpu`` (:mod:`tnc_tpu_torch.utils.logging_config`).
    A CUDA device raises ``RuntimeError`` when CUDA is absent (nothing
    falls back to the host) and turns TF32 off for matmuls and cuDNN, so
    complex64 products keep full FP32. ``who`` names the caller in the
    error."""
    import torch

    from tnc_tpu_torch.utils.logging_config import pinned_device

    device = torch.device(pinned_device() if device is None else device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"{who}: CUDA is not available; pass device='cpu' "
                "to run on the host"
            )
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return device


def _complex_dtype(dtype):
    import torch

    if dtype in ("complex128", np.complex128, torch.complex128):
        return torch.complex128
    if dtype in ("complex64", np.complex64, torch.complex64):
        return torch.complex64
    raise ValueError(f"unsupported dtype {dtype!r}: complex64 or complex128")


def _batched_slots(batched: Sequence[int]) -> list[int]:
    batched = list(batched)
    if not batched:
        raise ValueError(
            "execute_batched needs at least one batched slot; "
            "use execute() for unbatched programs"
        )
    return batched


class NumpyBackend(Backend):
    """The host oracle: every step a numpy matmul in ``dtype`` (complex128
    by default; ``np.complex64`` gives a single-precision oracle)."""

    name = "numpy"

    def __init__(self, dtype=np.complex128):
        self.dtype = np.dtype(dtype)

    def execute(
        self,
        program: ContractionProgram,
        arrays: Sequence[Any],
        step_spans: bool | None = None,
    ) -> np.ndarray:
        """``step_spans``: per-step timing spans (:func:`run_steps_timed`,
        tagged ``executor="numpy"``). Default (``None``) — on whenever
        tracing is on (the oracle is synchronous, so the timing is exact and
        costs no sync); ``False`` turns them off."""
        from tnc_tpu_torch import obs

        buffers = [np.asarray(a, dtype=self.dtype) for a in arrays]
        if obs.enabled() and (step_spans is None or step_spans):
            out, _ = run_steps_timed(program, buffers, dtype_bytes=dtype_width(self.dtype))
        else:
            out = _run_steps(program, buffers)
        return np.asarray(out).reshape(program.result_shape)

    def execute_batched(
        self,
        program: ContractionProgram,
        arrays: Sequence[Any],
        batched: Sequence[int],
    ) -> np.ndarray:
        """Host counterpart of :meth:`TorchBackend.execute_batched`: the
        slots in ``batched`` carry a leading ``(B, ...)`` axis, every
        other slot is shared. The batch leg is threaded through the step
        list (:mod:`tnc_tpu_torch.ops.batched`) so each touched step runs
        as one stacked matmul — per-entry results bit-compare to B
        sequential :meth:`execute` calls. As in the reference, a program
        whose batched operand meets a staged prep plan runs the
        sequential loop instead. Returns ``(B,) + result_shape``.
        ``batched`` must name at least one slot."""
        from tnc_tpu_torch.ops.batched import run_steps_batched, stacked_rows, thread_batch

        batched = _batched_slots(batched)
        b = int(np.asarray(arrays[batched[0]]).shape[0])
        flags, threadable = thread_batch(program, batched)
        if threadable:
            buffers = [np.asarray(a, dtype=self.dtype) for a in arrays]
            out = run_steps_batched(program, buffers, flags)
            return np.asarray(out).reshape((b,) + tuple(program.result_shape))
        return stacked_rows(
            lambda per: self.execute(program, per),
            list(arrays), batched, b, program.result_shape,
        )

    supports_slice_hooks = True

    def execute_sliced(
        self,
        sp,
        arrays: Sequence[Any],
        max_slices: int | None = None,
        host: bool = True,
        hoist: bool | None = None,
        slice_range: tuple[int, int] | None = None,
        ckpt: str | None = None,
        on_slice=None,
    ) -> np.ndarray:
        """The oracle of a sliced program, in ``dtype``
        (:func:`~tnc_tpu_torch.ops.sliced.execute_sliced_numpy`).
        ``host=False`` returns the result in **stored** shape, as the
        device backend does. ``hoist`` defaults to off, as in the
        reference: the plain loop is the oracle the hoisted executors are
        held against. ``ckpt`` / ``on_slice`` (``supports_slice_hooks``):
        slice-boundary checkpointing and cooperative preemption."""
        from tnc_tpu_torch.ops.sliced import execute_sliced_numpy

        out = execute_sliced_numpy(
            sp, arrays, dtype=self.dtype, max_slices=max_slices, hoist=bool(hoist),
            slice_range=slice_range, ckpt=ckpt, on_slice=on_slice,
        )
        if not host:
            return out.reshape(sp.program.stored_result_shape)
        return out


#: precision names the backend accepts. ``float32`` is the reference's
#: HIGHEST; ``high`` and ``default`` also run full FP32 in this port
#: (never TF32 — 3xTF32 for ``high`` is later work).
PRECISIONS = (None, "default", "high", "float32", "highest")


class TorchBackend(Backend):
    """Eager whole-program execution with PyTorch.

    ``device=None`` means ``"cuda"``; if CUDA is absent the constructor
    raises — it never falls back to the CPU. Pass ``device="cpu"`` to run
    on the host (the tests do). ``split_complex=None`` means split on
    CUDA and native complex on the CPU.

    Sliced programs (:meth:`execute_sliced`) run, as the reference's
    ``JaxBackend`` runs them by default, with ``hoist=True`` (the
    slice-invariant stem once) and ``sliced_strategy="chunked"``: the
    residual in chunks of at most ``chunk_steps`` steps, ``slice_batch``
    slices at a time (:mod:`tnc_tpu_torch.ops.chunked`, the batch clamped
    to the device's memory). ``sliced_strategy="loop"`` runs one slice at
    a time instead.

    On CUDA the constructor turns TF32 off for matmuls and cuDNN
    (``torch.backends.cuda.matmul.allow_tf32 = False``,
    ``torch.backends.cudnn.allow_tf32 = False``): every ``precision`` runs
    true FP32, the hand kernels FP32 FMA.

    >>> from tnc_tpu_torch.tensornetwork.tensor import CompositeTensor, LeafTensor
    >>> from tnc_tpu_torch.tensornetwork.tensordata import TensorData
    >>> from tnc_tpu_torch.contractionpath.paths import Greedy, OptMethod
    >>> from tnc_tpu_torch.ops.program import build_program, flat_leaf_tensors
    >>> tn = CompositeTensor([
    ...     LeafTensor([0], [2], TensorData.matrix(np.array([1.0, 2.0]))),
    ...     LeafTensor([0], [2], TensorData.matrix(np.array([3.0, 4.0])))])
    >>> program = build_program(tn, Greedy(OptMethod.GREEDY).find_path(tn).replace_path())
    >>> arrays = [l.data.into_data() for l in flat_leaf_tensors(tn)]
    >>> complex(TorchBackend(device="cpu", split_complex=True).execute(program, arrays))
    (11+0j)
    """

    name = "torch"

    def __init__(
        self,
        dtype="complex64",
        device=None,
        split_complex: bool | None = None,
        precision: str | None = "float32",
        sliced_strategy: str = "chunked",
        slice_batch: int = 8,
        chunk_steps: int = 64,
        hoist: bool = True,
    ):
        self.device = resolve_device(device, "TorchBackend")
        if precision not in PRECISIONS:
            raise ValueError(f"unknown precision {precision!r}: one of {PRECISIONS}")
        self.dtype = dtype
        _complex_dtype(dtype)  # validate
        if split_complex is None:
            split_complex = self.device.type != "cpu"
        self.split_complex = split_complex
        self.precision = precision
        if sliced_strategy not in ("loop", "chunked"):
            raise ValueError(f"unknown sliced_strategy {sliced_strategy!r}")
        self.sliced_strategy = sliced_strategy
        self.slice_batch = slice_batch
        self.chunk_steps = chunk_steps
        self.hoist = hoist
        self._policy_cache: dict[tuple, Any] = {}
        self._fit: tuple | None = None  # (cost model,) once fitted

    def kernel_policy(self, program: ContractionProgram):
        """The kernel promotion ladder for ``program`` (split mode only;
        ``None`` otherwise), planned once per (program, env override) from
        the backend's cost model (:meth:`cost_model`) and cached, so the
        policy does not change between calls as new step samples arrive.
        A fault in the fit raises."""
        if not self.split_complex:
            return None
        from tnc_tpu_torch.ops.split_complex import (
            complex_mult_key,
            dot_precision_key,
            plan_kernels,
        )

        key = (program.signature(), complex_mult_key(), dot_precision_key())
        policy = self._policy_cache.get(key)
        if policy is None:
            policy = plan_kernels(program, cost_model=self.cost_model())
            self._policy_cache[key] = policy
        return policy

    def cost_model(self):
        """The cost model every policy of this backend is planned from:
        :meth:`~tnc_tpu_torch.obs.calibrate.CalibratedCostModel.
        from_registry` fitted to the registry's step spans at the first
        call and kept for the backend's life (``None`` — the no-model
        ladder — when no fit was possible then)."""
        if self._fit is None:
            from tnc_tpu_torch.obs.calibrate import CalibratedCostModel

            self._fit = (CalibratedCostModel.from_registry(),)
        return self._fit[0]

    def policy_key(self) -> tuple:
        """What decides how :meth:`kernel_policy` routes a program's steps
        (and so which bits it gives): the ``TNC_TPU_COMPLEX_MULT`` /
        ``TNC_TPU_DOT_PRECISION`` overrides and the constants of the
        backend's :meth:`cost_model` (``None``: the no-model ladder). Empty
        outside split mode. Part of the reuse store's environment key
        (:func:`~tnc_tpu_torch.serve.reuse.backend_env_key`)."""
        if not self.split_complex:
            return ()
        from tnc_tpu_torch.ops.split_complex import complex_mult_key, dot_precision_key

        model = self.cost_model()
        fit = (None if model is None
               else (model.flops_per_s, model.dispatch_s, model.bytes_per_s))
        return (complex_mult_key(), dot_precision_key(), fit)

    def _device_buffers(self, arrays: Sequence[Any]) -> list[Any]:
        return place_buffers(arrays, self.dtype, self.split_complex, self.device)

    def _dispatch(self, run):
        """One dispatch under the reference's retry frame
        (``tnc_tpu/ops/backends.py:450-475``): the ``backend.dispatch``
        fault point, then ``run()`` under the default
        :class:`~tnc_tpu_torch.resilience.retry.RetryPolicy` — a TRANSIENT
        failure runs it again after a backoff, a RESOURCE or FATAL one
        (a sticky CUDA error among them) re-raises at once. Under
        ``TNC_TPU_SYNC_DISPATCH`` the device is synchronised inside the
        guarded region, so an asynchronous CUDA failure surfaces there.
        ``run`` must start from inputs it does not consume. With no fault
        the frame costs two calls and a bool check."""
        from tnc_tpu_torch.resilience import retry as _retry
        from tnc_tpu_torch.resilience.faultinject import fault_point

        def attempt():
            fault_point("backend.dispatch")
            out = run()
            if self.device.type == "cuda" and _retry.sync_dispatch():
                import torch

                torch.cuda.synchronize(self.device)
            return out

        return _retry.default_policy().run(attempt, label="backend.dispatch")

    def _run(self, program: ContractionProgram, buffers: list[Any]):
        """Run ``program`` on ``buffers`` under :meth:`kernel_policy`, one
        retryable dispatch (:meth:`_dispatch`; each attempt runs on its own
        copy of the buffer list, whose tensors no step writes). With
        tracing and ``TNC_TPU_STEP_TIME`` on, one launch unit at a time
        through :func:`run_steps_timed` with ``sync``, each unit's span a
        measured sample for the calibration fit."""
        import torch

        from tnc_tpu_torch import obs

        if obs.enabled() and obs.step_timing_enabled():
            def timed():
                with torch.inference_mode():
                    out, _ = run_steps_timed(
                        program, list(buffers), self.kernel_policy(program), sync=True,
                        precision=self.precision, dtype_bytes=dtype_width(self.dtype),
                        split_complex=self.split_complex,
                    )
                return out

            return self._dispatch(timed)
        return self._dispatch(lambda: self._run_untimed(program, list(buffers)))

    def _run_untimed(self, program: ContractionProgram, buffers: list[Any]):
        import torch

        with torch.inference_mode():
            if self.split_complex:
                from tnc_tpu_torch.ops.split_complex import run_steps_split

                return run_steps_split(
                    program, buffers, self.precision,
                    policy=self.kernel_policy(program),
                )
            return _run_steps(program, buffers)

    def execute(self, program: ContractionProgram, arrays: Sequence[Any]) -> np.ndarray:
        result = self.execute_on_device(program, arrays)
        if self.split_complex:
            from tnc_tpu_torch.ops.split_complex import combine_array

            return combine_array(*result).reshape(program.result_shape)
        return result.cpu().numpy().reshape(program.result_shape)

    def execute_on_device(self, program: ContractionProgram, arrays: Sequence[Any]):
        """Like :meth:`execute` but leaves the result on the device (a
        (real, imag) pair in split mode), in **stored** shape
        (``program.stored_result_shape``) with axes in
        ``program.result_legs`` order."""
        buffers = self._device_buffers(arrays)
        return self._run(program, buffers)

    def execute_batched(
        self,
        program: ContractionProgram,
        arrays: Sequence[Any],
        batched: Sequence[int],
    ) -> np.ndarray:
        """Run ``program`` once over a leading batch axis carried by the
        slots in ``batched`` (their arrays are stacked ``(B, ...)``; every
        other slot is shared) — B network evaluations in one pass, the
        counterpart of the reference's ``vmap``-ed program. Returns ``(B,)
        + result_shape``.

        The batch leg is written out as a leading axis of every buffer a
        batched slot reaches; an unbatched operand of a batched step is
        broadcast, never copied per row, and a step (or chain) the axis
        never reaches runs once. In split mode the steps run under
        :meth:`kernel_policy` (:func:`~tnc_tpu_torch.ops.split_complex.
        run_split_units` with the batched slots): a chain that touches a
        batched slot is one batched ``fused_chain`` launch, a forced
        ``fused`` step one batched ``fused_complex_dot`` launch. Natively,
        :func:`~tnc_tpu_torch.ops.batched.run_steps_batched`. Unlike
        :meth:`NumpyBackend.execute_batched`, nothing falls back to a
        per-row loop: the staged prep plans that make the reference's
        threading infeasible are not run by this executor."""
        import torch

        batched = _batched_slots(batched)
        placed = self._device_buffers(arrays)

        def run():
            buffers = list(placed)
            with torch.inference_mode():
                if self.split_complex:
                    from tnc_tpu_torch.ops.split_complex import (
                        combine_array,
                        run_split_units,
                    )

                    run_split_units(program.steps, buffers, self.precision,
                                    self.kernel_policy(program), batched=set(batched))
                    return combine_array(*buffers[program.result_slot])
                from tnc_tpu_torch.ops.batched import run_steps_batched, thread_batch

                flags, _ = thread_batch(program, batched)
                return run_steps_batched(program, buffers, flags).cpu().numpy()

        out = self._dispatch(run)
        return out.reshape((-1,) + tuple(program.result_shape))

    def execute_sliced(
        self,
        sp,
        arrays: Sequence[Any],
        max_slices: int | None = None,
        host: bool = True,
        hoist: bool | None = None,
        slice_range: tuple[int, int] | None = None,
        graphs: bool = True,
        ckpt: str | None = None,
    ):
        """Sum a sliced program over its slices on the device.

        The full leaves are placed on the device once. ``hoist`` (``None``:
        the backend's setting) runs the slice-invariant stem once
        (:func:`~tnc_tpu_torch.ops.hoist.run_prelude`) and only the
        residual program per slice. Under ``sliced_strategy="chunked"`` the
        slices then run in batches through
        :func:`~tnc_tpu_torch.ops.chunked.run_sliced_chunked_placed`; under
        ``"loop"`` one at a time, the whole loop one dispatch under the
        ``backend.dispatch`` retry frame (:meth:`_dispatch`): each slice pins the sliced axes of the
        leaves that carry them (a dense copy of the slice), runs every step
        under the no-model ladder — one policy, planned once a call for
        all slices, as the reference's loop plans it — and is added to the
        sum with Kahan compensation, on the real and imaginary parts apart
        in split mode.

        ``max_slices`` caps the sum to the first slices (at least one);
        ``slice_range=(lo, hi)`` sums the shard ``[lo, hi)``; the two
        exclude each other. A program of one slice runs :meth:`execute`
        (:meth:`execute_on_device` with ``host=False``). ``host=False``
        returns the stored-shape result on the device, a (real, imag)
        pair in split mode.

        ``graphs`` (on the card): the unit each batch or slice runs is
        captured once as a CUDA graph and replayed for every later one
        (one graph per chunk, or one of the per-slice body;
        :mod:`tnc_tpu_torch.ops.graphs`), the first batch or slice and the
        prelude running eagerly; ``False`` runs everything eagerly, with
        the same bits.

        ``ckpt`` (or ``TNC_TPU_CKPT``; chunked strategy): slice-range
        checkpoints of the chunked executor, keyed by the program, the
        run's parameters and a digest of the host ``arrays``; a call that
        finds its checkpoint resumes at the saved cursor
        (:func:`~tnc_tpu_torch.ops.chunked.run_sliced_chunked_placed`).
        Unlike :class:`NumpyBackend` the backend has no per-slice
        ``on_slice`` hook (``supports_slice_hooks`` is False, as on the
        reference's ``JaxBackend``).
        """
        if slice_range is not None and max_slices is not None:
            raise ValueError("slice_range and max_slices are exclusive")
        if slice_range is None and sp.slicing.num_slices == 1:
            if not host:
                return self.execute_on_device(sp.program, arrays)
            return self.execute(sp.program, arrays)
        digest = None
        if self.sliced_strategy == "chunked" and slice_range is None:
            from tnc_tpu_torch.resilience import checkpoint as _ckpt

            if _ckpt.resolve_ckpt(ckpt) is not None:
                digest = _ckpt.arrays_digest(arrays)
        result = self.run_sliced_placed(
            sp, self._device_buffers(arrays), max_slices=max_slices, hoist=hoist,
            slice_range=slice_range, graphs=graphs, ckpt=ckpt, ckpt_data_digest=digest)
        if not host:
            return result
        if self.split_complex:
            from tnc_tpu_torch.ops.split_complex import combine_array

            return combine_array(*result).reshape(sp.program.result_shape)
        return result.cpu().numpy().reshape(sp.program.result_shape)

    def run_sliced_placed(
        self,
        sp,
        full: list[Any],
        max_slices: int | None = None,
        hoist: bool | None = None,
        slice_range: tuple[int, int] | None = None,
        graphs: bool = True,
        ckpt: str | None = None,
        ckpt_data_digest: str | None = None,
    ):
        """The slice sum of :meth:`execute_sliced` over leaves ``full``
        already placed on this backend's device (:meth:`_device_buffers`,
        never consumed), under the backend's strategy; the stored-shape
        result on the device, a (real, imag) pair in split mode. The
        distributed executors run each device's share of the slices
        through it. ``ckpt_data_digest`` names the host data for the
        chunked executor's checkpoints."""
        from tnc_tpu_torch.ops.sliced import slice_bounds

        if hoist is None:
            hoist = self.hoist
        if self.sliced_strategy == "chunked" and sp.slicing.num_slices > 1:
            from tnc_tpu_torch.ops.chunked import run_sliced_chunked_placed

            return run_sliced_chunked_placed(
                sp, full, batch=self.slice_batch, chunk_steps=self.chunk_steps,
                split_complex=self.split_complex, precision=self.precision,
                dtype=self.dtype, device=self.device, max_slices=max_slices,
                hoist=hoist, slice_range=slice_range, graphs=graphs,
                ckpt=ckpt, ckpt_data_digest=ckpt_data_digest,
            )
        lo, hi = slice_bounds(sp.slicing.num_slices, max_slices, slice_range)
        if hoist:
            import torch

            from tnc_tpu_torch.ops.hoist import hoisted

            with torch.inference_mode():
                sp, full = hoisted(sp, full, self.split_complex, self.precision)
        # the loop is one retryable dispatch, as a program is
        # (:meth:`_dispatch`); it never consumes ``full``
        return self._dispatch(lambda: self._run_sliced(sp, full, lo, hi, graphs))

    def slice_buffers(self, sp, full: list[Any], row) -> list[Any]:
        """The buffer list of one slice over resident leaves ``full``
        (placed by :meth:`_device_buffers`): a leaf with sliced axes gives
        a dense copy of its slice, gathered at ``row`` (the slice's
        ``(1, n_sliced_legs)`` index tensor on the device,
        :func:`~tnc_tpu_torch.ops.chunked.slice_index_rows`), any other
        leaf itself. The indices are read on the device, so a captured
        run follows what ``row`` holds at each replay. The list is the
        slice's own, to be consumed by one run of the program."""
        from tnc_tpu_torch.ops.chunked import gather_slices

        def pin(buf, info):
            if not info:
                return buf
            if self.split_complex:
                return tuple(p[0] for p in gather_slices(buf, info, row))
            return gather_slices(buf, info, row)[0]

        return [pin(buf, info) for buf, info in zip(full, sp.slot_slices)]

    def _run_sliced(self, sp, full: list[Any], lo: int, hi: int, graphs: bool = True):
        """Kahan sum of slices ``[lo, hi)`` over resident leaves ``full``
        (never consumed); stored shape. Each slice is one run of a body
        that pins its slice (:meth:`slice_buffers` at a static one-row
        index on the device), runs the program under the backend's policy
        and takes the Kahan step into static accumulators; ``graphs`` (on the card): slice ``lo`` runs it
        eagerly, slices ``lo + 1`` to ``hi - 1`` replay its CUDA graph."""
        import torch

        from tnc_tpu_torch.ops.chunked import slice_index_rows
        from tnc_tpu_torch.ops.graphs import run_batches
        from tnc_tpu_torch.ops.sliced import kahan_step
        from tnc_tpu_torch.ops.split_complex import plan_kernels, run_steps_split

        # the no-model ladder, as the reference's slice loop plans it
        policy = plan_kernels(sp.program) if self.split_complex else None
        like = full[0][0] if self.split_complex else full[0]
        shape = sp.program.stored_result_shape
        hi = max(lo, hi)
        with torch.inference_mode():
            rows_all = torch.from_numpy(slice_index_rows(sp.slicing, lo, hi)).to(self.device)
            row = torch.empty_like(rows_all[:1])
            # a (sum, compensation) pair per part: real and imaginary in split mode
            acc = [
                (torch.zeros(shape, dtype=like.dtype, device=self.device),
                 torch.zeros(shape, dtype=like.dtype, device=self.device))
                for _ in range(2 if self.split_complex else 1)
            ]

            def body() -> None:
                buffers = self.slice_buffers(sp, full, row)
                if self.split_complex:
                    contrib = run_steps_split(sp.program, buffers, self.precision,
                                              policy=policy)
                else:
                    contrib = (_run_steps(sp.program, buffers),)
                for (s, c), x in zip(acc, contrib):
                    kahan_step(s, c, x)

            run_batches(self.device, [("the slice body", body)], hi - lo,
                        lambda i: row.copy_(rows_all[i:i + 1]), graphs)
            total = tuple(s + c for s, c in acc)
        return total if self.split_complex else total[0]

    def bind_resident(self, program: ContractionProgram, arrays: Sequence[Any],
                      graphs: bool = True):
        """Place ``arrays`` on the device once and return a callable that
        runs the program on those resident inputs and returns the
        device-resident result (stored shape). The inputs are never
        consumed, so the callable can be called any number of times.
        ``graphs`` (on the card): the first call runs eagerly, the second
        captures the program as one CUDA graph and replays it, every later
        call replays; each returns a fresh copy of the output
        (:class:`~tnc_tpu_torch.ops.graphs.BoundProgram`)."""
        from tnc_tpu_torch.ops.graphs import BoundProgram

        buffers = self._device_buffers(arrays)
        return BoundProgram(lambda: self._run_untimed(program, list(buffers)),
                            self.device, graphs)


_BACKENDS: dict[str, Backend] = {}


def get_backend(name: str | Backend | None = None) -> Backend:
    """Resolve a backend by name (``numpy``, ``torch``), instance, or
    default (``None``: ``torch``, i.e. :class:`TorchBackend` on the GPU,
    which raises without CUDA). The complex128 host oracle runs only when
    asked for by name or instance."""
    if isinstance(name, Backend):
        return name
    if name is None:
        name = "torch"
    backend = _BACKENDS.get(name)
    if backend is None:
        if name == "numpy":
            backend = NumpyBackend()
        elif name == "torch":
            backend = TorchBackend()
        else:
            raise ValueError(f"Unknown backend '{name}'")
        _BACKENDS[name] = backend
    return backend
