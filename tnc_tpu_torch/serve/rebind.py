"""Bra rebinding: many bitstrings through one planned program (the port's
counterpart of ``tnc_tpu.serve.rebind``).

An amplitude network's *structure* does not depend on the bitstring:
the path, the compiled :class:`~tnc_tpu_torch.ops.program.
ContractionProgram`, its signature and every gate leaf are shared by all
``2^n`` bitstrings; only the 2-element ⟨0|/⟨1| bra leaves differ. A
:class:`BoundProgram` is built once per circuit structure
(:func:`bind_template`) and each query swaps fresh bra values into the
bra slots — no replanning.

Batching: ``B`` bitstrings stack their one-hot bras along a new leading
batch leg, and each dispatch is one of:

- ``batched`` — a :class:`~tnc_tpu_torch.ops.backends.TorchBackend`, split
  or native: :meth:`~tnc_tpu_torch.ops.backends.TorchBackend.
  execute_batched`, the reference's ``vmap`` branch (no padding of the
  batch: eager PyTorch compiles nothing per batch size);
- ``threaded`` — :class:`~tnc_tpu_torch.ops.backends.NumpyBackend` on a
  threadable program: the leg threaded through the touched steps
  (:func:`~tnc_tpu_torch.ops.batched.run_steps_batched`); ``loop`` when
  it is not threadable;
- ``sliced`` — a structure planned under a ``target_size`` it exceeds:
  one slice-summed run per request (:func:`~tnc_tpu_torch.ops.batched.
  stacked_rows` over ``execute_sliced``);
- ``loop`` — any other backend: one ``execute`` per request.

:data:`DISPATCH` counts the dispatches by mode.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Iterable, Sequence

import numpy as np

from tnc_tpu_torch.builders.circuit_builder import BASIS_STATES, AmplitudeTemplate
from tnc_tpu_torch.ops.backends import Backend, NumpyBackend, TorchBackend
from tnc_tpu_torch.ops.batched import stacked_rows, thread_batch
from tnc_tpu_torch.ops.program import ContractionProgram, build_program, flat_leaf_tensors
from tnc_tpu_torch.ops.sliced import build_sliced_program

#: dispatches of :meth:`BoundProgram.amplitudes_det`, by mode (``threaded``,
#: ``batched``, ``sliced``, ``loop``)
DISPATCH: dict[str, int] = {}

_LATER = "ROADMAP A10 (serving hooks and resilience)"


def reset_dispatch() -> None:
    """Zero :data:`DISPATCH`."""
    DISPATCH.clear()


def _count(mode: str) -> None:
    DISPATCH[mode] = DISPATCH.get(mode, 0) + 1


def pow2_bucket(n: int) -> int:
    """Round a batch size up to the next power of two — the bucketing
    rule of batched serving shapes, so that traffic of many batch sizes
    runs a few shapes.

    >>> [pow2_bucket(n) for n in (1, 2, 3, 8, 9)]
    [1, 2, 4, 8, 16]
    """
    return 1 << max(int(n) - 1, 0).bit_length()


def stacked_bras(batch_bits: Sequence[str]) -> np.ndarray:
    """One-hot bra values for a batch: ``(B, n_det, 2)``, qubit order,
    from the builder's :data:`~tnc_tpu_torch.builders.circuit_builder.
    BASIS_STATES`.

    >>> stacked_bras(["01"]).tolist()[0]
    [[(1+0j), 0j], [0j, (1+0j)]]
    """
    return np.stack(
        [np.stack([BASIS_STATES[c] for c in bits]) for bits in batch_bits]
    )


@dataclass
class BoundProgram:
    """A compiled amplitude program with rebindable bra leaves.

    Built once per circuit *structure* (:func:`bind_template`); each
    :meth:`amplitudes` call swaps per-request bra values into the bra
    slots and dispatches — no replanning.
    """

    template: AmplitudeTemplate
    program: ContractionProgram
    arrays: list[np.ndarray]  # leaf data; bra slots hold placeholders
    bra_slots: tuple[int, ...]  # one per determined qubit, qubit order
    batch_flags: tuple[tuple[bool, bool], ...]
    threadable: bool  # batch leg threads through every touched step
    # the budget this structure was planned under
    target_size: float | None = None
    # a structure over its budget carries a sliced plan: each request runs
    # the slice loop (stacked dispatch; the batch leg stops here)
    sliced: Any = None  # SlicedProgram | None

    @property
    def result_shape(self) -> tuple[int, ...]:
        return tuple(self.program.result_shape)

    def _batch_buffers(
        self, batch_bits: Sequence[str], arrays: Sequence[np.ndarray]
    ) -> list[np.ndarray]:
        bras = stacked_bras(batch_bits)  # (B, n_det, 2)
        buffers = list(arrays)
        for i, slot in enumerate(self.bra_slots):
            buffers[slot] = np.ascontiguousarray(bras[:, i])
        return buffers

    def amplitudes(
        self,
        bitstrings: Sequence[str | Iterable],
        backend: Backend | None = None,
    ) -> np.ndarray:
        """Amplitudes for a batch of request bitstrings, one dispatch.

        Returns ``(B,) + result_shape`` (open-leg axes in the program's
        result-leg order — scalar amplitudes for fully determined
        templates). On the numpy backend the batched result
        bit-compares to B sequential singleton contractions.
        """
        return self.amplitudes_det(
            [self.template.request_bits(b) for b in bitstrings], backend
        )

    def amplitudes_det(
        self,
        batch_bits: Sequence[str],
        backend: Backend | None = None,
        slice_range: tuple[int, int] | None = None,
        ckpt: str | None = None,
        on_slice=None,
    ) -> np.ndarray:
        """:meth:`amplitudes` over already-validated determined-position
        bit strings (``template.request_bits`` output).

        ``backend=None`` is :class:`~tnc_tpu_torch.ops.backends.
        TorchBackend` on the card, which raises without CUDA (the
        reference takes its complex128 ``NumpyBackend``); pass
        ``NumpyBackend()`` or ``TorchBackend(device="cpu")`` for the host.

        ``slice_range=(lo, hi)`` (sliced structures only): each request's
        amplitude is the **partial sum** over that contiguous slice shard.

        ``ckpt`` / ``on_slice`` (slice checkpoints and preemption) are
        dropped on a backend without ``supports_slice_hooks``, as in the
        reference; no backend of the port has them yet (ROADMAP A10)."""
        if backend is None:
            backend = TorchBackend()
        if slice_range is not None and self.sliced is None:
            raise ValueError(
                "slice_range only applies to sliced structures "
                "(this bound program has no slicing)"
            )
        if not getattr(backend, "supports_slice_hooks", False):
            ckpt = None
            on_slice = None
        if not batch_bits:
            return np.zeros((0,) + self.result_shape, dtype=np.complex128)
        arrays = self.arrays
        kw = {} if slice_range is None else {"slice_range": slice_range}
        if ckpt is not None:
            kw["ckpt"] = ckpt
        if on_slice is not None:
            kw["on_slice"] = on_slice
        if not self.bra_slots:
            # fully-open template: every request is the same statevector;
            # a range shard returns the range PARTIAL
            if self.sliced is not None:
                out = np.asarray(
                    backend.execute_sliced(self.sliced, list(arrays), **kw)
                )
            else:
                out = np.asarray(backend.execute(self.program, list(arrays)))
            return np.broadcast_to(out, (len(batch_bits),) + out.shape).copy()
        buffers = self._batch_buffers(batch_bits, arrays)
        b = len(batch_bits)

        if self.sliced is not None:
            # one slice-summed run per request: the batch leg would
            # multiply the per-slice peak the slicing was planned to bound
            _count("sliced")
            return stacked_rows(
                lambda per: backend.execute_sliced(self.sliced, per, **kw),
                buffers, self.bra_slots, b, self.result_shape,
            )

        if isinstance(backend, NumpyBackend):
            _count("threaded" if self.threadable else "loop")
            out = backend.execute_batched(self.program, buffers, self.bra_slots)
            return out.reshape((b,) + self.result_shape)

        if isinstance(backend, TorchBackend):
            _count("batched")
            out = backend.execute_batched(self.program, buffers, self.bra_slots)
            return np.asarray(out).reshape((b,) + self.result_shape)

        # any other backend: stacked dispatch (same results, B runs)
        _count("loop")
        return stacked_rows(
            lambda per: backend.execute(self.program, per),
            buffers, self.bra_slots, b, self.result_shape,
        )


def plan_signature(bound: BoundProgram) -> str:
    """The *plan* identity of a bound structure: its program's
    :meth:`~tnc_tpu_torch.ops.program.ContractionProgram.signature_digest`."""
    return bound.program.signature_digest()


def plan_structure(
    tn, pathfinder=None, target_size: float | None = None, cost_model=None
):
    """Plan one amplitude structure: find a path, slice to the budget
    when needed, compile. Returns ``(path, slicing, program,
    sliced_program, result)``.

    A slicing-aware pathfinder exposes its winning slice set as
    ``last_slicing``; the budget repair here is then *seeded* with it.
    ``cost_model`` keeps the repair's leg scoring in the same
    predicted-seconds domain as a calibrated planner."""
    from tnc_tpu_torch.contractionpath.contraction_path import ContractionPath

    if pathfinder is None:
        from tnc_tpu_torch.contractionpath.paths import Greedy, OptMethod

        pathfinder = Greedy(OptMethod.GREEDY)
    result = pathfinder.find_path(tn)
    slicing = None
    if target_size is not None and result.size > target_size:
        from tnc_tpu_torch.contractionpath.slicing import slice_and_reconfigure

        seed = getattr(pathfinder, "last_slicing", None)
        replace_pairs, slicing = slice_and_reconfigure(
            list(tn.tensors), result.ssa_path.toplevel, target_size,
            cost_model=cost_model,
            seed_slices=seed.legs if seed is not None else None,
        )
        if slicing.num_slices <= 1:
            slicing = None
        path = ContractionPath.simple(list(replace_pairs))
    else:
        path = result.replace_path()
    program = build_program(tn, path)
    sliced = (
        build_sliced_program(tn, path, slicing)
        if slicing is not None
        else None
    )
    return path, slicing, program, sliced, result


def bind_template(
    template: AmplitudeTemplate,
    pathfinder=None,
    plan_cache=None,
    target_size: float | None = None,
    reuse_store=None,
) -> BoundProgram:
    """Plan ``template`` and compile it into a :class:`BoundProgram`.

    ``target_size``: peak-intermediate budget (elements). When the
    planned path exceeds it, the structure is sliced
    (``slice_and_reconfigure``) and serving runs the slice loop per
    request.

    ``plan_cache`` and ``reuse_store`` (the plan cache and cross-request
    reuse) are not ported yet: passing either raises
    ``NotImplementedError``.
    """
    if plan_cache is not None:
        raise NotImplementedError(f"bind_template(plan_cache=...) waits for {_LATER}")
    if reuse_store is not None:
        raise NotImplementedError(f"bind_template(reuse_store=...) waits for {_LATER}")
    tn = template.network
    leaves = flat_leaf_tensors(tn)
    n_det = len(template.determined)
    bra_slots = tuple(range(len(leaves) - n_det, len(leaves)))
    _, _, program, sliced, _ = plan_structure(tn, pathfinder, target_size)
    arrays = [leaf.data.into_data() for leaf in leaves]
    flags, threadable = thread_batch(program, bra_slots)
    return BoundProgram(
        template=template,
        program=program,
        arrays=arrays,
        bra_slots=bra_slots,
        batch_flags=flags,
        threadable=threadable,
        sliced=sliced,
        target_size=target_size,
    )


def bind_circuit(
    circuit,
    mask: str | Iterable | None = None,
    pathfinder=None,
    plan_cache=None,
    target_size: float | None = None,
    reuse_store=None,
) -> BoundProgram:
    """``into_amplitude_template`` + :func:`bind_template` in one call
    (consumes ``circuit``, finalizer semantics)."""
    return bind_template(
        circuit.into_amplitude_template(mask), pathfinder, plan_cache,
        target_size, reuse_store,
    )
