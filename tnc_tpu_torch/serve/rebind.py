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

A :class:`~tnc_tpu_torch.serve.plancache.PlanCache` makes a repeat
structure load its path from disk with zero pathfinding; an
:class:`~tnc_tpu_torch.serve.reuse.IntermediateStore` splits the bound
program into cached, content-addressed subtrees and a per-request
residual (:func:`bind_template`).
"""

from __future__ import annotations

import logging
from dataclasses import dataclass, field
from typing import Any, Iterable, Sequence

import numpy as np

from tnc_tpu_torch.builders.circuit_builder import BASIS_STATES, AmplitudeTemplate
from tnc_tpu_torch.ops.backends import Backend, NumpyBackend, TorchBackend
from tnc_tpu_torch.ops.batched import stacked_rows, thread_batch
from tnc_tpu_torch.ops.program import ContractionProgram, build_program, flat_leaf_tensors
from tnc_tpu_torch.ops.sliced import build_sliced_program

logger = logging.getLogger(__name__)

#: dispatches of :meth:`BoundProgram.amplitudes_det`, by mode (``threaded``,
#: ``batched``, ``sliced``, ``loop``)
DISPATCH: dict[str, int] = {}


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
    plan: dict = field(default_factory=dict)  # plan-cache record (if any)
    # the budget this structure was planned under (part of the cache key)
    target_size: float | None = None
    # a structure over its budget carries a sliced plan: each request runs
    # the slice loop (stacked dispatch; the batch leg stops here)
    sliced: Any = None  # SlicedProgram | None
    # cross-request reuse (bind_template(..., reuse_store=)): `program` is
    # then the per-request RESIDUAL and the cached-subtree inputs are
    # materialized per backend environment from the content-addressed
    # store (tnc_tpu_torch.serve.reuse)
    reuse: Any = None  # ReuseBinding | None

    @property
    def result_shape(self) -> tuple[int, ...]:
        return tuple(self.program.result_shape)

    def _serving_arrays(self, backend) -> list[np.ndarray]:
        """The request-invariant input arrays for ``backend``: the bound
        leaf data, or — under cross-request reuse — the residual's inputs
        with cached subtrees materialized (store-first) for this
        backend's numeric environment."""
        if self.reuse is None:
            return self.arrays
        return self.reuse.arrays_for(backend)

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

        ``ckpt`` / ``on_slice`` (sliced structures, backends with
        ``supports_slice_hooks``: :class:`~tnc_tpu_torch.ops.backends.
        NumpyBackend`): slice-boundary checkpointing and cooperative
        preemption. Dropped on a backend without the hooks, as in the
        reference; a ``TorchBackend`` checkpoints its sliced runs through
        ``TNC_TPU_CKPT`` instead."""
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
        arrays = self._serving_arrays(backend)
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
    """The *plan* identity of a bound structure: the pre-split program's
    :meth:`~tnc_tpu_torch.ops.program.ContractionProgram.signature_digest`.
    Under cross-request reuse ``bound.program`` is the residual, whose
    signature depends on the store split, so the identity comes from the
    reuse binding."""
    if bound.reuse is not None:
        return bound.reuse.cold_signature
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
    """Plan (or load a cached plan for) ``template`` and compile it into
    a :class:`BoundProgram`.

    With a :class:`~tnc_tpu_torch.serve.plancache.PlanCache`, a repeat
    structure loads its path from disk and performs **zero pathfinding**;
    a cached plan whose rebuilt program (or sliced program) no longer
    matches the signature it was stored with, or that does not rebuild,
    is dropped and the structure replanned.

    ``target_size``: peak-intermediate budget (elements). When the
    planned path exceeds it, the structure is sliced
    (``slice_and_reconfigure``) and the slicing + hoist split persist
    in the plan record; serving then runs the slice loop per request.

    ``reuse_store``: an :class:`~tnc_tpu_torch.serve.reuse.IntermediateStore`
    — the bound program is split into content-addressed cached subtrees
    plus a per-request residual (:func:`~tnc_tpu_torch.serve.reuse.
    compute_split`); value-identical subtrees are contracted once
    store-wide and reloaded by every later binding. On the numpy backend
    results stay bit-identical to the cold path.
    """
    from tnc_tpu_torch.contractionpath.contraction_path import ContractionPath

    tn = template.network
    leaves = flat_leaf_tensors(tn)
    n_det = len(template.determined)
    bra_slots = tuple(range(len(leaves) - n_det, len(leaves)))

    plan: dict = {}
    key = None
    pairs = None
    if plan_cache is not None:
        # the budget is part of the key: a plan cached without (or with a
        # different) target_size must not answer this lookup
        key = plan_cache.key_for_network(tn, target_size)
        plan = plan_cache.load(key) or {}
        pairs = plan.get("pairs")
    if pairs is None:
        path, slicing, program, sliced, result = plan_structure(
            tn, pathfinder, target_size
        )
        if plan_cache is not None:
            plan = plan_cache.record_for(
                path,
                program,
                slicing=slicing,
                sliced_program=sliced,
                flops=result.flops,
                peak=result.size,
                finder=(
                    type(pathfinder).__name__
                    if pathfinder is not None
                    else "Greedy"
                ),
                target_size=target_size,
            )
            plan_cache.store(key, plan)
    else:
        try:
            path = ContractionPath.from_obj(pairs)
            slicing = plan_cache.plan_slicing(plan)
            program = build_program(tn, path)
            valid = plan_cache.validate(plan, program)
            sliced = (
                build_sliced_program(tn, path, slicing)
                if valid and slicing is not None and slicing.num_slices > 1
                else None
            )
            if sliced is not None and plan.get("sliced_sig") not in (
                None, sliced.signature_digest()
            ):
                # the sliced compilation drifted from what the plan was
                # stored with
                valid = False
        except Exception as exc:  # noqa: BLE001 — any bad entry → replan
            # valid JSON but semantically corrupt (out-of-range pairs,
            # planner drift): degrade to a replan, never raise — and never
            # leave the poison pill on disk
            logger.warning(
                "cached plan %s does not rebuild (%s: %s); replanning",
                key, type(exc).__name__, exc,
            )
            valid = False
        if not valid:
            plan_cache.invalidate(key)
            return bind_template(
                template, pathfinder, plan_cache, target_size, reuse_store
            )

    arrays = [leaf.data.into_data() for leaf in leaves]
    reuse = None
    if reuse_store is not None and bra_slots:
        from tnc_tpu_torch.serve.reuse import ReuseBinding, compute_split

        split = compute_split(program, arrays, bra_slots, sliced=sliced)
        if split is not None:
            reuse = ReuseBinding(
                split, reuse_store, arrays, program.signature_digest()
            )
            program = split.residual
            sliced = split.residual_sliced
            bra_slots = split.bra_slots
            arrays = split.placeholder_arrays(reuse.base_arrays)
    flags, threadable = thread_batch(program, bra_slots)
    return BoundProgram(
        template=template,
        program=program,
        arrays=arrays,
        bra_slots=bra_slots,
        batch_flags=flags,
        threadable=threadable,
        plan=plan,
        sliced=sliced,
        target_size=target_size,
        reuse=reuse,
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
