"""Slice-parallel distributed contraction over several devices (the port's
counterpart of ``tnc_tpu.parallel.sliced_parallel``).

A sliced contraction is a sum of ``num_slices`` programs of the same
shapes, so the slices spread over devices with no communication until one
sum at the end. Each device runs its contiguous share of the slice range
(the per-slice loop of :class:`~tnc_tpu_torch.ops.backends.TorchBackend`),
then the partial sums reduce:

- from one process over a :class:`Mesh` of ``torch.device``\\ s (a device
  may repeat), each share on a CUDA stream of its own, the partials moved
  to the mesh's first device and added in device order;
- under a ``torch.distributed`` process group (the caller's
  ``init_process_group``), one device per rank, the partials reduced with
  ``all_reduce`` (each part of a split pair apart). Group
  backends: NCCL with one GPU per rank; gloo where ranks share a card or
  on the CPU. A backend that cannot reduce a tensor raises.

This composes with partition parallelism
(:mod:`tnc_tpu_torch.parallel.partitioned`, its ``mesh`` strategy).
"""

from __future__ import annotations

import logging
from dataclasses import dataclass

import numpy as np

from tnc_tpu_torch import obs
from tnc_tpu_torch.contractionpath.contraction_path import ContractionPath
from tnc_tpu_torch.contractionpath.slicing import Slicing
from tnc_tpu_torch.ops.program import flat_leaf_tensors
from tnc_tpu_torch.ops.sliced import SlicedProgram, build_sliced_program
from tnc_tpu_torch.parallel._devices import (
    device_stream,
    group_up,
    handed_over,
    host_result,
    make_backend,
    parts,
    rank_device,
    resolve_devices,
    to_device,
)
from tnc_tpu_torch.resilience import faultinject as _faults
from tnc_tpu_torch.resilience import retry as _retry
from tnc_tpu_torch.tensornetwork.tensor import CompositeTensor, LeafTensor
from tnc_tpu_torch.tensornetwork.tensordata import TensorData

logger = logging.getLogger(__name__)


def _effective_chunk(num_slices: int, n_devices: int, max_slices: int | None) -> int:
    """Per-device slice count actually executed: the full share, shrunk to
    ``ceil(max_slices / n_devices)`` under a probe subset. The ONE
    definition shared by the device function, its cache key, and the span's
    flop accounting — they must never disagree on the chunk size.

    >>> _effective_chunk(128, 4, None), _effective_chunk(128, 4, 10)
    (32, 3)
    """
    chunk = num_slices // n_devices
    if max_slices is not None:
        chunk = min(chunk, max(1, -(-max_slices // n_devices)))
    return chunk


@dataclass(frozen=True)
class Mesh:
    """A one-axis mesh: the devices the slices spread over (a device may
    repeat) and the axis's name; ``shape[axis]`` is the device count."""

    devices: tuple
    axis: str = "slices"

    @property
    def shape(self) -> dict[str, int]:
        return {self.axis: len(self.devices)}


def make_mesh(n_devices: int | None = None, axis: str = "slices", devices=None) -> Mesh:
    """A one-axis :class:`Mesh` over ``devices`` (a list of
    ``torch.device``\\ s; ``None``: every visible CUDA device, raising
    without CUDA), cut to the first ``n_devices``; too few raises
    ``ValueError``.

    >>> import torch
    >>> make_mesh(2, devices=[torch.device("cpu")] * 4).shape
    {'slices': 2}
    """
    return Mesh(tuple(resolve_devices(devices, n_devices)), axis)


def _reduce_to_first(partials: list, device):
    """The "psum": every device's partial moved to ``device`` and added in
    device order (each part of a (real, imag) pair apart)."""
    acc = to_device(partials[0], device)
    for p in partials[1:]:
        moved = to_device(p, device)
        if isinstance(acc, tuple):
            acc = tuple(a + b for a, b in zip(acc, parts(moved)))
        else:
            acc = acc + moved
    return acc


def _hoisted_program(sp: SlicedProgram, hoist: bool):
    """The hoisted split of ``sp`` when ``hoist`` and it has a stem, else
    ``None`` — the decision the device function and the span both take."""
    if not hoist:
        return None
    from tnc_tpu_torch.ops.hoist import hoist_sliced_program

    cand = hoist_sliced_program(sp)
    return None if cand.is_noop else cand


def _make_spmd_fn(
    sp: SlicedProgram,
    mesh: Mesh,
    axis: str,
    dtype,
    split_complex: bool,
    precision: str | None = "float32",
    max_slices: int | None = None,
    hoist: bool = False,
):
    """``fn(buffers)``: the slice sum of ``sp`` over the mesh, each device
    summing its share and the partials reduced onto the mesh's first
    device (stored shape; a (real, imag) pair in split mode). ``buffers``
    are the program's full leaves, placed on any device (each device takes
    its own copy, once per distinct device).

    Device ``d`` runs slices ``[d*chunk, (d+1)*chunk)`` of the
    :func:`_effective_chunk` — under ``max_slices`` a partial sum over the
    **first** ``n_devices * ceil(max_slices / n_devices)`` slices — on the
    per-slice loop (under the no-model kernel ladder, Kahan-summed, its
    body replayed as a CUDA graph), on a stream of its own.
    ``hoist=True`` runs the slice-invariant prelude once per device before
    its loop."""
    n_devices = mesh.shape[axis]
    num = sp.slicing.num_slices
    if num % n_devices != 0:
        raise ValueError(f"num_slices ({num}) must be divisible by mesh size ({n_devices})")
    chunk = _effective_chunk(num, n_devices, max_slices)
    backends: dict = {}
    for dev in mesh.devices:
        if dev not in backends:
            backends[dev] = make_backend(dev, dtype, split_complex, precision,
                                         sliced_strategy="loop", hoist=hoist)

    def fn(buffers):
        placed: dict = {}
        partials = []
        for d, dev in enumerate(mesh.devices):
            full = placed.get(dev)
            if full is None:
                full = placed[dev] = [to_device(b, dev) for b in buffers]
            with device_stream(dev):
                out = backends[dev].run_sliced_placed(
                    sp, full, slice_range=(d * chunk, (d + 1) * chunk), hoist=hoist)
            partials.append(handed_over(out, dev))
        return _reduce_to_first(partials, mesh.devices[0])

    return fn


def _make_group_fn(
    sp: SlicedProgram,
    device,
    dtype,
    split_complex: bool,
    precision: str | None,
    max_slices: int | None,
    hoist: bool,
):
    """``fn(buffers)`` under a process group: this rank's
    :func:`_effective_chunk` of the slices on ``device`` (the per-slice
    loop, as :func:`_make_spmd_fn` runs each device's share). The ranks'
    partials are summed by the caller, outside its retry frame."""
    from tnc_tpu_torch.obs.core import process_identity

    world, rank = process_identity()
    num = sp.slicing.num_slices
    if num % world != 0:
        raise ValueError(f"num_slices ({num}) must be divisible by the group size ({world})")
    chunk = _effective_chunk(num, world, max_slices)
    backend = make_backend(device, dtype, split_complex, precision, sliced_strategy="loop",
                           hoist=hoist)

    def fn(buffers):
        full = [to_device(b, device) for b in buffers]
        return backend.run_sliced_placed(
            sp, full, slice_range=(rank * chunk, (rank + 1) * chunk), hoist=hoist)

    return fn


# The device functions are rebuilt per call otherwise: their backends keep
# the kernel policies and the hoist plan, so a timed call after a warm-up
# at the same chunk plans nothing.
_SPMD_FN_CACHE: dict = {}
_SPMD_FN_CACHE_MAX = 64


def _spmd_fn_cached(sp, mesh, axis, dtype, split_complex, precision, max_slices,
                    hoist=False, group_device=None):
    """:func:`_make_spmd_fn` (or, with ``group_device``, this rank's
    :func:`_make_group_fn`) from a bounded cache keyed by everything the
    function bakes in."""
    from tnc_tpu_torch.obs.core import process_identity
    from tnc_tpu_torch.ops.split_complex import complex_mult_key, dot_precision_key

    if group_device is not None:
        world, rank = process_identity()
        chunk = _effective_chunk(sp.slicing.num_slices, world, max_slices)
        placement = ("group", world, rank, group_device)
    else:
        chunk = _effective_chunk(sp.slicing.num_slices, mesh.shape[axis], max_slices)
        placement = (mesh.devices, axis)
    key = (
        sp.signature(), placement, str(dtype), split_complex, precision, chunk, hoist,
        # the policy bakes in the env rungs: a function kept across a
        # flipped TNC_TPU_COMPLEX_MULT / TNC_TPU_DOT_PRECISION would run
        # the wrong kernels
        complex_mult_key() if split_complex else None,
        dot_precision_key() if split_complex else None,
    )
    fn = _SPMD_FN_CACHE.get(key)
    obs.counter_add("spmd_fn_cache.hit" if fn is not None else "spmd_fn_cache.miss")
    if fn is None:
        if group_device is not None:
            fn = _make_group_fn(sp, group_device, dtype, split_complex, precision,
                                max_slices, hoist)
        else:
            fn = _make_spmd_fn(sp, mesh, axis, dtype, split_complex, precision,
                               max_slices, hoist)
        _SPMD_FN_CACHE[key] = fn
        while len(_SPMD_FN_CACHE) > _SPMD_FN_CACHE_MAX:
            _SPMD_FN_CACHE.pop(next(iter(_SPMD_FN_CACHE)))
    return fn


def distributed_sliced_contraction(
    tn: CompositeTensor,
    contract_path: ContractionPath,
    slicing: Slicing,
    mesh: Mesh | None = None,
    n_devices: int | None = None,
    dtype: str = "complex64",
    axis: str = "slices",
    split_complex: bool | None = None,
    precision: str | None = "float32",
    max_slices: int | None = None,
    hoist: bool = False,
    device=None,
) -> LeafTensor:
    """Contract ``tn`` with its slices spread over devices.

    From one process: over ``mesh`` (:func:`make_mesh`; ``None`` builds one
    over ``n_devices`` visible CUDA devices, raising without CUDA). Under a
    ``torch.distributed`` process group (one rank or several) and with no
    ``mesh`` / ``n_devices``: one share per rank on ``device``
    (:func:`~tnc_tpu_torch.parallel._devices.rank_device`: ``None``
    means ``cuda:{LOCAL_RANK}``), the partials summed by ``all_reduce``, and
    every rank returns the whole sum; a rank that fails makes the call
    raise (on the other ranks the collective fails or times out). The slice count must divide by the
    device (or rank) count.

    ``max_slices``: probe subsets — the partial sum over the **first**
    ``n_devices * ceil(max_slices / n_devices)`` slices. ``hoist=True``:
    each device runs the slice-invariant prelude once before its loop.
    ``split_complex=None`` means split on CUDA, native complex on the CPU.

    The run is one dispatch under the ``spmd.dispatch`` fault point and the
    shared retry policy (the inputs are never consumed, so a re-dispatch is
    exact); under a group the retry covers the rank's own share only, and
    the ``all_reduce`` runs once after it. It is wrapped in ``obs.maybe_jax_profiler_trace()`` and an
    ``spmd.contract`` span.

    >>> import torch
    >>> from tnc_tpu_torch.contractionpath.slicing import find_slicing
    >>> rng = np.random.default_rng(0)
    >>> ts = [LeafTensor([0, 1], [4, 4], TensorData.matrix(rng.standard_normal((4, 4)))),
    ...       LeafTensor([1, 2], [4, 4], TensorData.matrix(rng.standard_normal((4, 4)))),
    ...       LeafTensor([2, 0], [4, 4], TensorData.matrix(rng.standard_normal((4, 4))))]
    >>> tn = CompositeTensor([t.copy() for t in ts])
    >>> path = ContractionPath.simple([(0, 1), (0, 2)])
    >>> slicing = find_slicing(ts, path.toplevel, target_size=12)
    >>> mesh = make_mesh(devices=[torch.device("cpu")] * slicing.num_slices)
    >>> out = distributed_sliced_contraction(tn, path, slicing, mesh=mesh)
    >>> a, b, c = (t.data.into_data() for t in ts)
    >>> want = np.einsum("ab,bc,ca->", a, b, c)
    >>> bool(abs(complex(out.data.into_data().reshape(-1)[0]) - want)
    ...      <= 1e-5 * abs(want))
    True
    """
    import torch

    from tnc_tpu_torch.obs.core import process_identity
    from tnc_tpu_torch.ops.backends import place_buffers

    world = process_identity()[0]
    group_device = None
    if mesh is None and n_devices is None and group_up():
        group_device = rank_device(device)
        n_dev, first = world, group_device
    else:
        if mesh is None:
            mesh = make_mesh(n_devices, axis)
        n_dev, first = mesh.shape[axis], mesh.devices[0]
    if split_complex is None:
        split_complex = first.type != "cpu"

    sp = build_sliced_program(tn, contract_path, slicing)
    leaves = flat_leaf_tensors(tn)
    logger.debug(
        "sliced SPMD: %d slices over %d devices (%d sliced legs, split_complex=%s)",
        slicing.num_slices, n_dev, len(slicing.legs), split_complex,
    )
    fn = _spmd_fn_cached(sp, mesh, axis, dtype, split_complex, precision, max_slices,
                         hoist, group_device)
    chunk = _effective_chunk(slicing.num_slices, n_dev, max_slices)
    executed = chunk * n_dev  # prefix-subset semantics (_make_spmd_fn)
    hp = _hoisted_program(sp, hoist)
    with obs.maybe_jax_profiler_trace(), obs.span(
        "spmd.contract", slices=executed, devices=n_dev, hoisted=hp is not None,
    ) as osp:
        arrays = place_buffers(
            [leaf.data.into_data() for leaf in leaves], dtype, split_complex, first)

        def _dispatch():
            _faults.fault_point("spmd.dispatch")
            out = fn(arrays)
            if first.type == "cuda" and _retry.sync_dispatch():
                torch.cuda.synchronize(first)
            return out

        # a transient failure re-runs the whole dispatch under the shared
        # policy (the inputs are not consumed, so a re-dispatch is exact);
        # an out-of-memory error propagates to the caller's ladder
        with torch.inference_mode():
            out = _retry.retry_call(_dispatch, label="spmd.dispatch")
            if group_device is not None:
                # once, outside the retry: a collective run again on one
                # rank alone would put the group's collectives out of step
                import torch.distributed as dist

                for part in parts(out):
                    dist.all_reduce(part)
            result = host_result(out, split_complex, sp.program.result_shape)
        if obs.enabled():
            from tnc_tpu_torch.ops.program import steps_flops

            if hp is not None:
                # each device runs the prelude once, then the residual per slice
                flops = n_dev * steps_flops(
                    ps.step for ps in hp.prelude_steps
                ) + executed * steps_flops(hp.residual.program.steps)
            else:
                flops = executed * steps_flops(sp.program.steps)
            osp.add(flops=flops)
    return LeafTensor(
        list(sp.program.result_legs),
        list(sp.program.result_shape),
        TensorData.matrix(result),
    )
