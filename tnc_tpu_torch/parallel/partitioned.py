"""Partition-parallel distributed contraction over PyTorch devices (the
port's counterpart of ``tnc_tpu.parallel.partitioned``).

The reference's MPI pipeline (``tnc/src/mpi/communication.rs``) is

    rank 0: partition → per-partition paths → toplevel fan-in path
    broadcast_path / scatter_tensor_network    (bcast + p2p sends)
    every rank: contract its partition locally (zero communication)
    intermediate_reduce_tensor_network         (pairwise p2p fan-in)

Here the same schedule runs from one process over a list of
``torch.device``\\ s, or, under a ``torch.distributed`` process group,
one process per GPU:

- *Scatter* = each partition's leaves placed on its device
  (:func:`~tnc_tpu_torch.ops.backends.place_buffers`).
- *Local phase* = each partition's program run by a
  :class:`~tnc_tpu_torch.ops.backends.TorchBackend` on its device, issued
  on a CUDA stream of its own: on k cards the partitions overlap; several
  partitions on one card share it. A partition sliced to fit its memory
  budget runs the chunked executor, the per-slice loop, or its slices
  spread over spare devices (``mesh``).
- *Fan-in reduce* = the ``toplevel`` path as a communication schedule
  (``communication.rs:199-249``): for each pair ``(x, y)`` the tensor
  held by ``y``'s device moves to ``x``'s device (``.to(device)``, a
  device-to-device copy between cards, nothing on a repeated device) and
  is contracted there, after the events of the partitions' streams.
- *Final tensor on device 0*: :class:`DeviceTensorMapping` assigns the
  partition that survives the fan-in to device slot 0, mirroring
  ``get_tensor_mapping`` reserving rank 0 (``communication.rs:89-115``).

Under a process group of several ranks (the caller's
``torch.distributed.init_process_group``), partitions shard across the
ranks (:func:`process_shard_map`) and cross-rank pairs travel as host
objects over the group's c10d store (:func:`send_object`,
:func:`recv_object`, :func:`broadcast_object`). Group backends: NCCL with
one GPU per rank; gloo where ranks share a card (or on the CPU).
"""

from __future__ import annotations

import contextlib
import logging
import time
from dataclasses import dataclass
from typing import Any, Sequence

import numpy as np

from tnc_tpu_torch import obs
from tnc_tpu_torch.contractionpath.contraction_path import ContractionPath
from tnc_tpu_torch.ops.program import ContractionProgram, _pair_step, build_program
from tnc_tpu_torch.parallel._devices import (
    device_stream,
    group_up,
    handed_over,
    host_result,
    item_bytes,
    make_backend,
    parts,
    process_index,
    rank_device,
    resolve_devices,
    to_device,
)
from tnc_tpu_torch.parallel.sliced_parallel import Mesh, _spmd_fn_cached
from tnc_tpu_torch.resilience import faultinject as _faults
from tnc_tpu_torch.resilience import retry as _retry
from tnc_tpu_torch.tensornetwork.tensor import CompositeTensor, LeafTensor
from tnc_tpu_torch.tensornetwork.tensordata import TensorData

logger = logging.getLogger(__name__)


class PartitionExecutionError(RuntimeError):
    """A partition's scatter, local contraction, or fan-in step failed;
    names the partition index, device slot, and **process** (the rank of
    the process group) so a failure in a multi-process log is attributable
    to a machine. Chains the original (``__cause__``)."""

    def __init__(
        self,
        partition: int,
        device: int,
        original: BaseException,
        process: int | None = None,
        phase: str = "local",
    ):
        if process is None:
            process = process_index()
        super().__init__(
            f"partition {partition} on device {device} "
            f"(process {process}, {phase} phase) failed: "
            f"{type(original).__name__}: {original}"
        )
        self.partition = partition
        self.device = device
        self.process = process
        self.phase = phase
        self.original = original


def partition_latency_map(
    tn: CompositeTensor,
    contract_path: ContractionPath,
    cost_model=None,
) -> dict[int, float]:
    """Per-partition local completion latencies for fan-in scheduling —
    never ``None``-filled: predicted seconds under ``cost_model`` (a
    :class:`~tnc_tpu_torch.obs.calibrate.CalibratedCostModel`, launch
    overhead charged per local step), raw local op counts otherwise.

    This is what the latency-aware communication schemes
    (``WEIGHTED_BRANCH_BOUND``, ``BIPARTITION_SWEEP``) must receive on
    the partitioned path: with an empty latency map every partition looks
    instantly available and the "latency-aware" schedule degenerates to a
    plain flops fan-in.
    """
    from tnc_tpu_torch.contractionpath.contraction_cost import contract_path_cost

    latency: dict[int, float] = {}
    steps: dict[int, float] = {}
    for i, child in enumerate(tn.tensors):
        if not isinstance(child, CompositeTensor):
            raise TypeError(f"top-level child {i} is not a partition composite")
        if i not in contract_path.nested:
            raise ValueError(f"partition {i} has no nested contraction path")
        local = contract_path.nested[i]
        flops, _ = contract_path_cost(child.tensors, local, True)
        latency[i] = flops
        steps[i] = float(len(local.toplevel))
    if cost_model is not None:
        from tnc_tpu_torch.contractionpath.communication_schemes import (
            calibrated_latency_map,
        )

        latency = calibrated_latency_map(latency, cost_model, steps)
    return latency


def replan_fanin(
    tn: CompositeTensor,
    contract_path: ContractionPath,
    communication_scheme,
    cost_model=None,
    rng=None,
) -> ContractionPath:
    """Re-derive the toplevel fan-in schedule of a partitioned path with a
    latency-aware communication scheme, keeping the nested local paths.
    The latency map comes from :func:`partition_latency_map` — calibrated
    seconds when a ``cost_model`` is given."""
    import random as _random

    latency = partition_latency_map(tn, contract_path, cost_model)
    children = [child.external_tensor() for child in tn.tensors]  # type: ignore[union-attr]
    toplevel = communication_scheme.communication_path(
        children,
        latency,
        rng if rng is not None else _random.Random(42),
        cost_model=cost_model,
    )
    return ContractionPath(dict(contract_path.nested), list(toplevel))


def _fanin_survivor(k: int, toplevel: Sequence[tuple[int, int]]) -> int:
    """Index that holds the final tensor after a replace-left fan-in."""
    alive = [True] * k
    for x, y in toplevel:
        if not (alive[x] and alive[y]):
            raise ValueError(f"communication path reuses a consumed index: {(x, y)}")
        alive[y] = False
    survivors = [i for i, a in enumerate(alive) if a]
    if len(survivors) != 1:
        raise ValueError(
            f"communication path leaves {len(survivors)} tensors, expected 1"
        )
    return survivors[0]


@dataclass(frozen=True)
class DeviceTensorMapping:
    """Partition index ↔ device slot, final-result partition pinned to
    slot 0.

    Equivalent of ``RankTensorMapping`` (``mpi/mpi_types.rs:11-62``) +
    ``get_tensor_mapping`` (``communication.rs:89-115``).
    """

    device_of_partition: tuple[int, ...]  # partition i → device slot

    @classmethod
    def for_path(
        cls, k: int, toplevel: Sequence[tuple[int, int]]
    ) -> "DeviceTensorMapping":
        root = _fanin_survivor(k, toplevel)
        order = [root] + [i for i in range(k) if i != root]
        device_of = [0] * k
        for slot, part in enumerate(order):
            device_of[part] = slot
        return cls(tuple(device_of))

    def device(self, partition: int) -> int:
        return self.device_of_partition[partition]


@dataclass
class Communication:
    """Executor state for one distributed contraction (cf. ``Communication``
    in ``communication.rs:118-122``).

    ``devices`` is a list of ``torch.device``\\ s (a device may repeat).
    ``programs[i]`` is either a :class:`ContractionProgram` (the partition
    fits the memory budget) or a
    :class:`~tnc_tpu_torch.ops.sliced.SlicedProgram` (the partition sliced
    to fit)."""

    mapping: DeviceTensorMapping
    devices: list
    programs: list[Any]
    results_meta: list[LeafTensor]


def _pair_program(ta: LeafTensor, tb: LeafTensor) -> tuple[ContractionProgram, LeafTensor]:
    step, result = _pair_step(0, 1, ta, tb)
    program = ContractionProgram(
        num_inputs=2,
        steps=(step,),
        result_slot=0,
        result_legs=tuple(result.legs),
        result_shape=tuple(result.bond_dims),
    )
    return program, result


def _leaf_arrays(child: CompositeTensor) -> list[np.ndarray]:
    from tnc_tpu_torch.ops.program import flat_leaf_tensors

    return [np.asarray(leaf.data.into_data()) for leaf in flat_leaf_tensors(child)]


def _slice_partition(child: CompositeTensor, nested: ContractionPath, hbm_bytes: int):
    """Slice one partition's local path until its program fits the memory
    budget. Returns a SlicedProgram (or None if the unsliced program
    already fits, or nothing local slicing can do).

    Uses slice-and-reconfigure (slicing interleaved with subtree
    re-planning in the sliced size model) rather than plain greedy leg
    picking, so the returned program may follow a different local path
    than ``nested``: the fan-in metadata comes from
    ``sp.program.result_legs``.
    """
    from tnc_tpu_torch.contractionpath.contraction_path import replace_ssa_ordering
    from tnc_tpu_torch.contractionpath.slicing import slice_and_reconfigure
    from tnc_tpu_torch.ops.budget import fits_hbm, program_peak_bytes
    from tnc_tpu_torch.ops.sliced import build_sliced_program

    program = build_program(child, nested)
    if fits_hbm(program, hbm_bytes=hbm_bytes):
        return None
    if nested.nested:
        raise ValueError(
            "HBM budget exceeded on a partition with a nested local path; "
            "slicing supports flat partition paths"
        )
    inputs = [t for t in child.tensors if isinstance(t, LeafTensor)]
    est = program_peak_bytes(program)
    ssa = replace_ssa_ordering(nested.toplevel, len(inputs))
    # element targets, descending from a quarter of the current peak
    # (~8 bytes per complex element; starting AT the peak would be a
    # no-op): the first slicing that fits the budget wins; keep the deepest
    # achievable as best effort. A partition whose peak is its own open-leg
    # output cannot be sliced locally at all — only GLOBAL slicing (cut
    # legs sliceable) helps there.
    target = 2.0 ** np.floor(np.log2(max(est.peak_bytes / 8.0 / 4.0, 2.0)))
    best = None
    while target >= 4:
        try:
            pairs, slicing = slice_and_reconfigure(
                inputs, ssa, target,
                reconf_rounds=1, step_budget=None,
                final_rounds=2, final_budget=None,
            )
        except ValueError:
            break
        if not slicing.legs:  # target above the current peak: no-op
            target /= 4.0
            continue
        sp = build_sliced_program(child, ContractionPath.simple(pairs), slicing)
        best = sp
        if fits_hbm(sp.program, hbm_bytes=hbm_bytes):
            break
        target /= 4.0
    if best is None:
        # nothing sliceable (open-leg-bound peak): run unsliced rather
        # than wrap a fake 1-slice program as success
        logger.warning(
            "partition peak %.3g bytes exceeds the %d-byte budget but has "
            "no sliceable (closed) legs; running unsliced — use global "
            "slicing (partitioned_sliced_executor) to slice cut legs",
            est.peak_bytes,
            hbm_bytes,
        )
        return None
    if not fits_hbm(best.program, hbm_bytes=hbm_bytes):
        logger.warning(
            "partition sliced best-effort (%d legs, %d slices) but still "
            "exceeds the %d-byte budget",
            len(best.slicing.legs),
            best.slicing.num_slices,
            hbm_bytes,
        )
    logger.debug(
        "partition sliced: %d legs, %d slices",
        len(best.slicing.legs),
        best.slicing.num_slices,
    )
    return best


def _partitions(tn: CompositeTensor, contract_path: ContractionPath) -> list:
    """The partitions of ``tn``; a child that is not a partition composite
    raises ``TypeError``, one with no nested path ``ValueError``."""
    children = list(tn.tensors)
    for i, child in enumerate(children):
        if not isinstance(child, CompositeTensor):
            raise TypeError(f"top-level child {i} is not a partition composite")
        if i not in contract_path.nested:
            raise ValueError(f"partition {i} has no nested contraction path")
    return children


def _build_partition_programs(
    children: list,
    contract_path: ContractionPath,
    hbm_bytes: int | None,
    slot_of,
) -> tuple[list[Any], list[LeafTensor]]:
    """Every partition's program, on the host: a
    :class:`ContractionProgram`, or with ``hbm_bytes`` set a
    :class:`~tnc_tpu_torch.ops.sliced.SlicedProgram` where the partition
    must slice to fit (:func:`_slice_partition`), and the meta of its
    result. Returns ``(programs, metas)``. A failure other than a
    ``ValueError`` or ``TypeError`` raises
    :class:`PartitionExecutionError` naming the partition and its device
    slot ``slot_of(i)`` (scatter phase)."""
    programs: list[Any] = []
    metas: list[LeafTensor] = []
    for i, child in enumerate(children):
        try:
            sp = None
            if hbm_bytes is not None:
                sp = _slice_partition(child, contract_path.nested[i], hbm_bytes)
            program = sp.program if sp is not None else build_program(
                child, contract_path.nested[i])
        except (ValueError, TypeError):
            raise  # caller contract errors keep their type
        except Exception as exc:  # noqa: BLE001 — name the failure site
            raise PartitionExecutionError(i, slot_of(i), exc, phase="scatter") from exc
        programs.append(sp if sp is not None else program)
        metas.append(LeafTensor(list(program.result_legs), list(program.result_shape)))
    return programs, metas


def scatter_partitions(
    tn: CompositeTensor,
    contract_path: ContractionPath,
    devices: list,
    dtype: str,
    split_complex: bool,
    hbm_bytes: int | None = None,
) -> tuple[Communication, list[list[Any]]]:
    """Compile per-partition programs and place each partition's leaves on
    its device (``scatter_tensor_network``, ``communication.rs:125-195``).

    With ``hbm_bytes`` set, any partition whose program exceeds the
    per-device budget is sliced locally (sum over slice programs on its
    own device) before the fan-in — composing partition parallelism with
    slicing.
    """
    from tnc_tpu_torch.ops.backends import place_buffers

    children = _partitions(tn, contract_path)
    k = len(children)
    if k > len(devices):
        raise ValueError(f"{k} partitions but only {len(devices)} devices")
    mapping = DeviceTensorMapping.for_path(k, contract_path.toplevel)

    buffers: list[list[Any]] = []
    with obs.span("partitioned.scatter", partitions=k):
        programs, metas = _build_partition_programs(
            children, contract_path, hbm_bytes, mapping.device)
        for i, child in enumerate(children):
            try:
                buffers.append(place_buffers(
                    _leaf_arrays(child), dtype, split_complex, devices[mapping.device(i)]))
            except (ValueError, TypeError):
                raise
            except Exception as exc:  # noqa: BLE001 — name the failure site
                raise PartitionExecutionError(
                    i, mapping.device(i), exc, phase="scatter"
                ) from exc
            # mirror of "Scattering tensor network" (communication.rs:132)
            logger.debug("scatter: partition %d -> device %d (%d tensors, %s)",
                         i, mapping.device(i), len(child), type(programs[i]).__name__)

    comm = Communication(mapping, list(devices), programs, metas)
    return comm, buffers


def local_contract_partitions(
    comm: Communication,
    buffers: list[list[Any]],
    split_complex: bool,
    precision,
    max_slices: int | None = None,
    sliced_strategy: str = "chunked",
    dtype: str = "complex64",
    slice_batch: int = 8,
    chunk_steps: int = 64,
    hoist: bool = False,
) -> list[Any]:
    """Run every partition's program on its device; returns the partition
    results on their devices (stored shape; (real, imag) pairs in split
    mode). Each partition is issued on a CUDA stream of its own, so on k
    cards the k local phases overlap (the per-rank local phase); the
    current stream waits for all of them before returning. ``max_slices``
    caps sliced partitions' sums (benchmark subset mode — the partial sums
    are NOT the correct partition tensors). ``hoist=True`` runs each
    sliced partition's slice-invariant stem once before its slice loop
    (:mod:`tnc_tpu_torch.ops.hoist`).

    An unsliced partition runs through
    :class:`~tnc_tpu_torch.ops.backends.TorchBackend` under its kernel
    policy (chains through ``fused_chain``). Sliced partitions run through
    the chunked executor by default (``sliced_strategy="chunked"``,
    ``slice_batch`` slices at a time in chunks of ``chunk_steps`` steps);
    ``"loop"`` runs one slice at a time. ``"mesh"``: a locally sliced
    partition's slice range is spread over its own device and the spare
    devices beyond the partition count (``comm.devices[k:]``, handed out
    round-robin), each running its share on its own stream
    (:mod:`tnc_tpu_torch.parallel.sliced_parallel`; the sub-mesh shrinks
    to the largest size dividing the partition's slice count), and the
    partials are summed on the partition's own device.

    A transient failure retries the partition in place under the shared
    policy (the ``partition.local`` fault point, with ``partition=`` and
    ``device=``); anything that survives the retries raises
    :class:`PartitionExecutionError` naming the partition, device slot and
    process.
    """
    if sliced_strategy not in ("chunked", "loop", "mesh"):
        raise ValueError(
            f"unknown sliced_strategy {sliced_strategy!r}; "
            "expected 'chunked', 'loop', or 'mesh'"
        )
    logger.debug("local phase: %d partition programs", len(comm.programs))
    from tnc_tpu_torch.ops.sliced import SlicedProgram

    # mesh strategy: hand the spare devices (slots beyond the partition
    # count) to the sliced partitions, round-robin
    spare_of: dict[int, list] = {}
    if sliced_strategy == "mesh":
        k = len(comm.programs)
        sliced_parts = [
            i for i, p in enumerate(comm.programs) if isinstance(p, SlicedProgram)
        ]
        spare_of = {i: [] for i in sliced_parts}
        for j, dev in enumerate(comm.devices[k:]):
            if sliced_parts:
                spare_of[sliced_parts[j % len(sliced_parts)]].append(dev)

    def compile_one(i, program):
        own = comm.devices[comm.mapping.device(i)]
        if isinstance(program, SlicedProgram):
            if sliced_strategy == "mesh":
                sub = [own] + spare_of.get(i, [])
                n = len(sub)
                while program.slicing.num_slices % n:
                    n -= 1
                fn = _spmd_fn_cached(
                    program, Mesh(tuple(sub[:n])), "slices", dtype, split_complex,
                    precision, max_slices, hoist,
                )
                return fn  # the sum lands on sub[0], the partition's device
            backend = make_backend(own, dtype, split_complex, precision,
                                   sliced_strategy=sliced_strategy, slice_batch=slice_batch,
                                   chunk_steps=chunk_steps, hoist=hoist)
            return lambda bufs: backend.run_sliced_placed(
                program, bufs, max_slices=max_slices, hoist=hoist)
        backend = make_backend(own, dtype, split_complex, precision)
        return lambda bufs: backend._run(program, bufs)

    def run_job(i, fn, bufs):
        slot = comm.mapping.device(i)
        device = comm.devices[slot]
        with obs.span("partitioned.local_partition", partition=i, device=slot):
            # a transient failure retries THIS partition in place (bounded,
            # shared policy); anything that survives the retries is
            # re-raised naming the partition and device
            def _attempt():
                _faults.fault_point("partition.local", partition=i, device=slot)
                return fn(bufs)

            try:
                with device_stream(device):
                    out = _retry.default_policy().run(
                        _attempt,
                        label="partition.local",
                        classify=_retry.donation_guarded_classify(bufs),
                    )
            except Exception as exc:  # noqa: BLE001 — annotate and re-raise
                raise PartitionExecutionError(i, slot, exc) from exc
            return handed_over(out, device)

    jobs = [
        (i, compile_one(i, program), list(bufs))
        for i, (program, bufs) in enumerate(zip(comm.programs, buffers))
    ]
    with obs.span("partitioned.local", partitions=len(jobs)):
        return [run_job(i, fn, bufs) for i, fn, bufs in jobs]


def plan_fanin_pairs(
    metas: Sequence[LeafTensor], toplevel: Sequence[tuple[int, int]]
) -> tuple[list[ContractionProgram], list[LeafTensor], list[float], LeafTensor]:
    """Precompute the whole fan-in schedule's pair programs: for each pair
    ``(x, y)`` of the communication path, its 2-tensor program, the meta of
    the tensor **moved** (y's, the interconnect payload), and the pair's
    flop count. Returns ``(programs, moved_metas, flops, final_meta)``, so
    that a level's pairs go back-to-back with no planning between them."""
    from tnc_tpu_torch.ops.program import step_flops

    pair_meta = list(metas)
    programs: list[ContractionProgram] = []
    moved: list[LeafTensor] = []
    flops: list[float] = []
    for x, y in toplevel:
        program, result_meta = _pair_program(pair_meta[x], pair_meta[y])
        programs.append(program)
        moved.append(pair_meta[y])
        flops.append(float(step_flops(program.steps[0])))
        pair_meta[x] = result_meta
    root = _fanin_survivor(len(metas), toplevel) if toplevel else 0
    return programs, moved, flops, pair_meta[root]


def _walk_fanin(levels, plan, elem_bytes: float, contract, record: bool = True,
                process: int | None = None, **attrs) -> None:
    """Walk a fan-in schedule level by level. ``contract(pi, x, y)`` moves
    y's tensor to x's holder and contracts the pair there (``pi``: the
    pair's index in flattened level order, into ``plan``, the
    :func:`plan_fanin_pairs` of that order); it returns whether this
    process ran the pair's program. With ``record``, one
    ``partitioned.fanin`` span over the walk (``attrs`` added to it) and
    one ``partitioned.fanin_level`` span per level carry the pair count,
    the bytes moved (each moved tensor's elements times ``elem_bytes``,
    counted on every process) and the flops of the pairs run here;
    ``process`` tags every span."""
    _programs, moved, pair_flops, _final = plan
    tag = {} if process is None else {"process": process}

    def span(name, **args):
        return obs.span(name, **args, **tag) if record else contextlib.nullcontext()

    total_bytes = total_flops = 0.0
    pi = 0
    with span("partitioned.fanin", pairs=len(moved), levels=len(levels), **attrs) as fanin_sp:
        for li, level in enumerate(levels):
            with span("partitioned.fanin_level", level=li, pairs=len(level)) as level_sp:
                level_bytes = level_flops = 0.0
                for x, y in level:
                    level_bytes += float(np.prod(moved[pi].bond_dims)) * elem_bytes
                    if contract(pi, x, y):
                        level_flops += pair_flops[pi]
                    pi += 1
                if record and obs.enabled():
                    level_sp.add(bytes=level_bytes, flops=level_flops)
            total_bytes += level_bytes
            total_flops += level_flops
        if record and obs.enabled():
            fanin_sp.add(bytes=total_bytes, flops=total_flops)


def intermediate_reduce(
    comm: Communication,
    toplevel: Sequence[tuple[int, int]],
    results: list[Any],
    split_complex: bool,
    precision,
    levels: Sequence[Sequence[tuple[int, int]]] | None = None,
) -> tuple[Any, LeafTensor]:
    """Tree fan-in following the communication path
    (``intermediate_reduce_tensor_network``, ``communication.rs:199-249``):
    for ``(x, y)``, move y's tensor onto x's device and contract there.

    The path is grouped into dependency **levels**
    (:func:`~tnc_tpu_torch.contractionpath.communication_schemes.fanin_levels`,
    from the scheme's own pair order). The pairs of a level are
    independent; each is issued without a host synchronisation (the move
    is an asynchronous copy, the pair program a queued launch), and the
    partials stay on their devices between levels. One
    ``partitioned.fanin_level`` span per level records the pair count,
    the bytes moved and the pairs' flops.
    """
    if levels is None:
        from tnc_tpu_torch.contractionpath.communication_schemes import fanin_levels

        levels = fanin_levels(toplevel)
    # program bookkeeping in FLATTENED level order (a level schedule may
    # reorder independent pairs relative to the path; the tree — which
    # tensors meet — is unchanged either way)
    flat = [pair for level in levels for pair in level]
    plan = plan_fanin_pairs(comm.results_meta, flat)
    pair_programs, final_meta = plan[0], plan[3]
    held: list[Any] = list(results)
    backends: dict = {}

    def contract(pi, x, y):
        dev = comm.mapping.device(x)
        target = comm.devices[dev]
        logger.debug("fan-in: partition %d (device %d) <- partition %d (device %d)",
                     x, dev, y, comm.mapping.device(y))
        try:
            backend = backends.get(target)
            if backend is None:  # (a program runs in its buffers' dtype)
                backend = backends[target] = make_backend(
                    target, "complex64", split_complex, precision)
            held[x] = backend._run(pair_programs[pi], [held[x], to_device(held[y], target)])
        except Exception as exc:  # noqa: BLE001 — name the site
            raise PartitionExecutionError(x, dev, exc, phase="fanin") from exc
        held[y] = None
        return True

    _walk_fanin(levels, plan, item_bytes(results[0]), contract)
    root = _fanin_survivor(len(held), flat) if flat else 0
    return held[root], final_meta if flat else comm.results_meta[root]


def process_shard_map(
    k: int, toplevel: Sequence[tuple[int, int]], n_procs: int
) -> tuple[int, ...]:
    """Partition index → owning process for the process-sharded executor.
    The fan-in survivor is pinned to process 0 (the reference's rank-0
    contract); the rest round-robin across processes so every rank carries
    a near-equal share of the local phase.

    >>> process_shard_map(4, [(0, 1), (2, 3), (0, 2)], 2)
    (0, 1, 0, 1)
    """
    root = _fanin_survivor(k, toplevel) if toplevel else 0
    n_procs = max(int(n_procs), 1)
    owner = [0] * k
    for j, part in enumerate(i for i in range(k) if i != root):
        owner[part] = (j + 1) % n_procs
    return tuple(owner)


def _fetch_host(buf: Any):
    """Device buffer → host numpy payload for the store transport (a
    (real, imag) numpy pair in split mode)."""
    if isinstance(buf, tuple):
        return tuple(p.cpu().numpy() for p in buf)
    return buf.cpu().numpy()


def _place_host(payload, device):
    """The inverse of :func:`_fetch_host`: a host payload on ``device``."""
    import torch

    if isinstance(payload, tuple):
        return tuple(torch.from_numpy(p).to(device) for p in payload)
    return torch.from_numpy(payload).to(device)


def _process_sharded_contraction(
    tn: CompositeTensor,
    contract_path: ContractionPath,
    dtype: str,
    split_complex: bool | None,
    precision,
    hbm_bytes: int | None,
    local_sliced_strategy: str,
    slice_batch: int,
    chunk_steps: int,
    hoist: bool,
    device=None,
) -> LeafTensor:
    """Multi-process partitioned contraction under a ``torch.distributed``
    process group: partitions shard across the ranks
    (:func:`process_shard_map`), each rank places its partitions on its
    own device (:func:`rank_device`) and contracts them, and the fan-in
    walks the level schedule in the same order on every rank — a pair
    whose operands live on one rank reduces on its device; a cross-rank
    pair ships y's tensor as a host object over the group's store
    (:func:`send_object` / :func:`recv_object`) to x's owner, which
    contracts on its device. Every rank walks the same schedule, so the
    transport stays in lockstep by construction; the final tensor is
    broadcast from the survivor's owner (rank 0) to every rank, and the
    result is **bit-identical** to the single-process executor (same pair
    programs, same arithmetic, byte-exact transport).
    """
    from tnc_tpu_torch.contractionpath.communication_schemes import fanin_levels
    from tnc_tpu_torch.obs.core import process_identity
    from tnc_tpu_torch.ops.backends import place_buffers

    n_procs, me = process_identity()
    local = rank_device(device)
    if split_complex is None:
        split_complex = local.type != "cpu"

    children = _partitions(tn, contract_path)
    k = len(children)
    owner = process_shard_map(k, contract_path.toplevel, n_procs)
    mine = [i for i in range(k) if owner[i] == me]

    # every rank derives ALL partition programs on the host (cheap, no
    # communication): pair programs and result metas must agree everywhere
    # for the schedule to stay in lockstep
    with obs.span("partitioned.scatter", partitions=len(mine), process=me):
        programs, metas = _build_partition_programs(
            children, contract_path, hbm_bytes, lambda i: 0)
        buffers = {}
        for i in mine:
            try:
                buffers[i] = place_buffers(
                    _leaf_arrays(children[i]), dtype, split_complex, local
                )
            except Exception as exc:  # noqa: BLE001 — name the site
                raise PartitionExecutionError(
                    i, 0, exc, process=me, phase="scatter"
                ) from exc

    # local phase: this rank's partitions only, all on its device
    sub = Communication(
        DeviceTensorMapping(tuple(0 for _ in mine)),
        [local],
        [programs[i] for i in mine],
        [metas[i] for i in mine],
    )
    try:
        results = local_contract_partitions(
            sub,
            [buffers[i] for i in mine],
            split_complex,
            precision,
            sliced_strategy=local_sliced_strategy,
            dtype=dtype,
            slice_batch=slice_batch,
            chunk_steps=chunk_steps,
            hoist=hoist,
        )
    except PartitionExecutionError as exc:
        # name the global partition id, not the sub-communication's index
        raise PartitionExecutionError(
            mine[exc.partition], exc.device, exc.original,
            process=me, phase=exc.phase,
        ) from exc.original
    held: dict[int, Any] = dict(zip(mine, results))

    levels = fanin_levels(contract_path.toplevel)
    flat = [pair for level in levels for pair in level]
    plan = plan_fanin_pairs(metas, flat)
    pair_programs, final_meta = plan[0], plan[3]
    backend = make_backend(local, dtype, split_complex, precision)
    # one point-to-point namespace per fan-in: cross-rank pairs move from
    # sender to receiver only. Every rank reserves it (counter alignment),
    # even if no pair of the schedule crosses ranks.
    p2p_seq = p2p_sequence()

    def contract(pi, x, y):
        ox, oy = owner[x], owner[y]
        moved = None
        if ox == oy:
            if ox == me:
                moved = held.pop(y)
        elif p2p_seq is not None:
            if oy == me:
                send_object(_fetch_host(held.pop(y)), p2p_seq, pi)
            elif ox == me:
                moved = _place_host(recv_object(p2p_seq, pi), local)
        else:
            # no store: the all-process broadcast (lockstep per pair)
            payload = _fetch_host(held.pop(y)) if oy == me else None
            obj = broadcast_object(payload, root=oy)
            if ox == me:
                moved = _place_host(obj, local)
        if ox != me:
            return False
        try:
            held[x] = backend._run(pair_programs[pi], [held.pop(x), moved])
        except Exception as exc:  # noqa: BLE001 — name the site
            raise PartitionExecutionError(x, 0, exc, process=me, phase="fanin") from exc
        return True

    # every moved pair counts its payload, whether it stays on one rank or
    # crosses ranks, so the bytes compare with the single-process executor's
    _walk_fanin(levels, plan, float(np.dtype(dtype).itemsize), contract, process=me,
                cross_pairs=sum(owner[x] != owner[y] for x, y in flat))

    root_part = _fanin_survivor(k, flat) if flat else 0
    if not flat:
        final_meta = metas[root_part]
    data = None
    if owner[root_part] == me:
        data = host_result(held[root_part], split_complex, final_meta.bond_dims)
    # every rank returns the same tensor (byte-exact transport)
    data = broadcast_object(data, root=owner[root_part])
    return LeafTensor(
        list(final_meta.legs), list(final_meta.bond_dims), TensorData.matrix(data)
    )


def distributed_partitioned_contraction(
    tn: CompositeTensor,
    contract_path: ContractionPath,
    devices: list | None = None,
    n_devices: int | None = None,
    dtype: str = "complex64",
    split_complex: bool | None = None,
    precision: str | None = "float32",
    hbm_bytes: int | None = None,
    local_sliced_strategy: str = "chunked",
    slice_batch: int = 8,
    chunk_steps: int = 64,
    hoist: bool = False,
    communication_scheme=None,
    cost_model=None,
    process_sharded: bool | None = None,
    device=None,
) -> LeafTensor:
    """Contract a partitioned network with one partition per device.

    ``tn`` must be the output of ``partition_tensor_network`` (top-level
    children = partitions) and ``contract_path`` must carry a nested path
    per partition plus the toplevel communication schedule. ``devices``: a
    list of ``torch.device``\\ s, one slot per partition at least (a device
    may repeat); ``None`` takes every visible CUDA device (the first
    ``n_devices``) and raises without CUDA. ``split_complex=None`` means
    split on CUDA, native complex on the CPU. ``hbm_bytes`` sets a
    per-device budget; partitions that exceed it are locally sliced and
    run by ``local_sliced_strategy`` ('chunked', 'loop' or 'mesh';
    :func:`local_contract_partitions`), ``hoist=True`` running each sliced
    partition's slice-invariant stem once.

    ``communication_scheme`` (a :class:`~tnc_tpu_torch.contractionpath.
    communication_schemes.CommunicationScheme`): re-derive the fan-in
    schedule here via :func:`replan_fanin` instead of trusting
    ``contract_path.toplevel``.

    ``process_sharded``: shard partitions across the ranks of the
    ``torch.distributed`` process group the caller created
    (:func:`_process_sharded_contraction`, each rank on ``device`` —
    :func:`rank_device` — and bit-identical to the single-process result).
    ``None``: automatic whenever a group of more than one rank is up,
    *unless* an explicit ``devices`` / ``n_devices`` placement was given
    (which keeps the single-process path; combining one with
    ``process_sharded=True`` raises).
    """
    from tnc_tpu_torch.obs.core import process_identity

    if communication_scheme is not None:
        contract_path = replan_fanin(tn, contract_path, communication_scheme, cost_model)
    explicit_placement = devices is not None or n_devices is not None
    if process_sharded is None:
        process_sharded = process_identity()[0] > 1 and not explicit_placement
    if process_sharded:
        if explicit_placement:
            raise ValueError(
                "process_sharded=True places partitions on each rank's own "
                "device itself; devices/n_devices cannot be combined with it"
            )
        return _process_sharded_contraction(
            tn, contract_path, dtype, split_complex, precision, hbm_bytes,
            local_sliced_strategy, slice_batch, chunk_steps, hoist, device,
        )
    devices = resolve_devices(devices, n_devices)
    if split_complex is None:
        split_complex = devices[0].type != "cpu"

    comm, buffers = scatter_partitions(
        tn, contract_path, devices, dtype, split_complex, hbm_bytes=hbm_bytes
    )
    results = local_contract_partitions(
        comm,
        buffers,
        split_complex,
        precision,
        sliced_strategy=local_sliced_strategy,
        dtype=dtype,
        slice_batch=slice_batch,
        chunk_steps=chunk_steps,
        hoist=hoist,
    )
    final, meta = intermediate_reduce(
        comm, contract_path.toplevel, results, split_complex, precision
    )
    # device buffers live in stored (merged) shape; restore leg granularity
    data = host_result(final, split_complex, meta.bond_dims)
    return LeafTensor(list(meta.legs), list(meta.bond_dims), TensorData.matrix(data))


def flatten_partitioned_path(
    tn: CompositeTensor, contract_path: ContractionPath
) -> tuple[list[LeafTensor], list[tuple[int, int]]]:
    """Inline a partitioned path into one flat replace-left path over the
    global leaf list (children in index order, as ``flat_leaf_tensors``
    orders them) — the form the slicing planner consumes.

    >>> import random
    >>> from tnc_tpu_torch.contractionpath.repartitioning import compute_solution
    >>> tn = CompositeTensor([LeafTensor([0, 1], [2, 2]),
    ...     LeafTensor([1, 2], [2, 2]), LeafTensor([2, 3], [2, 2]),
    ...     LeafTensor([3, 0], [2, 2])])
    >>> ptn, ppath, _, _ = compute_solution(tn, [0, 0, 1, 1],
    ...     rng=random.Random(0))
    >>> leaves, pairs = flatten_partitioned_path(ptn, ppath)
    >>> len(leaves), len(pairs)   # 4 leaves, fully contracted
    (4, 3)
    """
    flat_leaves: list[LeafTensor] = []
    start: dict[int, int] = {}
    children = list(tn.tensors)
    for ci, child in enumerate(children):
        if not isinstance(child, CompositeTensor):
            raise TypeError(f"top-level child {ci} is not a partition composite")
        start[ci] = len(flat_leaves)
        flat_leaves.extend(child.tensors)  # type: ignore[arg-type]

    pairs: list[tuple[int, int]] = []
    rep: dict[int, int] = {}
    for ci, child in enumerate(children):
        local = contract_path.nested[ci].toplevel
        base = start[ci]
        for i, j in local:
            pairs.append((base + i, base + j))
        rep[ci] = base + _fanin_survivor(len(child.tensors), local)
    for x, y in contract_path.toplevel:
        pairs.append((rep[x], rep[y]))
    return flat_leaves, pairs


def distributed_partitioned_sliced_contraction(
    tn: CompositeTensor,
    contract_path: ContractionPath,
    devices: list | None = None,
    n_devices: int | None = None,
    dtype: str = "complex64",
    split_complex: bool | None = None,
    precision: str | None = "float32",
    hbm_bytes: int | None = None,
    target_size: float | None = None,
    max_slices: int | None = None,
):
    """Partitioning × **global** slicing (BASELINE config #5): legs are
    sliced across the *whole* network — partition cut edges included — and
    for every slice each device contracts its partition, the fan-in
    reduces the slice's result over the devices, and the results
    accumulate on the root device.

    ``target_size`` (elements) fixes the slicing directly; otherwise it is
    derived from ``hbm_bytes`` (default: the device's memory).
    ``max_slices`` caps the loop (benchmark subset mode — the sum is then
    partial). Returns ``(result leaf, slicing)``.
    """
    run, slicing, final_meta = partitioned_sliced_executor(
        tn,
        contract_path,
        devices=devices,
        n_devices=n_devices,
        dtype=dtype,
        split_complex=split_complex,
        precision=precision,
        hbm_bytes=hbm_bytes,
        target_size=target_size,
    )
    data = run(max_slices)
    return (
        LeafTensor(
            list(final_meta.legs), list(final_meta.bond_dims), TensorData.matrix(data)
        ),
        slicing,
    )


def global_slicing_target(hbm_bytes: float) -> float:
    """Per-slice element target for the composed pipeline: split-complex
    working set ~8 bytes/elem x ~8 live copies."""
    return max(float(hbm_bytes) / 64.0, 4.0)


def plan_global_slicing(
    flat_leaves, flat_pairs, target_size: float, max_slices: int = 1 << 24
):
    """Find the global slicing for a flattened partitioned path at
    ``target_size`` elements, relaxing the target 4x at a time when it
    needs more slices than ``max_slices`` (the per-slice footprint then
    overshoots the budget — best effort; the caller sees the slicing and
    can re-plan). Host only.

    ``max_slices`` defaults to the executable regime; plan ranking may pass
    a deep cap (2^40) so that budget-infeasible candidates are recognized
    rather than silently relaxed — an executor must never inherit that
    cap, or a tiny-peak network turns into a billion-iteration slice
    loop."""
    from tnc_tpu_torch.contractionpath.slicing import find_slicing

    while True:
        try:
            return find_slicing(flat_leaves, flat_pairs, target_size, max_slices=max_slices)
        except ValueError:
            if target_size > 2.0**62:
                raise
            target_size *= 4.0
            logger.warning("global slicing target relaxed to %g elements", target_size)


def partitioned_sliced_executor(
    tn: CompositeTensor,
    contract_path: ContractionPath,
    devices: list | None = None,
    n_devices: int | None = None,
    dtype: str = "complex64",
    split_complex: bool | None = None,
    precision: str | None = "float32",
    hbm_bytes: int | None = None,
    target_size: float | None = None,
    plan_max_slices: int = 1 << 24,
):
    """Plan the partitioned × globally-sliced pipeline once and return
    ``(run, slicing, final_meta)`` where ``run(max_slices=None)`` executes
    the slice loop (partial sum when capped) and returns the accumulated
    host array; the placed leaves, programs and kernel policies are reused
    across calls (a benchmark warms up with one slice, then times a
    subset).

    ``plan_max_slices``: forwarded to :func:`plan_global_slicing` — a
    benchmark passes its deep ranking cap (2^40) so that the slicing the
    executor runs is the one its strategy ranking scored; interactive
    callers keep the executable default.

    Per slice: each partition's leaves are pinned to the slice (a dense
    copy of each sliced leaf's slice), its program runs on its device on a
    stream of its own under the no-model kernel ladder
    (:func:`~tnc_tpu_torch.ops.split_complex.plan_kernels`, chains through
    ``fused_chain``), the slice's fan-in reduces over the devices, and the
    survivor adds into the sum on the root device."""
    import torch

    from tnc_tpu_torch.contractionpath.communication_schemes import fanin_levels
    from tnc_tpu_torch.ops.backends import _run_steps, place_buffers
    from tnc_tpu_torch.ops.budget import device_hbm_bytes
    from tnc_tpu_torch.ops.sliced import _slice_indices, build_sliced_program, index_buffer
    from tnc_tpu_torch.ops.split_complex import plan_kernels, run_steps_split

    devices = resolve_devices(devices, n_devices)
    if split_complex is None:
        split_complex = devices[0].type != "cpu"

    flat_leaves, flat_pairs = flatten_partitioned_path(tn, contract_path)
    if target_size is None:
        if hbm_bytes is None:
            hbm_bytes = device_hbm_bytes(devices[0])
        target_size = global_slicing_target(hbm_bytes)
    slicing = plan_global_slicing(
        flat_leaves, flat_pairs, target_size, max_slices=plan_max_slices
    )
    logger.debug(
        "global slicing: %d legs, %d slices (target %g elems)",
        len(slicing.legs), slicing.num_slices, target_size,
    )

    children = list(tn.tensors)
    k = len(children)
    if k > len(devices):
        raise ValueError(f"{k} partitions but only {len(devices)} devices")
    mapping = DeviceTensorMapping.for_path(k, contract_path.toplevel)
    sps = [
        build_sliced_program(child, contract_path.nested[i], slicing)
        for i, child in enumerate(children)
    ]
    metas = [
        LeafTensor(list(sp.program.result_legs), list(sp.program.result_shape))
        for sp in sps
    ]
    part_devices = [devices[mapping.device(i)] for i in range(k)]
    buffers = [
        place_buffers(_leaf_arrays(child), dtype, split_complex, part_devices[i])
        for i, child in enumerate(children)
    ]
    policies = [plan_kernels(sp.program) if split_complex else None for sp in sps]

    def local(i: int, indices):
        sp = sps[i]

        def pin(buf, info):
            if not info:
                return buf
            return tuple(index_buffer(p, info, indices).contiguous() for p in parts(buf)) \
                if split_complex else index_buffer(buf, info, indices).contiguous()

        sliced = [pin(buf, info) for buf, info in zip(buffers[i], sp.slot_slices)]
        if split_complex:
            return run_steps_split(sp.program, sliced, precision, policy=policies[i])
        return _run_steps(sp.program, sliced)

    # fan-in pair programs are slice-independent (legs already reduced);
    # programs indexed in FLATTENED level order (the tree is unchanged)
    levels = fanin_levels(contract_path.toplevel)
    flat_top = [pair for level in levels for pair in level]
    fanin_plan = plan_fanin_pairs(metas, flat_top)
    pair_programs, final_meta = fanin_plan[0], fanin_plan[3]
    root = _fanin_survivor(k, flat_top) if flat_top else 0
    if not flat_top:
        final_meta = metas[root]
    backends = {dev: make_backend(dev, dtype, split_complex, precision)
                for dev in set(part_devices)}
    elem_bytes = float(np.dtype(dtype).itemsize)

    def run_slices(num: int):
        acc = None
        for s in range(num):
            indices = _slice_indices(slicing, s)
            held = []
            for i in range(k):
                with device_stream(part_devices[i]):
                    out = local(i, indices)
                held.append(handed_over(out, part_devices[i]))

            def contract(pi, x, y, held=held):
                target = part_devices[x]
                held[x] = backends[target]._run(
                    pair_programs[pi], [held[x], to_device(held[y], target)])
                held[y] = None
                return True

            # the slice's tree reduce; the survivor stays on the root
            # device. Spans for the first slice of a run only (one
            # schedule, many identical slices)
            _walk_fanin(levels, fanin_plan, elem_bytes, contract, record=(s == 0))
            if acc is None:
                acc = held[root]
            elif split_complex:
                acc = (acc[0] + held[root][0], acc[1] + held[root][1])
            else:
                acc = acc + held[root]
        return acc

    def run(max_slices: int | None = None):
        num = slicing.num_slices if max_slices is None else min(
            slicing.num_slices, max_slices
        )
        with obs.maybe_jax_profiler_trace(), obs.span(
            "partitioned.sliced_run", slices=num, partitions=k
        ), torch.inference_mode():
            acc = run_slices(num)
            return host_result(acc, split_complex, final_meta.bond_dims)

    return run, slicing, final_meta


# ---------------------------------------------------------------------------
# the object transport over the process group's c10d store

# process-local counter giving every broadcast_object call a unique,
# deterministic store key. broadcast_object is a collective: all processes
# call it the same number of times in the same order, so their counters
# agree by construction.
_KV_BCAST_SEQ = 0
_KV_BCAST_TIMEOUT_MS = 120_000
# how often a parked (``wait_forever``) receiver looks for its exclusion mark
_KV_PARK_POLL_MS = 1_000


def _coordination_client():
    """The c10d store of the default process group (the TCP or file store
    ``init_process_group`` already set up), or ``None`` when no group is
    up. The private-API access is isolated here on purpose."""
    if not group_up():
        return None
    try:
        from torch.distributed import distributed_c10d

        return distributed_c10d._get_default_store()
    except Exception:  # noqa: BLE001 — any API drift → collective fallback
        return None


def _timeout_ms(timeout_s: float | None) -> int:
    if timeout_s is None:
        return _KV_BCAST_TIMEOUT_MS
    return max(int(float(timeout_s) * 1000.0), 1)


def _store_wait(store, keys: list[str], timeout_ms: int) -> None:
    """``store.wait`` with an expired wait raised as :class:`TimeoutError`
    (TRANSIENT under :func:`~tnc_tpu_torch.resilience.retry.
    classify_exception`); any other store error re-raises as it is."""
    import datetime

    try:
        store.wait(keys, datetime.timedelta(milliseconds=timeout_ms))
    except RuntimeError as exc:  # DistStoreError (TCP) or RuntimeError (file store)
        if "timeout" not in str(exc).lower() and "timed out" not in str(exc).lower():
            raise
        raise TimeoutError(
            f"store wait for {keys} expired after {timeout_ms} ms"
        ) from exc


def _readers(n: int, root: int, members) -> list[int]:
    """The processes besides ``root`` whose part a collective waits for:
    every one of ``n``, or those of ``members`` (a process that left the
    group's collectives is waited for no longer)."""
    keep = range(n) if members is None else {int(p) for p in members}
    return [p for p in sorted(keep) if p != root and 0 <= p < n]


def _reclaim(store, keys: list[str], arrivals: list[str], timeout_ms: int, what: str) -> None:
    """The root's cleanup of one collective: once every reader's arrival
    key is there (each reader sets its own after it has read), delete the
    payload keys and the arrivals. Best effort: on a wait or delete failure
    the keys stay (leak, not break), and a reader that died stalls the root
    here for ``timeout_ms`` at most."""
    try:
        if arrivals:
            _store_wait(store, arrivals, timeout_ms)
        for key in keys + arrivals:
            store.delete_key(key)
    except Exception:  # noqa: BLE001 — cleanup must never fail a collective
        logger.debug("%s key cleanup skipped", what)


class ProcessExcluded(RuntimeError):
    """The root left this process out of its collectives
    (:func:`exclude_process`): it stopped waiting on the process, whose
    place in the group's sequence is gone. Raised by a ``wait_forever``
    receiver of :func:`broadcast_object`; the process must leave."""


def _excluded_key(root: int, process: int) -> str:
    return f"tnc_tpu/excluded/{root}/{process}"


def exclude_process(process: int, root: int = 0) -> None:
    """Mark ``process`` as left out of ``root``'s collectives, for good (the
    root's call once it stops waiting on the process, e.g. after its gather
    slot was lost): the process's parked ``wait_forever``
    :func:`broadcast_object` raises :class:`ProcessExcluded` instead of
    waiting on a sequence that goes on without it. No-op without a store."""
    store = _coordination_client()
    if store is not None:
        store.set(_excluded_key(root, process), b"1")


def broadcast_object(
    obj,
    root: int = 0,
    wait_forever: bool = False,
    timeout_s: float | None = None,
    members=None,
):
    """Broadcast any picklable object from process ``root`` to all
    processes — the transport under :func:`broadcast_path` and the
    cross-process fan-in (the reference's serialized MPI broadcast,
    ``mpi/communication.rs:14-28``).

    Identity when running as one process; non-root processes pass any
    value (it is ignored) and receive root's object.

    ``wait_forever``: a receiver re-arms its store wait past the transport
    timeout instead of raising — the serving fleet's command channel
    (:mod:`tnc_tpu_torch.serve.multihost`), where a worker legitimately
    blocks on the *next* command through idle periods of any length. The
    per-call sequence key is taken once, so re-armed waits stay in
    lockstep with the sender. Such a receiver looks for its exclusion mark
    (:func:`exclude_process`) every second it waits and once the payload
    is there, and raises :class:`ProcessExcluded` when the root has left it
    out: a process that was only slow never parks on a key that the root
    set and deleted without it.

    ``timeout_s``: bound every wait of this call (a receiver's wait for the
    payload, the root's wait for the readers) instead of the 120 s
    default; a receiver's expired wait raises :class:`TimeoutError`
    (TRANSIENT under :func:`~tnc_tpu_torch.resilience.retry.
    classify_exception`). Ignored by a ``wait_forever`` receiver.

    ``members`` (the root's argument): the processes still taking part in
    the group's collectives; the root waits for no other reader. The
    serving fleet's dispatcher drops a process whose gather slot was lost
    (:class:`GatherLost`), so that later rounds do not wait on it, and
    tells it so (:func:`exclude_process`).

    Transport: the process group's **c10d store**. The root ``set``\\ s the
    pickled payload under a per-call sequence key; every other process
    waits on it, ``get``\\ s it and sets an arrival key of its own; the
    root waits for the readers' arrivals and deletes the keys. Control-plane
    data on the store's TCP or file channel, not the GPUs' data plane. The
    root does not block on a receiver that died past ``timeout_s`` (the
    cleanup gives up and leaves the key). Without a store, the all-process
    ``torch.distributed.broadcast_object_list`` (under NCCL it needs
    ``torch.cuda.set_device`` called first).
    """
    from tnc_tpu_torch.obs.core import process_identity

    n, me = process_identity()
    if n == 1:
        return obj

    import pickle

    global _KV_BCAST_SEQ
    is_root = me == root
    store = _coordination_client()
    if store is not None:
        timeout_ms = _timeout_ms(timeout_s)
        seq = _KV_BCAST_SEQ
        _KV_BCAST_SEQ += 1
        key = f"tnc_tpu/bcast/{root}/{seq}"
        done = f"tnc_tpu/bcast_done/{root}/{seq}"
        if is_root:
            blob = pickle.dumps(obj)
            store.set(key, blob)
            arrivals = [f"{done}/{p}" for p in _readers(n, root, members)]
            _reclaim(store, [key], arrivals, timeout_ms, key)
            return pickle.loads(blob)
        while True:
            try:
                _store_wait(store, [key], _KV_PARK_POLL_MS if wait_forever else timeout_ms)
                arrived = True
            except TimeoutError as exc:
                if not wait_forever:
                    raise TimeoutError(
                        f"broadcast wait for {key} expired after {timeout_ms} ms "
                        "(sender dead or stalled)"
                    ) from exc
                arrived = False  # the same key: the sender has not spoken yet
            if wait_forever and store.check([_excluded_key(root, me)]):
                raise ProcessExcluded(
                    f"process {me} was left out of process {root}'s collectives"
                )
            if arrived:
                break
        out = pickle.loads(store.get(key))
        store.set(f"{done}/{me}", b"1")
        return out

    import torch.distributed as dist

    box = [obj if is_root else None]
    dist.broadcast_object_list(box, src=root)
    return box[0]


class GatherLost:
    """Root-side placeholder for a gather slot whose sender never delivered
    within the timeout (dead or stalled process), or that the root did not
    wait for (a process outside ``members``). Carries the source process
    index; only ever appears in :func:`gather_objects` output when
    ``missing_ok=True`` or ``members`` leaves a process out."""

    def __init__(self, process: int):
        self.process = int(process)

    def __repr__(self) -> str:
        return f"GatherLost(process={self.process})"

    def __eq__(self, other) -> bool:
        return isinstance(other, GatherLost) and other.process == self.process

    def __hash__(self) -> int:
        return hash(("GatherLost", self.process))


def gather_objects(
    obj,
    root: int = 0,
    timeout_s: float | None = None,
    missing_ok: bool = False,
    members=None,
) -> list | None:
    """Gather one picklable object per process at ``root``: returns the
    per-process list (index = rank) on the root, ``None`` elsewhere. The
    inverse of :func:`broadcast_object`: each sender ``set``\\ s its slot
    of one shared sequence key and returns; only the root reads the slots,
    and deletes them. Every process must call this in the same order.

    ``timeout_s`` bounds the root's whole collection (a shared deadline
    across slots, floor 1 s per remaining slot). An expired slot raises
    :class:`TimeoutError` (TRANSIENT under :func:`~tnc_tpu_torch.
    resilience.retry.classify_exception`) — or, with ``missing_ok=True``,
    lands a :class:`GatherLost` in that slot so the caller can reassign the
    lost work. ``members`` (the root's argument): the processes whose slots
    the root waits for; any other slot is a :class:`GatherLost` at once.

    Identity as one process (returns ``[obj]``). Without a store, n
    :func:`broadcast_object` rounds.
    """
    from tnc_tpu_torch.obs.core import process_identity

    n, me = process_identity()
    if n == 1:
        return [obj]

    import pickle

    global _KV_BCAST_SEQ
    store = _coordination_client()
    if store is None:
        # collective fallback: everyone hears everything (n broadcasts)
        parts = [broadcast_object(obj if me == src else None, root=src) for src in range(n)]
        return parts if me == root else None

    timeout_ms = _timeout_ms(timeout_s)
    seq = _KV_BCAST_SEQ
    _KV_BCAST_SEQ += 1
    prefix = f"tnc_tpu/gather/{root}/{seq}"
    if me != root:
        store.set(f"{prefix}/{me}", pickle.dumps(obj))
        return None
    parts: list = [GatherLost(src) for src in range(n)]
    parts[root] = obj
    read = []
    deadline = time.monotonic() + timeout_ms / 1000.0
    for src in _readers(n, root, members):
        remaining_ms = max(int((deadline - time.monotonic()) * 1000.0), 1000)
        try:
            _store_wait(store, [f"{prefix}/{src}"], remaining_ms)
        except TimeoutError as exc:
            if not missing_ok:
                raise TimeoutError(
                    f"gather wait for process {src} expired after "
                    f"{remaining_ms} ms (process dead or stalled)"
                ) from exc
            continue
        parts[src] = pickle.loads(store.get(f"{prefix}/{src}"))
        read.append(f"{prefix}/{src}")
    # the root is the slots' only reader: it deletes what it read (a slot
    # written after its timeout stays: leak, not break)
    _reclaim(store, read, [], timeout_ms, prefix)
    return parts


def p2p_sequence() -> int | None:
    """Reserve one point-to-point key namespace for the calling collective.
    EVERY process must call this at the same point of the same collective
    (it advances the shared sequence counter, keeping later
    :func:`broadcast_object` keys aligned) even though only a
    sender/receiver pair touches each :func:`send_object` /
    :func:`recv_object` slot under it. Returns ``None`` when no store is
    available — callers fall back to :func:`broadcast_object`."""
    global _KV_BCAST_SEQ
    seq = _KV_BCAST_SEQ
    _KV_BCAST_SEQ += 1
    return seq if _coordination_client() is not None else None


def send_object(obj, seq: int, slot: int) -> None:
    """Point-to-point send: publish ``obj`` under slot ``slot`` of the
    :func:`p2p_sequence` namespace ``seq``. Non-blocking; only the one
    consumer (:func:`recv_object`) reads it."""
    import pickle

    _coordination_client().set(f"tnc_tpu/p2p/{seq}/{slot}", pickle.dumps(obj))


def recv_object(seq: int, slot: int):
    """Point-to-point receive half of :func:`send_object`. The receiver is
    the slot's only consumer, so it deletes the key itself after reading
    (best effort). A wait past the transport timeout (120 s) raises
    :class:`TimeoutError`."""
    import pickle

    store = _coordination_client()
    key = f"tnc_tpu/p2p/{seq}/{slot}"
    _store_wait(store, [key], _KV_BCAST_TIMEOUT_MS)
    out = pickle.loads(store.get(key))
    try:
        store.delete_key(key)
    except Exception:  # noqa: BLE001 — cleanup must never fail a recv
        logger.debug("p2p key cleanup skipped for %s", key)
    return out


def broadcast_path(path_: ContractionPath, root: int = 0) -> ContractionPath:
    """Share the planner's path with every process (``broadcast_path``,
    ``communication.rs:32-49``): the identity as one process; under a
    process group, the path found by ``root`` travels to all others as
    serialized bytes (:func:`broadcast_object`)."""
    return broadcast_object(path_, root=root)


# Reference-named aliases (``mpi/communication.rs:125,199``)
scatter_tensor_network = scatter_partitions
intermediate_reduce_tensor_network = intermediate_reduce
# the reference's generic serialized broadcast (``broadcast_serializing``,
# ``mpi/communication.rs:14-28``) — any picklable object from root to all
broadcast_serializing = broadcast_object
