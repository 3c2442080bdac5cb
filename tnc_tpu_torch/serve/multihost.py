"""Multi-host sharded serving: one fleet, one queue, N processes (the
port's copy of ``tnc_tpu.serve.multihost``).

The single-process :class:`~tnc_tpu_torch.serve.service.ContractionService`
micro-batches requests into one dispatch. This module spreads that
dispatch across every process of a ``torch.distributed`` process group:

- **batched bras shard across processes** — the root process
  micro-batches as usual, then fans the batch's bitstrings out in
  contiguous shards (:func:`shard_ranges`); every process answers its
  shard with its own :class:`~tnc_tpu_torch.serve.rebind.BoundProgram`,
  and the rows gather back at the root. Each amplitude is computed wholly
  in one process by the identical program on the same shard, so the
  fleet's rows are **bit-identical** to one process's run of the same
  shards (on a :class:`~tnc_tpu_torch.ops.backends.NumpyBackend`, whose
  rows do not depend on the batch, to one run of the whole batch);
- **slice ranges shard across processes** — a memory-sliced structure's
  per-request slice loop splits into contiguous ranges
  (``amplitudes_det(..., slice_range=)``), each process sums its range,
  and the root adds the range partials *in range order*. The association
  of the sum differs from the one-process loop, so range-sharded
  amplitudes agree to accumulation rounding (not bitwise).

Transport: every control and data message rides the c10d store of the
process group (:func:`~tnc_tpu_torch.parallel.partitioned.broadcast_object`
and :func:`~tnc_tpu_torch.parallel.partitioned.gather_objects`), with
``wait_forever`` so that an idle worker blocks on the next command
indefinitely instead of timing out. All processes run the same sequence of
collectives in the same order: one command broadcast, then one gather.
A process whose gather slot was lost leaves the sequence: the dispatcher
waits on it no longer and marks it excluded
(:func:`~tnc_tpu_torch.parallel.partitioned.exclude_process`), so a worker
that was only slow raises
:class:`~tnc_tpu_torch.parallel.partitioned.ProcessExcluded` at its next
park instead of waiting forever (the reference's rounds go on waiting on
a lost process).

Deployment shape:

- every process binds the same circuit against a **shared**
  :class:`~tnc_tpu_torch.serve.plancache.PlanCache` directory, so the
  fleet plans once — the first process to publish wins, everyone else
  gets a planner-free cache hit;
- process 0 runs the :class:`~tnc_tpu_torch.serve.service.ContractionService`
  with a :class:`ClusterDispatcher`; every other process parks in
  :func:`serve_cluster`;
- a :class:`~tnc_tpu_torch.serve.replan.SharedCacheWatcher` per process
  makes the background replanner's swaps visible fleet-wide.

Process identity (index and count) comes from ``torch.distributed``
(:func:`~tnc_tpu_torch.obs.core.process_identity`); without a process
group every entry point runs as one process.
"""

from __future__ import annotations

import logging
import os
import threading
import weakref
from typing import Sequence

import numpy as np

from tnc_tpu_torch import obs
from tnc_tpu_torch.obs import fleet as _fleet
from tnc_tpu_torch.parallel.partitioned import (
    GatherLost,
    broadcast_object,
    exclude_process,
    gather_objects,
)
from tnc_tpu_torch.resilience.faultinject import fault_point
from tnc_tpu_torch.serve.rebind import BoundProgram, bind_template

logger = logging.getLogger(__name__)


class DispatcherStoppedError(RuntimeError):
    """The ClusterDispatcher was stopped; the call never entered the
    fleet's collective sequence. A clean shutdown signal (the service's
    degrade path fails only the in-flight requests), never a sign of
    fleet desync."""


class _ShardFailure:
    """A process's shard computation failed. Gathered in place of the
    rows so the fleet's collective sequence stays in lockstep — the
    root raises AFTER the gather completes (naming the process), which
    means a transient shard error surfaces as a retryable batch failure
    instead of desynchronizing the per-process broadcast counters (the
    service's retry re-dispatches into a still-synced fleet)."""

    def __init__(self, process: int, exc: BaseException):
        self.process = process
        self.error = f"{type(exc).__name__}: {exc}"

    def __repr__(self) -> str:  # shows up in the root's raise
        return f"process {self.process}: {self.error}"


def _raise_shard_failures(parts: list) -> None:
    failures = [p for p in parts if isinstance(p, _ShardFailure)]
    if failures:
        raise RuntimeError(
            "cluster shard computation failed on "
            + "; ".join(repr(f) for f in failures)
        )


def _procs() -> tuple[int, int]:
    """(process_count, process_index) — (1, 0) without a process group, so
    every entry point degrades to local execution."""
    from tnc_tpu_torch.obs.core import process_identity

    return process_identity()


def shard_ranges(n_items: int, n_parts: int) -> list[tuple[int, int]]:
    """Split ``[0, n_items)`` into ``n_parts`` contiguous ranges whose
    sizes differ by at most one (leading ranges take the remainder).
    Empty ranges are legal — a 3-request batch on an 8-host fleet
    simply idles five hosts for that round.

    >>> shard_ranges(7, 3)
    [(0, 3), (3, 5), (5, 7)]
    >>> shard_ranges(2, 4)
    [(0, 1), (1, 2), (2, 2), (2, 2)]
    """
    n_parts = max(int(n_parts), 1)
    base, extra = divmod(max(int(n_items), 0), n_parts)
    out = []
    lo = 0
    for p in range(n_parts):
        hi = lo + base + (1 if p < extra else 0)
        out.append((lo, hi))
        lo = hi
    return out


def _concat_rows(parts: Sequence) -> np.ndarray:
    """Concatenate per-process row shards, dropping EMPTY shards first:
    ``amplitudes_det([])`` returns complex128 zeros whatever the
    backend dtype, and ``np.concatenate`` promotes across all inputs —
    so a batch smaller than the fleet (idle hosts return empty shards)
    would otherwise upcast the whole batch's dtype relative to the same
    batch on a single host."""
    arrays = [np.asarray(p) for p in parts]
    filled = [a for a in arrays if a.shape[0]] or arrays[:1]
    return np.concatenate(filled, axis=0)


def _gather_rows(
    mine, me: int, n: int, root: int, timeout_s: float | None = None,
    members=None,
) -> list | None:
    """Collective gather of per-process payloads at the root (one
    root-only-read store round, O(n · payload) — not n broadcasts); every
    process participates, non-root processes get ``None``. ``mine`` is
    this process's payload — possibly a :class:`_ShardFailure`, which the
    root raises only after the gather completed, keeping the fleet's
    collective sequence in lockstep through shard errors.

    ``timeout_s`` bounds every wait (elastic fleets): a slot whose process
    died mid-round comes back as a :class:`~tnc_tpu_torch.parallel.
    partitioned.GatherLost` marker instead of hanging the root — the
    caller reassigns that shard to a survivor. ``members``: the processes
    the root waits for (the others' slots are ``GatherLost`` at once)."""
    parts = gather_objects(
        mine, root=root, timeout_s=timeout_s,
        missing_ok=timeout_s is not None, members=members,
    )
    if me == root:
        _raise_shard_failures(parts)
    return parts


def _lost_slots(
    parts: list, ranges, members, lost, root: int
) -> list[tuple[int, int, int]]:
    """The root's view of a gather's lost slots: ``(process, lo, hi)`` for
    every :class:`GatherLost` of a process that was still a member this
    round (each added to ``lost`` and, with a ``lost`` set, marked
    excluded: :func:`exclude_process`). A process outside ``members`` left
    in an earlier round: its range is empty and its slot is dropped."""
    out = []
    for src, part in enumerate(parts):
        if not isinstance(part, GatherLost):
            continue
        if members is not None and src not in members:
            parts[src] = None
            continue
        if lost is not None:
            lost.add(src)
            exclude_process(src, root)
        lo, hi = ranges[src] if src < len(ranges) else (0, 0)
        out.append((src, lo, hi))
    return out


def cluster_amplitudes(
    bound: BoundProgram,
    batch_bits: Sequence[str],
    backend=None,
    root: int = 0,
    ranges: Sequence[tuple[int, int]] | None = None,
    timeout_s: float | None = None,
    members=None,
    lost: set | None = None,
) -> np.ndarray | None:
    """One collective bra-sharded batch: every process of the fleet
    computes a contiguous shard of ``batch_bits`` with its local ``bound``
    and the rows gather at ``root``. Returns the full ``(B,) +
    result_shape`` array on the root process, ``None`` elsewhere. **All
    processes must call this with the same batch** (the root's command
    loop guarantees that in service deployments).

    Bit-identical to one process's ``bound.amplitudes_det`` of the same
    shards: each row is produced by the same program, backend and
    arithmetic — sharding only changes *where*, never *how*.

    ``ranges`` overrides the default even split with an explicit
    per-process row assignment (the elastic dispatcher's roster-aware
    placement: stale members get empty ranges). ``timeout_s`` bounds the
    gather; a shard lost to a dead process is recomputed at the root
    (bit-identical — same program, same rows) and counted as
    ``serve.elastic.reassigned``. ``members`` (root): the processes still
    in the fleet's collectives, the only ones waited for; ``lost`` (root):
    a set the processes lost this round are added to, each then marked
    excluded (:func:`exclude_process`).
    """
    n, me = _procs()
    if n == 1:
        return bound.amplitudes_det(list(batch_bits), backend)
    if ranges is None:
        ranges = shard_ranges(len(batch_bits), n)
    lo, hi = ranges[me] if me < len(ranges) else (0, 0)
    try:
        with obs.span(
            "serve.cluster_shard", mode="bras", rows=hi - lo, process=me
        ):
            mine = bound.amplitudes_det(list(batch_bits[lo:hi]), backend)
    except Exception as exc:  # noqa: BLE001 — stay in collective lockstep
        mine = _ShardFailure(me, exc)
    parts = _gather_rows(mine, me, n, root, timeout_s=timeout_s, members=members)
    if me != root:
        return None
    for src, slo, shi in _lost_slots(parts, ranges, members, lost, root):
        # the process died mid-round: its rows rerun HERE, under the
        # same program and backend, so the batch stays bit-identical
        logger.warning(
            "cluster_amplitudes: process %d lost mid-round; recomputing "
            "rows [%d, %d) at the root", src, slo, shi,
        )
        _note_reassigned(mode="bras")
        parts[src] = bound.amplitudes_det(
            list(batch_bits[slo:shi]), backend
        )
    return _concat_rows([p for p in parts if p is not None])


def _note_reassigned(mode: str) -> None:
    """Count a lost-shard reassignment on both surfaces: the obs registry
    (``serve.elastic.reassigned`` — scraped via /metrics) and the elastic
    module's cumulative tally (``stats()["elastic"]``)."""
    obs.counter_add("serve.elastic.reassigned", mode=mode)
    from tnc_tpu_torch.serve import elastic as _elastic

    _elastic.count_event("reassigned")


def cluster_amplitudes_sliced(
    bound: BoundProgram,
    batch_bits: Sequence[str],
    backend=None,
    root: int = 0,
    ranges: Sequence[tuple[int, int]] | None = None,
    timeout_s: float | None = None,
    ckpt_dir: str | None = None,
    members=None,
    lost: set | None = None,
) -> np.ndarray | None:
    """One collective slice-range-sharded batch for a memory-sliced
    structure: every process runs the WHOLE batch over its contiguous share
    of the slice range (``amplitudes_det(slice_range=)``) and the root sums
    the range partials in range order. Exact up to float accumulation
    association (the one-process loop adds slice by slice, the fleet adds
    range partials) — use :func:`cluster_amplitudes` when bitwise
    reproducibility beats slice-loop wall-clock.

    The elastic knobs (all optional, default = frozen fleet):

    - ``ranges``: explicit per-process slice-range assignment (the
      roster-aware placement — stale members get ``(0, 0)``);
    - ``timeout_s``: bounds the gather. A range lost to a dead process is
      *reassigned* to the root, which — with ``ckpt_dir`` on a backend with
      slice hooks — resumes from the dead worker's last slice-boundary
      checkpoint on the shared directory; the resumed partial accumulates
      the remaining slices in the same order with the same kernels, so the
      recovered batch is **bit-identical** to the unfailed run. A
      ``TorchBackend`` has no slice hooks: its lost range is recomputed
      from its start at the root, with the same program and kernels;
    - ``ckpt_dir``: shared checkpoint directory; every range shard persists
      its cursor and accumulator there at the configured cadence
      (``TNC_TPU_CKPT_EVERY`` / ``TNC_TPU_CKPT_SECS``);
    - ``members`` / ``lost`` (root): as in :func:`cluster_amplitudes`.

    Workers expose the ``cluster.worker`` fault site once per completed
    slice (``phase="slice"``, backends with slice hooks), so a
    deterministic mid-request worker kill is one ``TNC_TPU_FAULTS`` rule
    away.
    """
    n, me = _procs()
    if n == 1:
        return bound.amplitudes_det(list(batch_bits), backend)
    if bound.sliced is None:
        raise ValueError(
            "cluster_amplitudes_sliced needs a sliced bound program"
        )
    num = bound.sliced.slicing.num_slices
    if ranges is None:
        ranges = shard_ranges(num, n)
    lo, hi = ranges[me] if me < len(ranges) else (0, 0)

    def _on_slice(cursor: int, _me=me) -> bool:
        # deterministic worker-loss injection: a `kill` rule here
        # SIGKILLs this process mid-range, exactly at the configured
        # slice — the scenario the reassignment path recovers from
        fault_point("cluster.worker", phase="slice", s=cursor, process=_me)
        return False

    try:
        with obs.span(
            "serve.cluster_shard", mode="slices", slices=hi - lo, process=me
        ):
            mine = bound.amplitudes_det(
                list(batch_bits), backend, slice_range=(lo, hi),
                ckpt=ckpt_dir, on_slice=_on_slice if ckpt_dir else None,
            )
    except Exception as exc:  # noqa: BLE001 — stay in collective lockstep
        mine = _ShardFailure(me, exc)
    parts = _gather_rows(mine, me, n, root, timeout_s=timeout_s, members=members)
    if me != root:
        return None
    for src, slo, shi in _lost_slots(parts, ranges, members, lost, root):
        logger.warning(
            "cluster_amplitudes_sliced: process %d lost mid-round; "
            "resuming its range [%d, %d) at the root%s", src, slo, shi,
            " from checkpoint" if ckpt_dir else "",
        )
        _note_reassigned(mode="slices")
        # resume, not restart: the dead worker's checkpoint (shared
        # ckpt_dir, signature includes the range) carries its partial
        # accumulator and cursor — the surviving recompute finishes the
        # same accumulation sequence, bit-identical to the unfailed run
        parts[src] = bound.amplitudes_det(
            list(batch_bits), backend, slice_range=(slo, shi),
            ckpt=ckpt_dir,
        )
    kept = [np.asarray(p) for p in parts if p is not None]
    acc = kept[0]
    for p in kept[1:]:
        acc = acc + p
    return acc


class ClusterDispatcher:
    """Root-side batch dispatcher for a multi-process
    :class:`~tnc_tpu_torch.serve.service.ContractionService`: plug it in as
    ``ContractionService(..., dispatcher=ClusterDispatcher())``.

    Every call broadcasts one command to the worker processes parked in
    :func:`serve_cluster` and runs the matching collective: batched bras
    shard across processes; a sliced bound program shards its slice ranges
    instead. Calls are serialized by an internal lock — the fleet's
    collective sequence must never interleave two batches (or a batch with
    :meth:`stop`).

    ``stop()`` drains the in-flight collective round (the internal lock
    serializes it behind the round), then broadcasts the shutdown command
    and releases the workers; call it after stopping the service. A stopped
    dispatcher raises :class:`DispatcherStoppedError` — requests racing the
    shutdown fail cleanly instead of desynchronizing the fleet.

    Elastic operation (all optional):

    - ``registry`` (a :class:`~tnc_tpu_torch.obs.fleet.FleetRegistry` on
      the fleet's shared directory, judged by its ``stale_after_s``): the
      dispatcher consults the live roster **per collective round** instead
      of the frozen process list — a worker whose heartbeat went stale
      stays in the collectives with an empty assignment, and is assigned
      work again the round after its heartbeat recovers;
    - ``timeout_s``: bounds every broadcast and gather wait of a round
      (timeouts classify TRANSIENT through
      :func:`~tnc_tpu_torch.resilience.retry.classify_exception`); a
      process whose gather slot is lost (dead, or slower than
      ``timeout_s``) leaves the collectives for good (``lost``): its range
      is recomputed at the root, later rounds give it no range and wait
      for it no more, and it is marked excluded, so that a worker that was
      only slow leaves :func:`serve_cluster` with
      :class:`~tnc_tpu_torch.parallel.partitioned.ProcessExcluded` at its
      next park;
    - ``ckpt_dir``: shared slice-range checkpoint directory — the
      mid-request reassignment resume substrate
      (:func:`cluster_amplitudes_sliced`).
    """

    def __init__(
        self,
        root: int = 0,
        registry=None,
        timeout_s: float | None = None,
        ckpt_dir: str | None = None,
    ):
        self.root = int(root)
        self.registry = registry
        self.timeout_s = timeout_s
        self.ckpt_dir = ckpt_dir
        self._lock = threading.Lock()
        self._stopped = False
        self._seq = 0  # dispatch sequence, rides the TraceContext
        # the most recent round's per-process assignment (observability:
        # the service heartbeat ships it to the fleet view)
        self.last_ranges: list | None = None
        # processes whose gather slot was lost: out of the collectives
        self.lost: set[int] = set()
        # (weakref to bound, sig): an `is` check on the live object —
        # never id(), which CPython recycles across swap generations
        self._sig_cache: tuple | None = None

    def _members(self, n: int) -> set[int] | None:
        """The processes still in the fleet's collectives (None: all)."""
        if not self.lost:
            return None
        return set(range(n)) - self.lost

    def _round_ranges(
        self, mode: str, bound: BoundProgram, bits: list, n: int
    ) -> list | None:
        """Per-round roster-aware assignment: contiguous ranges over the
        LIVE members only (stale, dead or lost processes get ``(0, 0)``),
        or ``None`` (= even split over all n) without a registry or a lost
        process."""
        if n <= 1 or (self.registry is None and not self.lost):
            return None
        from tnc_tpu_torch.serve import elastic as _elastic

        live = (
            _elastic.live_processes(self.registry, n, root=self.root)
            if self.registry is not None else set(range(n))
        )
        n_items = (
            bound.sliced.slicing.num_slices
            if mode == "slices" else len(bits)
        )
        return _elastic.assign_ranges(n_items, live - self.lost, n)

    def _plan_sig(self, bound: BoundProgram) -> str:
        """The bound's program signature, memoized per bound object —
        rides every command so the workers can prove (and restore, via the
        shared plan cache) plan agreement before computing."""
        cached = self._sig_cache
        if cached is not None and cached[0]() is bound:
            return cached[1]
        sig = bound.program.signature_digest()
        self._sig_cache = (weakref.ref(bound), sig)
        return sig

    def __call__(self, bound: BoundProgram, bits: list, backend=None):
        n, me = _procs()
        if me != self.root:
            raise RuntimeError(
                "ClusterDispatcher must run on the root process; workers "
                "belong in serve_cluster()"
            )
        mode = "slices" if bound.sliced is not None else "bras"
        with self._lock:
            if self._stopped:
                raise DispatcherStoppedError("ClusterDispatcher is stopped")
            self._seq += 1
            # injectable collective boundary: a `slow` rule here holds the
            # round open (the stop()-drain regression), a raising kind
            # exercises the poison path deterministically
            fault_point("cluster.broadcast", side="root", seq=self._seq)
            # cross-host trace propagation: the service set this batch's
            # identity (request ids, kind, plan generation) in a
            # thread-local around the dispatcher call; ship it with the
            # command so every worker's spans carry the root's rids
            ctx = _fleet.current_dispatch_context()
            trace = _fleet.TraceContext(
                riders=ctx.riders if ctx is not None else "",
                kind=ctx.kind if ctx is not None else mode,
                generation=ctx.generation if ctx is not None else 0,
                seq=self._seq,
                root_process=me,
                root_pid=os.getpid(),
            ).to_obj()
            ranges = self._round_ranges(mode, bound, bits, n)
            self.last_ranges = ranges
            members = self._members(n)
            if n > 1:
                # the command: mode, rows, plan signature, trace context
                # and the round's envelope (roster-aware ranges, wait
                # bound, shared checkpoint directory)
                envelope = {
                    "ranges": ranges,
                    "timeout_s": self.timeout_s,
                    "ckpt_dir": self.ckpt_dir,
                }
                cmd = (mode, list(bits), self._plan_sig(bound), trace, envelope)
                try:
                    broadcast_object(
                        cmd, root=self.root, timeout_s=self.timeout_s,
                        members=members,
                    )
                except Exception as exc:
                    # a failed COMMAND broadcast leaves the fleet's
                    # collective sequence in an unknown state — poison
                    # the dispatcher loudly rather than hang the next
                    # batch against desynced workers
                    self._stopped = True
                    raise RuntimeError(
                        "cluster command broadcast failed; the fleet's "
                        "collective sequence is unknown — dispatcher "
                        "stopped (restart the fleet)"
                    ) from exc
            obs.counter_add("serve.cluster.batches", mode=mode)
            if mode == "slices":
                return cluster_amplitudes_sliced(
                    bound, bits, backend, root=self.root,
                    ranges=ranges, timeout_s=self.timeout_s,
                    ckpt_dir=self.ckpt_dir, members=members, lost=self.lost,
                )
            return cluster_amplitudes(
                bound, bits, backend, root=self.root,
                ranges=ranges, timeout_s=self.timeout_s,
                members=members, lost=self.lost,
            )

    def stop(self, drain_timeout_s: float | None = None) -> None:
        """Release the worker processes (idempotent), DRAINING first: the
        lock serializes this call behind any in-flight collective round,
        so the stop command can never interleave with (or orphan) a
        round's broadcast/gather sequence.

        ``drain_timeout_s`` bounds the drain: when the in-flight round is
        wedged past it, the dispatcher is poisoned (no stop command can be
        safely broadcast into an unknown collective state) and
        :class:`TimeoutError` is raised — classify and escalate, the fleet
        needs a restart."""
        n, _me = _procs()
        if drain_timeout_s is None:
            self._lock.acquire()
        elif not self._lock.acquire(timeout=float(drain_timeout_s)):
            # can't join the collective sequence safely: poison so no
            # later call tries to; the in-flight round's holder re-checks
            # under the lock only on the NEXT round, which now refuses
            self._stopped = True
            raise TimeoutError(
                f"ClusterDispatcher.stop: in-flight round did not drain "
                f"within {drain_timeout_s}s; dispatcher poisoned"
            )
        try:
            if self._stopped:
                return
            self._stopped = True
            if n > 1:
                broadcast_object(
                    ("stop", None, None, None, None), root=self.root,
                    timeout_s=self.timeout_s, members=self._members(n),
                )
        finally:
            self._lock.release()


def serve_cluster(
    bound: BoundProgram,
    backend=None,
    root: int = 0,
    plan_cache=None,
    telemetry_port: int | None = None,
    telemetry_host: str = "127.0.0.1",
    fleet_dir: str | None = None,
    heartbeat_s: float = 2.0,
) -> int:
    """Worker-process serving loop: park on the root's command channel and
    answer each batch's shard until the root's
    :meth:`ClusterDispatcher.stop`. Returns the number of batches served.
    Every process must hold a ``bound`` for the SAME circuit structure
    (bind through one shared plan cache so only the first process pays the
    planner).

    ``backend=None`` builds ONE :class:`~tnc_tpu_torch.ops.backends.
    TorchBackend` (on the card; it raises without CUDA) for the loop's
    life, so its kernel policies persist across batches, as the service's
    does (the reference takes its numpy backend per call).

    ``telemetry_port`` (0 = ephemeral) exposes THIS replica's live
    telemetry (:class:`~tnc_tpu_torch.obs.http.TelemetryServer`) while it
    serves: ``/metrics`` renders the process-local obs registry (shard
    spans, worker rebind/batch counters), ``/healthz`` reports the
    worker's role, process index and batches served. The root process
    gets its endpoint from :meth:`~tnc_tpu_torch.serve.service.
    ContractionService.serve_telemetry` instead — one scrape target per
    replica either way. The endpoint stops (port released) when the loop
    exits.

    ``fleet_dir`` (or ``TNC_TPU_FLEET_DIR``) joins this worker to the
    shared :class:`~tnc_tpu_torch.obs.fleet.FleetRegistry`: a background
    :class:`~tnc_tpu_torch.obs.fleet.Heartbeat` republishes identity,
    batches served, the in-flight state and the scrape URL every
    ``heartbeat_s`` seconds, and the entry retires (clean leave) when the
    loop exits. With a registry joined, ``/healthz`` reports the replica
    identity and heartbeat age, and every ``/metrics`` family carries a
    ``replica=`` label — the root's :class:`~tnc_tpu_torch.obs.fleet.
    FleetAggregator` federates both.

    A worker that the root left out (its gather slot was lost: dead to
    the root, or slower than the dispatcher's ``timeout_s``) raises
    :class:`~tnc_tpu_torch.parallel.partitioned.ProcessExcluded` from its
    next park: the fleet goes on without it, so it must leave.

    Every command carries the root's plan signature; a mismatch (the
    root's service adopted a background-replanner/shared-cache swap) makes
    the worker rebuild its bound through ``plan_cache`` — a cache hit on
    the swap the root already published, zero pathfinding — BEFORE
    computing, so every shard of a batch runs under one plan. Without a
    ``plan_cache`` a signature mismatch fails the batch instead of
    silently computing under a stale plan.
    """
    n, me = _procs()
    if n == 1 or me == root:
        raise RuntimeError(
            "serve_cluster is the NON-root side of a multi-process fleet"
        )
    if backend is None:
        from tnc_tpu_torch.ops.backends import TorchBackend

        backend = TorchBackend()
    progress = {"served": 0, "inflight": 0}
    identity = _fleet.replica_identity()
    name = _fleet.replica_name(identity)
    fleet_dir = fleet_dir or os.environ.get("TNC_TPU_FLEET_DIR") or None
    registry = (
        _fleet.FleetRegistry(fleet_dir, name=name) if fleet_dir else None
    )
    telemetry = None
    if telemetry_port is not None:
        from tnc_tpu_torch.obs.http import TelemetryServer

        telemetry = TelemetryServer(
            host=telemetry_host,
            port=telemetry_port,
            health_fn=lambda: {
                "status": "ok",
                "role": "worker",
                "process": me,
                "replica": identity,
                "heartbeat_age_s": (
                    registry.last_heartbeat_age_s()
                    if registry is not None else None
                ),
                "batches_served": progress["served"],
            },
            base_labels={"replica": name},
        ).start()
    heartbeat = None
    if registry is not None:
        heartbeat = _fleet.Heartbeat(
            registry,
            provider=lambda: {
                "role": "worker",
                # the process index: what the elastic dispatcher's
                # roster-aware placement keys live membership on
                # (obs/fleet knows replicas, the collective knows process
                # slots — this joins them)
                "process": me,
                "queue_depth": 0,
                "inflight": progress["inflight"],
                "batches_served": progress["served"],
                "url": telemetry.url if telemetry is not None else None,
            },
            interval_s=heartbeat_s,
        ).start()
    try:
        return _serve_cluster_loop(
            bound, backend, root, plan_cache, n, me, progress
        )
    finally:
        if heartbeat is not None:
            heartbeat.stop()  # retires the registry entry: clean leave
        if telemetry is not None:
            telemetry.stop()


def _serve_cluster_loop(
    bound, backend, root, plan_cache, n, me, progress
) -> int:
    served = 0
    my_sig = bound.program.signature_digest()
    while True:
        # injectable worker-loss boundary: `kill` drops this worker
        # between rounds (a clean leave the roster notices), `slow`
        # delays its next park — the hung-collective scenario the root's
        # bounded gather must survive
        fault_point("cluster.worker", phase="round", process=me)
        msg = broadcast_object(None, root=root, wait_forever=True)
        cmd, payload, want_sig, trace_obj, envelope = msg
        fault_point("cluster.broadcast", side="worker", process=me)
        if cmd == "stop":
            logger.info("serve_cluster: stop after %d batches", served)
            return served
        trace = _fleet.TraceContext.from_obj(trace_obj)
        ranges = envelope["ranges"]
        timeout_s = envelope["timeout_s"]
        ckpt_dir = envelope["ckpt_dir"]
        if want_sig is not None and want_sig != my_sig:
            try:
                if plan_cache is None:
                    raise RuntimeError(
                        "root's plan signature changed but this worker "
                        "has no plan_cache to rebuild from — bind "
                        "through the fleet's shared cache to follow "
                        "plan swaps"
                    )
                new_bound = bind_template(
                    bound.template, None, plan_cache, bound.target_size
                )
                new_sig = new_bound.program.signature_digest()
                if want_sig != new_sig:
                    raise RuntimeError(
                        "worker rebuilt from the shared plan cache but "
                        "still disagrees with the root's plan signature "
                        "— cache divergence or version skew; refusing "
                        "to serve a mixed-plan batch"
                    )
            except Exception as exc:  # noqa: BLE001 — stay in lockstep
                # join the batch's gather with a failure sentinel and
                # keep looping: the root raises a retryable batch error
                # naming this process; a worker that raised here would
                # instead hang the whole fleet's next collective
                logger.exception("serve_cluster: plan-swap adoption failed")
                _gather_rows(
                    _ShardFailure(me, exc), me, n, root, timeout_s=timeout_s
                )
                continue
            bound, my_sig = new_bound, new_sig
            obs.counter_add("serve.cluster.worker_rebinds")
            logger.info("serve_cluster: adopted root's plan swap")
        if cmd not in ("slices", "bras"):
            # unknown command: the fleet is version-skewed — stop loud
            raise RuntimeError(f"serve_cluster: unknown command {cmd!r}")
        progress["inflight"] = len(payload) if payload is not None else 0
        # adopt the root's trace context: this worker's serve.dispatch span
        # (and, via the ambient trace args, every span nested under it)
        # carries the ROOT's request ids, so the merged fleet timeline
        # attributes this process's dispatch wall time to the same rids
        # the root's rollup uses
        with _fleet.adopt_trace_context(trace), obs.span(
            "serve.dispatch",
            batch=len(payload) if payload is not None else 0,
            kind=trace.kind if trace is not None else cmd,
            riders=trace.riders if trace is not None else "",
            generation=trace.generation if trace is not None else 0,
            seq=trace.seq if trace is not None else 0,
            remote=1,
            process=me,
        ):
            if cmd == "slices":
                cluster_amplitudes_sliced(
                    bound, payload, backend, root=root,
                    ranges=ranges, timeout_s=timeout_s, ckpt_dir=ckpt_dir,
                )
            else:
                cluster_amplitudes(
                    bound, payload, backend, root=root,
                    ranges=ranges, timeout_s=timeout_s,
                )
        served += 1
        progress["served"] = served
        progress["inflight"] = 0
        obs.counter_add("serve.cluster.worker_batches")
