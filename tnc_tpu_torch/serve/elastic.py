"""Elastic preemptible fleet: membership, reassignment, preemption, scaling
(the port's copy of ``tnc_tpu.serve.elastic``).

This module is the coordination brain behind four serving behaviours that
the static cluster path (``serve/multihost.py``) cannot express on its own:

- **Live membership** — ``live_processes`` folds a ``FleetRegistry``
  roster into the set of process indices that are currently beating, and
  ``assign_ranges`` shards a round's work across exactly those members.
  The dispatcher consults both *per collective round*, so a worker that
  joins or leaves between rounds changes the next round's shard map
  without any restart.

- **Mid-request reassignment** — when a worker dies *inside* a round the
  root's bounded gather yields a ``GatherLost`` sentinel; the root then
  re-runs the lost slice range locally, resuming from the dead worker's
  ``SliceCheckpoint`` on shared storage so the recomputed partial is
  bit-identical to what the worker would have produced (the checkpoint
  restores the accumulator bitwise and the remaining slices replay in
  the same order).  Counted under ``serve.elastic.reassigned``.  The
  checkpoint and the ``on_slice`` hook need a backend with slice hooks
  (``NumpyBackend``); on a ``TorchBackend`` the lost range is recomputed
  from its start, and nothing is preempted.

- **Priority preemption** — long sliced contractions run through
  ``preemptible_amplitudes``: an ``on_slice`` gate asks "is someone more
  important waiting?" at every slice-range checkpoint boundary; a True
  answer forces a checkpoint save and raises ``SliceYield``, the waiting
  priority work runs in the interlude, and the preempted contraction
  resumes from its checkpoint — bit-identical to the never-preempted
  golden because the accumulator round-trips bitwise.

- **Scaling signals** — ``ElasticController`` folds queue depth, SLO
  burn rate and roster size into scale-up / scale-down decisions with a
  cooldown, surfaced both as advisory hooks (for external autoscalers)
  and through ``LocalAutoscaler``, a subprocess-backed actuator that
  spawns / retires heartbeat workers (``python -m tnc_tpu_torch.serve.elastic
  --worker``) against the same registry directory.

Everything here is plain Python: the module is deliberately free of
transport imports so ``multihost.py`` can lazily reach ``count_event`` /
``live_processes`` / ``assign_ranges`` without a cycle, and so the
scheduler math is unit-testable in-process. The heartbeat workers never
touch CUDA.
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import subprocess
import sys
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Mapping, Sequence

from tnc_tpu_torch import obs

__all__ = [
    "count_event",
    "counters",
    "reset_counters",
    "live_processes",
    "assign_ranges",
    "weighted_fair_order",
    "ElasticConfig",
    "ElasticController",
    "LocalAutoscaler",
    "preemptible_amplitudes",
    "PreemptionExhaustedError",
]


# ---------------------------------------------------------------------------
# cross-layer event counters
# ---------------------------------------------------------------------------
#
# multihost.py (reassignment) and service.py (preemption) both tally here
# so ``stats()["elastic"]`` has one coherent ledger regardless of which
# layer observed the event.  The obs registry gets the same increments
# (``serve.elastic.*``) for Prometheus; this dict exists because obs can
# be globally disabled while stats() must still count.

_COUNTS: dict[str, int] = {}
_COUNTS_LOCK = threading.Lock()


def count_event(name: str, n: int = 1) -> None:
    """Tally an elastic event (``reassigned``, ``preempted``, ...)."""
    with _COUNTS_LOCK:
        _COUNTS[name] = _COUNTS.get(name, 0) + int(n)


def counters() -> dict[str, int]:
    """Snapshot of the cumulative elastic event tallies."""
    with _COUNTS_LOCK:
        return dict(_COUNTS)


def reset_counters() -> None:
    """Zero the tallies (test isolation)."""
    with _COUNTS_LOCK:
        _COUNTS.clear()


# ---------------------------------------------------------------------------
# live membership
# ---------------------------------------------------------------------------


def live_processes(
    registry,
    n: int,
    root: int = 0,
    stale_after_s: float | None = None,
) -> set[int]:
    """Process indices currently alive according to ``registry``.

    Heartbeat payloads published by ``serve_cluster`` / the worker entry
    carry ``"process": <index>``; a row counts as live when its state is
    ``"live"`` (optionally re-judged against a caller-supplied
    ``stale_after_s`` tighter/looser than the registry default).  The
    root is always a member — it is the process doing the asking, and a
    roster that has lost the root's own entry (slow shared volume) must
    not zero out the whole fleet.  Rows without a usable process index
    or out of ``[0, n)`` are ignored.
    """
    live = {int(root)}
    try:
        roster = registry.roster()
    except Exception:
        obs.counter_add("serve.elastic.roster_errors")
        return live
    for row in roster.get("replicas", ()):
        payload = row.get("payload") or {}
        proc = payload.get("process")
        if proc is None:
            continue
        try:
            proc = int(proc)
        except (TypeError, ValueError):
            continue
        if not (0 <= proc < int(n)):
            continue
        if stale_after_s is not None:
            alive = float(row.get("age_s", 0.0)) <= float(stale_after_s)
        else:
            alive = row.get("state") == "live"
        if alive:
            live.add(proc)
    return live


def assign_ranges(
    n_items: int,
    live: set[int] | Sequence[int],
    n: int,
) -> list[tuple[int, int]]:
    """Shard ``[0, n_items)`` across the live members of an ``n``-process
    cluster.  Returns a length-``n`` list of ``(lo, hi)`` per process
    slot; dead slots get ``(0, 0)`` and live slots receive contiguous
    ascending ranges in process order, so the root's in-order
    concatenation of partials is independent of *which* processes are
    alive.  With no live member (degenerate roster) everything lands on
    process 0.

    >>> assign_ranges(10, {0, 2}, 3)  # slot 1 is dead
    [(0, 5), (0, 0), (5, 10)]
    >>> assign_ranges(10, set(), 3)  # degenerate roster -> root
    [(0, 10), (0, 0), (0, 0)]
    """
    from tnc_tpu_torch.serve.multihost import shard_ranges

    n = max(int(n), 1)
    members = sorted({int(p) for p in live if 0 <= int(p) < n})
    if not members:
        members = [0]
    parts = shard_ranges(n_items, len(members))
    out: list[tuple[int, int]] = [(0, 0)] * n
    for slot, rng in zip(members, parts):
        out[slot] = rng
    return out


# ---------------------------------------------------------------------------
# weighted-fair scheduling
# ---------------------------------------------------------------------------


def weighted_fair_order(
    items: Sequence,
    tenant_of: Callable[[object], str],
    priority_of: Callable[[object], int],
    weights: Mapping[str, float] | None = None,
    default_weight: float = 1.0,
) -> list[int]:
    """Indices of ``items`` in dispatch order: priority classes first
    (higher wins), then weighted-fair interleave across tenants within a
    class, FIFO within each tenant.

    Fairness is stride scheduling: the k-th request of a tenant with
    weight ``w`` gets virtual finish time ``k / w``, and requests are
    served in ascending virtual time — a weight-2 tenant gets two slots
    for every one of a weight-1 tenant, regardless of who queued first.
    Arrival order (the index itself) breaks exact ties so the order is
    total and deterministic.
    """
    weights = weights or {}
    strides: dict[str, float] = {}
    keyed = []
    for i, item in enumerate(items):
        tenant = tenant_of(item)
        w = float(weights.get(tenant, default_weight))
        if w <= 0.0:
            w = default_weight if default_weight > 0 else 1.0
        vft = strides.get(tenant, 0.0) + 1.0 / w
        strides[tenant] = vft
        keyed.append((-int(priority_of(item)), vft, i))
    keyed.sort()
    return [i for (_, _, i) in keyed]


# ---------------------------------------------------------------------------
# preemptible execution
# ---------------------------------------------------------------------------


class PreemptionExhaustedError(RuntimeError):
    """A preemptible contraction yielded more times than the configured
    bound — the priority lane is starving it, which is a scheduling bug,
    not a reason to spin forever."""


def preemptible_amplitudes(
    bound,
    bits,
    backend=None,
    *,
    ckpt,
    should_yield: Callable[[int], bool],
    interlude: Callable[[], None] | None = None,
    max_yields: int = 1000,
):
    """Run ``bound.amplitudes_det(bits)`` so it can yield at slice-range
    checkpoint boundaries and resume bit-identically.

    ``should_yield(cursor)`` is consulted after every completed slice
    (except the last — finishing beats yielding); returning True forces
    a checkpoint save and raises ``SliceYield`` out of the executor,
    after which ``interlude()`` runs (the priority work) and the
    contraction restarts — the checkpoint restores the accumulator
    bitwise, so the final rows equal the never-preempted golden.  Yields
    are tallied under ``serve.elastic.preempted``.
    """
    from tnc_tpu_torch.ops.sliced import SliceYield

    yields = 0
    while True:
        try:
            return bound.amplitudes_det(
                bits, backend, ckpt=ckpt, on_slice=should_yield
            )
        except SliceYield as y:
            yields += 1
            count_event("preempted")
            obs.counter_add("serve.elastic.preempted")
            if yields >= int(max_yields):
                raise PreemptionExhaustedError(
                    f"sliced contraction preempted {yields} times without "
                    f"completing (cursor {y.cursor})"
                ) from y
            if interlude is not None:
                interlude()


# ---------------------------------------------------------------------------
# scaling controller
# ---------------------------------------------------------------------------


@dataclass
class ElasticConfig:
    """Knobs for the elastic serving path (``ContractionService``
    consumes this via ``enable_elastic``)."""

    # shared directory for slice-range checkpoints (reassignment +
    # preemption resume); None disables both resume paths
    ckpt_dir: str | None = None
    # tenant -> weighted-fair weight (unlisted tenants get 1.0)
    tenant_weights: dict[str, float] = field(default_factory=dict)
    # tenant -> max queued requests (unlisted tenants are uncapped)
    tenant_quotas: dict[str, int] = field(default_factory=dict)
    # priority strictly greater than a running batch's preempts it
    preempt_enabled: bool = True
    # safety bound on yields per contraction
    max_yields: int = 1000


class ElasticController:
    """Advisory scale controller: folds queue depth, SLO burn rate and
    roster size into ``scale_up`` / ``scale_down`` / ``hold`` decisions.

    Pure signal→decision math with an injectable clock; actuation is
    someone else's job (``LocalAutoscaler`` locally, or external
    infrastructure through the ``on_decision`` hooks).  A cooldown
    separates consecutive non-hold decisions so a noisy queue cannot
    flap the fleet.
    """

    def __init__(
        self,
        min_replicas: int = 1,
        max_replicas: int = 8,
        scale_up_depth: int = 8,
        scale_down_depth: int = 0,
        burn_threshold: float = 2.0,
        cooldown_s: float = 30.0,
        clock: Callable[[], float] = time.monotonic,
    ):
        self.min_replicas = int(min_replicas)
        self.max_replicas = int(max_replicas)
        self.scale_up_depth = int(scale_up_depth)
        self.scale_down_depth = int(scale_down_depth)
        self.burn_threshold = float(burn_threshold)
        self.cooldown_s = float(cooldown_s)
        self._clock = clock
        self._last_action_t: float | None = None
        self._lock = threading.Lock()
        self.last_decision: dict = {"action": "hold", "reason": "init"}
        self.on_decision: list[Callable[[dict], None]] = []

    @staticmethod
    def burn_from_slo(slo_stats: Mapping | None) -> float:
        """Worst long-window burn rate across objectives in an
        ``SLOEngine.stats()`` snapshot (0.0 when absent/malformed)."""
        worst = 0.0
        if not isinstance(slo_stats, Mapping):
            return worst
        for row in slo_stats.get("objectives", ()) or ():
            for w in row.get("windows", ()) or ():
                try:
                    worst = max(worst, float(w.get("burn_long", 0.0)))
                except (TypeError, ValueError):
                    continue
        return worst

    def decide(
        self,
        queue_depth: int,
        live_replicas: int,
        burn: float = 0.0,
        t: float | None = None,
    ) -> dict:
        """One control step.  Scale-up wins when the queue is deep *or*
        the SLO budget is burning fast (capacity is the only lever this
        controller has); scale-down needs the queue drained *and* burn
        quiet.  The returned dict is also stored as ``last_decision``
        and fanned to the advisory hooks."""
        now = self._clock() if t is None else float(t)
        depth = int(queue_depth)
        live = max(int(live_replicas), 0)
        action, reason = "hold", "steady"
        target = live
        if depth >= self.scale_up_depth or burn >= self.burn_threshold:
            if live < self.max_replicas:
                action = "scale_up"
                target = min(live + 1, self.max_replicas)
                reason = (
                    f"queue_depth={depth}" if depth >= self.scale_up_depth
                    else f"burn={burn:.2f}"
                )
            else:
                reason = "at_max"
        elif depth <= self.scale_down_depth and burn < 1.0:
            if live > self.min_replicas:
                action = "scale_down"
                target = max(live - 1, self.min_replicas)
                reason = "idle"
            else:
                reason = "at_min"
        with self._lock:
            if action != "hold" and self._last_action_t is not None:
                if now - self._last_action_t < self.cooldown_s:
                    action, reason = "hold", "cooldown"
                    target = live
            if action != "hold":
                self._last_action_t = now
            decision = {
                "action": action,
                "target": int(target),
                "live": live,
                "queue_depth": depth,
                "burn": round(float(burn), 4),
                "reason": reason,
            }
            self.last_decision = decision
        obs.gauge_set("serve.elastic.scale_target", float(target))
        if action != "hold":
            obs.counter_add("serve.elastic.decisions", action=action)
            count_event(action)
        for hook in list(self.on_decision):
            try:
                hook(dict(decision))
            except Exception:
                obs.counter_add("serve.elastic.hook_errors")
        return decision


# ---------------------------------------------------------------------------
# local autoscaler (subprocess-backed actuator)
# ---------------------------------------------------------------------------


class LocalAutoscaler:
    """Actuates controller decisions by spawning / retiring local
    heartbeat worker subprocesses (``python -m tnc_tpu_torch.serve.elastic
    --worker``; the reference spawns ``tnc_tpu.serve.elastic``) against a
    shared registry directory.

    This is the single-box stand-in for a real preemptible capacity
    pool: the subprocess boundary makes join / leave / SIGKILL
    observable through exactly the same heartbeat files a multi-host
    fleet would use, so membership tests exercise the production code
    path.  Workers are indexed ``base_process + k``; ``scale_to``
    reconciles the desired count against the live children.
    """

    def __init__(
        self,
        fleet_dir: str,
        base_process: int = 1,
        interval_s: float = 0.5,
        python: str | None = None,
    ):
        self.fleet_dir = str(fleet_dir)
        self.base_process = int(base_process)
        self.interval_s = float(interval_s)
        self.python = python or sys.executable
        self._procs: dict[int, subprocess.Popen] = {}
        self._lock = threading.Lock()

    def _spawn(self, index: int) -> subprocess.Popen:
        cmd = [
            self.python, "-m", "tnc_tpu_torch.serve.elastic", "--worker",
            "--fleet-dir", self.fleet_dir,
            "--process", str(index),
            "--interval", str(self.interval_s),
        ]
        return subprocess.Popen(
            cmd, stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL
        )

    def _reap(self) -> None:
        dead = [i for i, p in self._procs.items() if p.poll() is not None]
        for i in dead:
            del self._procs[i]

    def count(self) -> int:
        with self._lock:
            self._reap()
            return len(self._procs)

    def scale_to(self, n_workers: int) -> int:
        """Reconcile to ``n_workers`` live children; returns the actual
        count after reconciliation."""
        n_workers = max(int(n_workers), 0)
        with self._lock:
            self._reap()
            while len(self._procs) < n_workers:
                nxt = self.base_process
                while nxt in self._procs:
                    nxt += 1
                self._procs[nxt] = self._spawn(nxt)
                obs.counter_add("serve.elastic.workers_spawned")
            while len(self._procs) > n_workers:
                idx = max(self._procs)
                self._terminate(self._procs.pop(idx))
                obs.counter_add("serve.elastic.workers_retired")
            return len(self._procs)

    def apply(self, decision: Mapping) -> int:
        """Actuate a controller decision dict (``scale_up`` adds one
        worker, ``scale_down`` removes one, anything else reconciles to
        the current count)."""
        with self._lock:
            self._reap()
            have = len(self._procs)
        action = decision.get("action")
        if action == "scale_up":
            return self.scale_to(have + 1)
        if action == "scale_down":
            return self.scale_to(max(have - 1, 0))
        return self.scale_to(have)

    @staticmethod
    def _terminate(proc: subprocess.Popen, grace_s: float = 3.0) -> None:
        if proc.poll() is not None:
            return
        try:
            proc.terminate()
            proc.wait(timeout=grace_s)
        except Exception:
            try:
                proc.kill()
                proc.wait(timeout=grace_s)
            except Exception:
                pass

    def stop(self) -> None:
        with self._lock:
            procs = list(self._procs.values())
            self._procs.clear()
        for p in procs:
            self._terminate(p)

    def __enter__(self) -> "LocalAutoscaler":
        return self

    def __exit__(self, *exc) -> None:
        self.stop()


# ---------------------------------------------------------------------------
# worker entry point
# ---------------------------------------------------------------------------


def _worker_main(args: argparse.Namespace) -> int:
    """Heartbeat worker: joins the registry under a process index and
    beats until terminated.  SIGTERM retires the entry (clean leave);
    SIGKILL leaves it to go stale (crash) — which is exactly the
    distinction membership tests need to observe."""
    from tnc_tpu_torch.obs.fleet import FleetRegistry

    name = args.name or f"elastic-w{args.process}"
    registry = FleetRegistry(args.fleet_dir, name=name)
    payload = {"process": int(args.process), "role": "elastic-worker",
               "pid": os.getpid()}
    stop = threading.Event()

    def _on_term(signum, frame):
        stop.set()

    signal.signal(signal.SIGTERM, _on_term)
    registry.heartbeat(payload)
    sys.stdout.write(json.dumps({"joined": name,
                                 "process": int(args.process)}) + "\n")
    sys.stdout.flush()
    try:
        while not stop.wait(float(args.interval)):
            registry.heartbeat(payload)
    except KeyboardInterrupt:
        pass
    registry.retire()
    return 0


def main(argv: Sequence[str] | None = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m tnc_tpu_torch.serve.elastic",
        description="Elastic fleet utilities (heartbeat worker entry).",
    )
    parser.add_argument("--worker", action="store_true",
                        help="run as a heartbeat worker until SIGTERM")
    parser.add_argument("--fleet-dir", default=None,
                        help="FleetRegistry directory (required for --worker)")
    parser.add_argument("--process", type=int, default=1,
                        help="process index published in the heartbeat")
    parser.add_argument("--name", default=None,
                        help="replica name (default elastic-w<process>)")
    parser.add_argument("--interval", type=float, default=0.5,
                        help="heartbeat interval seconds")
    args = parser.parse_args(argv)
    if args.worker:
        if not args.fleet_dir:
            parser.error("--worker requires --fleet-dir")
        return _worker_main(args)
    parser.error("nothing to do (pass --worker)")
    return 2


if __name__ == "__main__":
    raise SystemExit(main())
