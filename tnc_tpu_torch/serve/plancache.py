"""Persistent, LRU-bounded plan cache for the serving path (the port's
copy of ``tnc_tpu.serve.plancache``).

Planning is the expensive, bitstring-independent part of an amplitude
query: a path search over the circuit structure, optional
slice-and-reconfigure, and the hoist split. This cache persists exactly
that — ``{path, slicing, hoist split, executor config}`` as plain JSON
(never pickle: a corrupted or adversarial entry must degrade to a
replan, not arbitrary code) — keyed by a **structure digest** of the
network's flat leaves (legs + bond dims), which every bitstring of a
circuit shares. A repeat circuit therefore performs zero pathfinding.

The record format and the keys are the reference's: the digests come from
the port's copy of the canonical encoder
(:func:`tnc_tpu_torch.utils.digest.stable_digest`), so a directory written
by the reference's cache answers the port's lookups and the other way
round.

- every entry records ``program_sig`` = the rebuilt program's
  ``signature_digest()``, validated after rebuild — a plan whose
  compiler output drifted is invalidated rather than trusted;
- writes are atomic (a uniquely named temp file + ``os.replace``), so
  N processes may share one directory; readers are lock-free;
- the cache is LRU-bounded by entry count (mtime = last use; loads
  touch it), with corrupted entries deleted and counted, never raised.
"""

from __future__ import annotations

import json
import logging
import os
import threading
import time
import uuid
from pathlib import Path

from tnc_tpu_torch import obs
from tnc_tpu_torch.contractionpath.contraction_path import ContractionPath
from tnc_tpu_torch.contractionpath.slicing import Slicing
from tnc_tpu_torch.tensornetwork.tensor import CompositeTensor
from tnc_tpu_torch.utils.digest import stable_digest

logger = logging.getLogger(__name__)

FORMAT_VERSION = 1


def network_structure_digest(
    tn: CompositeTensor, target_size: float | None = None
) -> str:
    """Stable digest of the network's contraction-relevant structure:
    every flat leaf's (legs, dims), in slot order. Bitstring-independent
    by construction — bra *values* never enter the digest — so all
    2^n amplitude networks of one circuit share a key.

    ``target_size`` (the caller's peak-memory budget) is part of the
    key: a plan is only reusable under the budget it was made for — an
    unsliced plan cached without a budget must never answer a
    budget-constrained lookup (it would OOM the device the budget
    modeled). Planner *identity* is deliberately not keyed: a cache
    directory is assumed to serve one planner configuration."""
    from tnc_tpu_torch.ops.program import flat_leaf_tensors

    leaves = flat_leaf_tensors(tn)
    return stable_digest(
        "tnc-plan-v%d" % FORMAT_VERSION,
        tuple((tuple(t.legs), tuple(t.bond_dims)) for t in leaves),
        float(target_size) if target_size is not None else None,
    )


class PlanCache:
    """On-disk plan store: ``<dir>/<structure-digest>.json`` entries.

    >>> import tempfile
    >>> cache = PlanCache(tempfile.mkdtemp(), max_entries=2)
    >>> plan = {"version": 1, "pairs": [[0, 1]], "program_sig": "x"}
    >>> cache.store("k1", plan)
    >>> cache.load("k1")["pairs"]
    [[0, 1]]
    >>> cache.load("missing") is None
    True
    """

    def __init__(self, directory: str | Path, max_entries: int = 256):
        self.directory = Path(directory)
        self.directory.mkdir(parents=True, exist_ok=True)
        self.max_entries = max(1, int(max_entries))
        # explicit per-key hit counts (process-local; the on-disk LRU
        # touch only *implies* heat via mtime)
        self._hits: dict[str, int] = {}
        self._hits_lock = threading.Lock()
        # process-local event counters mirroring the obs families —
        # stats() reads these, so cache efficacy is observable with obs
        # tracing off
        self._counts = {
            k: 0
            for k in (
                "hit", "miss", "store", "evicted", "corrupt",
                "invalidated", "store_failed",
            )
        }

    def _count(self, key: str) -> None:
        with self._hits_lock:
            self._counts[key] = self._counts.get(key, 0) + 1
        obs.counter_add(f"serve.plan_cache.{key}")

    def stats(self) -> dict:
        """Process-local cache efficacy: event counts (hit / miss /
        store / evicted / corrupt / invalidated / store_failed) plus
        the current on-disk entry count."""
        with self._hits_lock:
            counts = dict(self._counts)
        return {"counts": counts, "entries": len(self)}

    def _path(self, key: str) -> Path:
        return self.directory / f"{key}.json"

    def key_for_network(
        self, tn: CompositeTensor, target_size: float | None = None
    ) -> str:
        return network_structure_digest(tn, target_size)

    # -- entries -----------------------------------------------------------

    def record_for(
        self,
        path: ContractionPath,
        program,
        slicing: Slicing | None = None,
        sliced_program=None,
        executor: dict | None = None,
        flops: float | None = None,
        peak: float | None = None,
        finder: str | None = None,
        target_size: float | None = None,
        predicted_seconds: float | None = None,
    ) -> dict:
        """Build the JSON plan record for a freshly planned structure:
        path pairs, optional slicing + hoist split (computed from
        ``sliced_program`` when given), executor config, and the
        program-signature digest the entry is validated against.
        ``finder``/``predicted_seconds`` record plan *provenance*."""
        plan: dict = {
            "version": FORMAT_VERSION,
            "pairs": path.to_obj(),
            "slicing": slicing.to_obj() if slicing is not None else None,
            "hoist": None,
            "executor": dict(executor) if executor else None,
            "program_sig": program.signature_digest(),
            "created_at": time.time(),
            "finder": finder,
            "target_size": (
                float(target_size) if target_size is not None else None
            ),
        }
        if predicted_seconds is not None:
            plan["predicted_seconds"] = float(predicted_seconds)
        if sliced_program is not None:
            from tnc_tpu_torch.ops.hoist import hoist_split_counts

            plan["hoist"] = hoist_split_counts(sliced_program)
            plan["sliced_sig"] = sliced_program.signature_digest()
        if flops is not None:
            plan["flops"] = float(flops)
        if peak is not None:
            plan["peak"] = float(peak)
        return plan

    def validate(self, plan: dict, program) -> bool:
        """True when ``program`` (rebuilt from the cached path) matches
        the signature the plan was stored with."""
        return plan.get("program_sig") == program.signature_digest()

    @staticmethod
    def plan_path(plan: dict) -> ContractionPath:
        return ContractionPath.from_obj(plan["pairs"])

    @staticmethod
    def plan_slicing(plan: dict) -> Slicing | None:
        obj = plan.get("slicing")
        return Slicing.from_obj(obj) if obj else None

    # -- storage -----------------------------------------------------------

    def load(self, key: str) -> dict | None:
        """The cached plan, or None (absent / corrupt / wrong version —
        corruption is deleted and counted, never raised: a bad entry
        degrades to a replan)."""
        target = self._path(key)
        try:
            with open(target, "r", encoding="utf-8") as fh:
                plan = json.load(fh)
            if (
                not isinstance(plan, dict)
                or plan.get("version") != FORMAT_VERSION
                or not isinstance(plan.get("pairs"), list)
            ):
                raise ValueError(f"unusable plan entry: {plan!r:.80}")
        except FileNotFoundError:
            self._count("miss")
            return None
        except Exception as exc:  # noqa: BLE001 — any corruption → replan
            logger.warning(
                "plan cache entry %s unreadable (%s: %s); dropping it",
                target, type(exc).__name__, exc,
            )
            self._count("corrupt")
            self._count("miss")
            try:
                target.unlink(missing_ok=True)
            except OSError:
                pass
            return None
        self._count("hit")
        with self._hits_lock:
            self._hits[key] = self._hits.get(key, 0) + 1
        try:  # LRU touch: mtime records last use
            os.utime(target)
        except OSError:
            pass
        return plan

    def hits(self, key: str) -> int:
        """Process-local hit count for ``key`` (successful loads)."""
        with self._hits_lock:
            return self._hits.get(key, 0)

    def hot_keys(self, limit: int = 8) -> list[str]:
        """Keys by descending hit count — the explicit heat ranking the
        LRU mtimes only imply.

        >>> import tempfile
        >>> c = PlanCache(tempfile.mkdtemp())
        >>> c.store("a", {"version": 1, "pairs": []})
        >>> _ = c.load("a"); _ = c.load("a"); _ = c.load("missing")
        >>> c.hot_keys()
        ['a']
        """
        with self._hits_lock:
            ranked = sorted(self._hits.items(), key=lambda kv: (-kv[1], kv[0]))
        return [k for k, n in ranked[: max(limit, 0)] if n > 0]

    def entry_fingerprint(self, key: str) -> str | None:
        """Cheap content probe for ``key``'s on-disk entry: a digest of
        the entry's raw bytes, or ``None`` when absent/unreadable.
        Replicas poll this to notice another replica's publish without
        parsing the JSON — the read is lock-free (``os.replace`` publishes
        whole files, so the bytes are always one complete entry)."""
        try:
            with open(self._path(key), "rb") as fh:
                return stable_digest("plan-bytes", fh.read())
        except OSError:
            return None

    def store(self, key: str, plan: dict) -> None:
        """Atomic write + LRU eviction down to ``max_entries``.

        Best-effort, mirroring :meth:`load`: the cache is an
        optimization, so a write failure (disk full, permissions, dir
        removed) is logged and counted — never raised. The caller holds
        the freshly planned program in memory either way.

        Safe under concurrent writers (N replicas sharing the
        directory): the temp file is uniquely named per writer (pid +
        random suffix), so two replicas racing on one key can never
        interleave bytes — the last complete ``os.replace`` wins."""
        target = self._path(key)
        tmp = target.with_name(
            f"{key}.{os.getpid()}.{uuid.uuid4().hex[:8]}.json.tmp"
        )
        try:
            with open(tmp, "w", encoding="utf-8") as fh:
                json.dump(plan, fh)
                fh.flush()
                os.fsync(fh.fileno())
            os.replace(tmp, target)
        except OSError as exc:
            logger.warning(
                "plan cache store of %s failed (%s: %s); serving from "
                "the in-memory plan", target, type(exc).__name__, exc,
            )
            self._count("store_failed")
            try:  # don't strand the partial temp file
                tmp.unlink(missing_ok=True)
            except OSError:
                pass
            return
        self._count("store")
        self._evict()

    def invalidate(self, key: str) -> None:
        try:
            self._path(key).unlink(missing_ok=True)
        except OSError:
            pass
        with self._hits_lock:
            self._hits.pop(key, None)
        self._count("invalidated")

    def _entries(self) -> list[Path]:
        return [
            p for p in self.directory.glob("*.json") if p.is_file()
        ]

    def _evict(self) -> None:
        # reap orphaned temp files a crashed writer left behind (never
        # fresh ones — another replica may be mid-publish right now)
        now = time.time()
        for orphan in self.directory.glob("*.json.tmp"):
            try:
                if now - orphan.stat().st_mtime > 3600.0:
                    orphan.unlink(missing_ok=True)
            except OSError:
                continue
        entries = self._entries()
        if len(entries) <= self.max_entries:
            return
        def mtime(p: Path) -> float:
            try:
                return p.stat().st_mtime
            except OSError:
                return 0.0
        entries.sort(key=mtime)
        for victim in entries[: len(entries) - self.max_entries]:
            try:
                victim.unlink(missing_ok=True)
                self._count("evicted")
                logger.info("plan cache evicted %s (LRU)", victim.name)
            except OSError:
                continue
            # heat follows the entry out: hits()/hot_keys() must not
            # rank keys the cache no longer holds, and the dict must
            # not grow one entry per structure ever served
            with self._hits_lock:
                self._hits.pop(victim.stem, None)

    def __len__(self) -> int:
        return len(self._entries())
