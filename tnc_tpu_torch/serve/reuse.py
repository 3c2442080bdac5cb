"""Cross-request numeric reuse: content-addressed intermediate tensors
(the port's copy of ``tnc_tpu.serve.reuse``).

The plan cache (:mod:`tnc_tpu_torch.serve.plancache`) reuses *structure*
across requests and :mod:`tnc_tpu_torch.ops.hoist` reuses slice-invariant
values *within* one request. This module reuses values *across*
requests: near-duplicate traffic (one ansatz, many angle settings; a
circuit at growing depth) shares whole value-identical subtrees of the
contraction tree, and every bitstring of one circuit shares the subtrees
the bras never reach.

Three layers, bottom up:

- **Subtree digests** (:func:`compute_split`): every contraction-tree
  node gets a value-aware digest over (step shape record, operand
  digests), grounded in leaf digests over (shape, dtype, bytes). Slot
  ids are *excluded*, so two plans that contract the same values
  through the same shapes produce the same key regardless of slot
  layout.
- **Prefix/residual split** (:class:`ReuseSplit`): the hoist pass's
  marking run with "volatile" (bra leaves, sliced leaves) in place of
  "variant". Volatile steps become the per-request residual (fresh slot
  space, hoist's remap); every non-volatile value is addressable in the
  store. The residual's cached inputs are materialized once per backend
  environment (:func:`backend_env_key`) and reused by every request.
- **The store** (:class:`IntermediateStore`): byte-budgeted LRU memory
  tier over an optional host-disk npz tier with the plan cache's
  atomic-replace discipline (unique tmp names, digest validated on
  load, corrupt entries deleted and counted — degrade to recontract,
  never raise). Admission is cost-model-priced (:meth:`IntermediateStore.admit`).

A node is materialized through ``backend.execute`` of a standalone
program whose ``result_shape`` is the node's stored shape, so it returns
exactly the intermediate the cold path holds at that tree position; on
the numpy backend reused amplitudes bit-compare to cold ones. On a
``TorchBackend`` the node's value comes back to the host (complex64 in
split mode) and is placed on the card again with the bras on every
dispatch; the residual's products then run on other operands' grouping
than the cold program's, so reused amplitudes agree with cold ones to
float32 tolerance.

>>> import numpy as np
>>> store = IntermediateStore(max_bytes=1 << 16)
>>> store.put("node", np.ones(2, dtype=np.complex128))
>>> store.get("node")
array([1.+0.j, 1.+0.j])
>>> store.get("absent") is None
True
>>> [store.stats()[k] for k in ("hit", "miss", "store")]
[1, 1, 1]
"""

from __future__ import annotations

import logging
import os
import threading
import time
import uuid
from collections import OrderedDict
from dataclasses import dataclass, replace
from pathlib import Path
from typing import Any, Sequence

import numpy as np

from tnc_tpu_torch import obs
from tnc_tpu_torch.ops.program import (
    ContractionProgram,
    PairStep,
    step_flops,
    steps_bytes,
    steps_flops,
)
from tnc_tpu_torch.utils.digest import stable_digest

logger = logging.getLogger(__name__)

# Bump to invalidate every digest/spill entry (step-record or spill
# format change).
REUSE_VERSION = 1

_SPILL_SUFFIX = ".npz"
_TMP_ORPHAN_S = 3600.0


def leaf_digest(arr: np.ndarray) -> str:
    """Value digest of a leaf buffer: shape, dtype and raw bytes."""
    a = np.ascontiguousarray(arr)
    return stable_digest(
        "reuse-leaf-v%d" % REUSE_VERSION,
        tuple(int(d) for d in a.shape),
        str(a.dtype),
        a.tobytes(),
    )


def _step_record(st: PairStep) -> tuple:
    """The slot-id-free shape record of a step — everything an executor
    uses except *which* slots the operands live in."""
    return (
        st.a_view, st.a_perm, st.a_dot, st.a_cfirst,
        st.b_view, st.b_perm, st.b_dot, st.b_cfirst,
        st.swap, st.out_store, st.a_ops, st.b_ops,
    )


def step_digest(st: PairStep, lhs_digest: str, rhs_digest: str) -> str:
    """Value digest of a step node from its operands' value digests."""
    return stable_digest(
        "reuse-step-v%d" % REUSE_VERSION,
        _step_record(st),
        lhs_digest,
        rhs_digest,
    )


def backend_env_key(backend: Any) -> tuple:
    """Numeric-environment discriminator for store keys: two
    environments share an entry only when their executors produce
    bitwise-identical intermediates. ``None`` is the port's default
    backend (:func:`~tnc_tpu_torch.ops.backends.get_backend`). A
    ``"torch"`` backend adds what the reference's ``"jax"`` one adds
    (split mode, precision, device) and its kernel policy's key
    (``TorchBackend.policy_key``): a calibrated policy routes steps to
    other arithmetic and so gives other bits."""
    if backend is None:
        from tnc_tpu_torch.ops.backends import get_backend

        backend = get_backend(None)
    name = getattr(backend, "name", type(backend).__name__)
    key: tuple = (str(name), str(getattr(backend, "dtype", "")))
    if name == "torch":
        key += (
            bool(getattr(backend, "split_complex", False)),
            str(getattr(backend, "precision", "")),
            str(getattr(backend, "device", None)),
        )
    policy_key = getattr(backend, "policy_key", None)
    if policy_key is not None:
        key += (policy_key(),)
    return key


def store_key(env: tuple, node_digest: str) -> str:
    """On-disk / in-memory key of one node value in one environment."""
    return stable_digest("reuse-entry-v%d" % REUSE_VERSION, env, node_digest)


class IntermediateStore:
    """Content-addressed store of materialized contraction subtrees.

    Memory tier: ``OrderedDict`` LRU bounded by ``max_bytes`` (hits
    refresh recency, so a hot shared prefix survives a stream of
    one-use suffix values). Disk tier (optional ``directory``):
    write-through npz spill with the plan cache's atomic discipline —
    unique tmp name + fsync + ``os.replace`` so concurrent writers
    never tear an entry, payload digest validated on load so corrupt
    or stale files become a counted miss (file deleted), never an
    exception.

    Admission (:meth:`admit`): with a
    :class:`~tnc_tpu_torch.obs.calibrate.CalibratedCostModel`, store a
    subtree only when recontraction is priced above ``store_margin``
    times the cost of loading its output back; without one, a plain
    ``min_flops`` floor.
    """

    COUNT_KEYS = (
        "hit", "miss", "store", "evicted", "corrupt", "store_failed",
    )

    def __init__(
        self,
        directory: str | os.PathLike | None = None,
        max_bytes: int = 256 * 1024 * 1024,
        max_disk_bytes: int | None = None,
        cost_model: Any = None,
        store_margin: float = 2.0,
        min_flops: float = 0.0,
    ):
        self.directory = Path(directory) if directory is not None else None
        if self.directory is not None:
            self.directory.mkdir(parents=True, exist_ok=True)
        self.max_bytes = int(max_bytes)
        self.max_disk_bytes = (
            int(max_disk_bytes) if max_disk_bytes is not None else None
        )
        self.cost_model = cost_model
        self.store_margin = float(store_margin)
        self.min_flops = float(min_flops)
        self._mem: "OrderedDict[str, np.ndarray]" = OrderedDict()
        self._bytes = 0
        self._lock = threading.Lock()
        self._counts: dict[str, float] = {k: 0 for k in self.COUNT_KEYS}
        self._counts["flops_saved"] = 0.0
        self._counts["flops_computed"] = 0.0
        self._counts["steps_computed"] = 0.0

    # --- accounting -----------------------------------------------------

    def _count(self, key: str, value: float = 1.0, **labels) -> None:
        with self._lock:
            self._counts[key] = self._counts.get(key, 0) + value
        obs.counter_add(f"serve.reuse.{key}", value, **labels)

    def note_computed(self, flops: float, n_steps: int) -> None:
        """Record a cold node materialization (the total compute the
        reuse path actually paid)."""
        with self._lock:
            self._counts["flops_computed"] += float(flops)
            self._counts["steps_computed"] += float(n_steps)

    def bytes_held(self) -> int:
        with self._lock:
            return self._bytes

    def __len__(self) -> int:
        with self._lock:
            return len(self._mem)

    def stats(self) -> dict:
        with self._lock:
            out: dict[str, Any] = {
                k: (int(v) if k in self.COUNT_KEYS else float(v))
                for k, v in self._counts.items()
            }
            out["bytes_held"] = int(self._bytes)
            out["entries"] = len(self._mem)
        out["prefix_flops_saved"] = out.pop("flops_saved")
        return out

    def clear_memory(self) -> None:
        """Drop the memory tier (disk spill untouched) — the restart /
        second-replica shape, used by tests to force disk loads."""
        with self._lock:
            self._mem.clear()
            self._bytes = 0

    # --- admission ------------------------------------------------------

    def admit(
        self,
        flops: float,
        nbytes: float,
        n_steps: int = 1,
        out_nbytes: float = 0.0,
    ) -> bool:
        """Should a subtree of this cost be stored? With a cost model:
        recontraction seconds must exceed ``store_margin`` × the
        seconds to stream its output back. Without: a flop floor."""
        if self.cost_model is not None:
            recontract = self.cost_model.op_seconds(
                float(flops), nbytes=float(nbytes),
                dispatches=float(max(n_steps, 1)),
            )
            reload_s = self.cost_model.op_seconds(
                0.0, nbytes=float(out_nbytes), dispatches=1.0
            )
            return recontract > self.store_margin * reload_s
        return float(flops) >= self.min_flops

    # --- memory + disk tiers --------------------------------------------

    def get(self, key: str, flops: float = 0.0) -> np.ndarray | None:
        """Look up one node value. Returned arrays are shared — callers
        must treat them as immutable (executors only read leaf
        buffers). ``flops`` credits the prefix-flops-saved counter on a
        hit."""
        with self._lock:
            arr = self._mem.get(key)
            if arr is not None:
                self._mem.move_to_end(key)
                self._counts["hit"] += 1
                self._counts["flops_saved"] += float(flops)
        if arr is not None:
            obs.counter_add("serve.reuse.hit", tier="memory")
            return arr
        if self.directory is not None:
            arr = self._load_spill(key)
            if arr is not None:
                with self._lock:
                    self._counts["hit"] += 1
                    self._counts["flops_saved"] += float(flops)
                obs.counter_add("serve.reuse.hit", tier="disk")
                self._insert_mem(key, arr)
                return arr
        self._count("miss")
        return None

    def put(self, key: str, arr: np.ndarray, flops: float = 0.0) -> None:
        a = np.ascontiguousarray(arr)
        self._insert_mem(key, a)
        self._count("store")
        if self.directory is not None:
            self._spill(key, a)
            self._evict_disk()

    def _insert_mem(self, key: str, a: np.ndarray) -> None:
        evicted = 0
        with self._lock:
            if key in self._mem:
                self._mem.move_to_end(key)
            else:
                self._mem[key] = a
                self._bytes += a.nbytes
            while self._bytes > self.max_bytes and self._mem:
                _, old = self._mem.popitem(last=False)
                self._bytes -= old.nbytes
                self._counts["evicted"] += 1
                evicted += 1
        if evicted:
            obs.counter_add("serve.reuse.evicted", float(evicted), tier="memory")

    def _spill_path(self, key: str) -> Path:
        assert self.directory is not None
        return self.directory / f"{key}{_SPILL_SUFFIX}"

    def _spill(self, key: str, a: np.ndarray) -> None:
        target = self._spill_path(key)
        tmp = self.directory / (
            f"{key}.{os.getpid()}.{uuid.uuid4().hex[:8]}{_SPILL_SUFFIX}.tmp"
        )
        try:
            payload = stable_digest(
                "reuse-spill-v%d" % REUSE_VERSION,
                tuple(int(d) for d in a.shape),
                str(a.dtype),
                a.tobytes(),
            )
            with open(tmp, "wb") as fh:
                np.savez(
                    fh,
                    value=a,
                    key=np.array(key),
                    sha=np.array(payload),
                    version=np.array(REUSE_VERSION),
                )
                fh.flush()
                os.fsync(fh.fileno())
            os.replace(tmp, target)
        except OSError as exc:
            # spill is best-effort: the memory tier already has the
            # value and recontraction remains correct
            self._count("store_failed")
            logger.warning("reuse spill of %s failed: %s", key, exc)
            try:
                tmp.unlink(missing_ok=True)
            except OSError:
                pass

    def _load_spill(self, key: str) -> np.ndarray | None:
        path = self._spill_path(key)
        if not path.exists():
            return None
        try:
            with np.load(path, allow_pickle=False) as data:
                a = np.ascontiguousarray(data["value"])
                want_key = str(data["key"])
                sha = str(data["sha"])
                version = int(data["version"])
            payload = stable_digest(
                "reuse-spill-v%d" % REUSE_VERSION,
                tuple(int(d) for d in a.shape),
                str(a.dtype),
                a.tobytes(),
            )
            if version != REUSE_VERSION or want_key != key or sha != payload:
                raise ValueError("digest mismatch")
        except Exception as exc:  # noqa: BLE001 — any bad spill → miss
            # corrupt / stale / truncated entry: delete the poison pill,
            # count it, and let the caller recontract
            self._count("corrupt")
            logger.warning(
                "corrupt reuse spill %s (%s: %s); deleting",
                path.name, type(exc).__name__, exc,
            )
            try:
                path.unlink(missing_ok=True)
            except OSError:
                pass
            return None
        return a

    def _evict_disk(self) -> None:
        assert self.directory is not None
        now = time.time()
        entries: list[tuple[float, int, Path]] = []
        total = 0
        try:
            for p in self.directory.iterdir():
                try:
                    st = p.stat()
                except OSError:
                    continue
                if p.name.endswith(".tmp"):
                    # orphaned writer tmp (crashed process): reap old ones
                    if now - st.st_mtime > _TMP_ORPHAN_S:
                        try:
                            p.unlink(missing_ok=True)
                        except OSError:
                            pass
                    continue
                if p.suffix == _SPILL_SUFFIX:
                    entries.append((st.st_mtime, st.st_size, p))
                    total += st.st_size
        except OSError:
            return
        if self.max_disk_bytes is None:
            return
        entries.sort()  # oldest mtime first
        evicted = 0
        for _, size, p in entries:
            if total <= self.max_disk_bytes:
                break
            try:
                p.unlink(missing_ok=True)
            except OSError:
                continue
            total -= size
            evicted += 1
        if evicted:
            with self._lock:
                self._counts["evicted"] += evicted
            obs.counter_add("serve.reuse.evicted", float(evicted), tier="disk")


# ---------------------------------------------------------------------------
# prefix/residual split


@dataclass
class ReuseSplit:
    """The environment-independent split of one bound structure.

    ``steps``/``operands`` describe the original (slice-reduced when
    sliced) program's tree; every non-volatile step index appears in
    ``eval_order`` with a value digest and subtree cost; ``cached_idx``
    are the step indices whose values feed the residual as inputs."""

    residual: ContractionProgram
    residual_sliced: Any  # SlicedProgram | None
    sources: tuple[tuple[str, Any], ...]  # ("leaf", slot) | ("cached", idx)
    bra_slots: tuple[int, ...]  # bra positions in the residual slot space
    steps: tuple[PairStep, ...]
    operands: tuple[tuple[tuple, tuple], ...]
    node_digest: dict[int, str]
    node_flops: dict[int, float]
    node_bytes: dict[int, float]
    node_steps: dict[int, int]
    cached_idx: tuple[int, ...]
    eval_order: tuple[int, ...]  # all non-volatile step indices, ascending
    prefix_flops: float
    residual_flops: float

    def placeholder_arrays(self, base_arrays: Sequence[np.ndarray]) -> list:
        """Residual-slot-space array list with zero placeholders in the
        cached slots — shapes are real (the node's ``out_store``), so
        structural consumers (``thread_batch``, array comparisons) see
        the true layout without any materialization."""
        out: list[np.ndarray] = []
        for kind, ref in self.sources:
            if kind == "leaf":
                out.append(base_arrays[ref])
            else:
                shape = tuple(self.steps[ref].out_store)
                out.append(np.zeros(shape, dtype=np.complex128))
        return out


def compute_split(
    program: ContractionProgram,
    arrays: Sequence[np.ndarray],
    bra_slots: Sequence[int],
    sliced: Any = None,
) -> ReuseSplit | None:
    """Split a bound structure into store-addressable subtrees plus a
    per-request residual, or ``None`` when the split is trivial (no
    steps, nothing volatile, or everything volatile).

    Volatile values are the per-request bra leaves — plus, for sliced
    structures, the sliced leaves (their values change per slice, so
    they can never be cached across requests; the split then runs over
    the slice-reduced program and the residual keeps the slice loop).
    """
    prog = sliced.program if sliced is not None else program
    steps = prog.steps
    n = prog.num_inputs

    vol_leaf = set(int(s) for s in bra_slots)
    if sliced is not None:
        vol_leaf |= {s for s in range(n) if sliced.slot_slices[s]}

    # --- marking pass (hoist's, with volatile in place of variant) ------
    volatile: dict[tuple, bool] = {
        ("leaf", s): s in vol_leaf for s in range(n)
    }
    cur: dict[int, tuple] = {s: ("leaf", s) for s in range(n)}
    operands: list[tuple[tuple, tuple]] = []
    step_vol: list[bool] = []
    for i, st in enumerate(steps):
        va, vb = cur[st.lhs], cur[st.rhs]
        is_vol = volatile[va] or volatile[vb]
        operands.append((va, vb))
        step_vol.append(is_vol)
        out = ("step", i)
        volatile[out] = is_vol
        cur[st.lhs] = out
        cur[st.rhs] = ("dead", i)

    if not steps or all(step_vol) or not any(step_vol):
        return None

    # --- value digests + subtree costs, bottom-up (no recursion) -------
    leafd: dict[int, str] = {}

    def _leaf_d(s: int) -> str:
        d = leafd.get(s)
        if d is None:
            d = leaf_digest(arrays[s])
            leafd[s] = d
        return d

    node_digest: dict[int, str] = {}
    node_flops: dict[int, float] = {}
    node_bytes: dict[int, float] = {}
    node_steps: dict[int, int] = {}

    def _val_cost(v: tuple) -> tuple[float, float, int]:
        if v[0] == "leaf":
            return 0.0, 0.0, 0
        return node_flops[v[1]], node_bytes[v[1]], node_steps[v[1]]

    for i, st in enumerate(steps):
        if step_vol[i]:
            continue
        va, vb = operands[i]
        da = node_digest[va[1]] if va[0] == "step" else _leaf_d(va[1])
        db = node_digest[vb[1]] if vb[0] == "step" else _leaf_d(vb[1])
        node_digest[i] = step_digest(st, da, db)
        fa, ba, sa = _val_cost(va)
        fb, bb, sb = _val_cost(vb)
        node_flops[i] = fa + fb + step_flops(st)
        node_bytes[i] = ba + bb + steps_bytes([st])
        node_steps[i] = sa + sb + 1

    # --- residual: volatile steps on a fresh slot space (hoist remap) --
    res_slot_of: dict[tuple, int] = {}
    sources: list[tuple[str, Any]] = []
    res_slot_slices: list[tuple] = []
    res_steps: list[PairStep] = []

    def res_input(v: tuple) -> int:
        slot = len(sources)
        res_slot_of[v] = slot
        if v[0] == "leaf":
            sources.append(("leaf", v[1]))
            res_slot_slices.append(
                sliced.slot_slices[v[1]] if sliced is not None else ()
            )
        else:  # non-volatile intermediate: materialized from the store
            sources.append(("cached", v[1]))
            res_slot_slices.append(())
        return slot

    for i, st in enumerate(steps):
        if not step_vol[i]:
            continue
        va, vb = operands[i]
        la = res_slot_of.get(va)
        if la is None:
            la = res_input(va)
        lb = res_slot_of.get(vb)
        if lb is None:
            lb = res_input(vb)
        res_steps.append(replace(st, lhs=la, rhs=lb))
        res_slot_of[("step", i)] = la

    final_val = cur[prog.result_slot]
    assert volatile[final_val], "volatile steps exist, so the result is volatile"
    residual = ContractionProgram(
        num_inputs=len(sources),
        steps=tuple(res_steps),
        result_slot=res_slot_of[final_val],
        result_legs=prog.result_legs,
        result_shape=prog.result_shape,
        stored_result_shape=prog.stored_result_shape,
        canonical_legs=prog.canonical_legs,
    )
    residual_sliced = None
    if sliced is not None:
        from tnc_tpu_torch.ops.sliced import SlicedProgram

        residual_sliced = SlicedProgram(
            residual, sliced.slicing, tuple(res_slot_slices)
        )

    cached_idx = tuple(ref for kind, ref in sources if kind == "cached")
    if not cached_idx:
        return None
    new_bra = tuple(res_slot_of[("leaf", s)] for s in bra_slots)
    return ReuseSplit(
        residual=residual,
        residual_sliced=residual_sliced,
        sources=tuple(sources),
        bra_slots=new_bra,
        steps=steps,
        operands=tuple(operands),
        node_digest=node_digest,
        node_flops=node_flops,
        node_bytes=node_bytes,
        node_steps=node_steps,
        cached_idx=cached_idx,
        eval_order=tuple(sorted(node_digest)),
        prefix_flops=sum(node_flops[i] for i in cached_idx),
        residual_flops=steps_flops(res_steps),
    )


def _node_program(
    split: ReuseSplit, idx: int, memo: dict[int, np.ndarray]
) -> tuple[ContractionProgram, tuple[tuple[str, int], ...]]:
    """Standalone program computing node ``idx`` from the boundary of
    leaves and already-materialized node values. ``result_shape`` is
    the node's stored shape with identity canonical legs, so
    ``backend.execute`` returns exactly the intermediate buffer the
    full program would hold at this tree position."""
    region: set[int] = set()
    stack = [idx]
    while stack:
        j = stack.pop()
        if j in region:
            continue
        region.add(j)
        for v in split.operands[j]:
            if v[0] == "step" and v[1] not in memo:
                stack.append(v[1])

    local_of: dict[tuple, int] = {}
    srcs: list[tuple[str, int]] = []
    lsteps: list[PairStep] = []

    def add_input(v: tuple) -> int:
        slot = len(srcs)
        local_of[v] = slot
        srcs.append(("step" if v[0] == "step" else "leaf", v[1]))
        return slot

    for j in sorted(region):
        st = split.steps[j]
        va, vb = split.operands[j]
        la = local_of.get(va)
        if la is None:
            la = add_input(va)
        lb = local_of.get(vb)
        if lb is None:
            lb = add_input(vb)
        lsteps.append(replace(st, lhs=la, rhs=lb))
        local_of[("step", j)] = la

    shape = tuple(split.steps[idx].out_store)
    prog = ContractionProgram(
        num_inputs=len(srcs),
        steps=tuple(lsteps),
        result_slot=local_of[("step", idx)],
        result_legs=tuple(range(len(shape))),
        result_shape=shape,
        stored_result_shape=shape,
        canonical_legs=tuple(range(len(shape))),
    )
    return prog, tuple(srcs)


def materialize(
    split: ReuseSplit,
    store: IntermediateStore,
    arrays: Sequence[np.ndarray],
    backend: Any,
) -> dict[int, np.ndarray]:
    """Resolve every cached residual input for one backend environment.

    Admitted nodes are evaluated bottom-up (store lookup first, one
    ``serve.reuse.materialize`` span per cold compute), so *interior*
    values get snapshotted too — that is what lets a later request
    whose tree shares only a deeper subtree still hit. Non-admitted
    interior nodes fold into their consuming ancestor's program (tree
    paths consume each value exactly once, so nothing is recomputed).
    """
    if backend is None:
        from tnc_tpu_torch.ops.backends import get_backend

        backend = get_backend(None)
    env = backend_env_key(backend)
    memo: dict[int, np.ndarray] = {}
    needed = set(split.cached_idx)
    for i in split.eval_order:
        flops = split.node_flops[i]
        out_nbytes = float(np.prod(split.steps[i].out_store, dtype=float) * 16)
        admitted = store.admit(
            flops, split.node_bytes[i], split.node_steps[i], out_nbytes
        )
        if not admitted and i not in needed:
            continue
        key = store_key(env, split.node_digest[i])
        arr = store.get(key, flops=flops) if admitted else None
        if arr is None:
            prog, srcs = _node_program(split, i, memo)
            vals = [
                memo[ref] if kind == "step" else arrays[ref]
                for kind, ref in srcs
            ]
            region_flops = steps_flops(prog.steps)
            with obs.span(
                "serve.reuse.materialize",
                node=split.node_digest[i][:16],
                steps=len(prog.steps),
                flops=float(region_flops),
            ):
                arr = np.asarray(backend.execute(prog, vals))
            store.note_computed(region_flops, len(prog.steps))
            if admitted:
                store.put(key, arr, flops=flops)
        memo[i] = arr
    return {i: memo[i] for i in split.cached_idx}


class ReuseBinding:
    """Per-:class:`~tnc_tpu_torch.serve.rebind.BoundProgram` reuse state: the
    split, the shared store, the full (pre-split) leaf arrays, and one
    materialized residual array list per backend environment."""

    def __init__(
        self,
        split: ReuseSplit,
        store: IntermediateStore,
        base_arrays: Sequence[np.ndarray],
        cold_signature: str,
    ):
        self.split = split
        self.store = store
        self.base_arrays = list(base_arrays)
        # the pre-split program's signature digest: plan identity checks
        # compare plans, not residuals (rebind with a different store
        # state would otherwise look like a different plan)
        self.cold_signature = cold_signature
        self._env_arrays: dict[tuple, list[np.ndarray]] = {}
        self._lock = threading.Lock()

    def arrays_for(self, backend: Any) -> list[np.ndarray]:
        """The residual's input arrays for one backend environment,
        materializing (store-first) on first use."""
        key = backend_env_key(backend)
        with self._lock:
            got = self._env_arrays.get(key)
        if got is not None:
            return got
        values = materialize(self.split, self.store, self.base_arrays, backend)
        out = [
            self.base_arrays[ref] if kind == "leaf" else values[ref]
            for kind, ref in self.split.sources
        ]
        with self._lock:
            return self._env_arrays.setdefault(key, out)
