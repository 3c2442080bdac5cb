"""Atomic slice-range checkpoints for the sliced executors (the port's
copy of ``tnc_tpu.resilience.checkpoint``).

A deeply sliced contraction is a sum of independent slice contributions
accumulated in a fixed order; everything needed to resume after a crash
is (1) the partial accumulator (the Kahan (sum, comp) pairs in the
chunked executor, copied to the host between batches), (2) the
next-slice cursor, and (3) a signature of the
program + execution parameters so a checkpoint is never resumed into a
different computation. This module persists exactly that, atomically
(write-to-temp + fsync + ``os.replace``), as a single ``.npz``.

Gating: the executors take an explicit ``ckpt=`` argument, falling back
to the ``TNC_TPU_CKPT`` env var (:func:`resolve_ckpt`); unset means no
checkpoint object is ever constructed — the hot-path cost is one dict
lookup per *execution call* (not per slice).

``TNC_TPU_CKPT`` names a **directory** (created on demand): each
distinct program signature writes its own ``ckpt_<sig>.npz``, so the
parity oracle and the device run sharing one process never clobber each
other. A value ending in ``.npz`` is used as an exact file path.

Cadence (:meth:`SliceCheckpoint.maybe_save`): every
``TNC_TPU_CKPT_EVERY`` slices if set, else every ``TNC_TPU_CKPT_SECS``
seconds (default 30 — a checkpoint costs a device→host copy of the
accumulator, which is result-shaped, i.e. tiny, but the copy synchronises
the card with the host). Completed runs delete their checkpoint
(:meth:`finalize`), so a finished result is never "resumed".

Resume is **bit-identical**: the accumulator round-trips exactly
(float arrays, no re-encoding) and the remaining slices accumulate in
the same order with the same kernels.

>>> import tempfile, numpy as np, os
>>> d = tempfile.mkdtemp()
>>> ck = SliceCheckpoint(d, "sig-a", every=1)
>>> ck.load() is None
True
>>> ck.maybe_save(4, lambda: [np.arange(3.0)])
True
>>> cursor, arrs = SliceCheckpoint(d, "sig-a").load()
>>> cursor, [float(x) for x in arrs[0]]
(4, [0.0, 1.0, 2.0])
>>> SliceCheckpoint(d, "sig-OTHER").load() is None  # signature mismatch
True
>>> ck.finalize(); SliceCheckpoint(d, "sig-a").load() is None
True
"""

from __future__ import annotations

import hashlib
import json
import logging
import os
import time
from pathlib import Path
from typing import Any, Callable, Sequence

import numpy as np

from tnc_tpu_torch import obs

logger = logging.getLogger(__name__)

FORMAT_VERSION = 1


def resolve_ckpt(arg: str | None = None) -> str | None:
    """Explicit argument wins; else ``TNC_TPU_CKPT``; else None (off)."""
    if arg:
        return arg
    return os.environ.get("TNC_TPU_CKPT") or None


def signature_hash(*parts: Any) -> str:
    """Stable digest of the program + execution parameters a checkpoint
    is only valid for. Delegates to the shared canonical encoder
    (:func:`tnc_tpu_torch.utils.digest.stable_digest`) so checkpoint
    signatures and the serving plan cache hash program state the same
    way, independent of ``repr`` (dict ordering / hash seeds).

    >>> signature_hash("chunked-v1", (1, 2)) == signature_hash("chunked-v1", (1, 2))
    True
    """
    from tnc_tpu_torch.utils.digest import stable_digest

    return stable_digest(*parts)


def arrays_digest(arrays) -> str:
    """Digest of the input tensors' shapes, dtypes, and bytes. Folded
    into the checkpoint signature because the program signature alone is
    structural: two runs of the same circuit with different leaf data
    (e.g. amplitude networks for different bitstrings) share it, and one
    must never resume the other's accumulator. Only computed when
    checkpointing is armed, from host-resident arrays (never forces a
    device transfer)."""
    h = hashlib.sha256()
    for a in arrays:
        a = np.asarray(a)
        h.update(str(a.shape).encode())
        h.update(str(a.dtype).encode())
        h.update(np.ascontiguousarray(a).tobytes())
    return h.hexdigest()


class SliceCheckpoint:
    """One checkpoint slot for one (program, params) signature."""

    def __init__(
        self,
        path: str | Path,
        signature: str,
        every: int | None = None,
        min_interval_s: float | None = None,
    ):
        path = Path(path)
        if path.suffix == ".npz":
            self.file = path
        else:
            self.file = path / f"ckpt_{signature[:16]}.npz"
        self.signature = signature
        if every is None:
            raw = os.environ.get("TNC_TPU_CKPT_EVERY")
            every = int(raw) if raw else None
        self.every = every
        if min_interval_s is None:
            min_interval_s = float(os.environ.get("TNC_TPU_CKPT_SECS", "30"))
        self.min_interval_s = min_interval_s
        self._last_cursor = 0
        self._last_t = time.monotonic()

    def load(self) -> tuple[int, list[np.ndarray]] | None:
        """(cursor, accumulator arrays) or None (absent / corrupt /
        signature mismatch — each logged, never raised: a bad checkpoint
        degrades to a fresh run)."""
        if not self.file.exists():
            return None
        try:
            with np.load(self.file, allow_pickle=False) as z:
                meta = json.loads(str(z["meta"]))
                arrays = [z[f"a{i}"] for i in range(meta["n"])]
        except Exception as exc:  # noqa: BLE001 — any corruption → fresh
            logger.warning(
                "checkpoint %s unreadable (%s: %s); starting fresh",
                self.file, type(exc).__name__, exc,
            )
            return None
        if meta.get("version") != FORMAT_VERSION:
            logger.warning(
                "checkpoint %s has format version %s (want %d); ignoring",
                self.file, meta.get("version"), FORMAT_VERSION,
            )
            return None
        if meta.get("signature") != self.signature:
            logger.warning(
                "checkpoint %s signature mismatch (program or execution "
                "parameters changed); starting fresh", self.file,
            )
            return None
        cursor = int(meta["cursor"])
        obs.counter_add("resilience.ckpt.resumed")
        logger.info(
            "resuming from checkpoint %s at slice cursor %d",
            self.file, cursor,
        )
        self._last_cursor = cursor
        return cursor, arrays

    def save(self, cursor: int, arrays: Sequence[Any]) -> None:
        """Atomic write: temp file in the same directory, fsync,
        ``os.replace``. A SIGKILL at any instant leaves either the old
        or the new checkpoint, never a torn one."""
        self.file.parent.mkdir(parents=True, exist_ok=True)
        meta = {
            "version": FORMAT_VERSION,
            "signature": self.signature,
            "cursor": int(cursor),
            "n": len(arrays),
        }
        payload = {
            f"a{i}": np.asarray(a) for i, a in enumerate(arrays)
        }
        tmp = self.file.with_suffix(".npz.tmp")
        with open(tmp, "wb") as f:
            np.savez(f, meta=json.dumps(meta), **payload)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self.file)
        obs.counter_add("resilience.ckpt.saved")
        self._last_cursor = int(cursor)
        self._last_t = time.monotonic()

    def maybe_save(
        self, cursor: int, arrays_fn: Callable[[], Sequence[Any]]
    ) -> bool:
        """Cadence-gated :meth:`save`. ``arrays_fn`` is only called when
        a save actually happens (materializing the accumulator on the
        host costs a device sync)."""
        due = False
        if self.every is not None:
            due = cursor - self._last_cursor >= self.every
        elif self.min_interval_s is not None:
            due = time.monotonic() - self._last_t >= self.min_interval_s
        if not due:
            return False
        self.save(cursor, arrays_fn())
        return True

    def finalize(self) -> None:
        """Remove the checkpoint (run completed)."""
        try:
            self.file.unlink(missing_ok=True)
        except OSError:  # pragma: no cover — unwritable dir at exit
            pass
