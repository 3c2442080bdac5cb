"""Crash-resumable experiment journal (the port's copy of
``tnc_tpu.benchmark.protocol``).

Before each unit of work the driver appends ``Trying(id)``; after success
it appends ``Done(id)``. On restart, ``Trying`` entries without a matching
``Done`` mean the process died mid-run: they are recorded as ``Error`` and
skipped, so a crashing configuration cannot wedge a sweep loop.

Within-cell resume: with a ``checkpoint_dir``, a crashed cell whose
slice-range checkpoint survives (``tnc_tpu_torch.resilience.checkpoint``;
the executors write it under ``TNC_TPU_CKPT``) is **requeued** instead
of marked failed — re-running it resumes mid-range from the persisted
accumulator rather than redoing (or abandoning) hours of slices. Requeues are bounded (``max_resumes``, default 3): a cell
that keeps crashing *after* its first checkpoint would otherwise be
requeued on every restart forever, re-wedging exactly the sweep loop
this journal exists to protect.
"""

from __future__ import annotations

import json
from pathlib import Path


def cell_checkpoint_dir(checkpoint_dir: str | Path, run_id: str) -> Path:
    """Per-cell checkpoint directory (the value to export as
    ``TNC_TPU_CKPT`` while running that cell). Slashes in run ids become
    ``_`` so every cell stays one directory level."""
    return Path(checkpoint_dir) / run_id.replace("/", "_")


class Protocol:
    """Append-only Trying/Done/Error journal.

    >>> import tempfile, os
    >>> p = os.path.join(tempfile.mkdtemp(), "journal.jsonl")
    >>> proto = Protocol(p)
    >>> proto.should_run("cell-1")
    True
    >>> proto.trying("cell-1"); proto.done("cell-1")
    >>> proto.should_run("cell-1")
    False
    >>> proto.trying("cell-2")  # crash here: no Done follows
    >>> resumed = Protocol(p)   # restart marks cell-2 as Error
    >>> resumed.should_run("cell-2"), sorted(resumed.failed)
    (False, ['cell-2'])

    With a ``checkpoint_dir``, a crashed cell that left a checkpoint is
    requeued for a mid-range resume instead of failed:

    >>> d = tempfile.mkdtemp()
    >>> p2 = os.path.join(d, "journal.jsonl")
    >>> proto = Protocol(p2, checkpoint_dir=os.path.join(d, "ckpt"))
    >>> proto.trying("cell-3")  # crash mid-range...
    >>> ck = cell_checkpoint_dir(os.path.join(d, "ckpt"), "cell-3")
    >>> ck.mkdir(parents=True); _ = (ck / "ckpt_abc.npz").write_bytes(b"x")
    >>> back = Protocol(p2, checkpoint_dir=os.path.join(d, "ckpt"))
    >>> back.should_run("cell-3"), sorted(back.resumable)
    (True, ['cell-3'])
    """

    def __init__(
        self,
        path: str | Path,
        checkpoint_dir: str | Path | None = None,
        max_resumes: int = 3,
    ):
        self.path = Path(path)
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self.checkpoint_dir = (
            Path(checkpoint_dir) if checkpoint_dir is not None else None
        )
        self.max_resumes = max_resumes
        self._done: set[str] = set()
        self._error: set[str] = set()
        self._resumable: set[str] = set()
        self._load()

    def _has_checkpoint(self, run_id: str) -> bool:
        if self.checkpoint_dir is None:
            return False
        cell = cell_checkpoint_dir(self.checkpoint_dir, run_id)
        if cell.is_file():
            return True
        return cell.is_dir() and any(cell.glob("ckpt_*.npz"))

    def _load(self) -> None:
        trying: set[str] = set()
        resumes: dict[str, int] = {}
        if self.path.exists():
            with open(self.path) as f:
                for line in f:
                    line = line.strip()
                    if not line:
                        continue
                    rec = json.loads(line)
                    state, run_id = rec["state"], rec["id"]
                    if state == "trying":
                        trying.add(run_id)
                    elif state == "done":
                        trying.discard(run_id)
                        self._done.add(run_id)
                    elif state == "error":
                        # discard from trying too: an errored cell must
                        # not be re-processed (and re-journaled) as a
                        # stale Trying entry on every later load
                        trying.discard(run_id)
                        self._error.add(run_id)
                    elif state == "resuming":
                        resumes[run_id] = resumes.get(run_id, 0) + 1
        # stale Trying entries: resumable when a slice-range checkpoint
        # survives (the rerun picks up mid-range) and the resume budget
        # isn't spent; Error otherwise — a cell that crashed past its
        # first checkpoint on max_resumes straight resume attempts is
        # crashing deterministically, and must not wedge the sweep loop.
        # The budget counts "resuming" records, appended by :meth:`trying`
        # only when the cell actually re-runs — merely loading the
        # journal (e.g. a sweep filtered to other scenarios) spends
        # nothing.
        for run_id in sorted(trying):
            if (
                self._has_checkpoint(run_id)
                and resumes.get(run_id, 0) < self.max_resumes
            ):
                self._resumable.add(run_id)
                continue
            self._error.add(run_id)
            self._append("error", run_id)

    def _append(self, state: str, run_id: str) -> None:
        with open(self.path, "a") as f:
            f.write(json.dumps({"state": state, "id": run_id}) + "\n")

    def should_run(self, run_id: str) -> bool:
        """False for runs already done or known to crash (cells with a
        surviving checkpoint stay runnable — they resume mid-range)."""
        return run_id not in self._done and run_id not in self._error

    def trying(self, run_id: str) -> None:
        if run_id in self._resumable:
            # an actual resume attempt starts now — spend one unit of
            # the max_resumes budget in the journal
            self._append("resuming", run_id)
        self._append("trying", run_id)

    def done(self, run_id: str) -> None:
        self._done.add(run_id)
        self._resumable.discard(run_id)
        self._append("done", run_id)

    @property
    def completed(self) -> set[str]:
        return set(self._done)

    @property
    def failed(self) -> set[str]:
        return set(self._error)

    @property
    def resumable(self) -> set[str]:
        """Cells that crashed but left a checkpoint to resume from."""
        return set(self._resumable)
