"""Result records of the benchmark CLI (the port's copy of
``tnc_tpu.benchmark.results``).

Results are append-only JSON lines so concurrent/restarted sweeps never
clobber earlier records.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass
from pathlib import Path


@dataclass
class OptimizationResult:
    """Per-sweep record."""

    id: str
    method: str
    circuit: str
    partitions: int
    seed: int
    serial_flops: float
    serial_memory: float
    flops: float  # critical-path (parallel) cost
    flops_sum: float  # sum cost over all partitions
    memory: float  # bytes
    optimization_time: float  # seconds


@dataclass
class RunResult:
    """Per-run record."""

    id: str
    method: str
    circuit: str
    partitions: int
    seed: int
    time_to_solution: float  # seconds, contraction only
    backend: str = "torch"
    # the run resumed a crashed cell from a slice-range checkpoint: its
    # wall time covers only the REMAINING range, not a full contraction —
    # comparisons must not read it as a clean-run time
    resumed: bool = False


class ResultWriter:
    """Append-only JSON-lines writer.

    >>> import tempfile, os
    >>> w = ResultWriter(os.path.join(tempfile.mkdtemp(), "results.jsonl"))
    >>> w.write(RunResult("id1", "sa", "ghz", 4, 7, 1.5))
    >>> [r["kind"] for r in w.read_all()]
    ['RunResult']
    """

    def __init__(self, path: str | Path):
        self.path = Path(path)
        self.path.parent.mkdir(parents=True, exist_ok=True)

    def write(self, record: OptimizationResult | RunResult) -> None:
        payload = dataclasses.asdict(record)
        payload["kind"] = type(record).__name__
        with open(self.path, "a") as f:
            f.write(json.dumps(payload) + "\n")

    def read_all(self) -> list[dict]:
        if not self.path.exists():
            return []
        out = []
        with open(self.path) as f:
            for line in f:
                line = line.strip()
                if line:
                    out.append(json.loads(line))
        return out
