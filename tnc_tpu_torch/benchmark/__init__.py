"""Research benchmark driver (``python -m tnc_tpu_torch.benchmark
sweep|run``), the port's copy of ``tnc_tpu.benchmark``, and the north-star
plan (:mod:`tnc_tpu_torch.benchmark.northstar`).

Two phases decoupled across job submissions:

- **Sweep** — run a path/partitioning optimizer on a QASM circuit on the
  host, record an :class:`~tnc_tpu_torch.benchmark.results.
  OptimizationResult` (predicted serial/parallel flops, memory,
  optimization time) and cache the optimized partitioned network + path
  as a compressed artifact.
- **Run** — load the cached artifact and contract it (on the card, or
  distributed over device slots), recording ``time_to_solution``.

Crash-resume comes from the :class:`~tnc_tpu_torch.benchmark.protocol.
Protocol` journal (``Trying``/``Done`` records; stale ``Trying`` entries
become ``Error`` on restart and are skipped). Importing the package
imports no torch.
"""

from tnc_tpu_torch.benchmark.cache import ArtifactCache  # noqa: F401
from tnc_tpu_torch.benchmark.methods import METHODS, MethodRun  # noqa: F401
from tnc_tpu_torch.benchmark.protocol import Protocol  # noqa: F401
from tnc_tpu_torch.benchmark.results import (  # noqa: F401
    OptimizationResult,
    ResultWriter,
    RunResult,
)
