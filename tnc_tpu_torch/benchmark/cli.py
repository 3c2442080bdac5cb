"""Benchmark CLI (the port's copy of ``tnc_tpu.benchmark.cli``).

    python -m tnc_tpu_torch.benchmark sweep --circuits-dir circuits/ \
        --partitions 4 8 --seeds 0 1 2 --methods greedy sa-intermediate \
        --cache-dir cache/ --out results.jsonl
    python -m tnc_tpu_torch.benchmark run --circuits-dir circuits/ ...

Circuits are ``.qasm`` files in ``--circuits-dir``; every
(circuit x partitions x seed x method) cell is one scenario.
``--include``/``--exclude`` filter by scenario index ranges. ``sweep`` is
host work (no torch); ``run`` contracts on the card with ``--backend
torch`` (the default), or on the host under ``TNC_TPU_PLATFORM=cpu``
or with ``--backend numpy``. A scenario that fails is logged and the CLI
goes on, exiting 0: read the results, the protocol and the log.
"""

from __future__ import annotations

import argparse
import logging
import sys
from pathlib import Path

from tnc_tpu_torch.benchmark.cache import ArtifactCache
from tnc_tpu_torch.benchmark.driver import Scenario, do_run, do_sweep
from tnc_tpu_torch.benchmark.logging_util import setup_logging
from tnc_tpu_torch.benchmark.methods import METHODS
from tnc_tpu_torch.benchmark.protocol import Protocol
from tnc_tpu_torch.benchmark.results import ResultWriter

log = logging.getLogger("tnc_tpu_torch.benchmark")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="tnc_tpu_torch.benchmark")
    p.add_argument("mode", choices=["sweep", "run"])
    p.add_argument("--circuits-dir", required=True, type=Path)
    p.add_argument("--cache-dir", default=Path("bench_cache"), type=Path)
    p.add_argument("--out", default=Path("results.jsonl"), type=Path)
    p.add_argument("--protocol", default=Path("protocol.jsonl"), type=Path)
    p.add_argument(
        "--checkpoint-dir", default=None, type=Path,
        help="slice-range checkpoint root (tnc_tpu_torch.resilience): run cells "
        "with per-cell TNC_TPU_CKPT, and requeue crashed cells whose "
        "checkpoint survives (mid-range resume) instead of failing them",
    )
    p.add_argument("--log-dir", default=None, type=Path)
    p.add_argument("--partitions", nargs="+", type=int, default=[4])
    p.add_argument("--seeds", nargs="+", type=int, default=[0])
    p.add_argument(
        "--methods", nargs="+", default=["greedy"],
        choices=sorted(METHODS),
    )
    p.add_argument("--time-budget", type=float, default=600.0)
    p.add_argument("--backend", default="torch")
    p.add_argument("--distributed", action="store_true")
    p.add_argument("--repeats", type=int, default=1)
    p.add_argument("--include", nargs=2, type=int, metavar=("LO", "HI"),
                   help="only scenario indices in [LO, HI)")
    p.add_argument("--exclude", nargs=2, type=int, metavar=("LO", "HI"))
    return p


def enumerate_scenarios(args) -> list[Scenario]:
    circuits = sorted(args.circuits_dir.glob("*.qasm"))
    if not circuits:
        raise SystemExit(f"no .qasm circuits in {args.circuits_dir}")
    scenarios = []
    for circuit in circuits:
        text = circuit.read_text()
        for partitions in args.partitions:
            for seed in args.seeds:
                for method in args.methods:
                    scenarios.append(
                        Scenario(
                            circuit_name=circuit.stem,
                            circuit_text=text,
                            partitions=partitions,
                            seed=seed,
                            method=method,
                        )
                    )
    indexed = list(enumerate(scenarios))
    if args.include:
        lo, hi = args.include
        indexed = [(i, s) for i, s in indexed if lo <= i < hi]
    if args.exclude:
        lo, hi = args.exclude
        indexed = [(i, s) for i, s in indexed if not (lo <= i < hi)]
    return [s for _, s in indexed]


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    setup_logging(args.log_dir)

    from tnc_tpu_torch.io.qasm import import_qasm

    cache = ArtifactCache(args.cache_dir)
    writer = ResultWriter(args.out)
    protocol = Protocol(args.protocol, checkpoint_dir=args.checkpoint_dir)

    scenarios = enumerate_scenarios(args)
    log.info("%d scenarios in %s mode", len(scenarios), args.mode)

    circuits_cache: dict[str, object] = {}
    for scenario in scenarios:
        try:
            if args.mode == "sweep":
                if scenario.circuit_name not in circuits_cache:
                    circuit = import_qasm(scenario.circuit_text)
                    tn, _ = circuit.into_statevector_network()
                    circuits_cache[scenario.circuit_name] = tn
                do_sweep(
                    scenario,
                    circuits_cache[scenario.circuit_name],
                    cache, writer, protocol,
                    time_budget=args.time_budget,
                )
            else:
                do_run(
                    scenario, cache, writer, protocol,
                    backend=args.backend,
                    distributed=args.distributed,
                    repeats=args.repeats,
                    checkpoint_dir=args.checkpoint_dir,
                )
        except Exception:
            log.exception("scenario %s failed", scenario.run_id)
    return 0


if __name__ == "__main__":
    sys.exit(main())
