#!/usr/bin/env python3
"""Time one boundary-MPS sweep on the card under each cuSOLVER SVD driver
``torch.linalg.svd`` offers for the sweep's matrices.

Usage (from the repository root, one CUDA device)::

    python3 scripts/svd_driver_times.py [--chi 128] [--reps 3]

The sweep is ``chip_smoke.py`` phase 13's timed PEPS sandwich,
``peps(8, 8, 2, 2, 1)`` with data from ``default_rng(3)`` at
``unit_scale``, in complex64 at ``--chi``. The port's sweep passes
``gesvdj`` (``tnc_tpu_torch.tensornetwork.approximate._CUDA_SVD_DRIVER``);
this script sets that constant to each driver in turn, for its own calls
only. Each driver takes one warm-up sweep, then ``--reps`` timed sweeps,
the drivers' order reversed every other repetition; each sweep is timed
by CUDA events recorded just before and just after it (the value reaching
the host ends it). Ends with one JSON object: per driver the seconds of
each sweep, their median and the largest distance of its values from
``gesvdj``'s first one, and the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

DRIVERS = ("gesvdj", "gesvd")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--chi", type=int, default=128)
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args()

    import numpy as np
    import torch

    import chip_smoke as cs
    from tnc_tpu_torch.approx import ApproxProgram
    from tnc_tpu_torch.builders.peps import peps
    from tnc_tpu_torch.tensornetwork import approximate

    if not torch.cuda.is_available():
        print("svd_driver_times: CUDA is not available", file=sys.stderr)
        return 1
    card = cs.card_line()
    print(card, flush=True)
    length, _chis, dtype = cs.APPROX_PEPS[-1]
    tn = peps(length, length, 2, 2, 1)
    tn = approximate.attach_random_data(tn, np.random.default_rng(3),
                                        scale=approximate.unit_scale(tn))
    prog = ApproxProgram.from_peps_sandwich(tn, length, length, 1)
    kept = approximate._CUDA_SVD_DRIVER

    def sweep(driver: str) -> tuple[complex, float]:
        approximate._CUDA_SVD_DRIVER = driver
        try:
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            value, _weight = prog.contract(args.chi, dtype=dtype)
            end.record()
            end.synchronize()
            return value, start.elapsed_time(end) / 1e3
        finally:
            approximate._CUDA_SVD_DRIVER = kept

    for driver in DRIVERS:
        sweep(driver)
    seconds = {d: [] for d in DRIVERS}
    values = {d: [] for d in DRIVERS}
    for rep in range(args.reps):
        for driver in (DRIVERS if rep % 2 == 0 else DRIVERS[::-1]):
            value, sec = sweep(driver)
            seconds[driver].append(sec)
            values[driver].append(value)
            print(f"[peps{length}{length} chi {args.chi} {dtype}] {driver}: {sec:.4f} s, "
                  f"value {value:.10e}", flush=True)
    first = values["gesvdj"][0]
    out = {d: {"s": seconds[d], "median_s": statistics.median(seconds[d]),
               "max_value_distance": max(abs(v - first) for v in values[d])}
           for d in DRIVERS}
    print(json.dumps({"peps": [length, length, 2, 2, 1], "chi": args.chi, "dtype": dtype,
                      "drivers": out, "card": card}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
