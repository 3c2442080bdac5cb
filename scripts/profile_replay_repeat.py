#!/usr/bin/env python3
"""Profile one replayed CUDA graph of the two small sliced amplitudes many
times, on the card, and count the profiles that hold no device record.

Usage (from the repository root, one CUDA device)::

    python3 scripts/profile_replay_repeat.py [--reps N]

Each of ``chip_smoke.CHUNKED_SMALL``'s Sycamore-20 amplitudes runs on the
default sliced path in batches of 2, so its second batch replays the
captured graphs; ``chip_smoke.profile_replay`` profiles that replay under
``torch.profiler`` ``N`` times (one call each, no retry). A profile
without a device record is what ``profile_replay`` retries and, after its
last call, reports as not measured. Ends with one JSON object: per cell,
the profiles with and without device records, and the card's name and
power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=25)
    args = ap.parse_args()

    import torch

    import chip_smoke as cs
    from tnc_tpu_torch.ops import cuda_complex
    from tnc_tpu_torch.ops.backends import TorchBackend
    from tnc_tpu_torch.ops.program import flat_leaf_tensors
    from tnc_tpu_torch.ops.sliced import build_sliced_program

    card = cs.card_line()
    print(card, flush=True)
    t0 = time.perf_counter()
    cuda_complex.build_kernels()
    print(f"build {time.perf_counter() - t0:.1f} s", flush=True)
    # one profiler session first, as chip_smoke.py's phase 6 opens one
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]):
        torch.ones(1024, device="cuda").sum()
    torch.cuda.synchronize()
    cells = {}
    for cfg in cs.CHUNKED_SMALL:
        tn, path, sl = cs.build_sliced(cfg)
        sp = build_sliced_program(tn, path, sl)
        arrays = [leaf.data.into_data() for leaf in flat_leaf_tensors(tn)]
        backend = TorchBackend(slice_batch=2)
        backend.execute_sliced(sp, arrays, host=False)
        with_records = without = 0
        for _ in range(args.reps):
            rec = cs.profile_replay(lambda: backend.execute_sliced(sp, arrays, host=False),
                                    f"{cfg} batch 2", 1, attempts=1)
            if rec["device_records"]:
                with_records += 1
            else:
                without += 1
        cells[str(cfg)] = {"with_device_records": with_records, "without": without}
        print(f"{cfg}: profiles with device records {with_records}, without {without}",
              flush=True)
    print(json.dumps({"cells": cells, "reps": args.reps, "card": card}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
