#!/usr/bin/env python3
"""Time one long chain stage of ``fused_chain`` under several thread shapes,
on the card.

Usage (from the repository root, one CUDA device)::

    python3 scripts/chain_stage_sweep.py

The stage is the head of sycamore20_m8_t17's residual chain, ``(K, M, N) =
(256, 8, 256)``, run alone as a one-stage chain on random float32 operands
(seed 0), resident form. Printed, each with its device ms per launch
(CUDA events behind ``torch.cuda._sleep``, ``chip_smoke.time_ms``), its
error against the plain version, and the SM clock ``nvidia-smi`` reads
after it:

- the planned shape at K = 32, 64, 128, 256, 512 (batch 8): how the time
  grows with the contract length;
- K = 256 at batch 1, 8, 32, 132: whether it grows with the batch (one
  block a batch row);
- K = 256, batch 8, with the thread shape forced to 1, 2, 4 or 8 outputs
  a thread along the slow operand, and to 8 x 2 with K split over 2
  threads (the plan's choice);
- the whole chain (the head and its 2048-long dot) at batch 1 and 8.

Ends with one JSON line of the records and the card's name and power
limit.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path


def main() -> int:
    repo = Path(__file__).resolve().parent.parent
    sys.path.insert(0, str(repo))
    sys.path.insert(0, str(repo / "tests"))
    import torch

    if not torch.cuda.is_available():
        print("chain_stage_sweep: CUDA is not available", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from _torch_chain_cases import make_chain

    from tnc_tpu_torch.ops import cuda_complex as cc

    def clock() -> str:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader"],
            capture_output=True, text=True, check=True).stdout.strip()

    cc.build_kernels(["fused_chain"])
    records = []

    def bench(stages, batch, label, shape=None):
        first, link_ops, links = make_chain(stages, torch.float32, batch, device="cuda")
        real = cc.chain_stage_shape
        if shape is not None:
            cc.chain_stage_shape = lambda k, m, n: shape
        try:
            plan = cc.chain_plan(first, link_ops, links)
        finally:
            cc.chain_stage_shape = real
        got = cc.fused_chain(first, link_ops, links, plan)
        err, scale = cs.max_err(got, cc.fused_chain_reference(first, link_ops, links))
        ms, _ = cs.time_ms(lambda: cc.fused_chain(first, link_ops, links, plan), reps=100)
        rec = {"label": label, "stages": [list(s) for s in stages], "batch": batch,
               "shapes": [sh._asdict() for sh in plan.stages], "ms": ms,
               "rel_err": err / scale, "clock": clock()}
        records.append(rec)
        print(f"{label}: batch {batch}, shapes "
              f"{[(sh.tm, sh.tn, sh.ks) for sh in plan.stages]} (tm, tn, ks): {ms:.5f} ms, "
              f"relative error {err / scale:.1e}, SM clock {rec['clock']}", flush=True)

    for k in (32, 64, 128, 256, 512):
        bench([(k, 8, 256)], 8, f"head K={k}")
    for batch in (1, 8, 32, 132):
        bench([(256, 8, 256)], batch, "head K=256")
    for tm in (1, 2, 4, 8):
        bench([(256, 8, 256)], 8, f"head forced tm={tm}", cc.ChainStageShape(False, tm, 1))
    bench([(256, 8, 256)], 8, "head forced tm=8 tn=2 ks=2", cc.ChainStageShape(False, 8, 2, 2))
    for batch in (1, 8):
        bench([(256, 8, 256), (2048, 1, 1)], batch, "chain")
    print(json.dumps(records), flush=True)
    print(cs.card_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
