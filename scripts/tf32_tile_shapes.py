#!/usr/bin/env python3
"""Device times of the TF32 tiles on fixed shapes, on one NVIDIA GPU.

Two modes:

- ``python3 scripts/tf32_tile_shapes.py [CHECKOUT]`` times
  ``fused_complex_dot`` at float32, ``high`` and ``default`` on the tiles
  the checkout routes to, for the same-card comparison of two versions
  (run it once for each checkout, in one call, alternating). The shapes:
  outer products (K of 2 to 64, M <= 8, N to 2^24), a long thin dot (K =
  2^16, M = N = 1), small and mid products of a few tiles, few columns (N
  = 3), and two cubes (1024^3, 4096^3).
- ``python3 scripts/tf32_tile_shapes.py --tiles`` times, at each TF32 rung,
  the same launch on the wgmma tile (``cuda_complex.wgmma_tile``) and on
  the mma.sync tile (``cuda_complex.mma_tile``), the tile named through the
  wrappers' ``tile=``: ``fused_complex_dot`` on a grid of the shapes phase
  21 of ``chip_smoke.py`` records (contract-first operands, as the split
  path passes them) and ``fused_transpose_dot`` on every layout the PEPS
  cell's forced ``fused_transpose`` rung launches; then the split
  contraction's piece length (``cuda_complex.SPLIT_K_MIN`` at 512, 1024,
  2048 and no cut) on products of few output tiles, on both tiles.

Each time is the device ms of one call (CUDA events, after one warm-up
call; the two tiles alternate over two rounds and each keeps its lower
round; ``--tiles`` also prints every row in one JSON line at the end).
Run from the repository root on the card::

    python3 scripts/tf32_tile_shapes.py [CHECKOUT | --tiles]

It ends with the card's name and power limit.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

SHAPES = [(2, 2, 2**24), (4, 8, 2**22), (2, 1, 2**22), (64, 2, 500000), (2**16, 1, 1),
          (1024, 64, 2048), (4096, 64, 256), (2048, 128, 128), (256, 4000, 3),
          (1024, 1024, 1024), (4096, 4096, 4096)]

#: ``(K, M, N, batch)`` of the tile comparison: the cubes, the random28 stem,
#: the launches of 2^30 multiply-adds or more that phase 21 held, and some
#: just under
TILE_SHAPES = [
    (1024, 1024, 1024, 1), (2048, 2048, 2048, 1), (4096, 4096, 4096, 1),
    (8192, 8192, 8192, 1), (16384, 8192, 16384, 1), (32768, 8192, 8192, 1),
    (1024, 128, 65536, 1), (1024, 2048, 8192, 1), (1024, 4096, 16384, 1),
    (1024, 4096, 2048, 8), (2048, 2048, 4096, 1), (8192, 1024, 65536, 1),
    (16384, 512, 16384, 8), (262144, 4096, 1024, 1), (1048576, 256, 256, 1),
    (256, 256, 262144, 1), (128, 128, 524288, 1), (128, 8192, 8192, 1),
    (32, 4096, 16384, 1), (16, 4096, 16384, 1), (16, 8192, 1024, 8), (16, 16384, 512, 8),
    (64, 2, 2**24, 1), (2**20, 8, 1024, 1), (2**18, 4000, 3, 1),
    (512, 1024, 1024, 1), (256, 2048, 1024, 1), (1024, 64, 2048, 1), (32, 2048, 4096, 1),
]

#: ``(K, M, N, batch)`` of the piece-length comparison: products whose
#: output tiles leave most SMs idle
SPLIT_SHAPES = [
    (1024, 64, 2048, 1), (2048, 128, 128, 1), (4096, 64, 256, 1), (4096, 128, 128, 1),
    (8192, 64, 64, 1), (16384, 32, 32, 1), (65536, 1, 1, 1), (65536, 64, 64, 1),
    (262144, 32, 32, 1), (2**20, 1, 1, 8), (1048576, 256, 256, 1), (16384, 256, 512, 1),
]
SPLIT_MINS = (512, 1024, 2048, None)


def event_ms(torch, fn, reps: int) -> float:
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def warm_reps(torch, fn) -> int:
    """One warm-up call; as many timed calls as take about 0.2 s (3 to 20)."""
    t = event_ms(torch, fn, 1)
    return max(3, min(20, int(200.0 / max(t, 1e-3))))


def compare(torch, calls: dict) -> dict:
    """``{name: ms}`` of each call, alternating over two rounds, the lower
    round kept."""
    reps = {name: warm_reps(torch, fn) for name, fn in calls.items()}
    best = {name: float("inf") for name in calls}
    for _ in range(2):
        for name, fn in calls.items():
            best[name] = min(best[name], event_ms(torch, fn, reps[name]))
    return best


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def fixed_shapes(root: str) -> None:
    import torch

    from tnc_tpu_torch.ops import cuda_complex as cc

    gen = torch.Generator(device="cuda").manual_seed(0)
    for k, m, n in SHAPES:
        ops = [torch.randn(k, s, generator=gen, device="cuda") for s in (m, m, n, n)]
        row = {}
        for rung in ("float32", "high", "default"):
            event_ms(torch, lambda: cc.fused_complex_dot(*ops, precision=rung), 1)
            row[rung] = event_ms(torch, lambda: cc.fused_complex_dot(*ops, precision=rung), 10)
        print(f"{root} K={k} M={m} N={n} " + " ".join(f"{r} {t:.4f}" for r, t in row.items()),
              flush=True)
        del ops


def tile_comparison(root: str) -> None:
    import torch

    from tnc_tpu_torch.ops import cuda_complex as cc
    from tnc_tpu_torch.ops.program import build_program

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = []

    def ops_of(k, m, n, batch):
        lead = () if batch == 1 else (batch,)
        return [torch.randn(*lead, k, s, generator=gen, device="cuda") for s in (m, m, n, n)]

    for k, m, n, batch in TILE_SHAPES:
        ops = ops_of(k, m, n, batch)
        tiles = {"wgmma": cc.wgmma_tile(m, n), "mma": cc.mma_tile(m, n, sms)}
        for rung in ("high", "default"):
            routed = cc.tf32_config(k, m, n, rung, batch=batch, sms=sms).name
            ms = compare(torch, {fam: (lambda t=t: cc.fused_complex_dot(
                *ops, precision=rung, tile=t)) for fam, t in tiles.items()})
            row = {"kernel": "fused_complex_dot", "k": k, "m": m, "n": n, "batch": batch,
                   "rung": rung, "routed": routed, **{f"{fam} {tiles[fam]}": v
                                                      for fam, v in ms.items()}}
            print(json.dumps(row), flush=True)
            rows.append(row)
        del ops
        torch.cuda.empty_cache()

    # the PEPS cell's admitted transpose-dot layouts (chip_smoke.py phase 21)
    sys.path.insert(0, root)
    import chip_smoke as cs

    peps_tn = cs.build_peps(cs.PEPS)
    program = build_program(peps_tn, cs.plan(peps_tn))
    for first, second, steps in cs.transpose_cases(program):
        k, m, n = first.k_size, first.f_size, second.f_size
        ops = [torch.randn(v, generator=gen, device="cuda")
               for v in (first.view, first.view, second.view, second.view)]
        tiles = {"wgmma": cc.wgmma_tile(m, n), "mma": cc.mma_tile(m, n, sms)}
        for rung in ("high", "default"):
            ms = compare(torch, {fam: (lambda t=t: cc.fused_transpose_dot(
                *ops, first, second, rung, tile=t)) for fam, t in tiles.items()})
            row = {"kernel": "fused_transpose_dot", "steps": steps, "k": k, "m": m, "n": n,
                   "batch": 1, "rung": rung,
                   "routed": cc.tf32_config(k, m, n, rung, 4, sms=sms).name,
                   **{f"{fam} {tiles[fam]}": v for fam, v in ms.items()}}
            print(json.dumps(row), flush=True)
            rows.append(row)
        del ops
        torch.cuda.empty_cache()

    # the piece length of a split contraction
    saved = cc.SPLIT_K_MIN
    try:
        for k, m, n, batch in SPLIT_SHAPES:
            ops = ops_of(k, m, n, batch)
            tiles = {"wgmma": cc.wgmma_tile(m, n), "mma": cc.mma_tile(m, n, sms)}
            for rung in ("high", "default"):
                for fam, t in tiles.items():
                    calls = {}
                    for least in SPLIT_MINS:
                        def call(least=least, t=t):
                            cc.SPLIT_K_MIN = k + 1 if least is None else least
                            return cc.fused_complex_dot(*ops, precision=rung, tile=t)
                        calls[str(least)] = call
                    ms = compare(torch, calls)
                    pieces = {}
                    for least in SPLIT_MINS:
                        cc.SPLIT_K_MIN = k + 1 if least is None else least
                        tiles_n = cc.tf32_config(k, m, n, rung, batch=batch, sms=sms,
                                                 tile=t).tiles(m, n)
                        pieces[str(least)] = cc.split_k_pieces(k, tiles_n, batch, sms)
                    row = {"kernel": "fused_complex_dot split", "k": k, "m": m, "n": n,
                           "batch": batch, "rung": rung, "tile": t, "pieces": pieces,
                           "ms": ms}
                    print(json.dumps(row), flush=True)
                    rows.append(row)
            del ops
            torch.cuda.empty_cache()
    finally:
        cc.SPLIT_K_MIN = saved
    print(json.dumps({"tf32_tiles": rows}), flush=True)


def main() -> int:
    tiles = sys.argv[1:] == ["--tiles"]
    root = os.path.abspath(sys.argv[1] if len(sys.argv) > 1 and not tiles else
                           os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    sys.path.insert(0, root)
    import torch

    if not torch.cuda.is_available():
        print("tf32_tile_shapes: CUDA is not available", file=sys.stderr)
        return 2
    from tnc_tpu_torch.ops import cuda_complex as cc
    from tnc_tpu_torch.ops.backends import TorchBackend

    cc.build_kernels()
    TorchBackend()  # TF32 off
    if tiles:
        tile_comparison(root)
    else:
        fixed_shapes(root)
    print(card())
    return 0


if __name__ == "__main__":
    sys.exit(main())
