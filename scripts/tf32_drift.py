#!/usr/bin/env python3
"""How far TF32 products drift from float64 as their contraction grows, on
one NVIDIA GPU: one cuBLAS TF32 call beside the port's own TF32 rungs, and
the TF32 tile's accumulation depth.

For K in 1024, 4096, 16384 and 262144 (M = N = 1024, seeded normal FP32
operands) it prints the relative Frobenius error against a float64 product
of the same inputs of:

- the FP32 product (TF32 off);
- at ``high`` (3xTF32) and ``default`` (one TF32 pass): the rung's terms
  (``split_complex.split_tf32`` / ``rna_tf32`` operands) as cuBLAS TF32
  products in one call each, TF32 switched on here around them; and
  ``split_complex.rung_matmul``, the plain version (the same terms in FP32);
- the ``fused_complex_dot`` kernel at each rung (its four real products
  against the float64 complex product) for each chain depth of
  :data:`CHAINS`: the k8 steps one ``wgmma`` chain sums in the tensor cores
  (whose sum does not round to nearest) before its FP32 fold into the
  partial sums, and its time at each depth. The depth is a compile-time
  constant of ``csrc/tf32_tile.cuh`` (0, the kernels' own: one stage at
  ``high``, ``kDefaultChainK8`` at ``default``); the script builds a
  library for each other depth with ``-DTNC_TF32_CHAIN_K8=n`` under
  ``_build/tf32_drift/``, all at once.

The wgmma tile takes the products of 2^30 multiply-adds or more that
``cuda_complex.tf32_config`` routes to it; the script names it (``tile=``)
so that every K runs it.

Run from the repository root on the card (four minutes with the kernel
builds)::

    python3 scripts/tf32_drift.py

It ends with one JSON line and the card's name and power limit.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

#: the contraction lengths measured
KS = (1024, 4096, 16384, 262144)
#: the chain depths measured, in k8 steps (0: the kernels' own)
CHAINS = (0, 1, 2, 4, 8, 16, 64)


def chain_libraries(cc) -> dict:
    """``{depth: library path}`` of ``fused_complex_dot`` built at each
    depth of :data:`CHAINS` but 0 (one ``nvcc`` each, all started
    together)."""
    out_dir = cc.build_dir() / "tf32_drift"
    out_dir.mkdir(parents=True, exist_ok=True)
    source = cc.CSRC_DIR / "fused_complex_dot.cu"
    procs = {}
    for depth in CHAINS[1:]:
        path = out_dir / f"fused_complex_dot-chain{depth}.so"
        cmd = [cc._nvcc(), *cc.NVCC_FLAGS, f"-DTNC_TF32_CHAIN_K8={depth}", "-o", str(path),
               str(source)]
        procs[depth] = (path, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                               stderr=subprocess.STDOUT, text=True))
    out = {0: cc.build_kernels(["fused_complex_dot"])["fused_complex_dot"]}
    for depth, (path, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc at chain depth {depth} exited {proc.returncode}\n{log}")
        out[depth] = path
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("tf32_drift: CUDA is not available", file=sys.stderr)
        return 2
    from tnc_tpu_torch.ops import cuda_complex as cc
    from tnc_tpu_torch.ops import split_complex as sc
    from tnc_tpu_torch.ops.backends import TorchBackend

    TorchBackend()  # TF32 off
    libraries = chain_libraries(cc)
    matmul = torch.backends.cuda.matmul
    gen = torch.Generator(device="cuda").manual_seed(0)

    def rel(got, exact):
        return float((got.double() - exact).norm() / exact.norm())

    def cublas_tf32(x, y, rung):
        if rung == "default":
            terms = [(sc.rna_tf32(x), sc.rna_tf32(y))]
        else:
            (xh, xl), (yh, yl) = sc.split_tf32(x), sc.split_tf32(y)
            terms = [(xh, yl), (xl, yh), (xh, yh)]
        matmul.allow_tf32 = True
        try:
            out = terms[0][0] @ terms[0][1]
            for a, b in terms[1:]:
                out += a @ b
        finally:
            matmul.allow_tf32 = False
        return out

    def event_ms(fn, reps=3):
        fn()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / reps

    rows = []
    for k in KS:
        m = n = 1024
        x, y = (torch.randn(k, s, generator=gen, device="cuda") for s in (m, n))
        exact = x.double().mT @ y.double()
        row = {"k": k, "m": m, "n": n, "float32": rel(x.mT @ y, exact)}
        for rung in ("high", "default"):
            row[f"{rung} cuBLAS TF32"] = rel(cublas_tf32(x.mT, y, rung), exact)
            row[f"{rung} plain"] = rel(sc.rung_matmul(x.mT, y, rung), exact)
        del x, y, exact
        ops = [torch.randn(k, s, generator=gen, device="cuda") for s in (m, m, n, n)]
        exact = cc.fused_complex_dot_reference(*(t.double() for t in ops))
        den = sum(float((e ** 2).sum()) for e in exact)
        try:
            for rung in ("float32", "high", "default"):
                tile = None if rung == "float32" else cc.wgmma_tile(m, n)
                for chain in (CHAINS if rung != "float32" else (0,)):
                    cc._LIBS["fused_complex_dot"] = cc.bind_library("fused_complex_dot",
                                                                    libraries[chain])
                    got = cc.fused_complex_dot(*ops, precision=rung, tile=tile)
                    num = sum(float(((g.double() - e) ** 2).sum()) for g, e in zip(got, exact))
                    del got
                    key = f"fused_complex_dot {rung}" + ("" if rung == "float32" else
                                                          f" chain {chain}")
                    row[key] = (num / den) ** 0.5
                    row[f"{key} ms"] = event_ms(
                        lambda: cc.fused_complex_dot(*ops, precision=rung, tile=tile))
        finally:
            cc._LIBS["fused_complex_dot"] = cc.bind_library("fused_complex_dot", libraries[0])
        print(" ".join(f"{key} {value:.3e}" if isinstance(value, float) else f"{key} {value}"
                       for key, value in row.items()), flush=True)
        rows.append(row)
        del ops, exact
        torch.cuda.empty_cache()
    print(json.dumps({"tf32_drift": rows}), flush=True)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0])
    return 0


if __name__ == "__main__":
    sys.exit(main())
