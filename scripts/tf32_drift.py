#!/usr/bin/env python3
"""How far a cuBLAS TF32 product drifts from float64 as its contraction
grows, beside the port's own TF32 rungs, on one NVIDIA GPU: why the port's
TF32 products run the hand kernels' tensor-core tile and not cuBLAS.

For K in 1024, 4096 and 16384 (M = N = 1024, seeded normal FP32 operands)
it prints the relative Frobenius error against a float64 product of the same
inputs of:

- the FP32 product (TF32 off);
- at ``high`` (3xTF32) and ``default`` (one TF32 pass): the rung's terms
  (``split_complex.split_tf32`` / ``rna_tf32`` operands) as cuBLAS TF32
  products in one call each, TF32 switched on here around them; and
  ``split_complex.rung_matmul``, the plain version (the same terms in FP32);
- the ``fused_complex_dot`` kernel at each rung (its four real products
  against the float64 complex product), which adds each k8 step's
  tensor-core products in FP32.

Run from the repository root on the card (a minute with the kernel build)::

    python3 scripts/tf32_drift.py

It ends with one JSON line and the card's name and power limit.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("tf32_drift: CUDA is not available", file=sys.stderr)
        return 2
    from tnc_tpu_torch.ops import cuda_complex as cc
    from tnc_tpu_torch.ops import split_complex as sc
    from tnc_tpu_torch.ops.backends import TorchBackend

    TorchBackend()  # TF32 off
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

    rows = []
    for k in (1024, 4096, 16384):
        m = n = 1024
        x, y = (torch.randn(k, s, generator=gen, device="cuda") for s in (m, n))
        exact = x.double().mT @ y.double()
        row = {"k": k, "m": m, "n": n, "float32": rel(x.mT @ y, exact)}
        for rung in ("high", "default"):
            row[f"{rung} cuBLAS TF32"] = rel(cublas_tf32(x.mT, y, rung), exact)
            row[f"{rung} plain"] = rel(sc.rung_matmul(x.mT, y, rung), exact)
        ops = [torch.randn(k, s, generator=gen, device="cuda") for s in (m, m, n, n)]
        exact = cc.fused_complex_dot_reference(*(t.double() for t in ops))
        for rung in ("float32", "high", "default"):
            got = cc.fused_complex_dot(*ops, precision=rung)
            num = sum(float(((g.double() - e) ** 2).sum()) for g, e in zip(got, exact))
            den = sum(float((e ** 2).sum()) for e in exact)
            row[f"fused_complex_dot {rung}"] = (num / den) ** 0.5
        print(" ".join(f"{key} {value:.3e}" if isinstance(value, float) else f"{key} {value}"
                       for key, value in row.items()), flush=True)
        rows.append(row)
        del x, y, exact, ops
        torch.cuda.empty_cache()
    print(json.dumps({"tf32_drift": rows}), flush=True)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0])
    return 0


if __name__ == "__main__":
    sys.exit(main())
