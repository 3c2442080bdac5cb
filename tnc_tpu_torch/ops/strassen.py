"""Strassen-style contraction for the large stem GEMMs (the port's copy of
``tnc_tpu.ops.strassen`` in torch).

Tensor contraction is implicit matmul, and at stem-GEMM shapes (big,
square-ish, power-of-two dims) a single Strassen recursion level trades
an eighth of the multiplies for a few extra elementwise passes
(arXiv:1704.03092). This is plain torch, not a hand kernel: the seven
sub-products are ``torch.matmul`` calls, as the reference left them to
XLA, each at the step's dot-precision rung
(:func:`~tnc_tpu_torch.ops.split_complex.rung_matmul`: the quadrant and
Gauss sums are formed in FP32, then each sub-product's operands are rounded
or split, and the products run in FP32, on the card too). The executors
reach these functions at ``float32`` only: a step at a TF32 rung runs the
tensor-core tile of ``fused_complex_dot`` whatever its mode
(:func:`~tnc_tpu_torch.ops.split_complex.apply_step_split`). The
crossover below is the reference's TPU value; the port keeps it so both
packages plan the same steps as ``stem``.

Composition with split-complex arithmetic: a complex product lowers to
3 real GEMMs via the Gauss identity (``ops/split_complex.gauss_matmul``)
and each of those 3 runs one Strassen level — **3×7 = 21 half-size real
sub-GEMMs** against the naive lowering's 4 full GEMMs (= 32 half-size
multiply units): a 21/32 ≈ 0.66× multiply count. That factor is also
the *effective-flop credit* the benchmark applies so MFU numbers stay
comparable across kernel modes (``bench.py`` kernel buckets).

Layout convention matches the step compiler's dot layout and the fused
complex kernel: operands arrive contract-dim-leading, ``A: (K, M)``,
``B: (K, N)``, result ``AᵀB: (M, N)``. Written against that layout the
Strassen block sums are sums of contiguous ``(K/2, M/2)`` quadrants —
no operand is ever transposed; the transpose is a view inside each
sub-product.

Numerics: Strassen's extra additions mix operand magnitudes before the
products, so rounding error grows a small constant factor over the
naive dot (same failure family as the Gauss/Karatsuba instability —
see ``split_complex.complex_mult_env``). The reference documents
tolerance rungs vs the complex128 numpy oracle of **2e-5 relative
(float32)** and **1e-12 relative (float64)** at one recursion level.
"""

from __future__ import annotations

#: one Strassen level only pays off once every matricized dim clears
#: this floor (calibrated crossover: below it the 15 extra elementwise
#: passes over quadrant-sized buffers cost more than the saved eighth
#: of the multiplies; 2^11 per dim ≈ the stem-GEMM regime).
STRASSEN_MIN_DIM = 1 << 11

#: "square-ish" guard: beyond this aspect ratio the problem is really a
#: panel GEMM — bandwidth-bound, where Strassen's extra passes hurt.
STRASSEN_MAX_ASPECT = 4.0

#: multiply-count credit of one gauss+strassen level vs the naive 4-dot
#: complex lowering: 3 Gauss products × 7 half-size sub-GEMMs = 21
#: half-units against naive's 4 GEMMs × 8 half-units = 32.
GAUSS_STRASSEN_FLOP_FACTOR = 21.0 / 32.0


def strassen_eligible(
    m: int,
    k: int,
    n: int,
    min_dim: int | None = None,
    max_aspect: float | None = None,
) -> bool:
    """Can one Strassen level run an ``(m, k) @ (k, n)`` problem
    profitably? Every dim must halve evenly (program dims are powers of
    two, so this only excludes degenerate odd shapes), clear the
    crossover floor, and the problem must be square-ish.

    >>> strassen_eligible(4096, 2048, 4096)
    True
    >>> strassen_eligible(4096, 1024, 4096)    # K below the crossover
    False
    >>> strassen_eligible(1 << 16, 2048, 2048)  # panel, not square-ish
    False
    >>> strassen_eligible(2049, 2048, 2048)     # odd dim cannot halve
    False
    """
    if min_dim is None:
        min_dim = STRASSEN_MIN_DIM
    if max_aspect is None:
        max_aspect = STRASSEN_MAX_ASPECT
    dims = (m, k, n)
    if any(d % 2 for d in dims):
        return False
    lo, hi = min(dims), max(dims)
    if lo < min_dim:
        return False
    return hi <= max_aspect * lo


def strassen_dot_kl(a, b, dot=None, precision=None):
    """One Strassen level of ``aᵀ @ b`` with ``a: (K, M)``, ``b: (K, N)``
    torch tensors, either of which may carry a leading slice-batch axis
    (``(B, K, M)``): quadrants are cut from the last two dimensions and
    the sub-products broadcast an unbatched side over the batch.

    Quadrants are taken in the *stored* kl layout — with ``X = aᵀ`` the
    logical Strassen operand, ``X[i][j] == a[j][i]ᵀ``, so every block
    sum is a sum of contiguous ``a`` quadrants and the only transposes
    are the 7 sub-products' ``xᵀ @ y`` (a transposed view, which the
    matmul takes without a copy). ``dot(x, y)`` overrides the sub-product
    kernel (``xᵀ @ y`` over the last two dimensions, a hand kernel could
    slot in here); the default is that matmul at the rung ``precision``
    (:func:`~tnc_tpu_torch.ops.split_complex.rung_matmul`; ``None`` is
    full FP32).

    >>> import torch
    >>> g = torch.Generator().manual_seed(0)
    >>> a = torch.randn(8, 6, dtype=torch.float64, generator=g)
    >>> b = torch.randn(8, 4, dtype=torch.float64, generator=g)
    >>> torch.allclose(strassen_dot_kl(a, b), a.T @ b)
    True
    >>> a3 = torch.randn(3, 8, 6, dtype=torch.float64, generator=g)
    >>> torch.allclose(strassen_dot_kl(a3, b), a3.mT @ b)
    True
    >>> torch.allclose(strassen_dot_kl(a, b, dot=lambda x, y: torch.einsum("km,kn->mn", x, y)),
    ...                a.T @ b)
    True
    """
    import torch

    k, m = a.shape[-2:]
    n = b.shape[-1]
    if k % 2 or m % 2 or n % 2:
        raise ValueError(f"shape (K={k}, M={m}, N={n}) does not halve")
    if dot is None:
        from tnc_tpu_torch.ops.split_complex import _resolve_precision, rung_matmul

        rung = _resolve_precision(precision)

        def dot(x, y):
            return rung_matmul(x.mT, y, rung)

    k2, m2, n2 = k // 2, m // 2, n // 2
    # X = aᵀ is (M, K); X[row block i][col block j] = a[col block j][row block i]ᵀ:
    #   X11 = a[:k2, :m2]ᵀ   X12 = a[k2:, :m2]ᵀ
    #   X21 = a[:k2, m2:]ᵀ   X22 = a[k2:, m2:]ᵀ
    x11, x21 = a[..., :k2, :m2], a[..., :k2, m2:]
    x12, x22 = a[..., k2:, :m2], a[..., k2:, m2:]
    b11, b12 = b[..., :k2, :n2], b[..., :k2, n2:]
    b21, b22 = b[..., k2:, :n2], b[..., k2:, n2:]
    out = torch.empty(torch.broadcast_shapes(a.shape[:-2], b.shape[:-2]) + (m, n),
                      dtype=a.dtype, device=a.device)
    c11, c12 = out[..., :m2, :n2], out[..., :m2, n2:]
    c21, c22 = out[..., m2:, :n2], out[..., m2:, n2:]
    # each product is added into the quadrants it feeds as soon as it is
    # made and then freed, so one quadrant-sized product is alive at a time
    # beside the output; every quadrant still sums its products left to
    # right: c11 = p1 + p4 - p5 + p7, c12 = p3 + p5, c21 = p2 + p4,
    # c22 = p1 - p2 + p3 + p6
    p = dot(x11 + x22, b11 + b22)  # p1 = (X11+X22)(Y11+Y22)
    c11.copy_(p)
    c22.copy_(p)
    p = dot(x21 + x22, b11)  # p2 = (X21+X22)Y11
    c21.copy_(p)
    c22 -= p
    p = dot(x11, b12 - b22)  # p3 = X11(Y12-Y22)
    c12.copy_(p)
    c22 += p
    p = dot(x22, b21 - b11)  # p4 = X22(Y21-Y11)
    c11 += p
    c21 += p
    p = dot(x11 + x12, b22)  # p5 = (X11+X12)Y22
    c11 -= p
    c12 += p
    p = dot(x21 - x11, b11 + b12)  # p6 = (X21-X11)(Y11+Y12)
    c22 += p
    p = dot(x12 - x22, b21 + b22)  # p7 = (X12-X22)(Y21+Y22)
    c11 += p
    return out


def gauss_strassen_dot_kl(ar, ai, br, bi, precision=None):
    """``(re, im)`` of ``(ar + i·ai)ᵀ @ (br + i·bi)`` via the Gauss
    3-mult complex identity with one Strassen level per real product:
    3×7 = 21 half-size real sub-GEMMs against the naive lowering's 4
    full dots, each sub-product at the rung ``precision``. Same kl layout
    as :func:`strassen_dot_kl`.

    >>> import torch
    >>> g = torch.Generator().manual_seed(1)
    >>> ar, ai, br, bi = (torch.randn(8, s, dtype=torch.float64, generator=g)
    ...                   for s in (6, 6, 4, 4))
    >>> re, im = gauss_strassen_dot_kl(ar, ai, br, bi)
    >>> want = torch.complex(ar, ai).T @ torch.complex(br, bi)
    >>> torch.allclose(torch.complex(re, im), want)
    True
    """
    k1 = strassen_dot_kl(ar + ai, br, precision=precision)
    im = strassen_dot_kl(ar, bi - br, precision=precision)
    im += k1  # k1 + k2: the sum commutes, so the bits are the same
    k3 = strassen_dot_kl(ai, br + bi, precision=precision)
    k1 -= k3  # k1 - k3, in k1's buffer
    return k1, im
