// One output tile of a split-complex product, shared by both hand kernels
// (fused_complex_dot.cu and fused_chain.cu).
//
//   C = A^T B,  A: (K, M), B: (K, N), C: (M, N), every matrix a (re, im) pair
//   re = ar^T br - ai^T bi,   im = ar^T bi + ai^T br
//
// An operand is read through two element strides, element (k, f) at
// base[k * sk + f * sf], so a contract-first matrix (sk = F, sf = 1) and a
// transposed view (sk = 1, sf = K) go through the same code. C is written
// row-major (M, N).
//
// Design. A block of kThreads = 256 threads owns one kBM x kBN = 64 x 64
// output tile and walks K in steps of kBK = 16. Each step stages the four
// (kBK x 64) operand tiles (ar, ai, br, bi) in shared memory once; each
// thread then keeps a 4 x 4 micro-tile of BOTH outputs in registers and
// feeds them four FMAs per (k, m, n): each staged value is used by all
// four real products, the arithmetic the TPU kernel got from loading each
// operand tile once into VMEM. Accumulation is in T (FP32 FMA for float,
// FP64 for double): no tensor cores, no TF32. It is two-level: the products
// of one K step go to fresh partial sums, folded into the running totals
// once per step, so rounding grows with K / kBK rather than with K (one
// running sum missed the 1e-5 gate against cuBLAS at K = 16384;
// chip_smoke.py prints the kernel's and cuBLAS's error against a float64
// product there). Rows and columns of a thread are strided by 16, so
// shared-memory reads are bank-conflict free and global stores of a warp
// are contiguous. Ragged edges are
// bounds-checked: out-of-range operand elements load as 0 and
// out-of-range outputs are not stored. Global loads use __ldcg (cached in
// L2 only), so a block never reads an operand through a stale L1 line
// after another block rewrote it (the chain kernel's scratch buffers).
#pragma once

#include <cuda_runtime.h>

namespace tnc {

constexpr int kBM = 64;
constexpr int kBN = 64;
constexpr int kBK = 16;
constexpr int kThreads = 256;
constexpr int kTM = kBM / 16;  // output rows per thread
constexpr int kTN = kBN / 16;  // output columns per thread

template <typename T>
struct Operand {
  const T* re;
  const T* im;
  long long sk;  // element stride along the contract index
  long long sf;  // element stride along the free index
};

template <typename T>
struct TileSmem {
  T ar[kBK][kBM];
  T ai[kBK][kBM];
  T br[kBK][kBN];
  T bi[kBK][kBN];
};

__host__ __device__ inline long long tile_count(long long M, long long N) {
  return ((M + kBM - 1) / kBM) * ((N + kBN - 1) / kBN);
}

// Computes output tile `tile` (row-major over the tile grid) of C = A^T B.
// Every thread of the block must call it with the same arguments.
template <typename T>
__device__ void complex_tile(const Operand<T>& a, const Operand<T>& b,
                             long long K, long long M, long long N,
                             long long tile, T* cr, T* ci, TileSmem<T>& s) {
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const long long tiles_n = (N + kBN - 1) / kBN;
  const long long m0 = (tile / tiles_n) * kBM;
  const long long n0 = (tile % tiles_n) * kBN;

  T accr[kTM][kTN];
  T acci[kTM][kTN];
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
#pragma unroll
    for (int j = 0; j < kTN; ++j) {
      accr[i][j] = T(0);
      acci[i][j] = T(0);
    }
  }

  for (long long k0 = 0; k0 < K; k0 += kBK) {
    T pr[kTM][kTN];  // this K step's partial sums
    T pi[kTM][kTN];
#pragma unroll
    for (int i = 0; i < kTM; ++i) {
#pragma unroll
      for (int j = 0; j < kTN; ++j) {
        pr[i][j] = T(0);
        pi[i][j] = T(0);
      }
    }
    for (int idx = tid; idx < kBK * kBM; idx += kThreads) {
      const int kk = idx / kBM;
      const int mm = idx % kBM;
      const long long k = k0 + kk;
      const long long m = m0 + mm;
      const bool ok = k < K && m < M;
      const long long off = k * a.sk + m * a.sf;
      s.ar[kk][mm] = ok ? __ldcg(a.re + off) : T(0);
      s.ai[kk][mm] = ok ? __ldcg(a.im + off) : T(0);
    }
    for (int idx = tid; idx < kBK * kBN; idx += kThreads) {
      const int kk = idx / kBN;
      const int nn = idx % kBN;
      const long long k = k0 + kk;
      const long long n = n0 + nn;
      const bool ok = k < K && n < N;
      const long long off = k * b.sk + n * b.sf;
      s.br[kk][nn] = ok ? __ldcg(b.re + off) : T(0);
      s.bi[kk][nn] = ok ? __ldcg(b.im + off) : T(0);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      T xr[kTM], xi[kTM], yr[kTN], yi[kTN];
#pragma unroll
      for (int i = 0; i < kTM; ++i) {
        xr[i] = s.ar[kk][ty + 16 * i];
        xi[i] = s.ai[kk][ty + 16 * i];
      }
#pragma unroll
      for (int j = 0; j < kTN; ++j) {
        yr[j] = s.br[kk][tx + 16 * j];
        yi[j] = s.bi[kk][tx + 16 * j];
      }
#pragma unroll
      for (int i = 0; i < kTM; ++i) {
#pragma unroll
        for (int j = 0; j < kTN; ++j) {
          pr[i][j] = fma(xr[i], yr[j], pr[i][j]);
          pr[i][j] = fma(-xi[i], yi[j], pr[i][j]);
          pi[i][j] = fma(xr[i], yi[j], pi[i][j]);
          pi[i][j] = fma(xi[i], yr[j], pi[i][j]);
        }
      }
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kTM; ++i) {
#pragma unroll
      for (int j = 0; j < kTN; ++j) {
        accr[i][j] += pr[i][j];
        acci[i][j] += pi[i][j];
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const long long m = m0 + ty + 16 * i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < kTN; ++j) {
      const long long n = n0 + tx + 16 * j;
      if (n < N) {
        cr[m * N + n] = accr[i][j];
        ci[m * N + n] = acci[i][j];
      }
    }
  }
}

}  // namespace tnc
