// fused_chain: a run of small consecutive contraction steps in ONE launch.
//
// Replaces the TPU kernel tnc_tpu/ops/pallas_complex.py::fused_chain_kl
// (body _chain_compute): the head step is the split-complex product of two
// prepped contract-first operands; each following link regroups the carried
// value by a reshape and contracts it on its k axis against one more prepped
// (K_i, X_i) operand, carried-first or carried-second. Arithmetic is the
// naive four-product lowering, accumulated in the operand type.
//
// What bounds it on an H100: not the arithmetic or the bytes. Every step of
// a chain has 2*k*m*n < 2^22 and the whole chain touches at most 2^20
// elements, so a chain is a few microseconds of FP32 work at most; a small
// chain costs one launch and the latency of its dependent reads, a long
// contraction the serial walk of one thread over K. The design therefore
// shapes every stage to its work, on the host (cuda_complex._ChainPlan):
//
// * Stage shape. A stage computes C (M, N) = A^T B over K. One operand is
//   "slow": a thread owns tm (1, 2, 4 or 8) consecutive outputs along its
//   free index, read as one row from shared memory; the other is "fast":
//   consecutive threads take consecutive outputs along its free index, so
//   a warp reads it coalesced, tn (1 or 2) columns a thread. A stage with
//   few outputs (M*N <= 128) splits K over ks threads per output instead
//   (interleaved, k = s, s + ks, ...), and the ks partial sums are folded by
//   a fixed shared-memory tree; a long stage of 8 x 2 outputs a thread
//   splits it over 2. Within a thread the sums are two-level: every kFold =
//   16 contract indices go to fresh partial sums, folded into the running
//   totals, so rounding grows with K / 16 rather than with K.
// * Resident form (one ordinary launch, grid = batch rows). Where every
//   carried value of the chain fits one block's shared memory, a block runs
//   the whole chain of one batch row: the carried value stays in shared
//   memory (two ping-pong buffers) from stage to stage, __syncthreads takes
//   the place of a grid sync, and small operands of every stage (and every
//   slow operand of several outputs a thread) are fetched at the start with
//   cp.async, all in flight at once, so the chain waits on one round trip
//   to memory, not one per stage. Operands are read from global memory
//   once. A launch whose stages all have one output a thread runs a lean
//   instantiation (fewer registers, no vector paths).
// * Grid form (one cooperative launch). A chain whose carried value does not
//   fit runs on a persistent grid: each stage's work items (batch row x tile
//   of outputs x K split) are strided over the blocks, the carried value
//   ping-pongs between two scratch buffers that stay in the 50 MB L2 (read
//   with __ldcg, so no block reads a stale L1 line), and the grid
//   synchronises between stages. Where a stage's tiles x batch leave SMs
//   idle, the plan splits its K across blocks (kb): each split writes its
//   partial sums to scratch, and after a grid sync they are summed in split
//   order.
//
// What still bounds the long stage (sycamore20_m8_t17's (256, 8, 256) head,
// one block a batch row): every lane of a warp reads the same slow row, so
// the shared-memory reads of those rows, not the FMAs, set its pace
// (PERF.md).
//
// Every reduction runs in a fixed order, so the same inputs give the same
// bits on every launch: no atomics.
//
// Dot-precision rungs (the reference's `precision`; a launch argument of
// the float entry, tnc::gemm::Rung): the chain computes its rung in the
// FMA loop above, not on the tensor cores. Its stages are steps under the
// fused kernel's flop floor, many smaller than one m16n8k8 tile, and a
// chain is bound by its launch and dependent reads (0.0079 ms a launch
// against an empty launch's 0.0019-0.0020 ms), so the rung changes what
// each multiply-add rounds, not how it is issued: at `default` every
// operand value is rounded with cvt.rna.tf32.f32 before its FMAs (one TF32
// product, exact in FP32, added in FP32); at `high` it is split as hi =
// rna(x), lo = rna(x - hi), and a real product takes three FMAs,
// hi_a lo_b + lo_a hi_b + hi_a hi_b, the small terms first (3xTF32). The
// carried value is rounded again where the next stage reads it, as the
// plain version rounds each product's operands. Double ignores the rung.
//
// The host table (one int64 row per stage, built once per chain shape by the
// Python wrapper) says where every operand and result lives: a global pointer
// pair (an index into the pointer array, which is the only thing that
// changes from call to call), shared memory, or both (a global operand that
// the resident form fetches into shared memory). A chain longer than
// kMaxStages stages is run by the wrapper as consecutive launches.
//
// Slice batch (the reference runs the kernel under jax.vmap in its chunked
// executor): every stage runs `batch` independent rows in the same launch.
// Each global operand has a batch stride, 0 for an operand every row shares
// (an unbatched cached value), so nothing is copied per row; row z of a
// result in global memory is written at z * M * N.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <type_traits>

#include "complex_gemm.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kMaxStages = 16;
// operand pairs of a launch: its stages' operands, the output, and scratch
constexpr int kMaxPtrs = 2 * (kMaxStages + 5);
constexpr int kFold = 16;  // contract indices per partial sum
constexpr int kResident = 0;
constexpr int kGrid = 1;
// host table: a header, then one row per stage
//   header: form, n_stages, batch, grid, smem_bytes, red (element offset of
//           the reduction buffer in shared memory)
//   stage:  a view (slot, sk, sf, sb, re, im), b view (same), c view (slot,
//           sm, sn, sb, re, im), K, M, N, slow_b, tm, ks, kb, vec, part, tn
constexpr int kHeader = 6;
constexpr int kFields = 28;

// Where one operand (K, F) or result (M, N) lives. re >= 0: in shared
// memory at element offsets re, im — a carried value (slot < 0, strides as
// given) or a global operand the resident form fetches there first (slot
// >= 0; stored as (K, F) rows). Else a global pointer pair `slot`, row z of
// the batch at + z * sb.
struct View {
  long long sk, sf, sb;
  int slot, re, im;
};

struct StageDesc {
  View a, b, c;
  int K, M, N;
  int slow_b;  // 1: B is the slow operand (its free index N per thread)
  int tm;      // outputs per thread along the slow operand's free index
  int ks;      // threads per output splitting K (a power of two)
  int kb;      // blocks per output splitting K (grid form)
  int vec;     // slow rows are read as vectors from shared memory
  int part;    // pointer pair of the K split's partial sums (grid form)
  int tn;      // outputs per thread along the fast operand's free index
};

struct Params {
  const void* ptr[kMaxPtrs];
  StageDesc stage[kMaxStages];
  int n_stages, batch, red;
};
static_assert(sizeof(Params) <= 4000, "kernel parameters exceed 4 KB");

template <typename T>
struct Src {
  const T* re;
  const T* im;
  long long sk, sf;
};

template <typename T>
struct Dst {
  T* re;
  T* im;
  long long ss, sf;  // element strides along the slow and fast indices
};

template <typename T, bool CG>
__device__ __forceinline__ T ld(const T* p) {
  if constexpr (CG) {
    return __ldcg(p);
  } else {
    return *p;
  }
}

template <typename T>
__device__ __forceinline__ Src<T> source(const Params& p, const View& v,
                                         long long z, int F, T* sm) {
  if (v.re >= 0) {
    if (v.slot >= 0) return {sm + v.re, sm + v.im, F, 1};
    return {sm + v.re, sm + v.im, v.sk, v.sf};
  }
  return {static_cast<const T*>(p.ptr[2 * v.slot]) + z * v.sb,
          static_cast<const T*>(p.ptr[2 * v.slot + 1]) + z * v.sb, v.sk, v.sf};
}

// The result of a stage as (m, n) strides; the stage maps them to its
// (slow, fast) indices.
template <typename T>
__device__ __forceinline__ Dst<T> dest(const Params& p, const View& v,
                                       long long z, T* sm) {
  if (v.re >= 0) return {sm + v.re, sm + v.im, v.sk, v.sf};
  return {static_cast<T*>(const_cast<void*>(p.ptr[2 * v.slot])) + z * v.sb,
          static_cast<T*>(const_cast<void*>(p.ptr[2 * v.slot + 1])) + z * v.sb,
          v.sk, v.sf};
}

// tm consecutive values of one slow row from shared memory (16-byte aligned
// rows of a multiple of tm values: the plan sets vec only then), read with
// shared-memory vector loads: a generic pointer would make them generic
// loads, which the row's broadcast to every lane makes the bottleneck
template <typename T, int TM>
__device__ __forceinline__ void load_vec(const T* p, T (&x)[TM]) {
  const unsigned a = tnc::gemm::smem_addr(p);
  if constexpr (std::is_same<T, float>::value && TM == 2) {
    asm volatile("ld.shared.v2.f32 {%0, %1}, [%2];\n"
                 : "=f"(x[0]), "=f"(x[1]) : "r"(a));
  } else if constexpr (std::is_same<T, float>::value) {
#pragma unroll
    for (int r = 0; r < TM; r += 4) {
      asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];\n"
                   : "=f"(x[r]), "=f"(x[r + 1]), "=f"(x[r + 2]), "=f"(x[r + 3])
                   : "r"(a + 4 * r));
    }
  } else {
#pragma unroll
    for (int r = 0; r < TM; r += 2) {
      asm volatile("ld.shared.v2.f64 {%0, %1}, [%2];\n"
                   : "=d"(x[r]), "=d"(x[r + 1]) : "r"(a + 8 * r));
    }
  }
}

// The fast operand's kFold values at contract indices k, k + ks, ... (those
// below k_hi when GUARD; the others 0).
template <typename T, bool CG, bool GUARD>
__device__ __forceinline__ void load_fast(const T* fr, const T* fi,
                                          long long f_sk, int k, int k_hi,
                                          int ks, T (&yr)[kFold],
                                          T (&yi)[kFold]) {
#pragma unroll
  for (int j = 0; j < kFold; ++j) {
    const int kk = k + j * ks;
    const bool ok = !GUARD || kk < k_hi;
    yr[j] = ok ? ld<T, CG>(fr + kk * f_sk) : T(0);
    yi[j] = ok ? ld<T, CG>(fi + kk * f_sk) : T(0);
  }
}

// NV operand values at rung R, in place: unchanged at kFp32; rounded to
// TF32 at kTf32 (lo 0); split into hi (in place) and lo at kTf32x3.
template <int R, typename T, int NV>
__device__ __forceinline__ void rung_values(T (&hi)[NV], T (&lo)[NV]) {
  if constexpr (R != tnc::gemm::kFp32) {
#pragma unroll
    for (int v = 0; v < NV; ++v) {
      unsigned h, l;
      tnc::gemm::tf32_split<R>(hi[v], h, l);
      hi[v] = __uint_as_float(h);
      lo[v] = __uint_as_float(l);
    }
  }
}

// p += x y at rung R, from the values rung_values made (x = xh + xl, y =
// yh + yl at kTf32x3: the three products, the small terms first)
template <int R, typename T>
__device__ __forceinline__ T rung_fma(T xh, T xl, T yh, T yl, T p) {
  if constexpr (R == tnc::gemm::kTf32x3) {
    p = fma(xh, yl, p);
    p = fma(xl, yh, p);
  }
  return fma(xh, yh, p);
}

// accr/acci += one partial sum over the kFold contract indices k, k + ks, ...
// (those below k_hi when GUARD) of this thread's TM x TN outputs at rung R;
// y(j, yr, yi) gives the fast operand's TN values at the j-th of them. The
// indices are unrolled UNROLL at a time (all kFold where y reads an array
// of registers).
template <typename T, int TM, int TN, bool VEC, bool CG, bool GUARD,
          int UNROLL, int R, class Y>
__device__ __forceinline__ void fold(const Y& y, const T* sr, const T* si,
                                     long long s_sk, long long s_sf, int rows,
                                     int k, int k_hi, int ks,
                                     T (&accr)[TM][TN], T (&acci)[TM][TN]) {
  T pr[TM][TN], pi[TM][TN];
#pragma unroll
  for (int r = 0; r < TM; ++r) {
#pragma unroll
    for (int t = 0; t < TN; ++t) {
      pr[r][t] = T(0);
      pi[r][t] = T(0);
    }
  }
#pragma unroll 1
  for (int j0 = 0; j0 < kFold; j0 += UNROLL) {
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int j = j0 + u;
      const int kk = k + j * ks;
      if (!GUARD || kk < k_hi) {
        T yr[TN], yi[TN];
        y(j, yr, yi);
        T xr[TM], xi[TM];
        if constexpr (VEC) {
          load_vec<T, TM>(sr + kk * s_sk, xr);
          load_vec<T, TM>(si + kk * s_sk, xi);
        } else {
#pragma unroll
          for (int r = 0; r < TM; ++r) {
            const bool ok = r < rows;
            xr[r] = ok ? ld<T, CG>(sr + kk * s_sk + r * s_sf) : T(0);
            xi[r] = ok ? ld<T, CG>(si + kk * s_sk + r * s_sf) : T(0);
          }
        }
        if constexpr (R == tnc::gemm::kFp32) {
#pragma unroll
          for (int r = 0; r < TM; ++r) {
#pragma unroll
            for (int t = 0; t < TN; ++t) {
              pr[r][t] = fma(xr[r], yr[t], pr[r][t]);
              pr[r][t] = fma(-xi[r], yi[t], pr[r][t]);
              pi[r][t] = fma(xr[r], yi[t], pi[r][t]);
              pi[r][t] = fma(xi[r], yr[t], pi[r][t]);
            }
          }
        } else {
          T xrl[TM], xil[TM], yrl[TN], yil[TN];
          rung_values<R>(xr, xrl);
          rung_values<R>(xi, xil);
          rung_values<R>(yr, yrl);
          rung_values<R>(yi, yil);
#pragma unroll
          for (int r = 0; r < TM; ++r) {
#pragma unroll
            for (int t = 0; t < TN; ++t) {
              pr[r][t] = rung_fma<R>(xr[r], xrl[r], yr[t], yrl[t], pr[r][t]);
              pr[r][t] = rung_fma<R>(-xi[r], -xil[r], yi[t], yil[t], pr[r][t]);
              pi[r][t] = rung_fma<R>(xr[r], xrl[r], yi[t], yil[t], pi[r][t]);
              pi[r][t] = rung_fma<R>(xi[r], xil[r], yr[t], yrl[t], pi[r][t]);
            }
          }
        }
      }
    }
  }
#pragma unroll
  for (int r = 0; r < TM; ++r) {
#pragma unroll
    for (int t = 0; t < TN; ++t) {
      accr[r][t] += pr[r][t];
      acci[r][t] += pi[r][t];
    }
  }
}

// Output groups [g_lo, g_hi) of one stage over contract indices [k_lo,
// k_hi). Group g is the TM x TN outputs (si .. si + TM - 1) x (fi, fi + FG,
// ..., fi + (TN - 1) FG), with FG = ceil(F / TN) column groups, fi = g % FG,
// si = (g / FG) * TM: each of a warp's loads of the fast operand is
// coalesced. The block's threads take kThreads / ks groups a pass; the ks
// threads of a group split its K and fold their sums by a fixed tree in
// `red` (2 * TM * TN * kThreads values). Every thread of the block calls it
// with the same arguments.
template <typename T, int TM, int TN, bool VEC, bool CG, int R>
__device__ void stage_groups(const Src<T> slow, const Src<T> fast, int S, int F,
                             int g_lo, int g_hi, int k_lo, int k_hi, int ks,
                             const Dst<T> c, T* red) {
  constexpr int E = TM * TN;  // outputs a thread
  const int P = kThreads / ks;
  const int s = threadIdx.x / P;
  const int gl = threadIdx.x - s * P;
  const int step = kFold * ks;
  const int FG = (F + TN - 1) / TN;  // groups of fast columns
  for (int g0 = g_lo; g0 < g_hi; g0 += P) {
    const int g = g0 + gl;
    const bool live = g < g_hi;
    T accr[TM][TN], acci[TM][TN];
#pragma unroll
    for (int r = 0; r < TM; ++r) {
#pragma unroll
      for (int t = 0; t < TN; ++t) {
        accr[r][t] = T(0);
        acci[r][t] = T(0);
      }
    }
    int si = 0;
    int fi = 0;  // the first of the thread's columns fi, fi + FG, ...
    int rows = 0;
    if (live) {
      fi = g % FG;
      si = (g / FG) * TM;
      rows = S - si < TM ? S - si : TM;
      const T* fr = fast.re + fi * fast.sf;
      const T* fm = fast.im + fi * fast.sf;
      const long long fg_sf = FG * fast.sf;
      const T* sr = slow.re + si * slow.sf;
      const T* sm = slow.im + si * slow.sf;
      int k = k_lo + s;
      if constexpr (E == 1) {
        // a chunk's fast values loaded together into registers
        for (; k + step - ks < k_hi; k += step) {
          T yr[kFold], yi[kFold];
          load_fast<T, CG, false>(fr, fm, fast.sk, k, k_hi, ks, yr, yi);
          fold<T, TM, TN, VEC, CG, false, kFold, R>(
              [&](int j, T (&r)[TN], T (&i)[TN]) {
                r[0] = yr[j];
                i[0] = yi[j];
              },
              sr, sm, slow.sk, slow.sf, rows, k, k_hi, ks, accr, acci);
        }
        if (k < k_hi) {
          T yr[kFold], yi[kFold];
          load_fast<T, CG, true>(fr, fm, fast.sk, k, k_hi, ks, yr, yi);
          fold<T, TM, TN, VEC, CG, true, kFold, R>(
              [&](int j, T (&r)[TN], T (&i)[TN]) {
                r[0] = yr[j];
                i[0] = yi[j];
              },
              sr, sm, slow.sk, slow.sf, rows, k, k_hi, ks, accr, acci);
        }
      } else {
        // several outputs a thread: read where used, 4 indices unrolled, so
        // the registers stay bounded
        const auto y = [&](int j, T (&r)[TN], T (&i)[TN]) {
          const long long at = (k + j * ks) * fast.sk;
#pragma unroll
          for (int t = 0; t < TN; ++t) {
            const bool ok = fi + t * FG < F;
            r[t] = ok ? ld<T, CG>(fr + at + t * fg_sf) : T(0);
            i[t] = ok ? ld<T, CG>(fm + at + t * fg_sf) : T(0);
          }
        };
        for (; k + step - ks < k_hi; k += step) {
          fold<T, TM, TN, VEC, CG, false, 4, R>(y, sr, sm, slow.sk, slow.sf, rows,
                                             k, k_hi, ks, accr, acci);
        }
        if (k < k_hi) {
          fold<T, TM, TN, VEC, CG, true, 4, R>(y, sr, sm, slow.sk, slow.sf, rows,
                                            k, k_hi, ks, accr, acci);
        }
      }
    }
    if (ks > 1) {
      // the ks partial sums of each output folded by a fixed tree; red holds
      // 2 * E planes of kThreads values
#pragma unroll
      for (int e = 0; e < E; ++e) {
        red[e * kThreads + threadIdx.x] = accr[e / TN][e % TN];
        red[(E + e) * kThreads + threadIdx.x] = acci[e / TN][e % TN];
      }
      __syncthreads();
      for (int h = ks >> 1; h > 0; h >>= 1) {
        if (s < h) {
#pragma unroll
          for (int e = 0; e < 2 * E; ++e) {
            red[e * kThreads + threadIdx.x] +=
                red[e * kThreads + threadIdx.x + h * P];
          }
        }
        __syncthreads();
      }
#pragma unroll
      for (int e = 0; e < E; ++e) {
        accr[e / TN][e % TN] = red[e * kThreads + threadIdx.x];
        acci[e / TN][e % TN] = red[(E + e) * kThreads + threadIdx.x];
      }
    }
    if (live && s == 0) {
#pragma unroll
      for (int r = 0; r < TM; ++r) {
#pragma unroll
        for (int t = 0; t < TN; ++t) {
          const int col = fi + t * FG;
          if (r < rows && col < F) {
            const long long at = (si + r) * c.ss + col * c.sf;
            c.re[at] = accr[r][t];
            c.im[at] = acci[r][t];
          }
        }
      }
    }
  }
}

__host__ __device__ inline int group_count(const StageDesc& st) {
  const int S = st.slow_b ? st.N : st.M;
  const int F = st.slow_b ? st.M : st.N;
  return ((S + st.tm - 1) / st.tm) * ((F + st.tn - 1) / st.tn);
}

// One stage's groups [g_lo, g_hi) over [k_lo, k_hi), written through c (as
// (m, n) strides): orients the operands and picks the instantiation. FULL
// false: only one output a thread and no vector reads (a lean kernel for
// launches whose stages all have that shape).
template <typename T, bool CG, bool FULL, int R>
__device__ void run_stage(const StageDesc& st, const Src<T> a, const Src<T> b,
                          const Dst<T> c, int g_lo, int g_hi, int k_lo,
                          int k_hi, T* red) {
  // by value: a reference chosen at run time would keep both in local memory
  const Src<T> slow = st.slow_b ? b : a;
  const Src<T> fast = st.slow_b ? a : b;
  const int S = st.slow_b ? st.N : st.M;
  const int F = st.slow_b ? st.M : st.N;
  const Dst<T> o{c.re, c.im, st.slow_b ? c.sf : c.ss, st.slow_b ? c.ss : c.sf};
#define TNC_STAGE(TM_, TN_, VEC_)                                        \
  stage_groups<T, TM_, TN_, VEC_, CG, R>(slow, fast, S, F, g_lo, g_hi, k_lo, \
                                      k_hi, st.ks, o, red)
  if constexpr (!FULL) {
    TNC_STAGE(1, 1, false);
  } else {
    // the shapes the plan gives (chain_stage_shape): tm 1, 2, 4 or 8 with
    // tn 1, and tm 8 with tn 2; vector reads of the slow rows where set
    switch ((st.tm * 4 + st.tn) * 2 + (st.vec ? 1 : 0)) {
      case 10: TNC_STAGE(1, 1, false); break;
      case 18: TNC_STAGE(2, 1, false); break;
      case 34: TNC_STAGE(4, 1, false); break;
      case 66: TNC_STAGE(8, 1, false); break;
      case 68: TNC_STAGE(8, 2, false); break;
      default:
        if constexpr (!CG) {
          switch (st.tm * 4 + st.tn) {
            case 9: TNC_STAGE(2, 1, true); break;
            case 17: TNC_STAGE(4, 1, true); break;
            case 33: TNC_STAGE(8, 1, true); break;
            case 34: TNC_STAGE(8, 2, true); break;
            default: break;
          }
        }
        break;
    }
  }
#undef TNC_STAGE
}

// Issues the copy of one operand's row z into shared memory as (K, F) rows,
// when the plan fetches it there.
template <typename T>
__device__ __forceinline__ void prefetch(const Params& p, const View& v, int K,
                                         int F, long long z, T* sm) {
  if (v.slot < 0 || v.re < 0) return;
  const T* gr = static_cast<const T*>(p.ptr[2 * v.slot]) + z * v.sb;
  const T* gi = static_cast<const T*>(p.ptr[2 * v.slot + 1]) + z * v.sb;
  const int n = K * F;
  for (int e = threadIdx.x; e < n; e += kThreads) {
    const int k = e / F;
    const long long off = k * v.sk + (e - k * F) * v.sf;
    tnc::gemm::cp_async_elem<sizeof(T)>(sm + v.re + e, gr + off, sizeof(T));
    tnc::gemm::cp_async_elem<sizeof(T)>(sm + v.im + e, gi + off, sizeof(T));
  }
}

// The resident form: block z runs the whole chain of batch row z.
template <typename T, bool FULL, int R>
__global__ void __launch_bounds__(kThreads, 1)
    chain_resident(const __grid_constant__ Params p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sm = reinterpret_cast<T*>(smem_raw);
  const long long z = blockIdx.x;
  for (int i = 0; i < p.n_stages; ++i) {
    const StageDesc& st = p.stage[i];
    prefetch<T>(p, st.a, st.K, st.M, z, sm);
    prefetch<T>(p, st.b, st.K, st.N, z, sm);
  }
  tnc::gemm::cp_async_commit();
  tnc::gemm::cp_async_wait<0>();
  __syncthreads();
  for (int i = 0; i < p.n_stages; ++i) {
    const StageDesc& st = p.stage[i];
    run_stage<T, false, FULL, R>(st, source<T>(p, st.a, z, st.M, sm),
                        source<T>(p, st.b, z, st.N, sm), dest<T>(p, st.c, z, sm),
                        0, group_count(st), 0, st.K, sm + p.red);
    __syncthreads();
  }
}

// The grid form: a persistent cooperative grid walks the stages in order.
template <typename T, int R>
__global__ void __launch_bounds__(kThreads, 1)
    chain_grid(const __grid_constant__ Params p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* red = reinterpret_cast<T*>(smem_raw);
  cg::grid_group grid = cg::this_grid();
  for (int i = 0; i < p.n_stages; ++i) {
    const StageDesc& st = p.stage[i];
    const int groups = group_count(st);
    const int per = kThreads / st.ks;  // groups of one work item
    const int tiles = (groups + per - 1) / per;
    const long long work = static_cast<long long>(p.batch) * tiles * st.kb;
    const int kc = (st.K + st.kb - 1) / st.kb;
    const long long mn = static_cast<long long>(st.M) * st.N;
    for (long long w = blockIdx.x; w < work; w += gridDim.x) {
      const long long z = w / (tiles * st.kb);
      const int rest = static_cast<int>(w - z * tiles * st.kb);
      const int tile = rest / st.kb;
      const int kbi = rest - tile * st.kb;
      Dst<T> c;
      if (st.kb > 1) {
        const long long row = (kbi * p.batch + z) * mn;
        c = {static_cast<T*>(const_cast<void*>(p.ptr[2 * st.part])) + row,
             static_cast<T*>(const_cast<void*>(p.ptr[2 * st.part + 1])) + row,
             st.N, 1};
      } else {
        c = dest<T>(p, st.c, z, nullptr);
      }
      const int g_lo = tile * per;
      const int k_lo = kbi * kc;
      run_stage<T, true, true, R>(st, source<T>(p, st.a, z, st.M, nullptr),
                         source<T>(p, st.b, z, st.N, nullptr), c, g_lo,
                         g_lo + per < groups ? g_lo + per : groups, k_lo,
                         k_lo + kc < st.K ? k_lo + kc : st.K, red);
    }
    if (st.kb > 1) {
      // the K split's partial sums, added in split order
      __threadfence();
      grid.sync();
      const T* pr = static_cast<const T*>(p.ptr[2 * st.part]);
      const T* pi = static_cast<const T*>(p.ptr[2 * st.part + 1]);
      const long long n = static_cast<long long>(p.batch) * mn;
      for (long long e = static_cast<long long>(blockIdx.x) * kThreads +
                         threadIdx.x;
           e < n; e += static_cast<long long>(gridDim.x) * kThreads) {
        const long long z = e / mn;
        const long long o = e - z * mn;
        T sr = T(0);
        T si = T(0);
        for (int j = 0; j < st.kb; ++j) {
          const long long at = (j * static_cast<long long>(p.batch) + z) * mn + o;
          sr += __ldcg(pr + at);
          si += __ldcg(pi + at);
        }
        const Dst<T> c = dest<T>(p, st.c, z, nullptr);
        const long long m = o / st.N;
        const long long at = m * c.ss + (o - m * st.N) * c.sf;
        c.re[at] = sr;
        c.im[at] = si;
      }
    }
    if (i + 1 < p.n_stages) {
      __threadfence();
      grid.sync();
    }
  }
}

__global__ void chain_empty() {}

template <typename T, int R>
int grid_blocks(int device, size_t smem) {
  static int cached[64] = {0};
  if (device >= 0 && device < 64 && cached[device] > 0) return cached[device];
  int per_sm = 0;
  cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, chain_grid<T, R>, kThreads, smem);
  if (e != cudaSuccess) return -static_cast<int>(e);
  int sms = 0;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (e != cudaSuccess) return -static_cast<int>(e);
  const int blocks = per_sm * sms;
  if (device >= 0 && device < 64) cached[device] = blocks;
  return blocks;
}

// Lets the resident kernel use all the shared memory a block of this device
// may opt in to (once per device and instantiation).
template <typename T, bool FULL, int R>
int allow_smem() {
  static bool ready[64] = {false};
  int device = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (device >= 0 && device < 64 && ready[device]) return 0;
  int optin = 0;
  e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             device);
  if (e != cudaSuccess) return static_cast<int>(e);
  e = cudaFuncSetAttribute(chain_resident<T, FULL, R>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (device >= 0 && device < 64) ready[device] = true;
  return 0;
}

void read_view(const long long* f, View* v) {
  v->slot = static_cast<int>(f[0]);
  v->sk = f[1];
  v->sf = f[2];
  v->sb = f[3];
  v->re = static_cast<int>(f[4]);
  v->im = static_cast<int>(f[5]);
}

template <typename T, int R>
int launch(const void* const* ptrs, int n_ptrs, const long long* table,
           void* stream) {
  const int form = static_cast<int>(table[0]);
  const int n = static_cast<int>(table[1]);
  const long long batch = table[2];
  const long long grid = table[3];
  const long long smem = table[4];
  if (n < 1 || n > kMaxStages || n_ptrs < 0 || n_ptrs > kMaxPtrs ||
      batch < 1 || batch > 0x7fffffffLL || grid < 1 || smem < 0 ||
      (form != kResident && form != kGrid))
    return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  for (int j = 0; j < kMaxPtrs; ++j) p.ptr[j] = j < n_ptrs ? ptrs[j] : nullptr;
  p.n_stages = n;
  p.batch = static_cast<int>(batch);
  p.red = static_cast<int>(table[5]);
  for (int i = 0; i < n; ++i) {
    const long long* f = table + kHeader + i * kFields;
    StageDesc& st = p.stage[i];
    read_view(f, &st.a);
    read_view(f + 6, &st.b);
    read_view(f + 12, &st.c);
    st.K = static_cast<int>(f[18]);
    st.M = static_cast<int>(f[19]);
    st.N = static_cast<int>(f[20]);
    st.slow_b = static_cast<int>(f[21]);
    st.tm = static_cast<int>(f[22]);
    st.ks = static_cast<int>(f[23]);
    st.kb = static_cast<int>(f[24]);
    st.vec = static_cast<int>(f[25]);
    st.part = static_cast<int>(f[26]);
    st.tn = static_cast<int>(f[27]);
    const bool tm_ok = (st.tn == 1 && (st.tm == 1 || st.tm == 2 ||
                                       st.tm == 4 || st.tm == 8)) ||
                       (st.tn == 2 && st.tm == 8);
    const bool ks_ok = st.ks >= 1 && st.ks <= kThreads &&
                       (st.ks & (st.ks - 1)) == 0 &&
                       (st.ks == 1 || st.tm * st.tn == 1 || st.ks == 2);
    const bool kb_ok = st.kb >= 1 && (st.kb == 1 || (form == kGrid && st.part >= 0));
    const bool shared_ok =
        form == kResident ||
        (!st.vec && st.a.re < 0 && st.b.re < 0 && st.c.re < 0);
    if (!tm_ok || !ks_ok || !kb_ok || !shared_ok || st.K < 1 || st.M < 1 ||
        st.N < 1)
      return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (form == kResident) {
    bool full = false;
    for (int i = 0; i < n; ++i) {
      const StageDesc& st = p.stage[i];
      full = full || st.tm > 1 || st.tn > 1 || st.vec;
    }
    const int rc = full ? allow_smem<T, true, R>() : allow_smem<T, false, R>();
    if (rc != 0) return rc;
    const dim3 g(static_cast<unsigned int>(batch));
    if (full) {
      chain_resident<T, true, R><<<g, kThreads, static_cast<size_t>(smem), s>>>(p);
    } else {
      chain_resident<T, false, R><<<g, kThreads, static_cast<size_t>(smem), s>>>(p);
    }
  } else {
    int device = 0;
    e = cudaGetDevice(&device);
    if (e != cudaSuccess) return static_cast<int>(e);
    const int resident = grid_blocks<T, R>(device, static_cast<size_t>(smem));
    if (resident < 0) return -resident;
    if (resident == 0) return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
    const long long g = grid < resident ? grid : resident;
    void* args[] = {&p};
    e = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(chain_grid<T, R>),
                                    dim3(static_cast<unsigned int>(g)),
                                    dim3(kThreads), args,
                                    static_cast<size_t>(smem), s);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int tnc_chain_max_stages() { return kMaxStages; }

int tnc_chain_table_fields() { return kFields; }

int tnc_chain_header_fields() { return kHeader; }

int tnc_chain_max_ptrs() { return kMaxPtrs; }

// ptrs: n_ptrs device pointers (operand, output and scratch parts, each pair
// re then im); table: the header and one row per stage; rung: 0 = float32,
// 1 = high (3xTF32), 2 = default (TF32) (tnc::gemm::Rung)
int tnc_fused_chain_f32(const void* const* ptrs, int n_ptrs,
                        const long long* table, int rung, void* stream) {
  if (rung == tnc::gemm::kFp32)
    return launch<float, tnc::gemm::kFp32>(ptrs, n_ptrs, table, stream);
  if (rung == tnc::gemm::kTf32x3)
    return launch<float, tnc::gemm::kTf32x3>(ptrs, n_ptrs, table, stream);
  if (rung == tnc::gemm::kTf32)
    return launch<float, tnc::gemm::kTf32>(ptrs, n_ptrs, table, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

// double ignores the rung: it takes none
int tnc_fused_chain_f64(const void* const* ptrs, int n_ptrs,
                        const long long* table, void* stream) {
  return launch<double, tnc::gemm::kFp32>(ptrs, n_ptrs, table, stream);
}

// One launch of an empty kernel of kThreads threads on `grid` blocks,
// ordinary or cooperative: the floor a launch of either form stands on.
int tnc_chain_empty_launch(int cooperative, int grid, void* stream) {
  if (grid < 1) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (cooperative) {
    const cudaError_t e = cudaLaunchCooperativeKernel(
        reinterpret_cast<const void*>(chain_empty), dim3(grid), dim3(kThreads),
        nullptr, 0, s);
    if (e != cudaSuccess) return static_cast<int>(e);
  } else {
    chain_empty<<<grid, kThreads, 0, s>>>();
  }
  return static_cast<int>(cudaGetLastError());
}

const char* tnc_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
