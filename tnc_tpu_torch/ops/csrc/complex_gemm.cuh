// The pipelined split-complex tile engine of fused_complex_dot.cu and
// fused_transpose_dot.cu.
//
//   C = A^T B,  A: (K, M), B: (K, N), C: (M, N), every matrix a (re, im) pair
//   re = ar^T br - ai^T bi,   im = ar^T bi + ai^T br
//
// A block of kThreads = 256 threads computes one BM x BN output tile. The
// two operands come from producers (a "source"): Strided reads element
// (k, f) at k * sk + f * sf, Gathered at off_k[k] + off_f[f] (offset
// tables). A source fills one shared-memory tile of its real and imaginary
// parts per stage in one of four modes, chosen by the host:
//
//   kVec    16-byte cp.async.cg along the free index (stride 1, rows and
//           base 16-byte aligned) into a [k][f] tile; ragged chunks copy
//           fewer bytes and the rest is zero-filled;
//   kWalkK  one cp.async per element into a [k][f] tile, lanes walking the
//           contract index (8 lanes per 32-byte sector) when it is the
//           stride-1 one;
//   kWalkF  one cp.async per element into a [k][f] tile, lanes walking the
//           free index;
//   kVecK   16-byte cp.async.cg along the contract index (stride 1, its
//           stored digit a multiple of the vector, every other stride and
//           the base 16-byte aligned) into a K-fastest [f][k] tile, whose
//           16-byte chunks are XOR-swizzled by row group so that both the
//           copies and the transposing reads below are free of bank
//           conflicts. Only the staged pipeline takes it.
//
// Out-of-range elements copy 0 bytes and read as zero, and out-of-range
// outputs are not stored, so any K, M and N is taken.
//
// Two pipelines over the same arithmetic:
//
//   direct  kStages ring slots that the copies fill in the layout the
//           arithmetic reads ([k][f]); both sides' Gauss sums are formed
//           once per stage beside the ring. fused_complex_dot, and
//           fused_transpose_dot when no operand is kVecK.
//   staged  two raw slots that the copies fill, and two compute slots that
//           a per-stage pass fills from them: a kVecK tile is transposed
//           through registers (a V x V block per thread: V 128-bit loads of
//           V contract indices, V 128-bit stores of V free indices), any
//           other tile copied, and the B side's sums formed in the same
//           pass. A 16-byte copy of V consecutive contract indices would
//           otherwise land across V rows of a [k][f] tile, and a K-fastest
//           tile read directly would need V contract indices of every
//           fragment live at once (96 more registers at 8 x 4). The pass
//           costs two 128-bit shared accesses per 4 elements and stage,
//           against kWalkK's one cp.async per element.
//
// Design, against what bounds the product on an H100 (FP32 operations on
// the CUDA cores, far above the ~20 operations-per-byte ridge):
//
// - Pipelined K loop: a ring of kStages stage buffers in dynamic shared
//   memory, filled by cp.async with one commit group per stage and one
//   barrier per stage. The sums of stage t + 1 are formed at the end of
//   stage t, so stage t + 1 must have landed by then; the copies of stage
//   t + 2 are in flight while stage t is computed.
// - Three real products per complex multiply-add (Gauss):
//     k1 = br (ar + ai),  k2 = ar (bi - br),  k3 = ai (br + bi)
//     re = k1 - k3,       im = k1 + k2
//   An FMA and an add take the same dispatch slot, so the sums are not
//   formed per contract index in registers. The direct pipeline forms all three
//   once per stage in shared memory (br + bi and ar + ai in buffers beside
//   the ring, bi - br over bi in the ring slot): 3 * TM * TN FMAs against
//   9 shared loads per contract index (8 x 4 micro-tile: 96 FMAs in 105
//   instructions). The staged pipeline has no room for the A side's sums
//   and forms ar + ai from the loaded fragments (TM adds per k).
// - Vector fragments: a thread owns TM rows and TN columns of the tile,
//   in runs of V = 16 / sizeof(T) consecutive elements (rows
//   r * BM / RV + V * tm + i), read with 128-bit shared loads. A warp is
//   4 x 8 threads, so each fragment load touches at most 128 distinct
//   bytes of one row. Rows of every shared tile are padded by one vector,
//   which keeps them 16-byte aligned and spreads the element-wise copies of
//   kWalkK over all 32 banks.
// - Two-level accumulation: the products of kFold stages go to fresh
//   partial sums, folded into the running (re, im), so rounding grows with
//   K / (kFold * BK) rather than with K (one running FP32 sum missed the
//   1e-5 gate against cuBLAS at K = 16384; chip_smoke.py prints the
//   kernel's and cuBLAS's error against a float64 product there).
//
// The dot-precision rungs (the reference's lax.Precision levels; a float
// launch's template argument R, cuda_complex.RUNG_CODES):
//
//   kFp32    FP32 (or FP64) FMA on the CUDA cores, the pipelines above;
//   kTf32x3  `high`: each operand x split as hi = rna(x), lo = rna(x - hi)
//            (rna: cvt.rna.tf32.f32, round to nearest with ties away, 10
//            mantissa bits), a.b ~ hi_a lo_b + lo_a hi_b + hi_a hi_b, the
//            small terms first, on the tensor cores;
//   kTf32    `default`: one TF32 product of rna(a) and rna(b).
//
// The TF32 rungs run tf32_tile.cuh's wgmma tile on launches of 2^30
// multiply-adds or more; a smaller launch runs complex_gemm_tile_tc below,
// whose light per-stage cost and many non-persistent blocks beat the
// wgmma tile's ring there (cuda_complex.tf32_config routes by size;
// chip_smoke.py phase 21 times both forms). It is the engine's direct and
// staged pipelines with naive four-product arithmetic (each part rounded
// on its own, as the plain version rounds) through mma.sync.m16n8k8 TF32,
// on the float variants padded for conflict-free fragment loads (the *Tc
// variants: a warp's fragment loads read element (k, f) at k * P + f for
// 4 contract indices x 8 free indices, on 32 distinct banks only when P =
// 8 mod 32); a tile of fewer than 16 rows (FlatTc, 8 x 512) is computed
// transposed, C^T = B^T A. Accumulation is three-level: each k8 step's tensor-core products start
// from zero, are added to partial sums with FP32 adds, and the partials of
// kFold stages folded into the running totals.
#pragma once

#include <cuda_runtime.h>

#include <type_traits>

namespace tnc {
namespace gemm {

constexpr int kThreads = 256;  // 8 warps
constexpr int kGroupM = 8;     // tile rows per raster group (L2 reuse)

// how a source fills a stage (the host picks it; see the header comment)
enum Mode : int { kVec = 0, kWalkK = 1, kWalkF = 2, kVecK = 3 };

// One tile variant: a GM x (256 / GM) grid of threads each owning TM x TN
// outputs, BK contract indices per stage, kStages stages in the ring,
// kFold stages per partial sum, kUnroll contract indices per unrolled step.
// GM = 16 arranges a warp as 4 x 8 threads (fragment loads of at most 128
// distinct bytes); GM = 2 as 1 x 32, a flat tile for products with a few
// rows.
// PadM_ / PadN_: the row padding of the A and B tiles, one vector unless
// given (the tensor-core variants pad so that fragment loads are free of
// bank conflicts).
template <typename T_, int GM_, int TM_, int TN_, int BK_, int kStages_,
          int kFold_, int kUnroll_, int PadM_ = 16 / static_cast<int>(sizeof(T_)),
          int PadN_ = 16 / static_cast<int>(sizeof(T_))>
struct Variant {
  using T = T_;
  static constexpr int V = 16 / static_cast<int>(sizeof(T));  // elements per 16 B
  static constexpr int GM = GM_;
  static constexpr int GN = kThreads / GM;
  static constexpr int LM = GM >= 16 ? 4 : 1;  // a warp's thread rows
  static constexpr int LN = 32 / LM;
  static constexpr int WM = GM / LM;  // the block's warp rows
  static constexpr int WN = 8 / WM;
  static constexpr int TM = TM_;
  static constexpr int TN = TN_;
  static constexpr int BM = GM * TM;
  static constexpr int BN = GN * TN;
  static constexpr int BK = BK_;
  static constexpr int kStages = kStages_;
  static constexpr int kFold = kFold_;      // stages summed before each fold
  static constexpr int kUnroll = kUnroll_;  // contract indices per unrolled step
  static constexpr int RV = TM / V;  // row vectors per thread
  static constexpr int CV = TN / V;  // column vectors per thread
  static constexpr int PM = BM + PadM_;  // padded row lengths
  static constexpr int PN = BN + PadN_;
  static constexpr int kSlotElems = 2 * BK * PM + 2 * BK * PN;  // ar ai br bi
  // the direct pipeline's Gauss sums of two stages: br + bi, ar + ai
  static constexpr int kSumElems = 2 * BK * PN + 2 * BK * PM;
  static constexpr size_t kTileBytes =
      sizeof(T) * (static_cast<size_t>(kStages) * kSlotElems + kSumElems);
  // the staged pipeline: two raw slots (kSlotElems each: a [k][f] tile or
  // the smaller swizzled [f][k] one) and two compute slots (ar ai; br,
  // bi - br, br + bi)
  static constexpr int kComputeElems = 2 * BK * PM + 3 * BK * PN;
  static constexpr size_t kStagedBytes =
      sizeof(T) * 2 * static_cast<size_t>(kSlotElems + kComputeElems);
  // the tensor-core rungs form no Gauss sums: the direct ring alone, and in
  // the staged pipeline compute slots of the four parts (ar ai; br bi)
  static constexpr size_t kTcTileBytes =
      sizeof(T) * static_cast<size_t>(kStages) * kSlotElems;
  static constexpr size_t kTcStagedBytes =
      sizeof(T) * 4 * static_cast<size_t>(kSlotElems);
  static_assert(TM % V == 0 && TN % V == 0, "micro-tile in whole vectors");
  static_assert(PadM_ % V == 0 && PadN_ % V == 0, "16-byte aligned rows");
  static_assert(LM * WM == GM && LN * WN == GN, "warp layout");
  static_assert(kStages >= 3, "the ring overlaps two stages with one");
  static_assert(BK % kUnroll == 0, "whole unrolled steps");
  static_assert(BK % 8 == 0, "element-wise copies walk 8 contract indices");
  static_assert(BK % V == 0 && ((BK / V) & (BK / V - 1)) == 0,
                "kVecK rows: a power-of-two number of contract vectors (the "
                "swizzle XORs vector indices)");
};

// ---- cp.async --------------------------------------------------------------

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// The copies carry no memory clobber: every read of a copied tile comes
// after cp_async_wait and a __syncthreads, which order it, so the compiler
// may keep the tables and offsets the copy loops read in registers.

// 16 bytes, of which `bytes` are read from src and the rest zero-filled
__device__ __forceinline__ void cp_async_16(void* dst, const void* src,
                                            int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(bytes));
}

// one element of B bytes (4 or 8): read when `bytes` == B, zero when 0
template <int B>
__device__ __forceinline__ void cp_async_elem(void* dst, const void* src,
                                              int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "n"(B), "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// ---- sources ---------------------------------------------------------------

// A (K, F) matrix through two element strides. f0: the tile's first free
// index (set per tile).
template <typename T>
struct Strided {
  using Offset = long long;
  const T* re;
  const T* im;
  long long sk, sf;
  long long K, F;
  int mode;
  long long f0;

  __device__ __forceinline__ long long row(long long k) const { return k * sk; }
  __device__ __forceinline__ long long col(int ff) const {
    return (f0 + ff) * sf;
  }
  // elements of the run of n starting at tile column ff that lie inside F
  __device__ __forceinline__ int valid(int ff, int n) const {
    const long long left = F - (f0 + ff);
    return left <= 0 ? 0 : (left < n ? static_cast<int>(left) : n);
  }
};

// A stored operand read through its contract and free offset tables
// (element (k, f) at off_k[k] + off_f[f]). The tile's free offsets are
// copied to shared memory (`tile_off`, -1 past the end) at the start of
// every tile; a stage reads the contract offsets of its own rows.
template <typename T, typename Off>
struct Gathered {
  using Offset = Off;  // int32 tables keep the address arithmetic 32-bit
  const T* re;
  const T* im;
  const Off* off_k;
  const Off* off_f;
  long long K, F;
  int mode;
  const Off* tile_off;  // shared memory

  __device__ __forceinline__ Off row(long long k) const {
    return __ldg(off_k + k);
  }
  __device__ __forceinline__ Off col(int ff) const { return tile_off[ff]; }
  // a free-index vector never straddles the end (F is a multiple of V
  // whenever kVec is chosen), so a run is all in or all out
  __device__ __forceinline__ int valid(int ff, int n) const {
    return tile_off[ff] >= 0 ? n : 0;
  }
};

// Where contract vector c of free index ff starts in a kVecK tile: rows of
// BK elements, vector c of row ff stored at c ^ (ff / V % CPR), so the V
// rows of one transposed block and the 8 lanes of a copy each spread over
// distinct banks.
template <int V, int BK>
__device__ __forceinline__ int vec_k_at(int ff, int c) {
  constexpr int CPR = BK / V;
  return ff * BK + V * (c ^ ((ff / V) % CPR));
}

// Copy one stage (contract indices k0 .. k0 + BK) of a source's real and
// imaginary parts into the tiles sr, si: (BK x P) with FT used columns, or
// for kVecK (FT x BK) swizzled.
template <typename T, int FT, int P, int BK, class Src>
__device__ __forceinline__ void stage_source(const Src& src, T* sr, T* si,
                                             long long k0) {
  constexpr int V = 16 / static_cast<int>(sizeof(T));
  constexpr int E = static_cast<int>(sizeof(T));
  using Offset = typename Src::Offset;
  const int tid = threadIdx.x;
  if (src.mode == kVec) {
    constexpr int CH = FT / V;           // vectors per row
    constexpr int ROWS = kThreads / CH;  // rows per pass
    static_assert(kThreads % CH == 0 && (BK % ROWS == 0 || ROWS > BK),
                  "vector tiling");
    const int c = tid % CH;
    const int n = src.valid(c * V, V);
    const Offset cofs = src.col(c * V);
#pragma unroll
    for (int i = 0; i < (BK + ROWS - 1) / ROWS; ++i) {
      const int r = tid / CH + i * ROWS;
      if (ROWS > BK && r >= BK) break;
      const long long k = k0 + r;
      const int bytes = k < src.K ? n * E : 0;
      const Offset off = bytes ? src.row(k) + cofs : Offset(0);
      cp_async_16(sr + r * P + c * V, src.re + off, bytes);
      cp_async_16(si + r * P + c * V, src.im + off, bytes);
    }
  } else if (src.mode == kWalkK) {
    constexpr int KL = 8;          // lanes along the contract index
    constexpr int FL = 256 / KL;   // free indices per pass of the block
    static_assert(FT % FL == 0 || FT < FL, "element-wise tiling");
    const int kl = tid % KL;
    const int fl = tid / KL;
#pragma unroll
    for (int h = 0; h < BK / KL; ++h) {
      const int r = KL * h + kl;
      const long long k = k0 + r;
      const bool kin = k < src.K;
      const Offset rofs = kin ? src.row(k) : Offset(0);
#pragma unroll
      for (int j = 0; j < (FT + FL - 1) / FL; ++j) {
        const int ff = fl + FL * j;
        if (FT < FL && ff >= FT) break;
        const int bytes = kin && src.valid(ff, 1) ? E : 0;
        const Offset off = bytes ? rofs + src.col(ff) : Offset(0);
        cp_async_elem<E>(sr + r * P + ff, src.re + off, bytes);
        cp_async_elem<E>(si + r * P + ff, src.im + off, bytes);
      }
    }
  } else if (src.mode == kVecK) {
    constexpr int CPR = BK / V;   // contract vectors per row
    constexpr int NC = FT * CPR;  // vectors per tile
#pragma unroll
    for (int i = 0; i < (NC + kThreads - 1) / kThreads; ++i) {
      const int q = tid + i * kThreads;
      if (NC % kThreads != 0 && q >= NC) break;
      const int c = q % CPR;  // 8 lanes read one 128-byte row segment
      const int ff = q / CPR;
      const long long k = k0 + c * V;
      const int bytes = k < src.K && src.valid(ff, 1) ? 16 : 0;
      const Offset off = bytes ? src.row(k) + src.col(ff) : Offset(0);
      const int at = vec_k_at<V, BK>(ff, c);
      cp_async_16(sr + at, src.re + off, bytes);
      cp_async_16(si + at, src.im + off, bytes);
    }
  } else {
    const int lane = tid % 32;
    const int warp = tid / 32;  // 8 warps, one contract index each per pass
#pragma unroll
    for (int h = 0; h < BK / 8; ++h) {
      const int r = 8 * h + warp;
      const long long k = k0 + r;
      const bool kin = k < src.K;
      const Offset rofs = kin ? src.row(k) : Offset(0);
#pragma unroll
      for (int j = 0; j < (FT + 31) / 32; ++j) {
        const int ff = lane + 32 * j;
        if (FT < 32 && ff >= FT) break;
        const int bytes = kin && src.valid(ff, 1) ? E : 0;
        const Offset off = bytes ? rofs + src.col(ff) : Offset(0);
        cp_async_elem<E>(sr + r * P + ff, src.re + off, bytes);
        cp_async_elem<E>(si + r * P + ff, src.im + off, bytes);
      }
    }
  }
}

// ---- arithmetic ------------------------------------------------------------

template <typename T>
struct Vec;
template <>
struct Vec<float> {
  using type = float4;
};
template <>
struct Vec<double> {
  using type = double2;
};

// x[0 .. V) = p[0 .. V) through one 128-bit shared load
template <typename T>
__device__ __forceinline__ void load_vec(const T* p, T* x) {
  using VT = typename Vec<T>::type;
  const VT v = *reinterpret_cast<const VT*>(p);
  const T* e = reinterpret_cast<const T*>(&v);
#pragma unroll
  for (int i = 0; i < static_cast<int>(sizeof(VT) / sizeof(T)); ++i) x[i] = e[i];
}

// The Gauss sums of one stage, this thread's share of its vectors:
// s = x + y and y = y - x in place, this thread's share of a stage tile's
// vectors (the B side's Gauss sums: br + bi, and bi - br over bi)
template <typename T, int FT, int P, int BK>
__device__ __forceinline__ void sum_tile(const T* x, T* y, T* s) {
  using VT = typename Vec<T>::type;
  constexpr int V = 16 / static_cast<int>(sizeof(T));
  constexpr int CH = FT / V;
  constexpr int NV = BK * CH;
  static_assert(NV % kThreads == 0 || NV < kThreads, "sum tiling");
#pragma unroll
  for (int i = 0; i < (NV + kThreads - 1) / kThreads; ++i) {
    const int q = threadIdx.x + i * kThreads;
    if (NV < kThreads && q >= NV) break;
    const int at = (q / CH) * P + (q % CH) * V;
    const VT xv = *reinterpret_cast<const VT*>(x + at);
    const VT yv = *reinterpret_cast<const VT*>(y + at);
    const T* xe = reinterpret_cast<const T*>(&xv);
    const T* ye = reinterpret_cast<const T*>(&yv);
    VT sv, dv;
    T* se = reinterpret_cast<T*>(&sv);
    T* de = reinterpret_cast<T*>(&dv);
#pragma unroll
    for (int e = 0; e < V; ++e) {
      se[e] = xe[e] + ye[e];
      de[e] = ye[e] - xe[e];
    }
    *reinterpret_cast<VT*>(s + at) = sv;
    *reinterpret_cast<VT*>(y + at) = dv;
  }
}

// s = x + y over this thread's share of a stage tile's vectors
template <typename T, int FT, int P, int BK>
__device__ __forceinline__ void add_tile(const T* x, const T* y, T* s) {
  constexpr int V = 16 / static_cast<int>(sizeof(T));
  constexpr int CH = FT / V;
  constexpr int NV = BK * CH;
#pragma unroll
  for (int i = 0; i < (NV + kThreads - 1) / kThreads; ++i) {
    const int q = threadIdx.x + i * kThreads;
    if (NV % kThreads != 0 && q >= NV) break;
    const int at = (q / CH) * P + (q % CH) * V;
    T xe[V], ye[V];
    load_vec(x + at, xe);
    load_vec(y + at, ye);
    typename Vec<T>::type sv;
    T* se = reinterpret_cast<T*>(&sv);
#pragma unroll
    for (int e = 0; e < V; ++e) se[e] = xe[e] + ye[e];
    *reinterpret_cast<typename Vec<T>::type*>(s + at) = sv;
  }
}

// k1 += xs yr, k2 += xr yd, k3 += xi ys over this thread's TM x TN
// micro-tile at contract index kk of the staged tiles (x: ar, ai and
// xs = ar + ai, read from `as` with kSumA, else formed here; y: br,
// bi - br, br + bi)
template <class Cfg, bool kSumA = false>
__device__ __forceinline__ void mac_k(
    const typename Cfg::T* ar, const typename Cfg::T* ai,
    const typename Cfg::T* as, const typename Cfg::T* br,
    const typename Cfg::T* bd, const typename Cfg::T* bs, int kk, int tm,
    int tn, typename Cfg::T (&k1)[Cfg::TM][Cfg::TN],
    typename Cfg::T (&k2)[Cfg::TM][Cfg::TN],
    typename Cfg::T (&k3)[Cfg::TM][Cfg::TN]) {
  using T = typename Cfg::T;
  constexpr int V = Cfg::V, TM = Cfg::TM, TN = Cfg::TN, RV = Cfg::RV,
                CV = Cfg::CV;
  T xr[TM], xi[TM], xs[TM], yr[TN], yd[TN], ys[TN];
#pragma unroll
  for (int r = 0; r < RV; ++r) {
    const int at = kk * Cfg::PM + r * (Cfg::BM / RV) + V * tm;
    load_vec(ar + at, xr + r * V);
    load_vec(ai + at, xi + r * V);
    if constexpr (kSumA) load_vec(as + at, xs + r * V);
  }
  if constexpr (!kSumA) {
#pragma unroll
    for (int i = 0; i < TM; ++i) xs[i] = xr[i] + xi[i];
  }
#pragma unroll
  for (int c = 0; c < CV; ++c) {
    const int at = kk * Cfg::PN + c * (Cfg::BN / CV) + V * tn;
    load_vec(br + at, yr + c * V);
    load_vec(bd + at, yd + c * V);
    load_vec(bs + at, ys + c * V);
  }
#pragma unroll
  for (int i = 0; i < TM; ++i) {
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      k1[i][j] = fma(xs[i], yr[j], k1[i][j]);
      k2[i][j] = fma(xr[i], yd[j], k2[i][j]);
      k3[i][j] = fma(xi[i], ys[j], k3[i][j]);
    }
  }
}

// The staged pipeline's per-stage pass over one operand: its raw tile
// (rr, ri; [k][P] or, for kVecK, swizzled [f][k]) into the compute slot's
// [k][P] planes: (o0, o1) = (re, im), or with kSums (the B side)
// (o0, o1, o2) = (re, im - re, re + im).
template <typename T, int FT, int P, int BK, bool kSums>
__device__ __forceinline__ void transform_stage(int mode, const T* rr,
                                                const T* ri, T* o0, T* o1,
                                                T* o2) {
  using VT = typename Vec<T>::type;
  constexpr int V = 16 / static_cast<int>(sizeof(T));
  auto put = [&](int at, const T* xr, const T* xi) {
    VT v0, v1, v2;
    T* e0 = reinterpret_cast<T*>(&v0);
    T* e1 = reinterpret_cast<T*>(&v1);
    T* e2 = reinterpret_cast<T*>(&v2);
#pragma unroll
    for (int e = 0; e < V; ++e) {
      e0[e] = xr[e];
      e1[e] = kSums ? xi[e] - xr[e] : xi[e];
      e2[e] = xr[e] + xi[e];
    }
    *reinterpret_cast<VT*>(o0 + at) = v0;
    *reinterpret_cast<VT*>(o1 + at) = v1;
    if (kSums) *reinterpret_cast<VT*>(o2 + at) = v2;
  };
  if (mode == kVecK) {
    // block (bf, bc): free indices V bf .. V bf + V, contract V bc .. V bc + V
    constexpr int FB = FT / V;
    constexpr int NB = FB * (BK / V);
#pragma unroll
    for (int i = 0; i < (NB + kThreads - 1) / kThreads; ++i) {
      const int q = threadIdx.x + i * kThreads;
      if (NB % kThreads != 0 && q >= NB) break;
      const int bf = q % FB;  // 8 lanes: 8 consecutive blocks of one row run
      const int bc = q / FB;
      T xr[V][V], xi[V][V];
#pragma unroll
      for (int r = 0; r < V; ++r) {
        const int at = vec_k_at<V, BK>(V * bf + r, bc);
        load_vec(rr + at, xr[r]);
        load_vec(ri + at, xi[r]);
      }
#pragma unroll
      for (int c = 0; c < V; ++c) {
        T yr[V], yi[V];
#pragma unroll
        for (int r = 0; r < V; ++r) {
          yr[r] = xr[r][c];
          yi[r] = xi[r][c];
        }
        put((V * bc + c) * P + V * bf, yr, yi);
      }
    }
  } else {
    constexpr int CH = FT / V;
    constexpr int NV = BK * CH;
#pragma unroll
    for (int i = 0; i < (NV + kThreads - 1) / kThreads; ++i) {
      const int q = threadIdx.x + i * kThreads;
      if (NV % kThreads != 0 && q >= NV) break;
      const int at = (q / CH) * P + (q % CH) * V;
      T xr[V], xi[V];
      load_vec(rr + at, xr);
      load_vec(ri + at, xi);
      put(at, xr, xi);
    }
  }
}

// One stage's products into the partial sums: kc contract indices of the
// tiles (ar, ai; br, bd = bi - br, bs = br + bi), all BK of them unrolled
// by kUnroll when the stage is whole.
template <class Cfg, bool kSumA = false>
__device__ __forceinline__ void compute_stage(
    const typename Cfg::T* ar, const typename Cfg::T* ai,
    const typename Cfg::T* as, const typename Cfg::T* br,
    const typename Cfg::T* bd,
    const typename Cfg::T* bs, int kc, int tm, int tn,
    typename Cfg::T (&k1)[Cfg::TM][Cfg::TN],
    typename Cfg::T (&k2)[Cfg::TM][Cfg::TN],
    typename Cfg::T (&k3)[Cfg::TM][Cfg::TN]) {
  if (kc == Cfg::BK) {
#pragma unroll 1
    for (int k0 = 0; k0 < Cfg::BK; k0 += Cfg::kUnroll) {
#pragma unroll
      for (int u = 0; u < Cfg::kUnroll; ++u)
        mac_k<Cfg, kSumA>(ar, ai, as, br, bd, bs, k0 + u, tm, tn, k1, k2, k3);
    }
  } else {
#pragma unroll 1
    for (int kk = 0; kk < kc; ++kk)
      mac_k<Cfg, kSumA>(ar, ai, as, br, bd, bs, kk, tm, tn, k1, k2, k3);
  }
}

// Folds the partial sums of the last kFold stages (or of the tile's last
// stages) into the running totals.
template <class Cfg>
__device__ __forceinline__ void fold(typename Cfg::T (&re)[Cfg::TM][Cfg::TN],
                                     typename Cfg::T (&im)[Cfg::TM][Cfg::TN],
                                     typename Cfg::T (&k1)[Cfg::TM][Cfg::TN],
                                     typename Cfg::T (&k2)[Cfg::TM][Cfg::TN],
                                     typename Cfg::T (&k3)[Cfg::TM][Cfg::TN]) {
  using T = typename Cfg::T;
#pragma unroll
  for (int i = 0; i < Cfg::TM; ++i) {
#pragma unroll
    for (int j = 0; j < Cfg::TN; ++j) {
      re[i][j] += k1[i][j] - k3[i][j];
      im[i][j] += k1[i][j] + k2[i][j];
      k1[i][j] = k2[i][j] = k3[i][j] = T(0);
    }
  }
}

// Stores this thread's outputs: row r * BM / RV + V * tm + ii, column
// c * BN / CV + V * tn + jj of the tile at (m0, n0); rows and columns past
// M and N are not stored.
template <class Cfg>
__device__ __forceinline__ void store_tile(
    const typename Cfg::T (&re)[Cfg::TM][Cfg::TN],
    const typename Cfg::T (&im)[Cfg::TM][Cfg::TN], long long M, long long N,
    long long m0, long long n0, int tm, int tn, typename Cfg::T* cr,
    typename Cfg::T* ci) {
  using T = typename Cfg::T;
  using VT = typename Vec<T>::type;
  constexpr int V = Cfg::V, BM = Cfg::BM, BN = Cfg::BN, RV = Cfg::RV,
                CV = Cfg::CV;
  const bool vec_rows = N % V == 0;
#pragma unroll
  for (int r = 0; r < RV; ++r) {
#pragma unroll
    for (int ii = 0; ii < V; ++ii) {
      const long long m = m0 + r * (BM / RV) + V * tm + ii;
      if (m >= M) continue;
      const int i = r * V + ii;
#pragma unroll
      for (int c = 0; c < CV; ++c) {
        const long long n = n0 + c * (BN / CV) + V * tn;
        const int j = c * V;
        if (vec_rows && n + V <= N) {
          VT vr, vi;
          T* er = reinterpret_cast<T*>(&vr);
          T* ei = reinterpret_cast<T*>(&vi);
#pragma unroll
          for (int jj = 0; jj < V; ++jj) {
            er[jj] = re[i][j + jj];
            ei[jj] = im[i][j + jj];
          }
          *reinterpret_cast<VT*>(cr + m * N + n) = vr;
          *reinterpret_cast<VT*>(ci + m * N + n) = vi;
        } else {
#pragma unroll
          for (int jj = 0; jj < V; ++jj) {
            if (n + jj < N) {
              cr[m * N + n + jj] = re[i][j + jj];
              ci[m * N + n + jj] = im[i][j + jj];
            }
          }
        }
      }
    }
  }
}

// The output tile at (m0, n0) of C = A^T B over the K contract indices,
// from two sources whose f0 / tile offsets the caller has set for this
// tile, through the direct pipeline (kStaged false; smem holds
// Cfg::kTileBytes) or the staged one (Cfg::kStagedBytes). Every thread of
// the block calls it.
template <class Cfg, bool kStaged, class SrcA, class SrcB>
__device__ __forceinline__ void complex_gemm_tile(
    const SrcA& a, const SrcB& b, long long K, long long M, long long N,
    long long m0, long long n0, typename Cfg::T* cr, typename Cfg::T* ci,
    typename Cfg::T* smem) {
  using T = typename Cfg::T;
  constexpr int TM = Cfg::TM, TN = Cfg::TN, BM = Cfg::BM, BN = Cfg::BN,
                BK = Cfg::BK, PM = Cfg::PM, PN = Cfg::PN;
  // within a raw or ring slot: ar, ai (BK x PM) then br, bi (BK x PN)
  constexpr int kRing = kStaged ? 2 : Cfg::kStages;
  auto slot = [&](long long t) { return smem + (t % kRing) * Cfg::kSlotElems; };

  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int tm = (warp / Cfg::WN) * Cfg::LM + lane / Cfg::LN;  // 0 .. GM - 1
  const int tn = (warp % Cfg::WN) * Cfg::LN + lane % Cfg::LN;  // 0 .. GN - 1

  const long long nk = (K + BK - 1) / BK;
  auto fetch = [&](long long t) {
    if (t < nk) {
      T* p = slot(t);
      stage_source<T, BM, PM, BK>(a, p, p + BK * PM, t * BK);
      stage_source<T, BN, PN, BK>(b, p + 2 * BK * PM, p + 2 * BK * PM + BK * PN,
                                  t * BK);
    }
    cp_async_commit();  // an empty group keeps the count uniform
  };

  T re[TM][TN], im[TM][TN];              // running totals
  T k1[TM][TN], k2[TM][TN], k3[TM][TN];  // partial sums of kFold stages
#pragma unroll
  for (int i = 0; i < TM; ++i) {
#pragma unroll
    for (int j = 0; j < TN; ++j)
      re[i][j] = im[i][j] = k1[i][j] = k2[i][j] = k3[i][j] = T(0);
  }
  // a partial last stage runs only its own contract indices
  auto depth = [&](long long t) {
    const long long left = K - t * BK;
    return left < BK ? static_cast<int>(left) : BK;
  };

  if constexpr (kStaged) {
    // compute slot t % 2: ar, ai (BK x PM) then br, bd, bs (BK x PN)
    T* const comp = smem + 2 * Cfg::kSlotElems;
    auto comp_of = [&](long long t) { return comp + (t % 2) * Cfg::kComputeElems; };
    auto transform = [&](long long t) {
      if (t < nk) {
        const T* p = slot(t);
        T* c = comp_of(t);
        transform_stage<T, BM, PM, BK, false>(a.mode, p, p + BK * PM, c,
                                              c + BK * PM, nullptr);
        transform_stage<T, BN, PN, BK, true>(
            b.mode, p + 2 * BK * PM, p + 2 * BK * PM + BK * PN, c + 2 * BK * PM,
            c + 2 * BK * PM + BK * PN, c + 2 * BK * PM + 2 * BK * PN);
      }
    };
    fetch(0);
    fetch(1);
    cp_async_wait<1>();  // stage 0 landed
    __syncthreads();
    transform(0);
    // One barrier per stage. Before it: this thread's copies of stage t + 1
    // landed. After it: every copy of stage t + 1 and the compute slot of
    // stage t are visible, and every thread is done with the raw slot of
    // stage t (refilled with stage t + 2) and the compute slot of stage
    // t - 1 (refilled from stage t + 1).
    for (long long t = 0; t < nk; ++t) {
      cp_async_wait<0>();
      __syncthreads();
      fetch(t + 2);
      const T* const c = comp_of(t);
      compute_stage<Cfg>(c, c + BK * PM, nullptr, c + 2 * BK * PM,
                         c + 2 * BK * PM + BK * PN,
                         c + 2 * BK * PM + 2 * BK * PN, depth(t), tm, tn, k1, k2,
                         k3);
      if ((t + 1) % Cfg::kFold == 0 || t + 1 == nk) fold<Cfg>(re, im, k1, k2, k3);
      transform(t + 1);
    }
  } else {
    constexpr int S = Cfg::kStages;
    T* const sums = smem + S * Cfg::kSlotElems;  // br + bi of two stages
    auto sums_of = [&](long long t) { return sums + (t % 2) * BK * PN; };
    T* const asums = sums + 2 * BK * PN;  // ar + ai of two stages
    auto asums_of = [&](long long t) { return asums + (t % 2) * BK * PM; };
    // the Gauss sums of stage t: br + bi and ar + ai beside the ring,
    // bi - br over bi in the slot
    auto make_sums = [&](long long t) {
      if (t < nk) {
        T* br = slot(t) + 2 * BK * PM;
        sum_tile<T, BN, PN, BK>(br, br + BK * PN, sums_of(t));
        add_tile<T, BM, PM, BK>(slot(t), slot(t) + BK * PM, asums_of(t));
      }
    };
#pragma unroll
    for (int s = 0; s < S - 1; ++s) fetch(s);
    cp_async_wait<S - 2>();  // stage 0 landed
    __syncthreads();
    make_sums(0);
    // One barrier per stage. Before it: this thread's copies of stage t + 1
    // landed. After it: every copy of stage t + 1 and every sum of stage t
    // is visible, and every thread is done with stage t - 1, whose slot is
    // refilled and whose sum buffer stage t + 1 reuses.
    for (long long t = 0; t < nk; ++t) {
      cp_async_wait<S - 3>();
      __syncthreads();
      fetch(t + S - 1);
      const T* const ar = slot(t);
      const T* const ai = ar + BK * PM;
      const T* const br = ai + BK * PM;
      compute_stage<Cfg, true>(ar, ai, asums_of(t), br, br + BK * PN, sums_of(t),
                               depth(t), tm, tn, k1, k2, k3);
      if ((t + 1) % Cfg::kFold == 0 || t + 1 == nk) fold<Cfg>(re, im, k1, k2, k3);
      make_sums(t + 1);
    }
  }
  cp_async_wait<0>();  // no copy may outlive the tile (empty groups only)
  store_tile<Cfg>(re, im, M, N, m0, n0, tm, tn, cr, ci);
}

// ---- the tensor-core rungs -----------------------------------------------

enum Rung : int { kFp32 = 0, kTf32x3 = 1, kTf32 = 2 };

// x rounded to TF32: to nearest, ties away from zero, the low 13 bits zero
__device__ __forceinline__ unsigned tf32_rna(float x) {
  unsigned r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// hi = rna(x) and, for kTf32x3, lo = rna(x - hi) (x - hi is exact in FP32;
// lo is 0 at kTf32)
template <int R>
__device__ __forceinline__ void tf32_split(float x, unsigned& hi, unsigned& lo) {
  hi = tf32_rna(x);
  if constexpr (R == kTf32x3) {
    lo = tf32_rna(x - __uint_as_float(hi));
  } else {
    lo = 0u;
  }
}

__device__ __forceinline__ unsigned tf32_neg(unsigned x) { return x ^ 0x80000000u; }

// d += a b over one m16n8k8 tile: a (16 x 8, row), b (8 x 8, col), TF32
__device__ __forceinline__ void mma_tf32(float (&d)[4], const unsigned (&a)[4],
                                         const unsigned (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// How the 8 warps of a block cover a tile with m16n8 tensor-core tiles. The
// "X" operand gives the mma rows (A, or B for a tile of fewer than 16 rows,
// which is computed transposed), the "Y" operand the mma columns. A warp
// owns WRows x WCols: MT x NT mma tiles.
template <class Cfg>
struct TcLayout {
  static constexpr bool kSwap = Cfg::BM < 16;
  static constexpr int XR = kSwap ? Cfg::BN : Cfg::BM;
  static constexpr int YC = kSwap ? Cfg::BM : Cfg::BN;
  static constexpr int PX = kSwap ? Cfg::PN : Cfg::PM;
  static constexpr int PY = kSwap ? Cfg::PM : Cfg::PN;
  static constexpr int WX = XR / 32 < 8 ? XR / 32 : 8;  // warps along the rows
  static constexpr int WY = 8 / WX;
  static constexpr int WRows = XR / WX;
  static constexpr int WCols = YC / WY;
  static constexpr int MT = WRows / 16;
  static constexpr int NT = WCols / 8;
  static_assert(WX * WY == 8 && MT * 16 == WRows && NT * 8 == WCols && MT >= 1 &&
                    NT >= 1, "tensor-core warp tiling");
  static_assert(Cfg::BK % 8 == 0, "whole k8 steps");
};

// One stage's products into the partial sums (pre, pim) of this warp's
// tiles: X = (xr, xi) and Y = (yr, yi) are [k][P] tiles of the stage, all BK
// contract indices (past K the tiles hold zeros). Each k8 step's products
// start from zero and are then added to the partials.
template <class Cfg, int R>
__device__ __forceinline__ void tc_stage(
    const float* xr, const float* xi, const float* yr, const float* yi, int wr,
    int wc, int gid, int tig,
    float (&pre)[TcLayout<Cfg>::MT][TcLayout<Cfg>::NT][4],
    float (&pim)[TcLayout<Cfg>::MT][TcLayout<Cfg>::NT][4]) {
  using L = TcLayout<Cfg>;
  constexpr int PX = L::PX, PY = L::PY, MT = L::MT, NT = L::NT;
#pragma unroll 1
  for (int k0 = 0; k0 < Cfg::BK; k0 += 8) {
    // the Y fragments of every column tile: (k0 + tig, c) and (k0 + tig + 4, c)
    unsigned bh[NT][2][2], bl[NT][2][2];  // [tile][re, im][register]
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int c = wc + nt * 8 + gid;
#pragma unroll
      for (int p = 0; p < 2; ++p) {
        const float* y = p ? yi : yr;
        tf32_split<R>(y[(k0 + tig) * PY + c], bh[nt][p][0], bl[nt][p][0]);
        tf32_split<R>(y[(k0 + tig + 4) * PY + c], bh[nt][p][1], bl[nt][p][1]);
      }
    }
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      // the X fragment: rows r, r + 8 at contract indices k0 + tig, + 4
      const int r = wr + mt * 16 + gid;
      unsigned ah[2][4], al[2][4];
#pragma unroll
      for (int p = 0; p < 2; ++p) {
        const float* x = p ? xi : xr;
        tf32_split<R>(x[(k0 + tig) * PX + r], ah[p][0], al[p][0]);
        tf32_split<R>(x[(k0 + tig) * PX + r + 8], ah[p][1], al[p][1]);
        tf32_split<R>(x[(k0 + tig + 4) * PX + r], ah[p][2], al[p][2]);
        tf32_split<R>(x[(k0 + tig + 4) * PX + r + 8], ah[p][3], al[p][3]);
      }
      // -xi, for re = xr yr - xi yi
      unsigned nh[4], nl[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        nh[i] = tf32_neg(ah[1][i]);
        nl[i] = tf32_neg(al[1][i]);
      }
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        float tr[4] = {0.f, 0.f, 0.f, 0.f};
        float ti[4] = {0.f, 0.f, 0.f, 0.f};
        if constexpr (R == kTf32x3) {
          mma_tf32(tr, ah[0], bl[nt][0]);
          mma_tf32(tr, al[0], bh[nt][0]);
          mma_tf32(tr, nh, bl[nt][1]);
          mma_tf32(tr, nl, bh[nt][1]);
          mma_tf32(ti, ah[0], bl[nt][1]);
          mma_tf32(ti, al[0], bh[nt][1]);
          mma_tf32(ti, ah[1], bl[nt][0]);
          mma_tf32(ti, al[1], bh[nt][0]);
        }
        mma_tf32(tr, ah[0], bh[nt][0]);
        mma_tf32(tr, nh, bh[nt][1]);
        mma_tf32(ti, ah[0], bh[nt][1]);
        mma_tf32(ti, ah[1], bh[nt][0]);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          pre[mt][nt][i] += tr[i];
          pim[mt][nt][i] += ti[i];
        }
      }
    }
  }
}

// complex_gemm_tile at a TF32 rung R (Cfg a float *Tc variant): the same
// sources, ring and pipelines, no Gauss sums, the stage's products on the
// tensor cores (tc_stage), and this warp's m16n8 accumulator tiles stored.
template <class Cfg, bool kStaged, int R, class SrcA, class SrcB>
__device__ __forceinline__ void complex_gemm_tile_tc(
    const SrcA& a, const SrcB& b, long long K, long long M, long long N,
    long long m0, long long n0, float* cr, float* ci, float* smem) {
  static_assert(std::is_same<typename Cfg::T, float>::value && R != kFp32,
                "the tensor-core rungs are float");
  using L = TcLayout<Cfg>;
  constexpr int BM = Cfg::BM, BN = Cfg::BN, BK = Cfg::BK, PM = Cfg::PM,
                PN = Cfg::PN, MT = L::MT, NT = L::NT;
  // within a raw, ring or compute slot: ar, ai (BK x PM) then br, bi (BK x PN)
  constexpr int kRing = kStaged ? 2 : Cfg::kStages;
  auto slot = [&](long long t) { return smem + (t % kRing) * Cfg::kSlotElems; };
  const long long nk = (K + BK - 1) / BK;
  auto fetch = [&](long long t) {
    if (t < nk) {
      float* p = slot(t);
      stage_source<float, BM, PM, BK>(a, p, p + BK * PM, t * BK);
      stage_source<float, BN, PN, BK>(b, p + 2 * BK * PM,
                                      p + 2 * BK * PM + BK * PN, t * BK);
    }
    cp_async_commit();  // an empty group keeps the count uniform
  };
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int gid = lane / 4;
  const int tig = lane % 4;
  const int wr = (warp / L::WY) * L::WRows;
  const int wc = (warp % L::WY) * L::WCols;

  float re[MT][NT][4], im[MT][NT][4];    // running totals
  float pre[MT][NT][4], pim[MT][NT][4];  // partial sums of kFold stages
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int i = 0; i < 4; ++i)
        re[mt][nt][i] = im[mt][nt][i] = pre[mt][nt][i] = pim[mt][nt][i] = 0.f;
    }
  }
  auto compute = [&](const float* p) {
    const float* ar = p;
    const float* ai = p + BK * PM;
    const float* br = p + 2 * BK * PM;
    const float* bi = br + BK * PN;
    if constexpr (L::kSwap) {
      tc_stage<Cfg, R>(br, bi, ar, ai, wr, wc, gid, tig, pre, pim);
    } else {
      tc_stage<Cfg, R>(ar, ai, br, bi, wr, wc, gid, tig, pre, pim);
    }
  };
  auto fold_tc = [&](long long t) {
    if ((t + 1) % Cfg::kFold != 0 && t + 1 != nk) return;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          re[mt][nt][i] += pre[mt][nt][i];
          im[mt][nt][i] += pim[mt][nt][i];
          pre[mt][nt][i] = pim[mt][nt][i] = 0.f;
        }
      }
    }
  };

  if constexpr (kStaged) {
    float* const comp = smem + 2 * Cfg::kSlotElems;
    auto comp_of = [&](long long t) { return comp + (t % 2) * Cfg::kSlotElems; };
    auto transform = [&](long long t) {
      if (t < nk) {
        const float* p = slot(t);
        float* c = comp_of(t);
        transform_stage<float, BM, PM, BK, false>(a.mode, p, p + BK * PM, c,
                                                  c + BK * PM, nullptr);
        transform_stage<float, BN, PN, BK, false>(
            b.mode, p + 2 * BK * PM, p + 2 * BK * PM + BK * PN, c + 2 * BK * PM,
            c + 2 * BK * PM + BK * PN, nullptr);
      }
    };
    fetch(0);
    fetch(1);
    cp_async_wait<1>();  // stage 0 landed
    __syncthreads();
    transform(0);
    // one barrier per stage, as in complex_gemm_tile's staged pipeline
    for (long long t = 0; t < nk; ++t) {
      cp_async_wait<0>();
      __syncthreads();
      fetch(t + 2);
      compute(comp_of(t));
      fold_tc(t);
      transform(t + 1);
    }
  } else {
    constexpr int S = Cfg::kStages;
#pragma unroll
    for (int s = 0; s < S - 1; ++s) fetch(s);
    // One barrier per stage. Before it: this thread's copies of stage t
    // landed. After it: every copy of stage t is visible and every thread
    // is done with stage t - 1, whose slot is refilled with stage t + S - 1.
    for (long long t = 0; t < nk; ++t) {
      cp_async_wait<S - 2>();
      __syncthreads();
      fetch(t + S - 1);
      compute(slot(t));
      fold_tc(t);
    }
  }
  cp_async_wait<0>();  // no copy may outlive the tile (empty groups only)
  // accumulator i of a tile: row gid (+ 8 for i >= 2), column 2 tig + i % 2
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = wr + mt * 16 + gid + (i >= 2 ? 8 : 0);
        const int col = wc + nt * 8 + 2 * tig + (i & 1);
        const long long m = L::kSwap ? m0 + col : m0 + row;
        const long long n = L::kSwap ? n0 + row : n0 + col;
        if (m < M && n < N) {
          cr[m * N + n] = re[mt][nt][i];
          ci[m * N + n] = im[mt][nt][i];
        }
      }
    }
  }
}

// (m0, n0) of tile `tile`, rastered in groups of kGroupM tile rows so the
// blocks resident at one time share operand panels in L2
template <class Cfg>
__device__ __forceinline__ void tile_origin(long long tile, long long M,
                                            long long N, long long* m0,
                                            long long* n0) {
  const long long tiles_m = (M + Cfg::BM - 1) / Cfg::BM;
  const long long tiles_n = (N + Cfg::BN - 1) / Cfg::BN;
  const long long per_group = kGroupM * tiles_n;
  const long long first = (tile / per_group) * kGroupM;
  const long long rows = tiles_m - first < kGroupM ? tiles_m - first : kGroupM;
  const long long in_group = tile % per_group;
  *m0 = (first + in_group % rows) * Cfg::BM;
  *n0 = (in_group / rows) * Cfg::BN;
}

template <class Cfg>
__host__ __device__ inline long long tile_count(long long M, long long N) {
  return ((M + Cfg::BM - 1) / Cfg::BM) * ((N + Cfg::BN - 1) / Cfg::BN);
}

// The tile variants the host chooses between (mirrored by
// cuda_complex.GEMM_VARIANTS): 0 = float 128 x 64, 1 = float 64 x 64,
// 2 = float 8 x 512 (a few rows, long columns: the outer-product steps),
// 3 = double 64 x 64.
using Wide = Variant<float, 16, 8, 4, 32, 3, 4, 8>;
using Narrow = Variant<float, 16, 4, 4, 16, 3, 2, 4>;
using Flat = Variant<float, 2, 4, 4, 8, 3, 4, 1>;
using Double = Variant<double, 16, 4, 4, 16, 3, 2, 2>;
// the float variants' tiles at the TF32 rungs' small launches, rows padded
// to 8 (mod 32) floats: 128 x 64 (P 136, 72), 64 x 64 (72, 72), 8 x 512
// (24, 520)
using WideTc = Variant<float, 16, 8, 4, 32, 3, 4, 8, 8, 8>;
using NarrowTc = Variant<float, 16, 4, 4, 16, 3, 2, 4, 8, 8>;
using FlatTc = Variant<float, 2, 4, 4, 8, 3, 4, 1, 16, 8>;

// A block's opt-in shared memory on an H100 (cuda_complex.MAX_SMEM_BYTES).
// Every mma.sync tile fits it in both pipelines, beside fused_transpose_dot's
// offset tables of 8-byte entries (BM + BN of them).
constexpr size_t kMaxSmemBytes = 232448;
template <class Cfg>
constexpr bool kTcFits =
    Cfg::kTcTileBytes + 8 * (Cfg::BM + Cfg::BN) <= kMaxSmemBytes &&
    Cfg::kTcStagedBytes + 8 * (Cfg::BM + Cfg::BN) <= kMaxSmemBytes;
static_assert(kTcFits<WideTc> && kTcFits<NarrowTc> && kTcFits<FlatTc>,
              "an mma.sync tile exceeds a block's shared memory");

// Sets the kernel's dynamic shared memory limit to its `bytes`, once per
// device (`done`: the caller's flags for this kernel). Returns a CUDA error
// code, 0 on success.
template <class Kernel>
inline int prepare(Kernel kernel, size_t bytes, bool (&done)[64]) {
  int device = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (device >= 0 && device < 64 && done[device]) return 0;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(bytes));
  if (e != cudaSuccess) return static_cast<int>(e);
  if (device >= 0 && device < 64) done[device] = true;
  return 0;
}

}  // namespace gemm
}  // namespace tnc
