// The TF32 tile of fused_complex_dot.cu and fused_transpose_dot.cu: their
// `high` (3xTF32) and `default` (one TF32 pass) launches of 2^30
// multiply-adds or more but the outer products (below).
//
//   C = A^T B,  A: (K, M), B: (K, N), C: (M, N), every matrix a (re, im) pair
//   re = ar^T br - ai^T bi,   im = ar^T bi + ai^T br
//
// It replaces, at those rungs, the TPU kernels
// tnc_tpu/ops/pallas_complex.py::fused_complex_dot_kl and
// ::fused_transpose_dot_kl (the reference's `precision`), as
// complex_gemm.cuh's FMA engine replaces them at float32.
//
// What bounds it on an H100: 8*K*M*N*passes TF32 operations (the four naive
// real products; 3 passes at `high`, 1 at `default`) over the tensor cores'
// 494.7 TFLOP/s dense rate, against 8*(K*M + K*N + M*N) bytes over 3.35
// TB/s: far above the ridge on the products this tile takes. On
// the way to the tensor cores three things bound it, and the design answers
// each:
//
// - The instruction. wgmma.mma_async m64nNk8 TF32 is the only way to the
//   full rate; TF32 wgmma reads both operands from shared memory K-major
//   only (CUTLASS's TF32 GMMA atoms exist only as _TN). A block has two
//   consumer warpgroups, one per output part: warpgroup 0 sums re (ar br
//   and, through the instruction's negating scale on A, -ai bi), warpgroup
//   1 im (ar bi + ai br). Each holds its part of the whole tile, so every
//   instruction is as wide as the accumulators allow (N = 128 on the wide
//   tile): m64n128k8 reads 96 bytes of shared memory a clock at the full
//   rate, m64n64k8 would read 128, the whole of the SM's bandwidth.
// - The operands' layout and rounding. The engine's operands are mostly
//   MN-major (fused_complex_dot's (K, M) / (K, N) parts have the free index
//   at stride 1, and most PEPS gathers too), and wgmma only drops a TF32
//   operand's low bits where the plain version (split_complex.rung_matmul)
//   rounds to nearest. So loads land in raw slots in any layout, and a
//   conversion stage per k-block reads each element once, rounds it once
//   to TF32 (to nearest, ties away: cvt.rna.tf32.f32's bits, in two
//   integer operations; at `high` also splits it once into hi and lo
//   tiles) and writes compute slots in wgmma's canonical K-major layout with
//   the swizzle its descriptors name (128-byte rows at BK = 32 floats, 64 at
//   16): a [k][f] raw tile is transposed on the way (lanes along f: reads
//   and swizzled 16-byte writes free of bank conflicts), a [f][k] one
//   (contract index at stride 1) is copied chunk for chunk. The consumer
//   warpgroups convert stage t + 1 while the tensor cores run stage t.
// - The loads. A loading warpgroup (setmaxnreg down to 88 registers, the
//   consumers up to 208) fills two raw slots: with TMA
//   (cp.async.bulk.tensor, one 2-D or 3-D tensor map per part, built on
//   the host) for fused_complex_dot's operands whose free index has stride
//   1, with cp.async (16-byte along a stride-1 index, else one element)
//   for the rest and for fused_transpose_dot's gathered operands (offset
//   tables over many stored digits: a tensor map has at most 5
//   dimensions). mbarriers order the raw ring (full: 128 cp.async arrivals
//   and one with the TMA bytes; empty: the 256 consumer threads) and the two
//   compute slots (full once both consumer warpgroups converted a stage,
//   free once both warpgroups' wgmmas read it), so each warpgroup keeps its
//   wgmmas of a stage in flight while the next stage converts. The
//   block is persistent: it walks output tiles (and slice-batch rows), so
//   the loads of the next tile run under the last stages of this one.
//
// Accumulation. The tensor cores' sum does not round to nearest, so a
// chain of wgmma k8 steps into one accumulator drifts as it grows, about
// linearly with its length. A chain covers one stage, BK / 8 k8 steps, at
// `high`, and kDefaultChainK8 at `default`, whose error is its operands'
// TF32 rounding (kChainK8 > 0 sets another depth at compile time:
// scripts/tf32_drift.py builds the library at each candidate depth and
// measures it against float64 and one cuBLAS TF32 call), then is added in
// FP32 to the running totals. Two register levels of MG * YC / 2 floats a thread: 128
// on the wide tile (a third level of partial sums would leave the loading
// warpgroup too few registers; a long dot to a small output, where FP32
// sums would grow longest, is cut into pieces by the host instead).
// Chains of whole stages let a contraction's last, partial stage skip its
// k8 steps past K (an outer product's K = 2 runs one of two).
//
// Complex arithmetic as the plain version does it: the naive four products,
// at `high` each hi lo + lo hi + hi hi over the split parts, the small
// terms first.
//
// Tiles (cuda_complex.TF32_TILES mirrors them): the "X" operand gives
// wgmma's 64-row groups, the "Y" operand its N columns.
//   0 wide    X = A (64 rows), Y = B (128 columns); BK 32 at `default`, 16
//             at `high` (hi and lo compute slots);
//   1 flat_n  N <= 8: X = A (256 rows, four m64 groups), Y = B (8); BK 16.
// Three classes keep complex_gemm.cuh's mma.sync tiles (cuda_complex's
// `mma_*` tiles; cuda_complex.tf32_config routes them, scripts/
// tf32_tile_shapes.py --tiles times both tiles on the same launch):
// - a launch of fewer than 2^30 multiply-adds: this tile's fixed cost a
//   stage and a work item (the conversion, the ring's waits, the persistent
//   block's start) outweighs a short product's work, so neither tile wins
//   throughout;
// - M <= 8, the outer products (computed transposed there, 8 x 512): this
//   tile's transposed 256 x 8 form ran them 1.06-1.08x slower at `default`
//   and 1.43-1.51x at `high` on an H100, so it is not built;
// - fused_transpose_dot's int64 offset tables (operands of 2^31 elements
//   or more): its wgmma kernel reads int32 ones only.
#pragma once

#include <cuda.h>
#include <cuda_runtime.h>

#include "complex_gemm.cuh"

namespace tnc {
namespace tf32 {

using gemm::kTf32;
using gemm::kTf32x3;

constexpr int kConsumers = 256;  // warpgroups 0 (re) and 1 (im)
constexpr int kProducers = 128;  // warpgroup 2: the loads
constexpr int kThreads = kConsumers + kProducers;
// setmaxnreg moves registers within the block's own pool, 384 x 168 at
// launch (__launch_bounds__(384, 1)): 2 x 128 x 208 + 128 x 88 = 64512
constexpr int kLaunchRegs = 168;
constexpr int kConsumerRegs = 208;
constexpr int kProducerRegs = 88;
static_assert(kConsumers * kConsumerRegs + kProducers * kProducerRegs ==
                  kThreads * kLaunchRegs,
              "setmaxnreg keeps the block's register pool");
// k8 steps of a `default` chain (its error is the operands' TF32 rounding)
constexpr int kDefaultChainK8 = 16;
// k8 steps of every chain when above 0, else the rung's own (one stage at
// `high`, kDefaultChainK8 at `default`); only a measurement of the depth
// builds it otherwise (-DTNC_TF32_CHAIN_K8=n)
#ifndef TNC_TF32_CHAIN_K8
#define TNC_TF32_CHAIN_K8 0
#endif
constexpr int kChainK8 = TNC_TF32_CHAIN_K8;
// a source's copy mode beside tnc::gemm::Mode: TMA boxes into a [k][f] tile
constexpr int kTma = 4;

// The bytes of an operand part's tile of `rows` K-major rows of BK floats,
// in whole swizzle atoms (1 KB)
__host__ __device__ constexpr int tile_part_bytes(int rows, int bk) {
  return (rows * bk * 4 + 1023) / 1024 * 1024;
}

// One tile: XR rows (wgmma's M, in MG groups of 64) from the X operand A,
// YC columns (wgmma's N) from the Y operand B, BK contract indices a stage.
// RD / RH: the raw slots of the ring at `default` / `high` (as many as
// shared memory holds beside the two compute slots: the loads run that many
// stages ahead).
template <int XR_, int YC_, int BK_, int RD_, int RH_>
struct Tile {
  static constexpr int XR = XR_;
  static constexpr int YC = YC_;
  static constexpr int BK = BK_;
  template <int R>
  static constexpr int kRaw = R == kTf32x3 ? RH_ : RD_;
  static constexpr int MG = XR / 64;
  static constexpr int KS = BK / 8;   // k8 steps a stage
  static constexpr int CPR = BK / 4;  // 16-byte chunks of a K-major row
  static constexpr int BM = XR;  // the output tile (M x N)
  static constexpr int BN = YC;
  static constexpr int kXBytes = tile_part_bytes(XR, BK);
  static constexpr int kYBytes = tile_part_bytes(YC, BK);
  // a raw slot and a (hi) compute level: X re, X im, Y re, Y im
  static constexpr int kSlotBytes = 2 * kXBytes + 2 * kYBytes;
  static_assert(XR % 64 == 0 && YC % 8 == 0 && YC <= 256, "wgmma tile");
  static_assert(BK == 16 || BK == 32, "64- or 128-byte K-major rows");
  static_assert(XR <= 256 && YC <= 256, "a TMA box dimension is at most 256");
};

// the raw slots, two compute slots (hi, and lo at kTf32x3), the mbarriers
// (a full and an empty one a raw slot, a full and a free one a compute
// slot; 256 bytes), and the slack that aligns the base to 1 KB
template <class T, int R>
constexpr size_t kTileBytes =
    1024 + static_cast<size_t>(T::template kRaw<R>) * T::kSlotBytes +
    2 * static_cast<size_t>((R == kTf32x3 ? 2 : 1) * T::kSlotBytes) + 256;

// A tile with its offset tables (8 bytes an entry at most) within a block's
// shared memory (gemm::kMaxSmemBytes, cuda_complex.MAX_SMEM_BYTES)
template <class T, int R>
constexpr bool kFits = kTileBytes<T, R> + 8 * (T::XR + T::YC) <= gemm::kMaxSmemBytes;

using Wide = Tile<64, 128, 32, 2, 2>;      // `default`
using WideHigh = Tile<64, 128, 16, 5, 5>;  // `high`
using FlatN = Tile<256, 8, 16, 4, 2>;
static_assert(kFits<Wide, kTf32> && kFits<WideHigh, kTf32x3> && kFits<FlatN, kTf32> &&
                  kFits<FlatN, kTf32x3>,
              "a TF32 tile exceeds a block's shared memory");

// ---- PTX ---------------------------------------------------------------------

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(unsigned long long* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

// Waits for the phase of parity `parity` to complete. The loop is inside
// the asm, so the compiler sees no divergent path before the next wgmma. A
// ring that never fills traps (an error the launch reports) after ~2^36
// clocks instead of holding the card.
__device__ __forceinline__ void mbar_wait(unsigned long long* bar, unsigned parity) {
  asm volatile(
      "{\n.reg .pred p;\n.reg .u64 t0, t1;\n"
      "mov.u64 t0, %%clock64;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@p bra DONE;\n"
      "mov.u64 t1, %%clock64;\n"
      "sub.u64 t1, t1, t0;\n"
      "setp.lt.u64 p, t1, 68719476736;\n"
      "@p bra WAIT;\n"
      "trap;\n"
      "DONE:\n}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(unsigned long long* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void mbar_arrive_tx(unsigned long long* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// the barrier's arrival once every cp.async this thread issued has landed
__device__ __forceinline__ void cp_async_arrive(unsigned long long* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         unsigned long long* bar, int c0, int c1, int c2,
                                         int rank) {
  const unsigned long long m = reinterpret_cast<unsigned long long>(map);
  if (rank == 3) {
    asm volatile(
        "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
        " [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
        "l"(m), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2)
        : "memory");
  } else {
    asm volatile(
        "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
        " [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
        "l"(m), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
        : "memory");
  }
}

template <int ID, int COUNT>
__device__ __forceinline__ void named_barrier() {
  asm volatile("bar.sync %0, %1;\n" ::"n"(ID), "n"(COUNT) : "memory");
}

// generic-proxy writes to shared memory made visible to wgmma's reads
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// all but the most recent group have completed
__device__ __forceinline__ void wgmma_wait_prior() {
  asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
}

// keeps the compiler from moving reads of accumulators above a wgmma wait
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// Where 16-byte chunk c of row f of a K-major tile of BK floats a row lies,
// in floats: rows of 4 * BK bytes, the chunk XOR-swizzled as wgmma's
// 128-byte (BK 32) or 64-byte (BK 16) swizzle does it: address bits [4, 7)
// or [4, 6) XOR bits [7, 10) or [7, 9), on a 1 KB-aligned tile
template <int BK>
__device__ __forceinline__ int kmajor_at(int f, int c) {
  return f * BK + 4 * (c ^ (((f * BK * 4) >> 7) & (BK / 4 - 1)));
}

// wgmma's shared-memory descriptor of a K-major swizzled tile: start
// address, leading offset 1 (unused), stride 8 rows, layout type 1
// (128-byte swizzle) or 2 (64-byte)
template <int BK>
__device__ __forceinline__ unsigned long long kmajor_desc(const float* tile) {
  constexpr unsigned long long sbo = (8 * BK * 4) >> 4;
  constexpr unsigned long long layout = BK == 32 ? 1 : 2;
  return ((smem_u32(tile) >> 4) & 0x3FFF) | (1ull << 16) | (sbo << 32) | (layout << 62);
}

// d (+)= A B over one m64nNk8 step, A's sign SA (the instruction's scale)
template <int N, int SA>
struct Wgmma;

template <int SA>
struct Wgmma<8, SA> {
  __device__ __forceinline__ static void run(float (&d)[4], unsigned long long da,
                                             unsigned long long db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n8k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3}, %4, %5, p, %7, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "l"(da), "l"(db), "r"(scale_d), "n"(SA));
  }
};

template <int SA>
struct Wgmma<128, SA> {
  __device__ __forceinline__ static void run(float (&d)[64], unsigned long long da,
                                             unsigned long long db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
        "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, "
        "%27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, "
        "%53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
        "%64, %65, p, %67, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
          "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
          "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
          "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
          "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]),
          "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]),
          "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]),
          "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
          "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(da), "l"(db), "r"(scale_d), "n"(SA));
  }
};

// ---- loads (the loading warpgroup, threads p = 0 .. 127) ----------------------

// Whether a source's raw tile is [k][f] (rows of FT free indices) or [f][k]
// (rows of BK contract indices)
__device__ __forceinline__ bool kf_layout(int mode) {
  return mode == gemm::kVec || mode == gemm::kWalkF || mode == kTma;
}

// One stage (contract indices k0 .. k0 + BK) of one operand's parts into its
// raw tiles rr, ri through cp.async: [k][f] for kVec (16 bytes along the
// stride-1 free index) and kWalkF (an element a copy, lanes along f), [f][k]
// for kVecK (16 bytes along the stride-1 contract index) and kWalkK (an
// element, lanes along k). Elements past K or F copy 0 bytes and read zero.
template <int FT, int BK, class Src>
__device__ __forceinline__ void load_stage(const Src& src, float* rr, float* ri, long long k0,
                                           int p) {
  using Offset = typename Src::Offset;
  // not unrolled: unrolled, the offsets hoisted out of the loops spill the
  // loading warpgroup's registers
  if (src.mode == gemm::kVec) {
    constexpr int CH = FT / 4;
    constexpr int NQ = BK * CH;
#pragma unroll 1
    for (int i = 0; i < (NQ + kProducers - 1) / kProducers; ++i) {
      const int q = p + i * kProducers;
      if (NQ % kProducers != 0 && q >= NQ) break;
      const int r = q / CH, c = q % CH;
      const long long k = k0 + r;
      const int bytes = k < src.K ? 4 * src.valid(4 * c, 4) : 0;
      const Offset off = bytes ? src.row(k) + src.col(4 * c) : Offset(0);
      gemm::cp_async_16(rr + r * FT + 4 * c, src.re + off, bytes);
      gemm::cp_async_16(ri + r * FT + 4 * c, src.im + off, bytes);
    }
  } else if (src.mode == gemm::kWalkF) {
    constexpr int NQ = BK * FT;
#pragma unroll 1
    for (int i = 0; i < (NQ + kProducers - 1) / kProducers; ++i) {
      const int q = p + i * kProducers;
      if (NQ % kProducers != 0 && q >= NQ) break;
      const int r = q / FT, ff = q % FT;
      const long long k = k0 + r;
      const int bytes = k < src.K && src.valid(ff, 1) ? 4 : 0;
      const Offset off = bytes ? src.row(k) + src.col(ff) : Offset(0);
      gemm::cp_async_elem<4>(rr + r * FT + ff, src.re + off, bytes);
      gemm::cp_async_elem<4>(ri + r * FT + ff, src.im + off, bytes);
    }
  } else if (src.mode == gemm::kWalkK) {
    constexpr int NQ = FT * BK;
#pragma unroll 1
    for (int i = 0; i < (NQ + kProducers - 1) / kProducers; ++i) {
      const int q = p + i * kProducers;
      if (NQ % kProducers != 0 && q >= NQ) break;
      const int ff = q / BK, r = q % BK;
      const long long k = k0 + r;
      const int bytes = k < src.K && src.valid(ff, 1) ? 4 : 0;
      const Offset off = bytes ? src.row(k) + src.col(ff) : Offset(0);
      gemm::cp_async_elem<4>(rr + ff * BK + r, src.re + off, bytes);
      gemm::cp_async_elem<4>(ri + ff * BK + r, src.im + off, bytes);
    }
  } else {  // kVecK
    constexpr int CPR = BK / 4;
    constexpr int NQ = FT * CPR;
#pragma unroll 1
    for (int i = 0; i < (NQ + kProducers - 1) / kProducers; ++i) {
      const int q = p + i * kProducers;
      if (NQ % kProducers != 0 && q >= NQ) break;
      const int ff = q / CPR, c = q % CPR;
      const long long k = k0 + 4 * c;
      const int bytes = k < src.K && src.valid(ff, 1) ? 16 : 0;
      const Offset off = bytes ? src.row(k) + src.col(ff) : Offset(0);
      gemm::cp_async_16(rr + ff * BK + 4 * c, src.re + off, bytes);
      gemm::cp_async_16(ri + ff * BK + 4 * c, src.im + off, bytes);
    }
  }
}

// An operand's two tensor maps (its parts, (F, K) or (F, K, batch) boxes of
// (FT, BK[, 1])), when its mode is kTma
struct Maps {
  const CUtensorMap* re;
  const CUtensorMap* im;
  int rank;
};

// ---- the conversion stage (the consumer warpgroups, threads c = 0 .. 255) ---

// x's bits rounded to TF32: to nearest, ties away from zero, the low 13 bits
// zero. Two integer operations on the bits, as the plain version rounds
// (split_complex.rna_tf32); bit for bit cvt.rna.tf32.f32 on finite values,
// which sm_90 runs as a five-instruction sequence.
__device__ __forceinline__ unsigned rna_bits(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
}

// hi = rna(x) of a chunk and, at kTf32x3, lo = rna(x - hi) (x - hi is exact)
template <int R>
__device__ __forceinline__ void round_chunk(const float (&x)[4], uint4& hi, uint4& lo) {
  unsigned h[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    h[i] = rna_bits(x[i]);
    l[i] = R == kTf32x3 ? rna_bits(x[i] - __uint_as_float(h[i])) : 0u;
  }
  hi = make_uint4(h[0], h[1], h[2], h[3]);
  lo = make_uint4(l[0], l[1], l[2], l[3]);
}

// One operand's raw tiles (rr, ri; FT free indices, [k][f] or [f][k] by
// mode) into its compute tiles (hr, hi_: rounded; at kTf32x3 also lr, li:
// the low parts), K-major and swizzled. Each thread writes whole 16-byte
// chunks (4 contract indices of one free index): from a [k][f] tile lanes
// walk f (4 conflict-free 32-bit reads, one swizzled 16-byte write), from a
// [f][k] tile they walk the row's chunks (one 16-byte read and write).
// Chunks from `nch` on (past the k8 steps the stage's wgmmas read) are
// skipped.
template <int FT, int BK, int R>
__device__ __forceinline__ void convert_operand(int mode, const float* rr, const float* ri,
                                                float* hr, float* hi_, float* lr, float* li,
                                                int c, int nch) {
  constexpr int CPR = BK / 4;
  constexpr int NCH = FT * CPR;  // chunks a part
  const bool kf = kf_layout(mode);
#pragma unroll 2
  for (int i = 0; i < (2 * NCH + kConsumers - 1) / kConsumers; ++i) {
    const int q = c + i * kConsumers;
    if ((2 * NCH) % kConsumers != 0 && q >= 2 * NCH) break;
    const int part = q / NCH, qq = q % NCH;
    const float* src = part ? ri : rr;
    int f, ch;
    float x[4];
    if (kf) {
      f = qq % FT;
      ch = qq / FT;
      if (ch >= nch) continue;
#pragma unroll
      for (int e = 0; e < 4; ++e) x[e] = src[(4 * ch + e) * FT + f];
    } else {
      f = qq / CPR;
      ch = qq % CPR;
      if (ch >= nch) continue;
      const float4 v = *reinterpret_cast<const float4*>(src + f * BK + 4 * ch);
      x[0] = v.x;
      x[1] = v.y;
      x[2] = v.z;
      x[3] = v.w;
    }
    uint4 h, l;
    round_chunk<R>(x, h, l);
    const int at = kmajor_at<BK>(f, ch);
    *reinterpret_cast<uint4*>((part ? hi_ : hr) + at) = h;
    if constexpr (R == kTf32x3) *reinterpret_cast<uint4*>((part ? li : lr) + at) = l;
  }
}

// ---- the tile ------------------------------------------------------------------

// Shared memory of a tile at rung R, from a 1 KB-aligned base: the kRaw
// raw slots, compute slots 0 and 1 (each its hi level, then at kTf32x3 its
// lo level), then the full and empty mbarriers of the raw slots.
template <class T, int R>
struct Smem {
  static constexpr int kLevels = R == kTf32x3 ? 2 : 1;
  static constexpr int kRaw = T::template kRaw<R>;
  unsigned char* base;
  __device__ __forceinline__ float* raw(int s, int i) const {
    return reinterpret_cast<float*>(base + s * T::kSlotBytes + part_offset(i));
  }
  // compute slot s, level lv (0 hi, 1 lo), part i (0 X re, 1 X im, 2 Y re,
  // 3 Y im)
  __device__ __forceinline__ float* comp(int s, int lv, int i) const {
    return reinterpret_cast<float*>(base + kRaw * T::kSlotBytes +
                                    (s * kLevels + lv) * T::kSlotBytes + part_offset(i));
  }
  __device__ __forceinline__ unsigned long long* full(int s) const {
    return reinterpret_cast<unsigned long long*>(base + (kRaw + 2 * kLevels) * T::kSlotBytes) +
           s;
  }
  __device__ __forceinline__ unsigned long long* empty(int s) const { return full(kRaw) + s; }
  // compute slot s converted by both warpgroups / read by both warpgroups'
  // wgmmas
  __device__ __forceinline__ unsigned long long* cfull(int s) const {
    return full(2 * kRaw) + s;
  }
  __device__ __forceinline__ unsigned long long* cfree(int s) const {
    return full(2 * kRaw + 2) + s;
  }
  __host__ __device__ static constexpr int part_offset(int i) {
    return i < 2 ? i * T::kXBytes : 2 * T::kXBytes + (i - 2) * T::kYBytes;
  }
  // the bytes past the barriers (the transpose kernel's offset tables)
  __device__ __forceinline__ unsigned char* tail() const {
    return base + (kRaw + 2 * kLevels) * T::kSlotBytes + 256;
  }
};

// The problem a launch computes: W = batch x tiles work items, each the
// (M, N) tile `tile` of batch row z; a source's origin within it
template <class T>
struct Work {
  long long tiles, items;
  int nk;  // stages of a work item
  long long K, M, N;
  __device__ __forceinline__ void origin(long long w, long long* z, long long* m0,
                                         long long* n0) const {
    *z = w / tiles;
    gemm::tile_origin<T>(w % tiles, M, N, m0, n0);
  }
};

// The loading warpgroup: for each work item of this block, `begin(z, x0,
// y0, p, tail)` (the X and Y operands' first free indices; `tail`: shared
// memory past the barriers) and then every stage:
// wait until its raw slot is free, `load(raw X re, X im, Y re, Y im, k0,
// bar, p)`, arrive on the slot's full barrier (with the TMA bytes
// `tma_bytes`, when an operand takes TMA boxes) once this thread's copies
// land.
template <class T, int R, class Loader>
__device__ __forceinline__ void produce(Loader& ld, const Work<T>& work, const Smem<T, R>& sm,
                                        unsigned tma_bytes) {
  const int p = threadIdx.x - kConsumers;
  int s = 0, phase = 1;  // the raw slot, and the parity its free phase waits on
  for (long long w = blockIdx.x; w < work.items; w += gridDim.x) {
    long long z, m0, n0;
    work.origin(w, &z, &m0, &n0);
    ld.begin(z, m0, n0, p, sm.tail());
    for (int t = 0; t < work.nk; ++t) {
      mbar_wait(sm.empty(s), static_cast<unsigned>(phase));
      if (p == 0) mbar_arrive_tx(sm.full(s), tma_bytes);
      ld.load(sm.raw(s, 0), sm.raw(s, 1), sm.raw(s, 2), sm.raw(s, 3),
              static_cast<long long>(t) * T::BK, sm.full(s), p);
      cp_async_arrive(sm.full(s));
      if (++s == Smem<T, R>::kRaw) {
        s = 0;
        phase ^= 1;
      }
    }
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");  // none outlives the block
}

// The consumer warpgroup of part P (0 re, 1 im): its wgmma chains over the
// compute slots, the conversion stage of the next stage beside them (both
// warpgroups share it), the folds, and the store of its part of each tile.
template <class T, int R, int P>
__device__ __forceinline__ void consume(const Work<T>& work, const Smem<T, R>& sm, int a_mode,
                                        int b_mode, float* cr, float* ci) {
  constexpr int MG = T::MG, YC = T::YC, BK = T::BK, KS = T::KS, NA = YC / 2;
  const int c = threadIdx.x;  // 0 .. 255
  // one stage at `high`; kDefaultChainK8 at `default`, whose error is the
  // operands' TF32 rounding (2^-11), not the chain's drift
  constexpr int chain = kChainK8 > 0 ? kChainK8 : R == kTf32x3 ? KS : kDefaultChainK8;
  // the conversion of the next stage from raw slot rs into compute slot cs
  int rs = 0, rphase = 0;
  // the k8 steps of stage t that hold contract indices below K: the last
  // stage of a short or ragged contraction (an outer product's K = 2) runs
  // and converts only those (with chains of whole stages, so a chain never
  // starts on a skipped step)
  auto k8_steps = [&](int t) {
    const long long left = work.K - static_cast<long long>(t) * BK;
    return left >= BK || chain % KS != 0 ? KS : static_cast<int>((left + 7) / 8);
  };
  auto convert = [&](int cs, int nk8) {
    const int s = rs;
    mbar_wait(sm.full(s), static_cast<unsigned>(rphase));
    if (++rs == Smem<T, R>::kRaw) {
      rs = 0;
      rphase ^= 1;
    }
    const int lo = R == kTf32x3 ? 1 : 0;
    convert_operand<T::XR, BK, R>(a_mode, sm.raw(s, 0), sm.raw(s, 1), sm.comp(cs, 0, 0),
                                  sm.comp(cs, 0, 1), sm.comp(cs, lo, 0), sm.comp(cs, lo, 1), c,
                                  2 * nk8);
    convert_operand<T::YC, BK, R>(b_mode, sm.raw(s, 2), sm.raw(s, 3), sm.comp(cs, 0, 2),
                                  sm.comp(cs, 0, 3), sm.comp(cs, lo, 2), sm.comp(cs, lo, 3), c,
                                  2 * nk8);
    mbar_arrive(sm.empty(s));
    fence_async_smem();
    mbar_arrive(sm.cfull(cs));
  };

  float acc[MG][NA], tot[MG][NA];
#pragma unroll
  for (int gm = 0; gm < MG; ++gm) {
#pragma unroll
    for (int i = 0; i < NA; ++i) acc[gm][i] = tot[gm][i] = 0.f;
  }
  const int last_k8 = work.nk * KS;

  // the products of k8 step s of compute slot cs into the chain (sd = 0
  // starts it): re (P 0) = xr yr - xi yi, im = xr yi + xi yr; at kTf32x3
  // each x y = xh yl + xl yh + xh yh, the small terms first
  auto issue = [&](int cs, int s, int sd) {
    const int yr = P == 0 ? 2 : 3;
    const int yi = P == 0 ? 3 : 2;
#pragma unroll
    for (int gm = 0; gm < MG; ++gm) {
      const int xo = gm * 64 * BK + 8 * s;  // floats: the m64 group, the k8 step
      auto d = [&](int lv, int i, int off) { return kmajor_desc<BK>(sm.comp(cs, lv, i) + off); };
      const unsigned long long yrh = d(0, yr, 8 * s), yih = d(0, yi, 8 * s);
      const unsigned long long xrh = d(0, 0, xo), xih = d(0, 1, xo);
      if constexpr (R == kTf32x3) {
        const unsigned long long yrl = d(1, yr, 8 * s), yil = d(1, yi, 8 * s);
        const unsigned long long xrl = d(1, 0, xo), xil = d(1, 1, xo);
        Wgmma<YC, 1>::run(acc[gm], xrh, yrl, sd);
        Wgmma<YC, 1>::run(acc[gm], xrl, yrh, 1);
        Wgmma<YC, P == 0 ? -1 : 1>::run(acc[gm], xih, yil, 1);
        Wgmma<YC, P == 0 ? -1 : 1>::run(acc[gm], xil, yih, 1);
        Wgmma<YC, 1>::run(acc[gm], xrh, yrh, 1);
      } else {
        Wgmma<YC, 1>::run(acc[gm], xrh, yrh, sd);
      }
      Wgmma<YC, P == 0 ? -1 : 1>::run(acc[gm], xih, yih, 1);
    }
  };
  // after a chain ends (its wgmmas waited for)
  auto fold = [&]() {
#pragma unroll
    for (int gm = 0; gm < MG; ++gm) {
      fence_regs(acc[gm]);
#pragma unroll
      for (int i = 0; i < NA; ++i) tot[gm][i] += acc[gm][i];
    }
  };
  auto chain_end = [&](int j) { return (j + 1) % chain == 0 || j + 1 == last_k8; };

  const int lc = c % 128, warp = lc / 32, lane = lc % 32;
  float* const out = P == 0 ? cr : ci;
  // Stage g's compute slot is g % 2: converted by both warpgroups (cfull),
  // then read by both warpgroups' wgmmas, freed by each warpgroup once its
  // wgmmas of the stage have completed (cfree). A stage's wgmmas stay in
  // flight while the next stage is converted; the warpgroup waits for them
  // all only where its chain ends (to fold the accumulators), else only for
  // the stage before (wgmma.wait_group 1) before it frees that slot.
  int g = 0;          // the stages this block has computed
  int inflight = -1;  // a stage whose wgmmas this warpgroup has not waited for
  auto release = [&]() {
    if (inflight >= 0) mbar_arrive(sm.cfree(inflight & 1));
    inflight = -1;
  };
  if (blockIdx.x < work.items && work.nk > 0) convert(0, k8_steps(0));
  for (long long w = blockIdx.x; w < work.items; w += gridDim.x) {
    for (int t = 0; t < work.nk; ++t, ++g) {
      const int cs = g & 1;
      mbar_wait(sm.cfull(cs), static_cast<unsigned>((g >> 1) & 1));
      wgmma_fence();
      const int nk8 = k8_steps(t);
#pragma unroll
      for (int s = 0; s < KS; ++s) {
        const int j = t * KS + s;
        if (s < nk8) issue(cs, s, j % chain != 0);
        if (s + 1 < KS && chain_end(j)) {
          wgmma_commit();
          wgmma_wait();
          release();
          fold();
          wgmma_fence();
        }
      }
      wgmma_commit();
      if (inflight >= 0) {
        wgmma_wait_prior();  // the stage before has completed
        release();
      }
      inflight = g;
      if (t + 1 < work.nk || w + gridDim.x < work.items) {
        // slot (g + 1) % 2 last held stage g - 1: both warpgroups freed it
        if (g >= 1) mbar_wait(sm.cfree((g + 1) & 1), static_cast<unsigned>(((g - 1) >> 1) & 1));
        convert((g + 1) & 1, k8_steps(t + 1 < work.nk ? t + 1 : 0));
      }
      if (chain_end(t * KS + KS - 1)) {
        wgmma_wait();
        release();
        fold();
      }
    }
    // the store: accumulator i of group gm is row 64 gm + 16 warp + lane / 4
    // (+ 8 for i % 4 >= 2) and column 8 (i / 4) + 2 (lane % 4) + i % 2 of
    // the X x Y tile
    long long z, m0, n0;
    work.origin(w, &z, &m0, &n0);
    float* const o = out + z * work.M * work.N;
#pragma unroll
    for (int gm = 0; gm < MG; ++gm) {
#pragma unroll
      for (int i = 0; i < NA; i += 2) {
        const int xrow = 64 * gm + 16 * warp + lane / 4 + ((i % 4) >= 2 ? 8 : 0);
        const int ycol = 8 * (i / 4) + 2 * (lane % 4);
        const long long m = m0 + xrow, n = n0 + ycol;
        if (m < work.M) {
          const long long at = m * work.N + n;
          if (n + 1 < work.N && (reinterpret_cast<unsigned long long>(o + at) & 7) == 0) {
            *reinterpret_cast<float2*>(o + at) = make_float2(tot[gm][i], tot[gm][i + 1]);
          } else {
            if (n < work.N) o[at] = tot[gm][i];
            if (n + 1 < work.N) o[at + 1] = tot[gm][i + 1];
          }
        }
        tot[gm][i] = tot[gm][i + 1] = 0.f;
      }
    }
  }
}

// The whole block: barriers, then one branch per role that never rejoins
// (setmaxnreg needs it). `ld`: the loading warpgroup's sources.
template <class T, int R, class Loader>
__device__ __forceinline__ void run_tile(Loader& ld, const Work<T>& work, unsigned char* smem,
                                         int a_mode, int b_mode, float* cr, float* ci,
                                         unsigned tma_bytes) {
  // aligned by pointer arithmetic on the shared array, so the compiler keeps
  // every access in the shared state space (LDS / STS, 32-bit addresses)
  const Smem<T, R> sm{smem + ((1024u - (smem_u32(smem) & 1023u)) & 1023u)};
  if (threadIdx.x == 0) {
    for (int s = 0; s < Smem<T, R>::kRaw; ++s) {
      mbar_init(sm.full(s), kProducers + 1);
      mbar_init(sm.empty(s), kConsumers);
    }
    for (int s = 0; s < 2; ++s) {
      mbar_init(sm.cfull(s), kConsumers);
      mbar_init(sm.cfree(s), kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  // the warpgroup, read through a shuffle from lane 0 so that the compiler
  // knows every branch below is uniform across each warpgroup (else it
  // serialises the wgmmas in them)
  const int wg = __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x) / 128, 0);
  if (wg == 2) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    produce<T, R>(ld, work, sm, tma_bytes);
  } else if (wg == 0) {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
    consume<T, R, 0>(work, sm, a_mode, b_mode, cr, ci);
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
    consume<T, R, 1>(work, sm, a_mode, b_mode, cr, ci);
  }
}

// A launch's grid: one persistent block an SM at most, never more blocks
// than work items
inline int persistent_grid(long long items) {
  static int sms[64] = {0};
  int device = 0;
  if (cudaGetDevice(&device) != cudaSuccess || device < 0 || device >= 64) return 0;
  if (sms[device] == 0 &&
      cudaDeviceGetAttribute(&sms[device], cudaDevAttrMultiProcessorCount, device) !=
          cudaSuccess)
    return 0;
  return static_cast<int>(items < sms[device] ? items : sms[device]);
}

}  // namespace tf32
}  // namespace tnc
