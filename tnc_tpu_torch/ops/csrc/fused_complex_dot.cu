// fused_complex_dot: one split-complex product, both outputs in one pass.
//
// Replaces the TPU kernel tnc_tpu/ops/pallas_complex.py::fused_complex_dot_kl
// (re = ar^T br - ai^T bi, im = ar^T bi + ai^T br for contract-first
// A: (K, M), B: (K, N), accumulated in the operand type).
//
// What bounds it on an H100: at the shapes the forced `fused` rung gives it
// (K >= 128 on the heavy steps) it does 6*K*M*N FP32 operations (three
// real products per complex multiply-add) for 8*(K*M + K*N + M*N) bytes,
// far above the card's 20 FP32-operations-per-byte ridge (67 TFLOP/s over
// 3.35 TB/s), so it is bound by operations on the CUDA cores. The design
// (complex_gemm.cuh's direct pipeline) keeps the FMA pipe fed: a
// three-stage cp.async ring in dynamic shared memory hides the loads, the
// Gauss identity cuts the multiplies to three, the B side's sums are
// formed once per stage in shared memory, and a 128 x 64 tile with an
// 8 x 4 register micro-tile read through 128-bit shared loads spends 7
// loads and 8 adds on 96 FMAs per contract index. Both operands are
// Strided sources: 16-byte copies when the free index has stride 1 and
// rows are 16-byte aligned (the contract-first operands of the main path),
// else one element per copy. The wrapper (cuda_complex.fused_complex_dot)
// picks the tile variant and the copy modes. This replaces a
// single-buffered 64 x 64 tile with scalar shared loads and four products
// per complex multiply-add.
//
// Dot-precision rungs (the reference's `precision`, a launch argument of
// the float entry): float32 runs the FMA engine above; `high` (3xTF32) and
// `default` (one TF32 pass) run the engine's tensor-core tile
// (complex_gemm_tile_tc: mma.sync m16n8k8 on operands rounded with
// cvt.rna.tf32.f32, the four naive products, 12 and 4 mma a k8 step and
// tile) on the same ring. There the bound is 8*K*M*N*passes TF32
// operations over the tensor cores' 494.7 TFLOP/s, or the bytes, whichever
// is larger. At a TF32 rung every float32 step of the split path outside
// the chains and fused_transpose_dot comes here, whatever its mode; where
// the output's tiles and the batch give the card few blocks, the wrapper
// cuts a long contraction into pieces launched as batch rows and sums them
// (cuda_complex.split_k_pieces). wgmma and TMA are later work; double
// ignores the rung.
//
// Slice batch (the reference's jax.vmap of the kernel in its chunked
// executor): the batch is the grid's y dimension. Block row z reads each
// operand at base + z * batch stride, a stride of 0 for an operand every
// slice shares (never copied per slice), and writes its (M, N) outputs at
// z * M * N. The 16-byte copy mode needs every row's base aligned, which
// the wrapper checks on the batch stride too.
#include <cuda_runtime.h>

#include "complex_gemm.cuh"

namespace {

namespace g = tnc::gemm;

template <class Cfg, int R>
__global__ void __launch_bounds__(g::kThreads, 1)
    fused_complex_dot_kernel(g::Strided<typename Cfg::T> a, long long a_sb,
                             g::Strided<typename Cfg::T> b, long long b_sb,
                             long long K, long long M, long long N,
                             typename Cfg::T* cr, typename Cfg::T* ci) {
  using T = typename Cfg::T;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
  const long long z = blockIdx.y;
  a.re += z * a_sb;
  a.im += z * a_sb;
  b.re += z * b_sb;
  b.im += z * b_sb;
  cr += z * M * N;
  ci += z * M * N;
  const long long tiles = g::tile_count<Cfg>(M, N);
  for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    long long m0, n0;
    g::tile_origin<Cfg>(tile, M, N, &m0, &n0);
    a.f0 = m0;
    b.f0 = n0;
    if constexpr (R == g::kFp32) {
      g::complex_gemm_tile<Cfg, false>(a, b, K, M, N, m0, n0, cr, ci, smem);
    } else {
      g::complex_gemm_tile_tc<Cfg, false, R>(a, b, K, M, N, m0, n0, cr, ci, smem);
    }
    __syncthreads();  // the next tile refills the ring
  }
}

template <class Cfg, int R>
int launch(const typename Cfg::T* ar, const typename Cfg::T* ai,
           long long a_sb, long long a_sk, long long a_sf, int a_mode,
           const typename Cfg::T* br, const typename Cfg::T* bi,
           long long b_sb, long long b_sk, long long b_sf, int b_mode,
           typename Cfg::T* cr, typename Cfg::T* ci, int batch, long long K,
           long long M, long long N, void* stream) {
  static bool done[64] = {false};
  // the direct pipeline reads every tile as [k][f]
  if (a_mode == g::kVecK || b_mode == g::kVecK)
    return static_cast<int>(cudaErrorInvalidValue);
  if (batch < 1 || batch > 65535) return static_cast<int>(cudaErrorInvalidValue);
  constexpr size_t bytes = R == g::kFp32 ? Cfg::kTileBytes : Cfg::kTcTileBytes;
  const int rc = g::prepare(fused_complex_dot_kernel<Cfg, R>, bytes, done);
  if (rc != 0) return rc;
  const long long tiles = g::tile_count<Cfg>(M, N);
  if (tiles == 0) return 0;
  const long long grid = tiles < (1LL << 30) ? tiles : (1LL << 30);
  const g::Strided<typename Cfg::T> a{ar, ai, a_sk, a_sf, K, M, a_mode, 0};
  const g::Strided<typename Cfg::T> b{br, bi, b_sk, b_sf, K, N, b_mode, 0};
  const dim3 blocks(static_cast<unsigned int>(grid),
                    static_cast<unsigned int>(batch));
  fused_complex_dot_kernel<Cfg, R>
      <<<blocks, g::kThreads, bytes, static_cast<cudaStream_t>(stream)>>>(
          a, a_sb, b, b_sb, K, M, N, cr, ci);
  return static_cast<int>(cudaGetLastError());
}

// A float launch at rung R on tile variant `variant`
template <int R>
int launch_float(const float* ar, const float* ai, long long a_sb,
                 long long a_sk, long long a_sf, int a_mode, const float* br,
                 const float* bi, long long b_sb, long long b_sk, long long b_sf,
                 int b_mode, float* cr, float* ci, int batch, long long K,
                 long long M, long long N, int variant, void* stream) {
  using Tiles = g::FloatTiles<R>;
  if (variant == 0)
    return launch<typename Tiles::Wide, R>(ar, ai, a_sb, a_sk, a_sf, a_mode, br,
                                           bi, b_sb, b_sk, b_sf, b_mode, cr, ci,
                                           batch, K, M, N, stream);
  if (variant == 1)
    return launch<typename Tiles::Narrow, R>(ar, ai, a_sb, a_sk, a_sf, a_mode,
                                             br, bi, b_sb, b_sk, b_sf, b_mode, cr,
                                             ci, batch, K, M, N, stream);
  if (variant == 2)
    return launch<typename Tiles::Flat, R>(ar, ai, a_sb, a_sk, a_sf, a_mode, br,
                                           bi, b_sb, b_sk, b_sf, b_mode, cr, ci,
                                           batch, K, M, N, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

// a_mode / b_mode: each operand's copy mode (tnc::gemm::Mode); a_sb / b_sb:
// each operand's batch stride (0: shared by every row); batch: grid rows (1
// unbatched); variant: 0 = 128 x 64 tiles, 1 = 64 x 64, 2 = 8 x 512; rung:
// 0 = float32 (FMA), 1 = high (3xTF32), 2 = default (TF32) (tnc::gemm::Rung).
int tnc_fused_complex_dot_f32(const float* ar, const float* ai, long long a_sb,
                              long long a_sk, long long a_sf, int a_mode,
                              const float* br, const float* bi, long long b_sb,
                              long long b_sk, long long b_sf, int b_mode,
                              float* cr, float* ci, int batch, long long K,
                              long long M, long long N, int variant, int rung,
                              void* stream) {
  if (rung == g::kFp32)
    return launch_float<g::kFp32>(ar, ai, a_sb, a_sk, a_sf, a_mode, br, bi, b_sb,
                                  b_sk, b_sf, b_mode, cr, ci, batch, K, M, N,
                                  variant, stream);
  if (rung == g::kTf32x3)
    return launch_float<g::kTf32x3>(ar, ai, a_sb, a_sk, a_sf, a_mode, br, bi,
                                    b_sb, b_sk, b_sf, b_mode, cr, ci, batch, K,
                                    M, N, variant, stream);
  if (rung == g::kTf32)
    return launch_float<g::kTf32>(ar, ai, a_sb, a_sk, a_sf, a_mode, br, bi, b_sb,
                                  b_sk, b_sf, b_mode, cr, ci, batch, K, M, N,
                                  variant, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

// variant: 3 (64 x 64 tiles of doubles)
int tnc_fused_complex_dot_f64(const double* ar, const double* ai,
                              long long a_sb, long long a_sk, long long a_sf,
                              int a_mode, const double* br, const double* bi,
                              long long b_sb, long long b_sk, long long b_sf,
                              int b_mode, double* cr, double* ci, int batch,
                              long long K, long long M, long long N, int variant,
                              void* stream) {
  if (variant == 3)
    return launch<g::Double, g::kFp32>(ar, ai, a_sb, a_sk, a_sf, a_mode, br, bi,
                                       b_sb, b_sk, b_sf, b_mode, cr, ci, batch, K,
                                       M, N, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* tnc_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
