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
// `default` (one TF32 pass) run tf32_tile.cuh's tile: wgmma on operands
// rounded once with cvt.rna.tf32.f32 into K-major swizzled shared-memory
// tiles, TMA boxes for the operands whose free index has stride 1 (the
// main path's), behind an mbarrier ring with a loading warpgroup. There the
// bound is 8*K*M*N*passes TF32 operations over the tensor cores' 494.7
// TFLOP/s, or the bytes, whichever is larger. At a TF32 rung every float32
// step of the split path outside the chains and fused_transpose_dot comes
// here, whatever its mode; where the output's tiles and the batch give the
// card few blocks, the wrapper cuts a long contraction into pieces launched
// as batch rows and sums them (cuda_complex.split_k_pieces). The launches
// of fewer than 2^30 multiply-adds and those with M <= 8 run complex_gemm.cuh's
// mma.sync tiles instead (tile variants 2-4; tf32_tile.cuh says why).
// double ignores the rung.
//
// Slice batch (the reference's jax.vmap of the kernel in its chunked
// executor): the batch is the grid's y dimension. Block row z reads each
// operand at base + z * batch stride, a stride of 0 for an operand every
// slice shares (never copied per slice), and writes its (M, N) outputs at
// z * M * N. The 16-byte copy mode needs every row's base aligned, which
// the wrapper checks on the batch stride too.
#include <cuda.h>
#include <cuda_runtime.h>

#include "complex_gemm.cuh"
#include "tf32_tile.cuh"

namespace {

namespace g = tnc::gemm;
namespace tf = tnc::tf32;

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

// A float32 launch of the FMA engine on tile variant `variant`
int launch_fp32(const float* ar, const float* ai, long long a_sb, long long a_sk,
                long long a_sf, int a_mode, const float* br, const float* bi,
                long long b_sb, long long b_sk, long long b_sf, int b_mode, float* cr,
                float* ci, int batch, long long K, long long M, long long N, int variant,
                void* stream) {
  if (variant == 0)
    return launch<g::Wide, g::kFp32>(ar, ai, a_sb, a_sk, a_sf, a_mode, br, bi, b_sb, b_sk,
                                     b_sf, b_mode, cr, ci, batch, K, M, N, stream);
  if (variant == 1)
    return launch<g::Narrow, g::kFp32>(ar, ai, a_sb, a_sk, a_sf, a_mode, br, bi, b_sb, b_sk,
                                       b_sf, b_mode, cr, ci, batch, K, M, N, stream);
  if (variant == 2)
    return launch<g::Flat, g::kFp32>(ar, ai, a_sb, a_sk, a_sf, a_mode, br, bi, b_sb, b_sk,
                                     b_sf, b_mode, cr, ci, batch, K, M, N, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

// ---- the TF32 rungs ----------------------------------------------------------

// The loading warpgroup's view of the two strided operands: each work item
// (batch row z, first free indices x0 / y0 of the X and Y operands) read
// through its strides by cp.async, or as TMA boxes at (f0, k0[, z]).
template <class T>
struct StridedLoader {
  const g::Strided<float>& a;
  const g::Strided<float>& b;
  long long a_sb, b_sb;
  tf::Maps ma, mb;
  long long z, x0, y0;

  __device__ __forceinline__ void begin(long long zz, long long xx, long long yy, int,
                                        unsigned char*) {
    z = zz;
    x0 = xx;
    y0 = yy;
  }

  template <int FT>
  __device__ __forceinline__ void one(const g::Strided<float>& base, long long sb,
                                      const tf::Maps& maps, long long f0, float* rr, float* ri,
                                      long long k0, unsigned long long* bar, int p) const {
    if (base.mode == tf::kTma) {
      if (p == 0) {
        const int c2 = maps.rank == 3 ? static_cast<int>(z) : 0;
        tf::tma_load(rr, maps.re, bar, static_cast<int>(f0), static_cast<int>(k0), c2,
                     maps.rank);
        tf::tma_load(ri, maps.im, bar, static_cast<int>(f0), static_cast<int>(k0), c2,
                     maps.rank);
      }
      return;
    }
    g::Strided<float> src = base;
    src.re += z * sb;
    src.im += z * sb;
    src.f0 = f0;
    tf::load_stage<FT, T::BK>(src, rr, ri, k0, p);
  }

  __device__ __forceinline__ void load(float* xr, float* xi, float* yr, float* yi,
                                       long long k0, unsigned long long* bar, int p) const {
    one<T::XR>(a, a_sb, ma, x0, xr, xi, k0, bar, p);
    one<T::YC>(b, b_sb, mb, y0, yr, yi, k0, bar, p);
  }
};

template <class T, int R>
__global__ void __launch_bounds__(tf::kThreads, 1)
    fused_complex_dot_tf32_kernel(g::Strided<float> a, long long a_sb, g::Strided<float> b,
                                  long long b_sb, tf::Work<T> work, float* cr, float* ci,
                                  unsigned tma_bytes,
                                  const __grid_constant__ CUtensorMap ma_re,
                                  const __grid_constant__ CUtensorMap ma_im, int a_rank,
                                  const __grid_constant__ CUtensorMap mb_re,
                                  const __grid_constant__ CUtensorMap mb_im, int b_rank) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  StridedLoader<T> ld{a, b, a_sb, b_sb, {&ma_re, &ma_im, a_rank}, {&mb_re, &mb_im, b_rank},
                      0, 0, 0};
  tf::run_tile<T, R>(ld, work, smem_raw, a.mode, b.mode, cr, ci, tma_bytes);
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// libcuda's cuTensorMapEncodeTiled, through the runtime's entry-point query
// (no -lcuda at link time)
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                           cudaEnableDefault, &q);
#else
    const cudaError_t e =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (e == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// The tensor map of one part of a (batch, K, F) operand whose free index has
// stride 1: dims (F, K[, batch]), boxes of (ft, bk[, 1]) elements; 3-D only
// when batch rows differ (a batch stride of 0 reads one matrix). Returns 0,
// or a CUDA error code when the encoding is refused.
int encode_part(CUtensorMap* map, const float* base, long long F, long long K, long long batch,
                long long sk, long long sb, int ft, int bk, int* rank) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return static_cast<int>(cudaErrorNotSupported);
  *rank = sb != 0 && batch > 1 ? 3 : 2;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(F), static_cast<cuuint64_t>(K),
                              static_cast<cuuint64_t>(batch)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(sk) * 4,
                                 static_cast<cuuint64_t>(sb) * 4};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(ft), static_cast<cuuint32_t>(bk), 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, static_cast<cuuint32_t>(*rank),
                        const_cast<float*>(base), dims, strides, box, unit,
                        CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

// A TF32 launch at rung R on tile T: an operand copied in 16-byte vectors
// along its stride-1 free index (kVec) whose rows do not overlap takes TMA
// boxes instead; the block is persistent over batch x tiles work items.
template <class T, int R>
int launch_tf32(const float* ar, const float* ai, long long a_sb, long long a_sk,
                long long a_sf, int a_mode, const float* br, const float* bi, long long b_sb,
                long long b_sk, long long b_sf, int b_mode, float* cr, float* ci, int batch,
                long long K, long long M, long long N, void* stream) {
  static bool done[64] = {false};
  if (a_mode == g::kVecK || b_mode == g::kVecK)
    return static_cast<int>(cudaErrorInvalidValue);
  if (batch < 1 || batch > 65535) return static_cast<int>(cudaErrorInvalidValue);
  constexpr size_t bytes = tf::kTileBytes<T, R>;
  const int rc = g::prepare(fused_complex_dot_tf32_kernel<T, R>, bytes, done);
  if (rc != 0) return rc;
  const long long tiles = g::tile_count<T>(M, N);
  if (tiles == 0) return 0;
  const tf::Work<T> work{tiles, tiles * batch, static_cast<int>((K + T::BK - 1) / T::BK), K, M, N};
  const int grid = tf::persistent_grid(work.items);
  if (grid <= 0) return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap maps[4] = {};
  int ranks[2] = {2, 2};
  unsigned tma_bytes = 0;
  // operand 0 (A: M free indices, the X side), 1 (B: the Y side)
  const float* parts[2][2] = {{ar, ai}, {br, bi}};
  const long long sk[2] = {a_sk, b_sk}, sb[2] = {a_sb, b_sb}, F[2] = {M, N};
  int modes[2] = {a_mode, b_mode};
  for (int o = 0; o < 2; ++o) {
    const int ft = o == 0 ? T::XR : T::YC;
    if (modes[o] != g::kVec || K == 0 || sk[o] < F[o] || (sb[o] != 0 && sb[o] < sk[o] * K))
      continue;
    for (int part = 0; part < 2; ++part) {
      const int e = encode_part(&maps[2 * o + part], parts[o][part], F[o], K, batch, sk[o],
                                sb[o], ft, T::BK, &ranks[o]);
      if (e != 0) return e;
    }
    modes[o] = tf::kTma;
    tma_bytes += 2u * ft * T::BK * 4u;
  }
  const g::Strided<float> a{ar, ai, a_sk, a_sf, K, M, modes[0], 0};
  const g::Strided<float> b{br, bi, b_sk, b_sf, K, N, modes[1], 0};
  fused_complex_dot_tf32_kernel<T, R>
      <<<grid, tf::kThreads, bytes, static_cast<cudaStream_t>(stream)>>>(
          a, a_sb, b, b_sb, work, cr, ci, tma_bytes, maps[0], maps[1], ranks[0],
          maps[2], maps[3], ranks[1]);
  return static_cast<int>(cudaGetLastError());
}

// A TF32 launch at rung R on tile `variant`: the wgmma tile's 0 wide, 1
// flat_n, or the mma.sync tile's 2 mma_flat, 3 mma_wide, 4 mma_narrow
// (cuda_complex.tf32_config chooses)
template <int R>
int launch_tf32_variant(const float* ar, const float* ai, long long a_sb, long long a_sk,
                        long long a_sf, int a_mode, const float* br, const float* bi,
                        long long b_sb, long long b_sk, long long b_sf, int b_mode, float* cr,
                        float* ci, int batch, long long K, long long M, long long N,
                        int variant, void* stream) {
  using Wide = std::conditional_t<R == g::kTf32, tf::Wide, tf::WideHigh>;
  if (variant == 0)
    return launch_tf32<Wide, R>(ar, ai, a_sb, a_sk, a_sf, a_mode, br, bi, b_sb, b_sk, b_sf,
                                b_mode, cr, ci, batch, K, M, N, stream);
  if (variant == 1)
    return launch_tf32<tf::FlatN, R>(ar, ai, a_sb, a_sk, a_sf, a_mode, br, bi, b_sb, b_sk,
                                     b_sf, b_mode, cr, ci, batch, K, M, N, stream);
  if (variant == 2)
    return launch<g::FlatTc, R>(ar, ai, a_sb, a_sk, a_sf, a_mode, br, bi, b_sb, b_sk, b_sf,
                                b_mode, cr, ci, batch, K, M, N, stream);
  if (variant == 3)
    return launch<g::WideTc, R>(ar, ai, a_sb, a_sk, a_sf, a_mode, br, bi, b_sb, b_sk, b_sf,
                                b_mode, cr, ci, batch, K, M, N, stream);
  if (variant == 4)
    return launch<g::NarrowTc, R>(ar, ai, a_sb, a_sk, a_sf, a_mode, br, bi, b_sb, b_sk, b_sf,
                                  b_mode, cr, ci, batch, K, M, N, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

// a_mode / b_mode: each operand's copy mode (tnc::gemm::Mode); a_sb / b_sb:
// each operand's batch stride (0: shared by every row); batch: grid rows (1
// unbatched); rung: 0 = float32 (FMA), 1 = high (3xTF32), 2 = default (TF32)
// (tnc::gemm::Rung); variant: at float32 0 = 128 x 64 tiles, 1 = 64 x 64,
// 2 = 8 x 512; at a TF32 rung the tile of tf32_tile.cuh (0 wide, 1 flat_n)
// or complex_gemm.cuh's mma.sync tiles (2 8 x 512, 3 128 x 64, 4 64 x 64;
// cuda_complex.tf32_config chooses).
int tnc_fused_complex_dot_f32(const float* ar, const float* ai, long long a_sb,
                              long long a_sk, long long a_sf, int a_mode,
                              const float* br, const float* bi, long long b_sb,
                              long long b_sk, long long b_sf, int b_mode,
                              float* cr, float* ci, int batch, long long K,
                              long long M, long long N, int variant, int rung,
                              void* stream) {
  if (rung == g::kFp32)
    return launch_fp32(ar, ai, a_sb, a_sk, a_sf, a_mode, br, bi, b_sb, b_sk, b_sf, b_mode,
                       cr, ci, batch, K, M, N, variant, stream);
  if (rung == g::kTf32x3)
    return launch_tf32_variant<g::kTf32x3>(ar, ai, a_sb, a_sk, a_sf, a_mode, br, bi, b_sb,
                                           b_sk, b_sf, b_mode, cr, ci, batch, K, M, N,
                                           variant, stream);
  if (rung == g::kTf32)
    return launch_tf32_variant<g::kTf32>(ar, ai, a_sb, a_sk, a_sf, a_mode, br, bi, b_sb,
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
