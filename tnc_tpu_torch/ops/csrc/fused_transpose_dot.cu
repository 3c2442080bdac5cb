// fused_transpose_dot: a split-complex product whose operands are read in
// their raw stored macro views, the permutation applied while tiles are
// fetched, so no transposed copy is ever written.
//
// Replaces the TPU kernel
// tnc_tpu/ops/pallas_complex.py::fused_transpose_dot_kl. Each operand is a
// stored tensor whose axes split into contract and free axes. The logical
// (K, F) matrix the product reads has element (k, f) at
//
//   off_k[k] + off_f[f]
//
// because the two axis sets partition the stored axes: each term is the
// mixed-radix digits of the flat index times the stored strides. The
// wrapper (cuda_complex.fused_transpose_dot) computes the two offset
// tables of each operand on the device, once per layout and strides, as
// int32 when every offset of both operands fits (the PEPS operands hold at
// most 2^24 elements) and int64 otherwise; the kernel only adds and loads.
// The result is the flat row-major (M, N) pair
//   re = ar^T br - ai^T bi,   im = ar^T bi + ai^T br
// with rows iterating the first operand's free digits and columns the
// second's, exactly what the plain view + permute + reshape + matmul path
// gives, so callers reshape it to the step's stored output unchanged.
//
// What bounds it on an H100: on the PEPS steps it takes (K = 32 and 1024,
// M and N 64 to 16384) the product does 6*K*M*N FP32 operations (three
// real products per complex multiply-add) on operands of 8*(K*M + K*N)
// bytes read once, far above the card's ~20 operations per byte, so it is
// bound by operations on the CUDA cores, as fused_complex_dot is. What the
// TPU kernel saved, the HBM pass of the materialised transpose, is saved
// here too: each operand element goes from device memory straight into
// the shared-memory ring.
//
// Design. The arithmetic, tiles and accumulation are complex_gemm.cuh's,
// the same engine as fused_complex_dot; what differs is the source. At the
// start of an output tile the block copies the free offsets of its rows
// and columns into shared memory; a stage's copies read the contract
// offset of each contract index or vector they copy once (an L1-resident
// table), so a copy costs one add. The gate (transpose_dot_ineligible_reason,
// minor_axes) puts each operand's fastest contract and free digits on its
// two stored minor axes, so one of them has stride 1, and the wrapper picks
// the copy mode from it (cuda_complex.gather_copy_mode):
//
// - free index stride 1 (k_unit = 0), its stored digit a multiple of 4 and
//   every other stride and the base 16-byte aligned: 16-byte cp.async
//   along it into the [k][f] tile the arithmetic reads (four consecutive
//   free indices stay within one digit run);
// - contract index stride 1 (k_unit = 1; PEPS steps 2/3/6/7 and 18/19 on
//   both operands), aligned likewise and with int32 tables: 16-byte
//   cp.async of four consecutive contract indices into a K-fastest tile,
//   transposed per stage into the [k][f] layout through registers (the
//   engine's staged pipeline, taken whenever an operand is read this way).
//   Element copies into the [k][f] tile instead were slower on PEPS
//   steps 18/19, and reading K-fastest fragments directly would need four
//   contract indices of every fragment live at once;
// - otherwise one element per copy, lanes walking the stride-1 index.
//
// Ragged edges are bounds-checked (a free offset of -1 marks a row or
// column past the end; such elements copy 0 bytes and are not stored).
//
// Dot-precision rungs (a launch argument of the float entry, as in
// fused_complex_dot.cu): float32 runs the FMA engine; `high` (3xTF32) and
// `default` (one TF32 pass) run tf32_tile.cuh's wgmma tile on the same
// gathered sources, loaded by cp.async into raw slots in the copy mode's
// layout ([k][f] along a stride-1 free index, [f][k] along a stride-1
// contract index) and rounded into K-major compute slots by its conversion
// stage; the loading warpgroup keeps each tile's free offsets in shared
// memory. The launches of fewer than 2^30 multiply-adds, those with M <= 8
// and those with int64 offset tables run complex_gemm.cuh's mma.sync tiles
// instead (tile variants 2-4). double ignores the rung.
#include <cuda_runtime.h>

#include "complex_gemm.cuh"
#include "tf32_tile.cuh"

namespace {

namespace g = tnc::gemm;
namespace tf = tnc::tf32;

template <class Cfg, bool kStaged, int R>
__host__ __device__ constexpr size_t tile_bytes() {
  if (R == g::kFp32) return kStaged ? Cfg::kStagedBytes : Cfg::kTileBytes;
  return kStaged ? Cfg::kTcStagedBytes : Cfg::kTcTileBytes;
}

template <class Cfg, typename Off, bool kStaged, int R>
__global__ void __launch_bounds__(g::kThreads, 1)
    fused_transpose_dot_kernel(g::Gathered<typename Cfg::T, Off> a,
                               g::Gathered<typename Cfg::T, Off> b,
                               long long K, long long M, long long N,
                               typename Cfg::T* cr, typename Cfg::T* ci) {
  using T = typename Cfg::T;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
  Off* a_off = reinterpret_cast<Off*>(smem_raw + tile_bytes<Cfg, kStaged, R>());
  Off* b_off = a_off + Cfg::BM;
  a.tile_off = a_off;
  b.tile_off = b_off;
  const int tid = threadIdx.x;
  const long long tiles = g::tile_count<Cfg>(M, N);
  for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    long long m0, n0;
    g::tile_origin<Cfg>(tile, M, N, &m0, &n0);
    for (int i = tid; i < Cfg::BM + Cfg::BN; i += g::kThreads) {
      if (i < Cfg::BM) {
        const long long m = m0 + i;
        a_off[i] = m < M ? __ldg(a.off_f + m) : Off(-1);
      } else {
        const long long n = n0 + (i - Cfg::BM);
        b_off[i - Cfg::BM] = n < N ? __ldg(b.off_f + n) : Off(-1);
      }
    }
    __syncthreads();
    if constexpr (R == g::kFp32) {
      g::complex_gemm_tile<Cfg, kStaged>(a, b, K, M, N, m0, n0, cr, ci, smem);
    } else {
      g::complex_gemm_tile_tc<Cfg, kStaged, R>(a, b, K, M, N, m0, n0, cr, ci,
                                               smem);
    }
    __syncthreads();  // the next tile refills the ring and the tables
  }
}

template <class Cfg, typename Off, bool kStaged, int R>
int launch(const typename Cfg::T* ar, const typename Cfg::T* ai,
           const void* a_off_k, const void* a_off_f, int a_mode,
           const typename Cfg::T* br, const typename Cfg::T* bi,
           const void* b_off_k, const void* b_off_f, int b_mode,
           typename Cfg::T* cr, typename Cfg::T* ci, long long K, long long M,
           long long N, void* stream) {
  static bool done[64] = {false};
  // the operand tiles, then the free offsets of the tile's rows and columns
  constexpr size_t bytes =
      tile_bytes<Cfg, kStaged, R>() + sizeof(Off) * (Cfg::BM + Cfg::BN);
  const int rc =
      g::prepare(fused_transpose_dot_kernel<Cfg, Off, kStaged, R>, bytes, done);
  if (rc != 0) return rc;
  const long long tiles = g::tile_count<Cfg>(M, N);
  if (tiles == 0) return 0;
  const long long grid = tiles < (1LL << 30) ? tiles : (1LL << 30);
  using G = g::Gathered<typename Cfg::T, Off>;
  const G a{ar, ai, static_cast<const Off*>(a_off_k),
            static_cast<const Off*>(a_off_f), K, M, a_mode, nullptr};
  const G b{br, bi, static_cast<const Off*>(b_off_k),
            static_cast<const Off*>(b_off_f), K, N, b_mode, nullptr};
  fused_transpose_dot_kernel<Cfg, Off, kStaged, R>
      <<<static_cast<unsigned int>(grid), g::kThreads, bytes,
         static_cast<cudaStream_t>(stream)>>>(a, b, K, M, N, cr, ci);
  return static_cast<int>(cudaGetLastError());
}

template <class Cfg, int R>
int launch_any(const typename Cfg::T* ar, const typename Cfg::T* ai,
               const void* a_off_k, const void* a_off_f, int a_mode,
               const typename Cfg::T* br, const typename Cfg::T* bi,
               const void* b_off_k, const void* b_off_f, int b_mode,
               typename Cfg::T* cr, typename Cfg::T* ci, long long K,
               long long M, long long N, int off64, void* stream) {
  // the staged pipeline whenever an operand is copied along its contract
  // index; it is built for int32 tables only (int64 addressing spills)
  const bool staged = a_mode == g::kVecK || b_mode == g::kVecK;
  if (off64 && staged) return static_cast<int>(cudaErrorInvalidValue);
  if (off64)
    return launch<Cfg, long long, false, R>(ar, ai, a_off_k, a_off_f, a_mode, br,
                                         bi, b_off_k, b_off_f, b_mode, cr, ci,
                                         K, M, N, stream);
  if (staged)
    return launch<Cfg, int, true, R>(ar, ai, a_off_k, a_off_f, a_mode, br, bi,
                                  b_off_k, b_off_f, b_mode, cr, ci, K, M, N,
                                  stream);
  return launch<Cfg, int, false, R>(ar, ai, a_off_k, a_off_f, a_mode, br, bi,
                                 b_off_k, b_off_f, b_mode, cr, ci, K, M, N,
                                 stream);
}

// A float32 launch of the FMA engine on tile variant `variant`
int launch_fp32(const float* ar, const float* ai, const void* a_off_k, const void* a_off_f,
                int a_mode, const float* br, const float* bi, const void* b_off_k,
                const void* b_off_f, int b_mode, float* cr, float* ci, long long K,
                long long M, long long N, int off64, int variant, void* stream) {
  if (variant == 0)
    return launch_any<g::Wide, g::kFp32>(ar, ai, a_off_k, a_off_f, a_mode, br, bi, b_off_k,
                                         b_off_f, b_mode, cr, ci, K, M, N, off64, stream);
  if (variant == 1)
    return launch_any<g::Narrow, g::kFp32>(ar, ai, a_off_k, a_off_f, a_mode, br, bi, b_off_k,
                                           b_off_f, b_mode, cr, ci, K, M, N, off64, stream);
  if (variant == 2)
    return launch_any<g::Flat, g::kFp32>(ar, ai, a_off_k, a_off_f, a_mode, br, bi, b_off_k,
                                         b_off_f, b_mode, cr, ci, K, M, N, off64, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

// ---- the TF32 rungs ----------------------------------------------------------

// The loading warpgroup's view of the two gathered operands: at each work
// item the free offsets of the tile's X rows and Y columns go to shared
// memory (-1 past the end; the loaders alone read them), then each stage's
// elements are read at off_k[k] + off_f[f] by cp.async.
template <class T>
struct GatheredLoader {
  using G = g::Gathered<float, int>;
  const G& a;
  const G& b;
  int* tx;  // X rows', then Y columns' free offsets (int32 tables)
  int* ty;

  __device__ __forceinline__ void begin(long long, long long x0, long long y0, int p,
                                        unsigned char* tail) {
    tx = reinterpret_cast<int*>(tail);
    ty = tx + T::XR;
    tf::named_barrier<2, tf::kProducers>();  // the last tile's copies are issued
    for (int i = p; i < T::XR + T::YC; i += tf::kProducers) {
      if (i < T::XR) {
        const long long f = x0 + i;
        tx[i] = f < a.F ? __ldg(a.off_f + f) : -1;
      } else {
        const long long f = y0 + (i - T::XR);
        ty[i - T::XR] = f < b.F ? __ldg(b.off_f + f) : -1;
      }
    }
    tf::named_barrier<2, tf::kProducers>();
  }

  __device__ __forceinline__ void load(float* xr, float* xi, float* yr, float* yi,
                                       long long k0, unsigned long long*, int p) const {
    G x = a;  // X = A, Y = B with this tile's free offsets
    G y = b;
    x.tile_off = tx;
    y.tile_off = ty;
    tf::load_stage<T::XR, T::BK>(x, xr, xi, k0, p);
    tf::load_stage<T::YC, T::BK>(y, yr, yi, k0, p);
  }
};

// The wgmma tile reads int32 offset tables only (operands of under 2^31
// elements, the PEPS operands' 2^24 among them): int64 tables take the
// mma.sync tiles (cuda_complex.tf32_config), which halves the kernel's
// instantiations
template <class T, int R>
__global__ void __launch_bounds__(tf::kThreads, 1)
    fused_transpose_dot_tf32_kernel(g::Gathered<float, int> a, g::Gathered<float, int> b,
                                    tf::Work<T> work, float* cr, float* ci) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  GatheredLoader<T> ld{a, b, nullptr, nullptr};
  tf::run_tile<T, R>(ld, work, smem_raw, a.mode, b.mode, cr, ci, 0u);
}

template <class T, int R>
int launch_tf32(const float* ar, const float* ai, const void* a_off_k, const void* a_off_f,
                int a_mode, const float* br, const float* bi, const void* b_off_k,
                const void* b_off_f, int b_mode, float* cr, float* ci, long long K,
                long long M, long long N, int off64, void* stream) {
  static bool done[64] = {false};
  if (off64) return static_cast<int>(cudaErrorInvalidValue);
  // the tile, then the free offsets of its X rows and Y columns
  constexpr size_t bytes = tf::kTileBytes<T, R> + sizeof(int) * (T::XR + T::YC);
  const int rc = g::prepare(fused_transpose_dot_tf32_kernel<T, R>, bytes, done);
  if (rc != 0) return rc;
  const long long tiles = g::tile_count<T>(M, N);
  if (tiles == 0) return 0;
  const tf::Work<T> work{tiles, tiles, static_cast<int>((K + T::BK - 1) / T::BK), K, M, N};
  const int grid = tf::persistent_grid(work.items);
  if (grid <= 0) return static_cast<int>(cudaErrorInvalidValue);
  using G = g::Gathered<float, int>;
  const G a{ar, ai, static_cast<const int*>(a_off_k), static_cast<const int*>(a_off_f), K, M,
            a_mode, nullptr};
  const G b{br, bi, static_cast<const int*>(b_off_k), static_cast<const int*>(b_off_f), K, N,
            b_mode, nullptr};
  fused_transpose_dot_tf32_kernel<T, R>
      <<<grid, tf::kThreads, bytes, static_cast<cudaStream_t>(stream)>>>(a, b, work, cr, ci);
  return static_cast<int>(cudaGetLastError());
}

// A TF32 launch at rung R on tile `variant`: the wgmma tile's 0 wide, 1
// flat_n (int32 tables), or the mma.sync tile's 2 mma_flat, 3 mma_wide, 4
// mma_narrow
template <int R>
int launch_tf32_variant(const float* ar, const float* ai, const void* a_off_k,
                        const void* a_off_f, int a_mode, const float* br, const float* bi,
                        const void* b_off_k, const void* b_off_f, int b_mode, float* cr,
                        float* ci, long long K, long long M, long long N, int off64,
                        int variant, void* stream) {
  using Wide = std::conditional_t<R == g::kTf32, tf::Wide, tf::WideHigh>;
  if (variant == 0)
    return launch_tf32<Wide, R>(ar, ai, a_off_k, a_off_f, a_mode, br, bi, b_off_k, b_off_f,
                                b_mode, cr, ci, K, M, N, off64, stream);
  if (variant == 1)
    return launch_tf32<tf::FlatN, R>(ar, ai, a_off_k, a_off_f, a_mode, br, bi, b_off_k,
                                     b_off_f, b_mode, cr, ci, K, M, N, off64, stream);
  if (variant == 2)
    return launch_any<g::FlatTc, R>(ar, ai, a_off_k, a_off_f, a_mode, br, bi, b_off_k, b_off_f,
                                    b_mode, cr, ci, K, M, N, off64, stream);
  if (variant == 3)
    return launch_any<g::WideTc, R>(ar, ai, a_off_k, a_off_f, a_mode, br, bi, b_off_k, b_off_f,
                                    b_mode, cr, ci, K, M, N, off64, stream);
  if (variant == 4)
    return launch_any<g::NarrowTc, R>(ar, ai, a_off_k, a_off_f, a_mode, br, bi, b_off_k,
                                      b_off_f, b_mode, cr, ci, K, M, N, off64, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

// a_off_k/a_off_f: the first operand's contract (K) and free (M) offset
// tables; b_off_k/b_off_f the second's (K, N), int64 when off64 else int32.
// The first operand gives the output rows. a_mode / b_mode: copy modes
// (tnc::gemm::Mode; at float32 kVecK on either selects the staged
// pipeline); rung: 0 = float32 (FMA), 1 = high (3xTF32), 2 = default (TF32)
// (tnc::gemm::Rung); variant: at float32 0 = 128 x 64 tiles, 1 = 64 x 64,
// 2 = 8 x 512; at a TF32 rung the tile of tf32_tile.cuh (0 wide, 1 flat_n;
// int32 tables only) or complex_gemm.cuh's mma.sync tiles (2 8 x 512, 3
// 128 x 64, 4 64 x 64; cuda_complex.tf32_config chooses).
int tnc_fused_transpose_dot_f32(const float* ar, const float* ai,
                                const void* a_off_k, const void* a_off_f,
                                int a_mode, const float* br, const float* bi,
                                const void* b_off_k, const void* b_off_f,
                                int b_mode, float* cr, float* ci, long long K,
                                long long M, long long N, int off64,
                                int variant, int rung, void* stream) {
  if (rung == g::kFp32)
    return launch_fp32(ar, ai, a_off_k, a_off_f, a_mode, br, bi, b_off_k, b_off_f, b_mode,
                       cr, ci, K, M, N, off64, variant, stream);
  if (rung == g::kTf32x3)
    return launch_tf32_variant<g::kTf32x3>(ar, ai, a_off_k, a_off_f, a_mode, br, bi, b_off_k,
                                           b_off_f, b_mode, cr, ci, K, M, N, off64, variant,
                                           stream);
  if (rung == g::kTf32)
    return launch_tf32_variant<g::kTf32>(ar, ai, a_off_k, a_off_f, a_mode, br, bi, b_off_k,
                                         b_off_f, b_mode, cr, ci, K, M, N, off64, variant,
                                         stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

// variant: 3 (64 x 64 tiles of doubles)
int tnc_fused_transpose_dot_f64(const double* ar, const double* ai,
                                const void* a_off_k, const void* a_off_f,
                                int a_mode, const double* br, const double* bi,
                                const void* b_off_k, const void* b_off_f,
                                int b_mode, double* cr, double* ci,
                                long long K, long long M, long long N,
                                int off64, int variant, void* stream) {
  if (variant == 3)
    return launch_any<g::Double, g::kFp32>(ar, ai, a_off_k, a_off_f, a_mode, br,
                                           bi, b_off_k, b_off_f, b_mode, cr, ci,
                                           K, M, N, off64, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* tnc_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
