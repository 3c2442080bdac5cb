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
// tables of each operand on the device, once per layout and strides; the
// kernel only adds and loads.
// The result is the flat row-major (M, N) pair
//   re = ar^T br - ai^T bi,   im = ar^T bi + ai^T br
// with rows iterating the first operand's free digits and columns the
// second's, exactly what the plain view + permute + reshape + matmul path
// gives, so callers reshape it to the step's stored output unchanged.
//
// What bounds it on an H100: on the PEPS steps it takes (K = 32 and 1024,
// M and N 64 to 16384) the naive product does 8*K*M*N FP32 operations on
// operands of 8*(K*M + K*N) bytes read once, far above the card's ~20
// operations per byte, so it is bound by operations on the CUDA cores, as
// fused_complex_dot is. What the TPU kernel saved, the HBM pass of the
// materialised transpose, is saved here too: each operand element is read
// from device memory straight into the shared-memory tile.
//
// Design. The output tiling, the 4 x 4 register micro-tile, the four FMAs
// per staged value and the two-level accumulation (each 16-deep K step
// summed into fresh registers, then folded into the total) are those of
// complex_tile.cuh. What differs is staging. At the start of an output
// tile the block copies the free offsets of its 64 rows and 64 columns
// into shared memory; each staged element is then one load of its contract
// offset (16 distinct values a step, served by L1) and one load of the
// operand. An earlier version decomposed the contract index into digits
// inside the K loop: the 64-bit divisions, done by one warp while the
// block waited at a barrier, made it much slower than fused_complex_dot
// on the same problem. The gate (transpose_dot_ineligible_reason, minor_axes)
// puts each operand's fastest contract and free digits on its two stored
// minor axes, so one of them has stride 1: consecutive threads walk that
// index (k_unit says which), and the staged rows are padded by one element
// so the contract-fastest walk stores to shared memory without bank
// conflicts. Loads go through the read-only cache (__ldg): with the
// contract-fastest walk a K step uses half of each 128-byte line and the
// next K step the other half. Ragged edges are bounds-checked (a free
// offset of -1 marks a row or column past the end; such elements load as
// 0 and are not stored). TF32 and tensor cores stay off. wgmma with TMA
// boxes for the gather is later work.
#include <cuda_runtime.h>

#include "complex_tile.cuh"

namespace {

using tnc::kBK;
using tnc::kBM;
using tnc::kBN;
using tnc::kThreads;
using tnc::kTM;
using tnc::kTN;

// One operand: its stored parts and offset tables (K and F entries).
template <typename T>
struct Gathered {
  const T* re;
  const T* im;
  const long long* off_k;
  const long long* off_f;
  int k_unit;  // 1: the contract index has the smaller stride (walk it fastest)
};

template <typename T>
struct GatherSmem {
  T ar[kBK][kBM + 1];
  T ai[kBK][kBM + 1];
  T br[kBK][kBN + 1];
  T bi[kBK][kBN + 1];
  long long a_off_f[kBM];
  long long b_off_f[kBN];
};

// Stages the (kBK x 64) tile at contract index k0 of an operand's real and
// imaginary parts (rows padded to P = 65); off_f holds the tile's 64 free
// offsets, -1 past the end.
template <typename T, int P>
__device__ __forceinline__ void stage(const Gathered<T>& g, long long k0,
                                      long long K, const long long* off_f,
                                      T (&sr)[kBK][P], T (&si)[kBK][P]) {
  constexpr int kF = P - 1;
  for (int idx = threadIdx.x; idx < kBK * kF; idx += kThreads) {
    const int kk = g.k_unit ? idx % kBK : idx / kF;
    const int ff = g.k_unit ? idx / kBK : idx % kF;
    const long long k = k0 + kk;
    const long long of = off_f[ff];
    const bool in = k < K && of >= 0;
    const long long off = in ? __ldg(g.off_k + k) + of : 0;
    sr[kk][ff] = in ? __ldg(g.re + off) : T(0);
    si[kk][ff] = in ? __ldg(g.im + off) : T(0);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    fused_transpose_dot_kernel(Gathered<T> a, Gathered<T> b, long long K,
                               long long M, long long N, T* cr, T* ci) {
  __shared__ GatherSmem<T> s;
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const long long tiles_n = (N + kBN - 1) / kBN;
  const long long tiles = tnc::tile_count(M, N);
  for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const long long m0 = (tile / tiles_n) * kBM;
    const long long n0 = (tile % tiles_n) * kBN;
    if (tid < kBM) {
      const long long m = m0 + tid;
      s.a_off_f[tid] = m < M ? __ldg(a.off_f + m) : -1;
    } else if (tid < kBM + kBN) {
      const long long n = n0 + (tid - kBM);
      s.b_off_f[tid - kBM] = n < N ? __ldg(b.off_f + n) : -1;
    }
    __syncthreads();

    T accr[kTM][kTN];
    T acci[kTM][kTN];
    tnc::zero_tile(accr);
    tnc::zero_tile(acci);
    for (long long k0 = 0; k0 < K; k0 += kBK) {
      stage(a, k0, K, s.a_off_f, s.ar, s.ai);
      stage(b, k0, K, s.b_off_f, s.br, s.bi);
      __syncthreads();
      T pr[kTM][kTN];  // this K step's partial sums
      T pi[kTM][kTN];
      tnc::zero_tile(pr);
      tnc::zero_tile(pi);
      tnc::fma_step(s.ar, s.ai, s.br, s.bi, tx, ty, pr, pi);
      __syncthreads();
      tnc::fold_tile(accr, pr);
      tnc::fold_tile(acci, pi);
    }
    tnc::store_tile(accr, acci, m0, n0, M, N, tx, ty, cr, ci);
  }
}

template <typename T>
int launch(const T* ar, const T* ai, const long long* a_off_k,
           const long long* a_off_f, int a_k_unit, const T* br, const T* bi,
           const long long* b_off_k, const long long* b_off_f, int b_k_unit,
           T* cr, T* ci, long long K, long long M, long long N, void* stream) {
  const long long tiles = tnc::tile_count(M, N);
  if (tiles == 0) return 0;
  const long long grid = tiles < (1LL << 30) ? tiles : (1LL << 30);
  const Gathered<T> a{ar, ai, a_off_k, a_off_f, a_k_unit};
  const Gathered<T> b{br, bi, b_off_k, b_off_f, b_k_unit};
  fused_transpose_dot_kernel<T>
      <<<static_cast<unsigned int>(grid), kThreads, 0,
         static_cast<cudaStream_t>(stream)>>>(a, b, K, M, N, cr, ci);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// a_off_k/a_off_f: the first operand's contract (K) and free (M) offset
// tables; b_off_k/b_off_f the second's (K, N). The first operand gives the
// output rows.
int tnc_fused_transpose_dot_f32(const float* ar, const float* ai,
                                const long long* a_off_k,
                                const long long* a_off_f, int a_k_unit,
                                const float* br, const float* bi,
                                const long long* b_off_k,
                                const long long* b_off_f, int b_k_unit,
                                float* cr, float* ci, long long K, long long M,
                                long long N, void* stream) {
  return launch<float>(ar, ai, a_off_k, a_off_f, a_k_unit, br, bi, b_off_k,
                       b_off_f, b_k_unit, cr, ci, K, M, N, stream);
}

int tnc_fused_transpose_dot_f64(const double* ar, const double* ai,
                                const long long* a_off_k,
                                const long long* a_off_f, int a_k_unit,
                                const double* br, const double* bi,
                                const long long* b_off_k,
                                const long long* b_off_f, int b_k_unit,
                                double* cr, double* ci, long long K,
                                long long M, long long N, void* stream) {
  return launch<double>(ar, ai, a_off_k, a_off_f, a_k_unit, br, bi, b_off_k,
                        b_off_f, b_k_unit, cr, ci, K, M, N, stream);
}

const char* tnc_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
