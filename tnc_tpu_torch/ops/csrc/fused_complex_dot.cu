// fused_complex_dot: one split-complex product, both outputs in one pass.
//
// Replaces the TPU kernel tnc_tpu/ops/pallas_complex.py::fused_complex_dot_kl
// (re = ar^T br - ai^T bi, im = ar^T bi + ai^T br for contract-first
// A: (K, M), B: (K, N), accumulated in the operand type).
//
// What bounds it on an H100: at the shapes the forced `fused` rung gives it
// (K >= 128 on the big steps) it does 8*K*M*N FP32 operations for
// 8*(K*M + K*N + M*N) bytes, far above the card's 20 FP32-operations-per-byte
// ridge (67 TFLOP/s over 3.35 TB/s), so it is bound by operations on the
// CUDA cores. The design therefore spends its effort on reuse: each operand
// tile is staged in shared memory once and every staged value feeds all four
// real products from registers (complex_tile.cuh), with no separate
// elementwise epilogue. It takes any shape (ragged edges are bounds-checked),
// so unlike the TPU kernel it needs no tile floor. Tensor cores (wgmma,
// 3xTF32) and TMA are later work.
#include <cuda_runtime.h>

#include "complex_tile.cuh"

namespace {

template <typename T>
__global__ void __launch_bounds__(tnc::kThreads)
    fused_complex_dot_kernel(tnc::Operand<T> a, tnc::Operand<T> b, long long K,
                             long long M, long long N, T* cr, T* ci) {
  __shared__ tnc::TileSmem<T> s;
  const long long tiles = tnc::tile_count(M, N);
  for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    tnc::complex_tile<T>(a, b, K, M, N, tile, cr, ci, s);
  }
}

template <typename T>
int launch(const T* ar, const T* ai, long long a_sk, long long a_sf,
           const T* br, const T* bi, long long b_sk, long long b_sf,
           T* cr, T* ci, long long K, long long M, long long N, void* stream) {
  const long long tiles = tnc::tile_count(M, N);
  if (tiles == 0) return 0;
  const long long grid = tiles < (1LL << 30) ? tiles : (1LL << 30);
  tnc::Operand<T> a{ar, ai, a_sk, a_sf};
  tnc::Operand<T> b{br, bi, b_sk, b_sf};
  fused_complex_dot_kernel<T>
      <<<static_cast<unsigned int>(grid), tnc::kThreads, 0,
         static_cast<cudaStream_t>(stream)>>>(a, b, K, M, N, cr, ci);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int tnc_fused_complex_dot_f32(const float* ar, const float* ai, long long a_sk,
                              long long a_sf, const float* br, const float* bi,
                              long long b_sk, long long b_sf, float* cr,
                              float* ci, long long K, long long M, long long N,
                              void* stream) {
  return launch<float>(ar, ai, a_sk, a_sf, br, bi, b_sk, b_sf, cr, ci, K, M, N,
                       stream);
}

int tnc_fused_complex_dot_f64(const double* ar, const double* ai,
                              long long a_sk, long long a_sf, const double* br,
                              const double* bi, long long b_sk, long long b_sf,
                              double* cr, double* ci, long long K, long long M,
                              long long N, void* stream) {
  return launch<double>(ar, ai, a_sk, a_sf, br, bi, b_sk, b_sf, cr, ci, K, M,
                        N, stream);
}

const char* tnc_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
