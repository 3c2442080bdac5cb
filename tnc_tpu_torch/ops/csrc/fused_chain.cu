// fused_chain: a run of small consecutive contraction steps in ONE launch.
//
// Replaces the TPU kernel tnc_tpu/ops/pallas_complex.py::fused_chain_kl
// (body _chain_compute): the head step is the split-complex product of two
// prepped contract-first operands; each following link regroups the carried
// value by a reshape and contracts it on its k axis against one more prepped
// (K_i, X_i) operand, carried-first or carried-second. Arithmetic is the
// naive four-product lowering, accumulated in the operand type.
//
// What bounds it on an H100: nothing the arithmetic needs. Every step of a
// chain has 2*k*m*n < 2^22 and the whole chain touches at most 2^20 elements,
// so its FP32 work is a few microseconds of the card at most; what a run of
// such steps costs is one kernel launch each (plus the launch gaps). The
// design therefore makes a chain one cooperative launch: a persistent grid,
// sized from the occupancy calculator and capped at the largest stage's tile
// count, walks the stages in order. Within a stage the blocks share its
// output tiles (grid-strided, the same tile code as fused_complex_dot); the
// carried value ping-pongs between two scratch buffers that stay in the
// 50 MB L2, and the grid synchronises between stages. The stage table
// (shapes, strides, which buffer feeds which operand) is built once per chain
// by the Python wrapper and passed by value; only the operand pointers change
// from call to call. A chain longer than kMaxStages stages is run as
// consecutive launches of kMaxStages stages.
//
// Slice batch (the reference runs the kernel under jax.vmap in its chunked
// executor): every stage runs `batch` independent rows in the same launch,
// the blocks striding over batch x tiles. Each operand has a batch stride,
// 0 for an operand every row shares (an unbatched cached value), so nothing
// is copied per row; row z of a stage's (M, N) result is written at z*M*N,
// which is the carried value's batch stride in the next stage.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "complex_tile.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxStages = 32;
// per-stage fields of the host table:
//   a_src, a_sk, a_sf, a_sb, b_src, b_sk, b_sf, b_sb, K, M, N, c_dst
constexpr int kFields = 12;

template <typename T>
struct Stage {
  const T* ar;
  const T* ai;
  const T* br;
  const T* bi;
  T* cr;
  T* ci;
  long long a_sk, a_sf, a_sb, b_sk, b_sf, b_sb;
  long long K, M, N;
};

template <typename T>
struct ChainParams {
  Stage<T> stage[kMaxStages];
  int n_stages;
  int batch;
};

template <typename T>
__global__ void __launch_bounds__(tnc::kThreads)
    fused_chain_kernel(const ChainParams<T> p) {
  __shared__ tnc::TileSmem<T> s;
  cg::grid_group grid = cg::this_grid();
  for (int i = 0; i < p.n_stages; ++i) {
    const Stage<T>& st = p.stage[i];
    const long long tiles = tnc::tile_count(st.M, st.N);
    const long long work = tiles * p.batch;
    for (long long t = blockIdx.x; t < work; t += gridDim.x) {
      const long long z = t / tiles;
      const tnc::Operand<T> a{st.ar + z * st.a_sb, st.ai + z * st.a_sb,
                              st.a_sk, st.a_sf};
      const tnc::Operand<T> b{st.br + z * st.b_sb, st.bi + z * st.b_sb,
                              st.b_sk, st.b_sf};
      const long long out = z * st.M * st.N;
      tnc::complex_tile<T>(a, b, st.K, st.M, st.N, t - z * tiles, st.cr + out,
                           st.ci + out, s);
    }
    if (i + 1 < p.n_stages) {
      __threadfence();
      grid.sync();
    }
  }
}

template <typename T>
int max_resident_blocks(int device) {
  static int cached[64] = {0};
  if (device >= 0 && device < 64 && cached[device] > 0) return cached[device];
  int per_sm = 0;
  cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, fused_chain_kernel<T>, tnc::kThreads, 0);
  if (e != cudaSuccess) return -static_cast<int>(e);
  int sms = 0;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (e != cudaSuccess) return -static_cast<int>(e);
  const int blocks = per_sm * sms;
  if (device >= 0 && device < 64) cached[device] = blocks;
  return blocks;
}

template <typename T>
int launch(const void* const* ptrs, const long long* table, int n_stages,
           int batch, T* scratch, long long scratch_stride, T* out_r, T* out_i,
           void* stream) {
  if (batch < 1) return static_cast<int>(cudaErrorInvalidValue);
  int device = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int resident = max_resident_blocks<T>(device);
  if (resident < 0) return -resident;
  if (resident == 0) return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);

  auto src = [&](long long code, const T** re, const T** im) {
    if (code >= 0) {
      *re = static_cast<const T*>(ptrs[2 * code]);
      *im = static_cast<const T*>(ptrs[2 * code + 1]);
    } else {
      const long long pair = -code - 1;  // scratch pair 0 or 1
      *re = scratch + (2 * pair) * scratch_stride;
      *im = scratch + (2 * pair + 1) * scratch_stride;
    }
  };

  for (int first = 0; first < n_stages; first += kMaxStages) {
    ChainParams<T> p;
    p.n_stages = n_stages - first < kMaxStages ? n_stages - first : kMaxStages;
    p.batch = batch;
    long long max_tiles = 1;
    for (int i = 0; i < p.n_stages; ++i) {
      const long long* f = table + (first + i) * kFields;
      Stage<T>& st = p.stage[i];
      src(f[0], &st.ar, &st.ai);
      src(f[4], &st.br, &st.bi);
      st.a_sk = f[1];
      st.a_sf = f[2];
      st.a_sb = f[3];
      st.b_sk = f[5];
      st.b_sf = f[6];
      st.b_sb = f[7];
      st.K = f[8];
      st.M = f[9];
      st.N = f[10];
      if (f[11] == -3) {
        st.cr = out_r;
        st.ci = out_i;
      } else {
        const long long pair = -f[11] - 1;
        st.cr = scratch + (2 * pair) * scratch_stride;
        st.ci = scratch + (2 * pair + 1) * scratch_stride;
      }
      const long long tiles = tnc::tile_count(st.M, st.N) * batch;
      if (tiles > max_tiles) max_tiles = tiles;
    }
    const long long grid = max_tiles < resident ? max_tiles : resident;
    void* args[] = {&p};
    e = cudaLaunchCooperativeKernel(
        reinterpret_cast<const void*>(fused_chain_kernel<T>),
        dim3(static_cast<unsigned int>(grid)), dim3(tnc::kThreads), args, 0,
        static_cast<cudaStream_t>(stream));
    if (e != cudaSuccess) return static_cast<int>(e);
    e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  return 0;
}

}  // namespace

extern "C" {

int tnc_chain_max_stages() { return kMaxStages; }

int tnc_chain_table_fields() { return kFields; }

// batch: rows per stage (1 unbatched); scratch_stride: elements of one
// scratch part, at least batch times the largest carried value
int tnc_fused_chain_f32(const void* const* ptrs, const long long* table,
                        int n_stages, int batch, float* scratch,
                        long long scratch_stride, float* out_r, float* out_i,
                        void* stream) {
  return launch<float>(ptrs, table, n_stages, batch, scratch, scratch_stride,
                       out_r, out_i, stream);
}

int tnc_fused_chain_f64(const void* const* ptrs, const long long* table,
                        int n_stages, int batch, double* scratch,
                        long long scratch_stride, double* out_r, double* out_i,
                        void* stream) {
  return launch<double>(ptrs, table, n_stages, batch, scratch, scratch_stride,
                        out_r, out_i, stream);
}

const char* tnc_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
