// Small-table gather-sum (K2) and scatter-add (K3) over PreIdx rows.
//
// Replaces rsem_tpu/ops/pallas_table.py: _gather_sum_kernel (K2) and
// _scatter_kernel (K3). Index rows are [rows, cols] int32 (cols a multiple
// of 4, 128 for reads up to 128 bp); slots >= the table size are sentinels.
//
// What bounds them on the H100: both stream the index matrix once from
// device memory (rows * cols * 4 bytes, 1.28 GB for 2.5M hits) and touch a
// table of at most a few thousand slots, so they are bound by bytes. The
// TPU kernels scanned the table row by row with lane shuffles (gather) and
// built one-hot MXU products with a bf16 split and Kahan compensation
// (scatter); none of that has a reason to exist here.
//
// Design:
//  * one warp per index row, each lane loading 16 bytes (int4: four
//    indices) so a warp reads a 128-column row in one coalesced request;
//  * grid-stride over rows with a grid capped near residency, so the
//    per-block table set-up is paid ~1000 times, not once per row;
//  * gather: the table is copied into shared memory when it fits in 48 KB
//    (every main-path table does: <= 8,192 slots), else read through the
//    read-only cache (__ldg) by the same kernel; each row is summed in f64
//    (free here: the kernel waits on memory) and written as f32;
//  * scatter: each block keeps a private f32 histogram in shared memory,
//    filled with shared-memory atomics, and flushes it once into a global
//    f64 accumulator with f64 atomics. Sentinel slots are skipped, so the
//    28 padding lanes of a 100 bp read cost no atomics.

#include "common.cuh"

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kThreads = kWarpsPerBlock * 32;
constexpr size_t kDefaultSmem = 48 * 1024;
constexpr size_t kMaxSmem = 227 * 1024;

template <bool kShared>
__device__ __forceinline__ double table_at(const float* s_table,
                                           const float* __restrict__ table,
                                           int64_t n_table, int i) {
  if ((unsigned)i >= (unsigned long long)n_table) return 0.0;
  return kShared ? (double)s_table[i] : (double)__ldg(table + i);
}

template <bool kShared>
__global__ void __launch_bounds__(kThreads)
    gather_sum_kernel(const float* __restrict__ table, int64_t n_table,
                      const int4* __restrict__ idx, int64_t rows,
                      int vec_per_row, float* __restrict__ out) {
  extern __shared__ float s_table[];
  if (kShared) {
    for (int64_t i = threadIdx.x; i < n_table; i += blockDim.x)
      s_table[i] = table[i];
    __syncthreads();
  }
  const int lane = threadIdx.x & 31;
  const int64_t n_warps = (int64_t)gridDim.x * kWarpsPerBlock;
  for (int64_t r = (int64_t)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
       r < rows; r += n_warps) {
    const int4* row = idx + r * vec_per_row;
    double acc = 0.0;
    for (int v = lane; v < vec_per_row; v += 32) {
      const int4 q = __ldg(row + v);
      acc += table_at<kShared>(s_table, table, n_table, q.x);
      acc += table_at<kShared>(s_table, table, n_table, q.y);
      acc += table_at<kShared>(s_table, table, n_table, q.z);
      acc += table_at<kShared>(s_table, table, n_table, q.w);
    }
    for (int o = 16; o > 0; o >>= 1)
      acc += __shfl_down_sync(rsem::kFullMask, acc, o);
    if (lane == 0) out[r] = (float)acc;
  }
}

__device__ __forceinline__ void hist_add(float* s_hist, int size, int i,
                                         float w) {
  if ((unsigned)i < (unsigned)size) atomicAdd(s_hist + i, w);
}

__global__ void __launch_bounds__(kThreads)
    scatter_add_kernel(const int4* __restrict__ idx, int64_t rows,
                       int vec_per_row, const float* __restrict__ w,
                       int size, double* __restrict__ acc) {
  extern __shared__ float s_hist[];
  for (int i = threadIdx.x; i < size; i += blockDim.x) s_hist[i] = 0.f;
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int64_t n_warps = (int64_t)gridDim.x * kWarpsPerBlock;
  for (int64_t r = (int64_t)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
       r < rows; r += n_warps) {
    const float wr = __ldg(w + r);
    if (wr == 0.f) continue;  // adds nothing; saves the row's atomics
    const int4* row = idx + r * vec_per_row;
    for (int v = lane; v < vec_per_row; v += 32) {
      const int4 q = __ldg(row + v);
      hist_add(s_hist, size, q.x, wr);
      hist_add(s_hist, size, q.y, wr);
      hist_add(s_hist, size, q.z, wr);
      hist_add(s_hist, size, q.w, wr);
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < size; i += blockDim.x) {
    const float v = s_hist[i];
    if (v != 0.f) atomicAdd(acc + i, (double)v);
  }
}

}  // namespace

// out[r] = sum_c table[idx[r, c]] (slots outside the table read 0).
extern "C" int rsem_gather_sum(const float* table, int64_t n_table,
                               const int32_t* idx, int64_t rows, int cols,
                               float* out, cudaStream_t stream) {
  if (rows == 0) return (int)cudaGetLastError();
  if (cols % 4 != 0 || n_table <= 0) return (int)cudaErrorInvalidValue;
  const int vec = cols / 4;
  const int grid = rsem::grid_for(rows, kWarpsPerBlock, 8);
  const size_t smem = (size_t)n_table * sizeof(float);
  const int4* idx4 = reinterpret_cast<const int4*>(idx);
  if (smem <= kDefaultSmem) {
    gather_sum_kernel<true><<<grid, kThreads, smem, stream>>>(
        table, n_table, idx4, rows, vec, out);
  } else {
    gather_sum_kernel<false><<<grid, kThreads, 0, stream>>>(
        table, n_table, idx4, rows, vec, out);
  }
  return (int)cudaGetLastError();
}

// acc[t] += w[r] for every idx[r, c] == t < size (acc: f64 [size]).
extern "C" int rsem_scatter_add(const int32_t* idx, int64_t rows, int cols,
                                const float* w, int size, double* acc,
                                cudaStream_t stream) {
  if (rows == 0 || size == 0) return (int)cudaGetLastError();
  if (cols % 4 != 0 || size < 0) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)size * sizeof(float);
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  if (smem > kDefaultSmem) {
    cudaError_t e = cudaFuncSetAttribute(
        scatter_add_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int grid = rsem::grid_for(rows, kWarpsPerBlock, 8);
  scatter_add_kernel<<<grid, kThreads, smem, stream>>>(
      reinterpret_cast<const int4*>(idx), rows, cols / 4, w, size, acc);
  return (int)cudaGetLastError();
}

extern "C" const char* rsem_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
