// Shared helpers for the port's hand-written Hopper kernels.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace rsem {

constexpr unsigned kFullMask = 0xffffffffu;

// Grid for a grid-stride loop: enough blocks for `work_items` (each block
// covers `items_per_block`), capped at `blocks_per_sm` resident blocks per SM
// so per-block set-up (a shared-memory table fill, a histogram flush) is paid
// a bounded number of times.
inline int grid_for(int64_t work_items, int64_t items_per_block,
                    int blocks_per_sm) {
  int dev = 0;
  cudaGetDevice(&dev);
  int sms = 0;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  int64_t need = (work_items + items_per_block - 1) / items_per_block;
  int64_t cap = (int64_t)(sms > 0 ? sms : 1) * blocks_per_sm;
  int64_t g = need < cap ? need : cap;
  return (int)(g > 0 ? g : 1);
}

// Grid for a grid-stride loop of `kernel`: enough blocks for `work_items`,
// capped at the blocks that are resident at once (the occupancy the
// kernel's registers and shared memory, `smem` bytes of it dynamic, allow),
// so no block waits for a second wave while the others idle.
template <typename Kernel>
inline int resident_grid(Kernel kernel, int threads, int64_t work_items,
                         int64_t items_per_block, size_t smem = 0) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads,
                                                smem);
  const int64_t need = (work_items + items_per_block - 1) / items_per_block;
  const int64_t cap = (int64_t)(sms > 0 ? sms : 1) * (per_sm > 0 ? per_sm : 1);
  const int64_t g = need < cap ? need : cap;
  return (int)(g > 0 ? g : 1);
}

// Sum over a block of kWarps warps (butterfly in each warp, then the warps
// in order); the result is valid in thread 0. Ends with the block's
// threads past one barrier.
template <int kWarps>
__device__ double block_sum(double v, double* s_warp) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFullMask, v, o);
  if (lane == 0) s_warp[warp] = v;
  __syncthreads();
  double t = 0.0;
  if (threadIdx.x == 0)
    for (int i = 0; i < kWarps; ++i) t += s_warp[i];
  return t;
}

}  // namespace rsem
