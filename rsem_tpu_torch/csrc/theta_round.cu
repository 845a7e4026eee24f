// One theta-only EM round over frozen, per-read max-scaled conprbs (K1).
//
// Replaces rsem_tpu/ops/pallas_round.py: _round_kernel (with the bucket
// layout of build_pallas_data around it). Per read r with hits h:
//   w_h      = theta[sid_h] * cps_h
//   denom_r  = sum_h w_h + theta[0] * ncs_r
//   contrib[sid_h] += cps_h / denom_r
//   noise          += theta[0] * ncs_r / denom_r
// The caller multiplies contrib by theta and normalises (the M-step).
//
// What bounds it on the H100: bytes and atomics. One round reads
// H * (4 + 4) + N * (4 + 8) bytes (about 32 MB at 2.5M hits, 1M reads) and
// issues one f64 atomic per hit into an (M+1)-slot vector that L2 holds.
// The TPU kernel bucketed reads by hit count K into [X, 128] tiles, scanned
// the theta table with lane shuffles, summed denominators with XOR
// butterflies and scattered through one-hot MXU products with Kahan
// compensation; a GPU gathers and scatters directly, so none of that
// remains: the hits stay in CSR order (read_offsets), there is no M cap,
// and the sums are native f64.
//
// Design: a warp takes 32 consecutive reads. A read with <= kSmall hits
// (the common case: ~2.5 hits per read) is done by one lane alone; the
// warp's longer reads are then done one after another by all 32 lanes,
// striding over the hits and summing the denominator with a shuffle.
// theta is read through the read-only cache. The noise term is summed per
// lane in f64, reduced per block, and added with one f64 atomic per block.

#include "common.cuh"

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kThreads = kWarpsPerBlock * 32;
constexpr int64_t kSmall = 4;

__global__ void __launch_bounds__(kThreads) theta_round_kernel(
    const int32_t* __restrict__ sid, const float* __restrict__ cps,
    const float* __restrict__ ncs, const int64_t* __restrict__ offsets,
    int64_t n_reads, const float* __restrict__ theta,
    double* __restrict__ contrib, double* __restrict__ noise) {
  __shared__ double s_noise[kWarpsPerBlock];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const float th0 = __ldg(theta);
  double my_noise = 0.0;
  const int64_t n_groups = (n_reads + 31) / 32;
  for (int64_t g = (int64_t)blockIdx.x * kWarpsPerBlock + warp; g < n_groups;
       g += (int64_t)gridDim.x * kWarpsPerBlock) {
    const int64_t r = g * 32 + lane;
    const bool live = r < n_reads;
    int64_t b = 0, e = 0;
    if (live) {
      b = __ldg(offsets + r);
      e = __ldg(offsets + r + 1);
    }
    const bool small = live && (e - b) <= kSmall;
    if (small) {
      float d = 0.f;
      for (int64_t h = b; h < e; ++h)
        d += __ldg(theta + __ldg(sid + h)) * __ldg(cps + h);
      const float w0 = th0 * __ldg(ncs + r);
      const float denom = d + w0;
      const float inv = denom > 0.f ? 1.f / denom : 0.f;
      for (int64_t h = b; h < e; ++h) {
        const float u = __ldg(cps + h) * inv;
        if (u != 0.f) atomicAdd(contrib + __ldg(sid + h), (double)u);
      }
      my_noise += (double)(w0 * inv);
    }
    unsigned big = __ballot_sync(rsem::kFullMask, live && !small);
    while (big) {
      const int src = __ffs(big) - 1;
      big &= big - 1;
      const int64_t rb = __shfl_sync(rsem::kFullMask, b, src);
      const int64_t re = __shfl_sync(rsem::kFullMask, e, src);
      const int64_t rr = g * 32 + src;
      float d = 0.f;
      for (int64_t h = rb + lane; h < re; h += 32)
        d += __ldg(theta + __ldg(sid + h)) * __ldg(cps + h);
      for (int o = 16; o > 0; o >>= 1)
        d += __shfl_xor_sync(rsem::kFullMask, d, o);
      const float w0 = th0 * __ldg(ncs + rr);
      const float denom = d + w0;
      const float inv = denom > 0.f ? 1.f / denom : 0.f;
      for (int64_t h = rb + lane; h < re; h += 32) {
        const float u = __ldg(cps + h) * inv;
        if (u != 0.f) atomicAdd(contrib + __ldg(sid + h), (double)u);
      }
      if (lane == 0) my_noise += (double)(w0 * inv);
    }
  }
  for (int o = 16; o > 0; o >>= 1)
    my_noise += __shfl_xor_sync(rsem::kFullMask, my_noise, o);
  if (lane == 0) s_noise[warp] = my_noise;
  __syncthreads();
  if (threadIdx.x == 0) {
    double s = 0.0;
    for (int i = 0; i < kWarpsPerBlock; ++i) s += s_noise[i];
    if (s != 0.0) atomicAdd(noise, s);
  }
}

}  // namespace

// contrib: zeroed f64 [M+1]; noise: zeroed f64 [1].
extern "C" int rsem_theta_round(const int32_t* sid, const float* cps,
                                const float* ncs, const int64_t* offsets,
                                int64_t n_reads, const float* theta,
                                double* contrib, double* noise,
                                cudaStream_t stream) {
  if (n_reads == 0) return (int)cudaGetLastError();
  const int64_t n_groups = (n_reads + 31) / 32;
  const int grid = rsem::grid_for(n_groups, kWarpsPerBlock, 8);
  theta_round_kernel<<<grid, kThreads, 0, stream>>>(
      sid, cps, ncs, offsets, n_reads, theta, contrib, noise);
  return (int)cudaGetLastError();
}
