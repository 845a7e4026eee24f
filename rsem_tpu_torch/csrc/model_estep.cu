// E-step statistics of one fused model-update round: per-hit weights, the
// per-read denominators, the fractions, the expected counts and the
// fragment-length and read-start histograms, in one pass over the reads.
//
// Replaces no Pallas kernel: it stands for the JAX loop's seg_sum_sorted
// (the per-read denominators) and onehot_scatter (the expected counts and
// the two histograms) in rsem_tpu/ops/model_loop.py, which the port had
// run as five float64 index_add_ over all H hits a round and a dozen
// elementwise passes. From the round's log conprbs lp (per hit) and lnp
// (per read), theta and the frozen per-read scale s0:
//   w_h       = exp(min(lp_h + log theta[sid_h] - s0_r, max_drift))  f32
//   w0_r      = exp(min(lnp_r + log theta[0] - s0_r, max_drift))     f32
//   inv_r     = f32(1 / (sum_{hits h of r} w_h + w0_r))  (f64 sum; 0
//               where the sum is 0)
//   frac_h    = w_h * inv_r,  frac_noise_r = w0_r * inv_r            f32
//   counts[sid_h] += frac_h,  counts[0] += sum_r frac_noise_r        f64
//   gld[ins_h] += frac_h                                      (paired)
//   rspd[b0_h] += frac_h * rw0_h,  rspd[b1_h] += frac_h * rw1_h  (est-RSPD)
// The caller zeroes counts, gld and rspd; K3 then scatters frac and
// frac_noise into the profile and noise statistics.
//
// What bounds it on the H100: per hit it reads lp, sid, rid and, paired
// with est-RSPD, the insert slot and two bins and their weights (32 bytes),
// writes frac (4) and adds into counts[sid] in L2; per read lnp, s0, the
// offset and frac_noise (20): ~1.6 GB a round at 37M hits and 13.5M reads,
// ~0.5 ms at 3.35 TB/s. What held index_add_ at ~40 times that was
// contention: every hit's f64 atomic went to device memory, and two of
// the five calls put all 37M onto the 20 read-start bins. This kernel
// takes 1.3 ms a round at those shapes on an H100 at 700 W (~36% of the
// bound), where the ops it replaced took 50 ms.
//
// Design, K1's reads kernel (csrc/theta_round.cu) with the statistics
// added: a warp takes 32 consecutive reads and walks their hits (one CSR
// range) 32 at a time with coalesced loads; the denominators are a
// segmented f64 shuffle scan keyed by rid into shared memory, with no
// atomics; each lane then finishes one read, and a second walk (the hits
// again, from L1) forms frac, with one f64 atomic per hit into counts and
// the histogram slots in shared memory: one fragment-length copy per
// block, one read-start copy per warp (its 20 bins take the most
// collisions). Zero terms are not added. At the block's end the noise sum
// goes to counts[0] and each non-zero slot to gld or rspd, one f64 atomic
// each. Shared-memory f64 adds are compare-and-swap loops on sm_90, so
// lanes that meet on a slot retry; the per-warp read-start copies keep the
// other warps out of those retries. The atomics make the f64 sums' last
// bits depend on the order in which they land, as index_add_ on the card
// does; the f32 values do not.

#include "common.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
// histogram slots (f64) that fit the opt-in shared memory beside the
// kernel's static arrays
constexpr int kMaxHistSlots = 27 * 1024;

__device__ __forceinline__ float safe_log(float x) {
  return x > 0.f ? logf(x) : -INFINITY;
}

// exp(min(x, cap)), a NaN kept as torch's clamp keeps it
__device__ __forceinline__ float capped_exp(float x, float cap) {
  return expf(x > cap ? cap : x);
}

template <bool kPaired, bool kRspd>
__global__ void __launch_bounds__(kThreads) estep_kernel(
    const float* __restrict__ lp, const float* __restrict__ lnp,
    const float* __restrict__ theta, const float* __restrict__ s0,
    const int32_t* __restrict__ sid, const int32_t* __restrict__ rid,
    const int64_t* __restrict__ offsets, int64_t n_reads,
    const int32_t* __restrict__ ins, int n_gld,
    const int32_t* __restrict__ b0, const float* __restrict__ rw0,
    const int32_t* __restrict__ b1, const float* __restrict__ rw1,
    int n_rspd, float max_drift, float* __restrict__ frac,
    float* __restrict__ frac_noise, double* __restrict__ counts,
    double* __restrict__ gld, double* __restrict__ rspd) {
  extern __shared__ double s_hist[];  // gld [n_gld], rspd [kWarps][n_rspd]
  __shared__ double s_den[kWarps][32];
  __shared__ float s_s0[kWarps][32];
  __shared__ float s_inv[kWarps][32];
  __shared__ double s_warp[kWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_hist = n_gld + kWarps * n_rspd;
  for (int i = threadIdx.x; i < n_hist; i += kThreads) s_hist[i] = 0.0;
  __syncthreads();
  double* const h_rspd = s_hist + n_gld + warp * n_rspd;
  double* const den = s_den[warp];
  float* const s0w = s_s0[warp];
  float* const inv = s_inv[warp];
  const float lt0 = safe_log(__ldg(theta));
  double my_noise = 0.0;
  const int64_t n_groups = (n_reads + 31) / 32;
  for (int64_t g = (int64_t)blockIdx.x * kWarps + warp; g < n_groups;
       g += (int64_t)gridDim.x * kWarps) {
    const int64_t r0 = g * 32;
    const int nr = (int)min((int64_t)32, n_reads - r0);
    const int64_t hb = __ldg(offsets + r0), he = __ldg(offsets + r0 + nr);
    den[lane] = 0.0;
    s0w[lane] = lane < nr ? __ldg(s0 + r0 + lane) : 0.f;
    __syncwarp();
    for (int64_t h0 = hb; h0 < he; h0 += 32) {
      const int64_t h = h0 + lane;
      int key = -1;  // the hit's read in the group; -1 past the range
      double w = 0.0;
      if (h < he) {
        key = (int)(__ldg(rid + h) - r0);
        w = (double)capped_exp(
            __ldg(lp + h) + safe_log(__ldg(theta + __ldg(sid + h))) -
                s0w[key],
            max_drift);
      }
      // inclusive scan within runs of one key (hits are sorted by read)
      for (int o = 1; o < 32; o <<= 1) {
        const double wu = __shfl_up_sync(rsem::kFullMask, w, o);
        const int ku = __shfl_up_sync(rsem::kFullMask, key, o);
        if (lane >= o && ku == key) w += wu;
      }
      const int kn = __shfl_down_sync(rsem::kFullMask, key, 1);
      if (key >= 0 && (lane == 31 || kn != key)) den[key] += w;
      __syncwarp();
    }
    float iv = 0.f;
    if (lane < nr) {
      const int64_t r = r0 + lane;
      const float w0 =
          capped_exp(__ldg(lnp + r) + lt0 - s0w[lane], max_drift);
      const double d = den[lane] + (double)w0;
      iv = d > 0.0 ? __double2float_rn(1.0 / d) : 0.f;
      const float fn = w0 * iv;
      frac_noise[r] = fn;
      my_noise += (double)fn;
    }
    inv[lane] = iv;
    __syncwarp();
    for (int64_t h = hb + lane; h < he; h += 32) {
      const int key = (int)(__ldg(rid + h) - r0);
      const int32_t t = __ldg(sid + h);
      const float w = capped_exp(
          __ldg(lp + h) + safe_log(__ldg(theta + t)) - s0w[key], max_drift);
      const float f = w * inv[key];
      frac[h] = f;
      if (f == 0.f) continue;
      atomicAdd(counts + t, (double)f);
      if (kPaired) atomicAdd(s_hist + __ldg(ins + h), (double)f);
      if (kRspd) {
        const float a = f * __ldg(rw0 + h);
        if (a != 0.f) atomicAdd(h_rspd + __ldg(b0 + h), (double)a);
        const float b = f * __ldg(rw1 + h);
        if (b != 0.f) atomicAdd(h_rspd + __ldg(b1 + h), (double)b);
      }
    }
    __syncwarp();
  }
  // block_sum's barrier also ends every warp's histogram adds
  const double s = rsem::block_sum<kWarps>(my_noise, s_warp);
  if (threadIdx.x == 0 && s != 0.0) atomicAdd(counts, s);
  for (int i = threadIdx.x; i < n_gld; i += kThreads) {
    const double v = s_hist[i];
    if (v != 0.0) atomicAdd(gld + i, v);
  }
  for (int b = threadIdx.x; b < n_rspd; b += kThreads) {
    double v = 0.0;
    for (int c = 0; c < kWarps; ++c) v += s_hist[n_gld + c * n_rspd + b];
    if (v != 0.0) atomicAdd(rspd + b, v);
  }
}

template <bool kPaired, bool kRspd>
cudaError_t launch(const float* lp, const float* lnp, const float* theta,
                   const float* s0, const int32_t* sid, const int32_t* rid,
                   const int64_t* offsets, int64_t n_reads,
                   const int32_t* ins, int n_gld, const int32_t* b0,
                   const float* rw0, const int32_t* b1, const float* rw1,
                   int n_rspd, float max_drift, float* frac,
                   float* frac_noise, double* counts, double* gld,
                   double* rspd, cudaStream_t stream) {
  const auto kernel = estep_kernel<kPaired, kRspd>;
  const size_t smem = (size_t)(n_gld + kWarps * n_rspd) * sizeof(double);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const int grid = rsem::resident_grid(kernel, kThreads, (n_reads + 31) / 32,
                                       kWarps, smem);
  kernel<<<grid, kThreads, smem, stream>>>(
      lp, lnp, theta, s0, sid, rid, offsets, n_reads, ins, n_gld, b0, rw0,
      b1, rw1, n_rspd, max_drift, frac, frac_noise, counts, gld, rspd);
  return cudaGetLastError();
}

}  // namespace

// One round's E-step statistics (above) over n_reads reads and their hits
// (read_offsets [n_reads + 1] from 0, rid 0-based, sorted). Adds into
// counts [M+1], gld [n_gld] (paired; n_gld 0 otherwise) and rspd [n_rspd]
// (est-RSPD; 0 otherwise), and writes frac [H] and frac_noise [n_reads].
// Allocates nothing and does not synchronise; more than 27,648 histogram
// slots (n_gld + 8 * n_rspd) are refused.
extern "C" int rsem_estep_stats(
    const float* lp, const float* lnp, const float* theta, const float* s0,
    const int32_t* sid, const int32_t* rid, const int64_t* read_offsets,
    int64_t n_reads, const int32_t* ins_idx, int n_gld, const int32_t* rs_b0,
    const float* rs_w0, const int32_t* rs_b1, const float* rs_w1,
    int n_rspd, float max_drift, int paired, int est_rspd, float* frac,
    float* frac_noise, double* counts, double* gld, double* rspd,
    cudaStream_t stream) {
  if (n_reads < 0 || (paired ? n_gld <= 0 : n_gld != 0) ||
      (est_rspd ? n_rspd <= 0 : n_rspd != 0) ||
      n_gld + kWarps * n_rspd > kMaxHistSlots)
    return (int)cudaErrorInvalidValue;
  const auto run =
      paired ? (est_rspd ? &launch<true, true> : &launch<true, false>)
             : (est_rspd ? &launch<false, true> : &launch<false, false>);
  return (int)run(lp, lnp, theta, s0, sid, rid, read_offsets, n_reads,
                  ins_idx, n_gld, rs_b0, rs_w0, rs_b1, rs_w1, n_rspd,
                  max_drift, frac, frac_noise, counts, gld, rspd, stream);
}
