// Theta-only EM rounds over frozen, per-read max-scaled conprbs (K1), the
// M-step and the stop test included, enqueued a segment at a time.
//
// Replaces rsem_tpu/ops/pallas_round.py: _round_kernel (with the bucket
// layout of build_pallas_data around it) and the body of the on-device
// while_loop of rsem_tpu/ops/fast_estep.py: run_fast_em_loop. Round i reads
// theta = ring[i] and writes ring[i + 1], the counts and tot[i]:
//   inv_r     = 1 / (sum_h theta[sid_h] * cps_h + theta[0] * ncs_r)
//   counts[m] = theta[m] * sum_{hits h of m} cps_h * inv_{read of h}
//   counts[0] = sum_r theta[0] * ncs_r * inv_r + n0
//   ring[i+1] = f32(counts / sum(counts))          (f64 sums)
//   tot[i]    = #{m : theta[m] >= 1e-7f, |new - theta| / theta >= 1e-3f}
// (the last in f32, as the reference loop's test, EM.cpp:407-416).
//
// What bounds it on the H100: latency. One round reads H * (4 + 4 + 4) + N
// * (4 + 8) bytes and ~(M+1) * 24 (about 42 MB at 2.5M hits, 1M reads:
// ~13 us at 3.35 TB/s); at this size dependent gathers, launch gaps and
// the reductions across blocks set the time, and on the loop a host read
// per round cost more than the round. So a round allocates and zeroes
// nothing (the caller owns every buffer; each kernel resets what a later
// one accumulates into), the M-step and the stop count run on the device,
// and the host enqueues a whole segment of rounds with one call and reads
// the segment's stop counts once.
//
// Design, three kernels per round:
//  1. reads: a warp takes 32 consecutive reads and walks their hits (one
//     contiguous CSR range) 32 at a time with coalesced loads of sid, rid
//     and cps; the per-read denominators are a segmented sum over the
//     lanes (shuffle scan, keyed by rid) into shared memory, then each lane
//     finishes one read and a second walk adds cps * inv into
//     contrib[sid] with f64 atomics (2.5M of them, which L2 absorbs; a
//     deterministic form without atomics, a warp per transcript over a
//     sid-ordered copy gathering inv[rid], measured slower). The noise sum
//     goes to acc[0] with one f64 atomic per block.
//  2. counts over M+1: counts = contrib * theta, counts[0] = noise + n0,
//     contrib left zero, the total summed per block into acc[1].
//  3. M-step over M+1: ring[i+1] and the stop count (integer atomics, so
//     exact); acc[0] left zero.
// The atomics make the f64 sums' last bits depend on the order in which
// blocks finish, as index_add_ on the card does.
//
// Read-sharded rounds (parallel/fast_sharded.py) split a round in two C
// calls around one all_reduce: rsem_theta_partial runs kernel 1 on the
// rank's reads, leaving its partial contrib and noise sum in the caller's
// buffer; the ranks sum [contrib | acc[0]] (contiguous, M+2 doubles); then
// rsem_theta_finish runs kernels 2 and 3 on the sums, with the total
// recomputed between them by one block in a fixed order (total_kernel), so
// the total, theta and the stop count are the same bits on every rank
// whatever order kernel 2's blocks added theirs in, and all ranks stop at
// the same round.

#include "common.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr float kThetaCut = 1e-7f;  // THETA_CUT
constexpr float kStop = 1e-3f;      // STOP_CRITERIA
enum { kNoise = 0, kTotal = 1 };    // slots of acc

__global__ void __launch_bounds__(kThreads) reads_kernel(
    const int32_t* __restrict__ sid, const int32_t* __restrict__ rid,
    const float* __restrict__ cps, const float* __restrict__ ncs,
    const int64_t* __restrict__ offsets, int64_t n_reads,
    const float* __restrict__ theta, double* __restrict__ contrib,
    double* __restrict__ acc, int32_t* __restrict__ tot) {
  __shared__ float s_den[kWarps][32];
  __shared__ double s_warp[kWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  float* den = s_den[warp];
  const float th0 = __ldg(theta);
  double my_noise = 0.0;
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    acc[kTotal] = 0.0;  // read by the last round's M-step, summed below
    *tot = 0;
  }
  const int64_t n_groups = (n_reads + 31) / 32;
  for (int64_t g = (int64_t)blockIdx.x * kWarps + warp; g < n_groups;
       g += (int64_t)gridDim.x * kWarps) {
    const int64_t r0 = g * 32;
    const int nr = (int)min((int64_t)32, n_reads - r0);
    const int64_t hb = __ldg(offsets + r0), he = __ldg(offsets + r0 + nr);
    den[lane] = 0.f;
    __syncwarp();
    for (int64_t h0 = hb; h0 < he; h0 += 32) {
      const int64_t h = h0 + lane;
      int key = -1;  // the hit's read in the group; -1 past the range
      float w = 0.f;
      if (h < he) {
        key = (int)(__ldg(rid + h) - r0);
        w = __ldg(theta + __ldg(sid + h)) * __ldg(cps + h);
      }
      // inclusive scan within runs of one key (hits are sorted by read)
      for (int o = 1; o < 32; o <<= 1) {
        const float wu = __shfl_up_sync(rsem::kFullMask, w, o);
        const int ku = __shfl_up_sync(rsem::kFullMask, key, o);
        if (lane >= o && ku == key) w += wu;
      }
      const int kn = __shfl_down_sync(rsem::kFullMask, key, 1);
      if (key >= 0 && (lane == 31 || kn != key)) den[key] += w;
      __syncwarp();
    }
    float inv = 0.f;
    if (lane < nr) {
      const float w0 = th0 * __ldg(ncs + r0 + lane);
      const float denom = den[lane] + w0;
      inv = denom > 0.f ? 1.f / denom : 0.f;
      my_noise += (double)(w0 * inv);
    }
    __syncwarp();
    den[lane] = inv;
    __syncwarp();
    for (int64_t h = hb + lane; h < he; h += 32) {
      const float u = __ldg(cps + h) * den[__ldg(rid + h) - r0];
      if (u != 0.f) atomicAdd(contrib + __ldg(sid + h), (double)u);
    }
    __syncwarp();
  }
  const double s = rsem::block_sum<kWarps>(my_noise, s_warp);
  if (threadIdx.x == 0 && s != 0.0) atomicAdd(acc + kNoise, s);
}

__global__ void __launch_bounds__(kThreads) counts_kernel(
    double* __restrict__ contrib, int64_t n_tx,
    const float* __restrict__ theta, double n0, double* __restrict__ counts,
    double* __restrict__ acc) {
  __shared__ double s_warp[kWarps];
  double mine = 0.0;
  for (int64_t m = (int64_t)blockIdx.x * kThreads + threadIdx.x; m < n_tx;
       m += (int64_t)gridDim.x * kThreads) {
    const double c = contrib[m];
    contrib[m] = 0.0;
    if (m > 0) {
      const double v = c * (double)__ldg(theta + m);
      counts[m] = v;
      mine += v;
    }
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    const double c0 = acc[kNoise] + n0;
    counts[0] = c0;
    mine += c0;
  }
  const double s = rsem::block_sum<kWarps>(mine, s_warp);
  if (threadIdx.x == 0) atomicAdd(acc + kTotal, s);
}

__global__ void __launch_bounds__(kThreads) mstep_kernel(
    const float* __restrict__ theta, const double* __restrict__ counts,
    double* __restrict__ acc, float* __restrict__ theta_new, int64_t n_tx,
    int32_t* __restrict__ tot) {
  const double total = acc[kTotal];
  int n = 0;
  for (int64_t m = (int64_t)blockIdx.x * kThreads + threadIdx.x; m < n_tx;
       m += (int64_t)gridDim.x * kThreads) {
    const float tn = __double2float_rn(counts[m] / total);
    const float th = theta[m];
    theta_new[m] = tn;
    n += th >= kThetaCut && fabsf(tn - th) / th >= kStop;
  }
  n = __reduce_add_sync(rsem::kFullMask, n);
  if ((threadIdx.x & 31) == 0 && n) atomicAdd(tot, n);
  if (blockIdx.x == 0 && threadIdx.x == 0) acc[kNoise] = 0.0;
}

// The total of counts[0..n_tx) summed in a fixed order (thread t takes t,
// t + 1024, ...; then the warps' butterflies and the warps in order) into
// acc[1], over the counts kernel's order-dependent atomic sum.
constexpr int kTotalThreads = 1024;

__global__ void __launch_bounds__(kTotalThreads) total_kernel(
    const double* __restrict__ counts, int64_t n_tx,
    double* __restrict__ acc) {
  __shared__ double s_warp[kTotalThreads / 32];
  double v = 0.0;
  for (int64_t m = threadIdx.x; m < n_tx; m += kTotalThreads) v += counts[m];
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(rsem::kFullMask, v, o);
  if ((threadIdx.x & 31) == 0) s_warp[threadIdx.x >> 5] = v;
  __syncthreads();
  if (threadIdx.x == 0) {
    double t = 0.0;
    for (int i = 0; i < kTotalThreads / 32; ++i) t += s_warp[i];
    acc[kTotal] = t;
  }
}

}  // namespace

// Runs n_rounds rounds from ring[0] (ring: [n_rounds + 1, n_tx] f32),
// writing ring[1..n_rounds], counts (f64 [n_tx], the last round's) and
// tot[0..n_rounds). Scratch owned by the caller and reused: contrib f64
// [n_tx] and acc f64 [2], zero at the first call; the kernels leave
// contrib and acc[0] zero.
extern "C" int rsem_theta_rounds(
    const int32_t* sid, const int32_t* rid, const float* cps,
    const float* ncs, const int64_t* read_offsets, int64_t n_reads,
    int64_t n_tx, double n0, float* ring, double* counts, int32_t* tot,
    double* contrib, double* acc, int n_rounds, cudaStream_t stream) {
  if (n_rounds <= 0 || n_tx <= 0 || n_reads < 0)
    return (int)cudaErrorInvalidValue;
  const int g_reads = rsem::resident_grid(reads_kernel, kThreads,
                                          (n_reads + 31) / 32, kWarps);
  const int g_counts =
      rsem::resident_grid(counts_kernel, kThreads, n_tx, kThreads);
  const int g_m = rsem::resident_grid(mstep_kernel, kThreads, n_tx, kThreads);
  for (int i = 0; i < n_rounds; ++i) {
    const float* theta = ring + (int64_t)i * n_tx;
    float* theta_new = ring + (int64_t)(i + 1) * n_tx;
    reads_kernel<<<g_reads, kThreads, 0, stream>>>(
        sid, rid, cps, ncs, read_offsets, n_reads, theta, contrib, acc,
        tot + i);
    counts_kernel<<<g_counts, kThreads, 0, stream>>>(contrib, n_tx, theta,
                                                     n0, counts, acc);
    mstep_kernel<<<g_m, kThreads, 0, stream>>>(theta, counts, acc, theta_new,
                                               n_tx, tot + i);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaSuccess;
}

// Kernel 1 of one round on this rank's reads: adds the rank's partial sums
// into contrib (f64 [n_tx]) and acc[0] (the noise sum), and zeroes acc[1]
// and *tot for the finish.
extern "C" int rsem_theta_partial(const int32_t* sid, const int32_t* rid,
                                  const float* cps, const float* ncs,
                                  const int64_t* read_offsets,
                                  int64_t n_reads, const float* theta,
                                  double* contrib, double* acc, int32_t* tot,
                                  cudaStream_t stream) {
  if (n_reads < 0) return (int)cudaErrorInvalidValue;
  const int g_reads = rsem::resident_grid(reads_kernel, kThreads,
                                          (n_reads + 31) / 32, kWarps);
  reads_kernel<<<g_reads, kThreads, 0, stream>>>(
      sid, rid, cps, ncs, read_offsets, n_reads, theta, contrib, acc, tot);
  return (int)cudaGetLastError();
}

// Kernels 2 and 3 of one round on the summed contrib and acc[0]: writes
// counts, theta_new and *tot, and leaves contrib and acc[0] zero. The
// total is summed in a fixed order between them, so every rank computes
// the same bits.
extern "C" int rsem_theta_finish(int64_t n_tx, double n0, const float* theta,
                                 float* theta_new, double* counts,
                                 int32_t* tot, double* contrib, double* acc,
                                 cudaStream_t stream) {
  if (n_tx <= 0) return (int)cudaErrorInvalidValue;
  const int g_counts =
      rsem::resident_grid(counts_kernel, kThreads, n_tx, kThreads);
  const int g_m = rsem::resident_grid(mstep_kernel, kThreads, n_tx, kThreads);
  counts_kernel<<<g_counts, kThreads, 0, stream>>>(contrib, n_tx, theta, n0,
                                                   counts, acc);
  total_kernel<<<1, kTotalThreads, 0, stream>>>(counts, n_tx, acc);
  mstep_kernel<<<g_m, kThreads, 0, stream>>>(theta, counts, acc, theta_new,
                                             n_tx, tot);
  return (int)cudaGetLastError();
}
