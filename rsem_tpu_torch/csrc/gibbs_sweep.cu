// Collapsed-Gibbs tile sweep (K5) over one bucket part, all chains.
//
// Replaces rsem_tpu/ops/pallas_gibbs.py: _sweep_kernel (called from
// sweep_part). A part is n_tiles tiles of 8192 alignment slots; read r of a
// tile owns slots [r*K, (r+1)*K) (K a power of two). Each tile is one block
// of the blocked collapse: every read samples against the counts as they
// stood at the start of the tile, then the tile's +-1 deltas are applied.
//
// What bounds it on the H100: not bytes (one sweep at the full-width
// workload moves ~60 MB, ~18 us at 3.35 TB/s) but the chain of tiles, which
// must run in order within a chain: 359 dependent tile steps per sweep, each
// a table gather, a few block-wide barriers and the delta atomics. This first
// design takes the TPU grid's sequential dimension as a loop inside the
// block: one block of 1024 threads per chain walks the part's tiles, so 8
// chains keep 8 of 132 SMs busy. Making it fast is later work.
//
// Exactness (the plain PyTorch version in ops/gibbs.py agrees bit for bit):
//  * group sums run the TPU's XOR butterfly (x + x[j ^ s]) and the prefix
//    its Hillis-Steele order (within 128-slot rows, then across rows), as
//    warp shuffles for K <= 32 and in shared memory above;
//  * float arithmetic uses __fadd_rn/__fsub_rn/__fmul_rn, which nvcc never
//    contracts into a fused multiply-add;
//  * the counter hash runs in uint32 (wrap-around, logical shifts);
//  * the deltas of a tile are summed per sid in an int32 scratch (atomics,
//    exact in any order) and added to the f32 table once per sid, so a
//    table holding fractional pseudo-counts rounds as the TPU's one-hot
//    contraction did.
//
// The count table stays in device memory (20,001 x 4 B per chain at full
// width: L2-resident); there is no M cap.

#include <climits>

#include "common.cuh"

namespace {

constexpr int kThreads = 1024;
constexpr int kTileSlots = 8192;
constexpr int kPerThread = kTileSlots / kThreads;  // slots per thread
constexpr int kLanes = 128;
constexpr int kRowsPerTile = kTileSlots / kLanes;  // 64
constexpr int kMaxWideReads = kTileSlots / 64;     // reads per tile, K >= 64
constexpr uint32_t kGolden = 0x9E3779B9u;
constexpr uint32_t kTileMul = 0x7F4A7C15u;

__device__ __forceinline__ uint32_t mix32(uint32_t h) {
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  h ^= h >> 16;
  return h;
}

// f32 uniform of a read with 24 random bits, keyed on its first slot.
__device__ __forceinline__ float read_uniform(uint32_t h, int c, int first) {
  const uint32_t k = h + (uint32_t)c * (uint32_t)kTileSlots + (uint32_t)first;
  return (float)((mix32(mix32(k)) >> 7) & 0xFFFFFFu) * (1.0f / 16777216.0f);
}

struct Shared {
  int new_slot[kTileSlots];  // sampled slot of each read of the tile
  int dnoise;                // tile's net move onto hits (noise moves -)
  // K >= 64 only
  int last[kMaxWideReads];
  int chosen[kMaxWideReads];
  float row_total[kRowsPerTile];
  float row_acc[kRowsPerTile];
};

// Slot-level inputs of one read: everything but the group reductions.
struct Slot {
  int f, r, j, a;
  float w, w0, u;
};

__device__ __forceinline__ Slot load_slot(
    const int32_t* __restrict__ sid, const float* __restrict__ cps,
    const float* __restrict__ ncs, const int32_t* asg, const float* tab,
    int64_t sbase, int64_t rbase, int f, int log_k, float c0, uint32_t h,
    int c) {
  Slot s;
  s.f = f;
  s.r = f >> log_k;
  s.j = f & ((1 << log_k) - 1);
  s.a = asg[rbase + s.r];
  const bool has = s.a >= 0;
  const int my_sid = sid[sbase + f];
  const int cur = has ? sid[sbase + ((int64_t)s.r << log_k) + s.a] : -1;
  const float own = (has && my_sid == cur) ? 1.0f : 0.0f;
  s.w = __fmul_rn(fmaxf(__fsub_rn(tab[my_sid], own), 0.0f),
                  cps[sbase + f]);
  const float own0 = has ? 0.0f : 1.0f;
  s.w0 = __fmul_rn(fmaxf(__fsub_rn(c0, own0), 0.0f), ncs[rbase + s.r]);
  s.u = read_uniform(h, c, s.r << log_k);
  return s;
}

// Record a read's sampled slot and its +-1 deltas (one thread per read).
__device__ __forceinline__ void record(Shared& sh, const int32_t* sid,
                                       int32_t* d, int64_t sbase, int log_k,
                                       const Slot& s, int nw, int* dn) {
  sh.new_slot[s.r] = nw;
  if (nw == s.a) return;
  const int64_t first = sbase + ((int64_t)s.r << log_k);
  if (s.a >= 0) atomicAdd(d + sid[first + s.a], -1);
  if (nw >= 0) atomicAdd(d + sid[first + nw], 1);
  *dn += (nw >= 0 ? 1 : 0) - (s.a >= 0 ? 1 : 0);
}

__device__ __forceinline__ void flush(int32_t* d, float* tab, int s) {
  const int v = atomicExch(d + s, 0);
  if (v != 0) tab[s] = __fadd_rn(tab[s], (float)v);
}

template <bool kWarp>  // kWarp: K <= 32, a read's slots lie in one warp
__global__ void __launch_bounds__(kThreads)
    gibbs_sweep_kernel(const int32_t* __restrict__ sid,
                       const float* __restrict__ cps,
                       const float* __restrict__ ncs, int32_t* assign,
                       float* table, int32_t* dscratch, int n_tiles,
                       int log_k, int64_t n_reads, int64_t T,
                       uint32_t seed_part, uint32_t sweep) {
  extern __shared__ float dyn[];  // K >= 64: tot[8192], pre[8192]
  __shared__ Shared sh;
  const int c = blockIdx.x;
  const int K = 1 << log_k;
  const int rpt = kTileSlots >> log_k;
  const int tid = threadIdx.x;
  float* tab = table + (int64_t)c * T;
  int32_t* d = dscratch + (int64_t)c * T;
  int32_t* asg = assign + (int64_t)c * n_reads;
  float* s_tot = dyn;
  float* s_pre = dyn + kTileSlots;
  const uint32_t h_sweep = seed_part + sweep * kGolden;

  if (tid == 0) sh.dnoise = 0;
  if (!kWarp)
    for (int r = tid; r < kMaxWideReads; r += kThreads) {
      sh.last[r] = -1;
      sh.chosen[r] = INT_MAX;
    }
  __syncthreads();

  for (int t = 0; t < n_tiles; ++t) {
    const int64_t sbase = (int64_t)t * kTileSlots;
    const int64_t rbase = (int64_t)t * rpt;
    const uint32_t h = mix32(h_sweep + (uint32_t)t * kTileMul);
    const float c0 = tab[0];
    int dn = 0;

    if (kWarp) {
#pragma unroll 1
      for (int q = 0; q < kPerThread; ++q) {
        const Slot s = load_slot(sid, cps, ncs, asg, tab, sbase, rbase,
                                 q * kThreads + tid, log_k, c0, h, c);
        float tot = s.w, pre = s.w;
        for (int o = 1; o < K; o <<= 1)
          tot = __fadd_rn(tot, __shfl_xor_sync(rsem::kFullMask, tot, o));
        for (int o = 1; o < K; o <<= 1) {
          const float up = __shfl_up_sync(rsem::kFullMask, pre, o);
          if (s.j >= o) pre = __fadd_rn(pre, up);
        }
        const float target = __fmul_rn(s.u, __fadd_rn(tot, s.w0));
        const bool pick_noise = target < s.w0;
        const float t2 = __fsub_rn(target, s.w0);
        int last = s.w > 0.0f ? s.j : -1;
        for (int o = 1; o < K; o <<= 1)
          last = max(last, __shfl_xor_sync(rsem::kFullMask, last, o));
        int chosen = pre > t2 ? s.j : last;
        for (int o = 1; o < K; o <<= 1)
          chosen = min(chosen, __shfl_xor_sync(rsem::kFullMask, chosen, o));
        if (s.j == 0)
          record(sh, sid, d, sbase, log_k,
                 s, (!pick_noise && chosen >= 0) ? chosen : -1, &dn);
      }
    } else {
      Slot s[kPerThread];
#pragma unroll
      for (int q = 0; q < kPerThread; ++q) {
        s[q] = load_slot(sid, cps, ncs, asg, tab, sbase, rbase,
                         q * kThreads + tid, log_k, c0, h, c);
        s_tot[s[q].f] = s[q].w;
        s_pre[s[q].f] = s[q].w;
        if (s[q].w > 0.0f) atomicMax(&sh.last[s[q].r], s[q].j);
      }
      __syncthreads();
      // butterfly sums: x + x[f ^ o]
      for (int o = 1; o < K; o <<= 1) {
        float v[kPerThread];
#pragma unroll
        for (int q = 0; q < kPerThread; ++q)
          v[q] = __fadd_rn(s_tot[s[q].f], s_tot[s[q].f ^ o]);
        __syncthreads();
#pragma unroll
        for (int q = 0; q < kPerThread; ++q) s_tot[s[q].f] = v[q];
        __syncthreads();
      }
      // Hillis-Steele within each read's part of a 128-slot row
      const int width = K < kLanes ? K : kLanes;
      for (int o = 1; o < width; o <<= 1) {
        float v[kPerThread];
#pragma unroll
        for (int q = 0; q < kPerThread; ++q) {
          const int f = s[q].f;
          v[q] = (f & (width - 1)) >= o ? __fadd_rn(s_pre[f], s_pre[f - o])
                                        : s_pre[f];
        }
        __syncthreads();
#pragma unroll
        for (int q = 0; q < kPerThread; ++q) s_pre[s[q].f] = v[q];
        __syncthreads();
      }
      if (K > kLanes) {  // then across the rows of a read
        const int rpr = K / kLanes;
        if (tid < kRowsPerTile) {
          const float rt = s_pre[tid * kLanes + kLanes - 1];
          sh.row_total[tid] = rt;
          sh.row_acc[tid] = rt;
        }
        __syncthreads();
        for (int o = 1; o < rpr; o <<= 1) {
          float v = 0.0f;
          if (tid < kRowsPerTile)
            v = (tid & (rpr - 1)) >= o
                    ? __fadd_rn(sh.row_acc[tid], sh.row_acc[tid - o])
                    : sh.row_acc[tid];
          __syncthreads();
          if (tid < kRowsPerTile) sh.row_acc[tid] = v;
          __syncthreads();
        }
#pragma unroll
        for (int q = 0; q < kPerThread; ++q) {
          const int row = s[q].f / kLanes;
          s_pre[s[q].f] = __fadd_rn(
              s_pre[s[q].f], __fsub_rn(sh.row_acc[row], sh.row_total[row]));
        }
        __syncthreads();
      }
      float t2[kPerThread];
      bool pick_noise[kPerThread];
#pragma unroll
      for (int q = 0; q < kPerThread; ++q) {
        const float target =
            __fmul_rn(s[q].u, __fadd_rn(s_tot[s[q].f], s[q].w0));
        pick_noise[q] = target < s[q].w0;
        t2[q] = __fsub_rn(target, s[q].w0);
        atomicMin(&sh.chosen[s[q].r],
                  s_pre[s[q].f] > t2[q] ? s[q].j : sh.last[s[q].r]);
      }
      __syncthreads();
#pragma unroll
      for (int q = 0; q < kPerThread; ++q) {
        if (s[q].j != 0) continue;
        const int chosen = sh.chosen[s[q].r];
        record(sh, sid, d, sbase, log_k, s[q],
               (!pick_noise[q] && chosen >= 0) ? chosen : -1, &dn);
        sh.last[s[q].r] = -1;
        sh.chosen[s[q].r] = INT_MAX;
      }
    }

    // noise delta of the tile
    for (int o = 16; o > 0; o >>= 1)
      dn += __shfl_xor_sync(rsem::kFullMask, dn, o);
    if ((tid & 31) == 0 && dn != 0) atomicAdd(&sh.dnoise, dn);
    __syncthreads();  // every read has sampled; all deltas are recorded

    // apply: each touched sid once, then the moved reads' new slots
    for (int r = tid; r < rpt; r += kThreads) {
      const int a = asg[rbase + r];
      const int nw = sh.new_slot[r];
      if (nw == a) continue;
      const int64_t first = sbase + ((int64_t)r << log_k);
      if (a >= 0) flush(d, tab, sid[first + a]);
      if (nw >= 0) flush(d, tab, sid[first + nw]);
      asg[rbase + r] = nw;
    }
    if (tid == 0) {
      tab[0] = __fsub_rn(tab[0], (float)sh.dnoise);
      sh.dnoise = 0;
    }
    __syncthreads();
  }
}

}  // namespace

// One sweep of a part's tiles for every chain, in place. sid/cps: [n_tiles *
// 8192]; ncs: [n_tiles * 8192 / K]; assign: [C, n_reads] slot of each read
// (-1 = noise); table: [C, T] f32 counts + pseudo (index 0 = noise);
// dscratch: [C, T] int32 zeros (left zero).
extern "C" int rsem_gibbs_sweep(const int32_t* sid, const float* cps,
                                const float* ncs, int32_t* assign,
                                float* table, int32_t* dscratch, int n_tiles,
                                int log_k, int C, int64_t n_reads, int64_t T,
                                uint32_t seed_part, uint32_t sweep,
                                cudaStream_t stream) {
  if (n_tiles == 0 || C == 0) return (int)cudaGetLastError();
  if (log_k < 0 || (1 << log_k) > kTileSlots || T <= 0 ||
      n_reads != (int64_t)n_tiles * (kTileSlots >> log_k))
    return (int)cudaErrorInvalidValue;
  if (log_k <= 5) {
    gibbs_sweep_kernel<true><<<C, kThreads, 0, stream>>>(
        sid, cps, ncs, assign, table, dscratch, n_tiles, log_k, n_reads, T,
        seed_part, sweep);
  } else {
    const int smem = 2 * kTileSlots * (int)sizeof(float);
    cudaError_t e = cudaFuncSetAttribute(
        gibbs_sweep_kernel<false>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    gibbs_sweep_kernel<false><<<C, kThreads, smem, stream>>>(
        sid, cps, ncs, assign, table, dscratch, n_tiles, log_k, n_reads, T,
        seed_part, sweep);
  }
  return (int)cudaGetLastError();
}
