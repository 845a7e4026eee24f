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
// must run in order within a chain (359 dependent tile steps per sweep at
// full width), and within a tile step the instructions of 8192 slots. So
// the design is about the latency of one tile step:
//
//  * Staging. Everything a tile reads that does not depend on the chain's
//    state (slot sids and conprbs, read noise coefficients) and the tile's
//    own assignment slice (no other tile touches it) is fetched into a ring
//    of kStages shared-memory buffers by 1-D TMA bulk copies
//    (cp.async.bulk, completing on an mbarrier). A CTA consumes its slots of
//    a tile in chunks of up to 2048; one thread issues chunk g + kStages as
//    soon as chunk g is consumed, so copies run ahead of the sampling,
//    across tile boundaries. Within a tile every read samples against the
//    tile-start counts, so chunks may be processed one after another.
//  * Several SMs per chain (K <= 32). A thread-block cluster of kCluster
//    CTAs takes one chain; each CTA samples 8192 / kCluster slots of every
//    tile (whole reads), which divides the per-SM instruction count of a
//    tile step. Reads of K >= 64 may span CTAs and keep one CTA per chain.
//  * The count table stays in device memory for every T (L2-resident: 8
//    chains x 200,001 x 4 B = 6.4 MB of the 50 MB L2), one copy per chain
//    read through L2 by the cluster's CTAs; a chunk's table gathers are all
//    issued before any is used. A tile's deltas are summed per sid in an
//    int32 scratch [C, T] that the caller allocates zeroed once and the
//    kernel leaves zero. (A replica of the table in each CTA's shared memory
//    was measured no faster at T = 20,001; PERF.md.)
//  * No serial slot loop and no second sid read: a read's current and new
//    slot sids come from the warp (shuffles, K <= 32) or from the slot's own
//    thread (K >= 64) and stay in registers until the tile's deltas are
//    applied.
//
// Exactness (the plain PyTorch version in ops/gibbs.py agrees bit for bit):
//  * every read samples against the tile-start table minus its own
//    assignment;
//  * group sums run the TPU's XOR butterfly (x + x[j ^ s]; since f32
//    addition commutes, every slot of a group holds the same pairwise-tree
//    value, so the steps across warps run on one value per warp) and the
//    prefix its Hillis-Steele order (within 128-slot rows, then across
//    rows), as warp shuffles for K <= 32 and in shared memory above;
//  * float arithmetic uses __fadd_rn/__fsub_rn/__fmul_rn, which nvcc never
//    contracts into a fused multiply-add;
//  * the counter hash runs in uint32 (wrap-around, logical shifts);
//  * the deltas of a tile are summed per sid as integers (atomics, exact in
//    any order) and added to the f32 table once per touched sid; tab[0]
//    moves by the tile's net noise delta.

#include <cooperative_groups.h>

#include <climits>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 1024;
constexpr int kTileSlots = 8192;
constexpr int kMaxChunk = 2048;  // slots per staged chunk
constexpr int kStages = 2;
constexpr int kCluster = 8;  // CTAs per chain for K <= 32
constexpr int kCtrlBytes = 64;
constexpr int kLanes = 128;
constexpr int kRowsPerTile = kTileSlots / kLanes;  // 64
constexpr int kMaxWideReads = kTileSlots / 64;     // reads per tile, K >= 64
constexpr int kGroups = kTileSlots / 32;           // warp-sized slot groups
constexpr uint32_t kGolden = 0x9E3779B9u;
constexpr uint32_t kTileMul = 0x7F4A7C15u;

// A staging buffer of kCh slots: sids, conprbs, then the noise coefficients
// and assignments of their reads (a 16-byte-aligned span around <= kCh).
template <int kCh>
struct Stage {
  static constexpr int kReadCap = kCh + 8;
  static constexpr int kBytes = 2 * kCh * 4 + 2 * kReadCap * 4;
  static constexpr int kRingBytes = kStages * kBytes;
  static_assert(kBytes % 16 == 0, "bulk alignment");
};

// Slots of a staged chunk for a cluster of `cluster` CTAs per chain.
constexpr int chunk_for(int cluster) {
  return kTileSlots / cluster < kMaxChunk ? kTileSlots / cluster : kMaxChunk;
}

// Slots of a tile per CTA and chunk size for a cluster of kR CTAs.
template <int kR>
struct Split {
  static constexpr int kSlice = kTileSlots / kR;
  static constexpr int kCh = chunk_for(kR);
  static constexpr int kChunks = kSlice / kCh;  // per CTA and tile
  static constexpr int kSpc = kCh / kThreads;   // slots per thread, chunk
  static constexpr int kSpt = kSlice / kThreads;
};

struct Params {
  const int32_t* sid;
  const float* cps;
  const float* ncs;
  int32_t* assign;
  float* table;
  int32_t* dscratch;  // [C, T] per-sid delta sums, zero between tiles
  int n_tiles, log_k;
  int64_t n_reads, T;
  uint32_t seed_part, sweep;
  uint32_t chain0;  // global index of chain 0 (the uniforms' chain key)
};

struct Ctrl {
  uint64_t full[kStages];  // a stage's bulk copies have landed
  int dnoise[2];           // tile's net move onto hits, by tile parity
};
static_assert(sizeof(Ctrl) <= kCtrlBytes, "control block");

struct Wide {  // K >= 64 only
  float pre[kTileSlots];
  float part[kGroups];
  int rd_a[kMaxWideReads];
  int rd_cur[kMaxWideReads];
  float rd_w0[kMaxWideReads];
  int last[kMaxWideReads];
  int chosen[kMaxWideReads];
  float row_total[kRowsPerTile];
  float row_acc[kRowsPerTile];
};

// Dynamic shared memory of a launch: the staging ring, the control block
// and (K >= 64) the reduction arrays.
constexpr int64_t kNarrowSmem =
    Stage<Split<kCluster>::kCh>::kRingBytes + kCtrlBytes;
constexpr int64_t kWideSmem =
    Stage<Split<1>::kCh>::kRingBytes + kCtrlBytes + sizeof(Wide);

__device__ __forceinline__ uint32_t mix32(uint32_t h) {
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  h ^= h >> 16;
  return h;
}

// f32 uniform of a read with 24 random bits, keyed on its global chain
// index and its first slot.
__device__ __forceinline__ float read_uniform(uint32_t h, uint32_t c,
                                              int first) {
  const uint32_t k = h + c * (uint32_t)kTileSlots + (uint32_t)first;
  return (float)((mix32(mix32(k)) >> 7) & 0xFFFFFFu) * (1.0f / 16777216.0f);
}

// ---- mbarrier and 1-D bulk copy (TMA) ------------------------------------
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

// Waits for the phase `parity` of bar; a wait that outlasts millions of
// polls (a copy that never lands) traps, so a fault fails the launch
// instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_u32(bar);
  uint32_t done;
  for (uint32_t polls = 0;; ++polls) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
    if (done) return;
    if (polls == (1u << 22)) __trap();
  }
}

__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// The 16-byte-aligned span around n 4-byte elements at p: its start and
// byte count (a bulk copy needs both aligned); lead_of(p) is the number of
// elements the span holds before p.
__device__ __forceinline__ uint32_t span(const void* p, int64_t n,
                                         const void** start) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(p);
  const uintptr_t a0 = a & ~uintptr_t(15);
  *start = reinterpret_cast<const void*>(a0);
  return (uint32_t)(((a + 4 * n + 15) & ~uintptr_t(15)) - a0);
}

__device__ __forceinline__ int lead_of(const void* p) {
  return (int)((reinterpret_cast<uintptr_t>(p) & 15) >> 2);
}

// Issue the bulk copies of the kCh slots of tile t from slot `off` on, and
// of their reads, into ring stage s.
template <int kCh>
__device__ __forceinline__ void issue_chunk(const Params& p,
                                            unsigned char* ring, Ctrl& ctl,
                                            const int32_t* asg_c, int t,
                                            int off, int s) {
  unsigned char* st = ring + s * Stage<kCh>::kBytes;
  const int64_t slot0 = (int64_t)t * kTileSlots + off;
  const int64_t ri = (int64_t)t * (kTileSlots >> p.log_k) + (off >> p.log_k);
  const int nr = max(kCh >> p.log_k, 1);
  const void *n0, *a0;
  const uint32_t nb = span(p.ncs + ri, nr, &n0);
  const uint32_t ab = span(asg_c + ri, nr, &a0);
  mbar_expect_tx(&ctl.full[s], 2 * kCh * 4 + nb + ab);
  bulk_load(st, p.sid + slot0, kCh * 4, &ctl.full[s]);
  bulk_load(st + kCh * 4, p.cps + slot0, kCh * 4, &ctl.full[s]);
  bulk_load(st + 2 * kCh * 4, n0, nb, &ctl.full[s]);
  bulk_load(st + 2 * kCh * 4 + Stage<kCh>::kReadCap * 4, a0, ab,
            &ctl.full[s]);
}

// Stage pointers of the chunk of tile t from slot `off` on; ncs and asg are
// indexed by the read's index within the tile.
struct StageView {
  const int32_t* sid;
  const float* cps;
  const float* ncs;
  const int32_t* asg;
};

template <int kCh>
__device__ __forceinline__ StageView stage_view(const Params& p,
                                                const unsigned char* ring,
                                                const int32_t* asg_c, int t,
                                                int off, int s) {
  const unsigned char* st = ring + s * Stage<kCh>::kBytes;
  const int64_t ri = (int64_t)t * (kTileSlots >> p.log_k) + (off >> p.log_k);
  const int r0 = off >> p.log_k;
  StageView v;
  v.sid = reinterpret_cast<const int32_t*>(st);
  v.cps = reinterpret_cast<const float*>(st + kCh * 4);
  v.ncs = reinterpret_cast<const float*>(st + 2 * kCh * 4) +
          lead_of(p.ncs + ri) - r0;
  v.asg = reinterpret_cast<const int32_t*>(st + 2 * kCh * 4 +
                                           Stage<kCh>::kReadCap * 4) +
          lead_of(asg_c + ri) - r0;
  return v;
}

// ---- the cluster ---------------------------------------------------------
template <int kR>
__device__ __forceinline__ int cluster_rank() {
  if constexpr (kR == 1) return 0;
  else return (int)cg::this_cluster().block_rank();
}

template <int kR>
__device__ __forceinline__ void cluster_sync() {
  if constexpr (kR == 1) __syncthreads();
  else cg::this_cluster().sync();
}

// cluster_sync in two halves, so a CTA can do local work between them.
template <int kR>
__device__ __forceinline__ void cluster_arrive() {
  if constexpr (kR > 1)
    asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

template <int kR>
__device__ __forceinline__ void cluster_wait() {
  if constexpr (kR == 1) __syncthreads();
  else asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// p in the shared memory of cluster rank r.
template <int kR, typename T>
__device__ __forceinline__ T* at_rank(T* p, int r) {
  if constexpr (kR == 1) return p;
  else return cg::this_cluster().map_shared_rank(p, (unsigned)r);
}

// A table entry; shared by a cluster it is read through L2, since another
// SM may have written it.
template <int kR>
__device__ __forceinline__ float tab_get(const float* tab, int s) {
  if constexpr (kR > 1) return __ldcg(tab + s);
  else return tab[s];
}

// Apply sid s's summed delta to the table once and reset it; any of the
// threads that touched s may call this, exactly one applies a non-zero sum.
template <int kR>
__device__ __forceinline__ void flush(int32_t* d, float* tab, int s) {
  const int v = atomicExch(d + s, 0);
  if (v != 0) tab[s] = __fadd_rn(tab_get<kR>(tab, s), (float)v);
}

__device__ __forceinline__ int warp_sum(int v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(rsem::kFullMask, v, o);
  return v;
}

// Launch set-up shared by both kernels: mbarriers and the first chunks.
// Ends with a cluster barrier.
template <int kR, int kCh, int kChunks>
__device__ __forceinline__ void start(const Params& p, unsigned char* ring,
                                      Ctrl& ctl, const int32_t* asg_c,
                                      int rank) {
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) mbar_init(&ctl.full[s], 1);
    ctl.dnoise[0] = ctl.dnoise[1] = 0;
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int total = p.n_tiles * kChunks;
  if (tid == 0)
    for (int g = 0; g < kStages && g < total; ++g)
      issue_chunk<kCh>(p, ring, ctl, asg_c, g / kChunks,
                       rank * kCh * kChunks + (g % kChunks) * kCh, g);
  cluster_sync<kR>();
}

// K <= 32: a read's slots lie in one warp; a cluster of kCluster CTAs per
// chain.
__global__ void __launch_bounds__(kThreads, 1)
    narrow_kernel(const Params p) {
  constexpr int kR = kCluster;
  using S = Split<kR>;
  constexpr int kCh = S::kCh;
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* const ring = smem;
  Ctrl& ctl = *reinterpret_cast<Ctrl*>(smem + Stage<kCh>::kRingBytes);

  const int rank = cluster_rank<kR>();
  const int c = blockIdx.x / kR;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int log_k = p.log_k;
  const int K = 1 << log_k;
  const int rpt = kTileSlots >> log_k;
  const int total = p.n_tiles * S::kChunks;
  float* const tab = p.table + (int64_t)c * p.T;
  int32_t* const asg_c = p.assign + (int64_t)c * p.n_reads;
  int32_t* const d = p.dscratch + (int64_t)c * p.T;
  const uint32_t h_sweep = p.seed_part + p.sweep * kGolden;
  start<kR, kCh, S::kChunks>(p, ring, ctl, asg_c, rank);

  for (int t = 0; t < p.n_tiles; ++t) {
    const int64_t rbase = (int64_t)t * rpt;
    const uint32_t h = mix32(h_sweep + (uint32_t)t * kTileMul);
    float c0;
    int dn = 0;
    int rec_old[S::kSpt], rec_new[S::kSpt];
#pragma unroll
    for (int k = 0; k < S::kChunks; ++k) {
      const int g = t * S::kChunks + k;
      const int off = rank * S::kSlice + k * kCh;
      mbar_wait(&ctl.full[g % kStages], (g / kStages) & 1);
      const StageView sg = stage_view<kCh>(p, ring, asg_c, t, off,
                                           g % kStages);
      int my_sid[S::kSpc], a[S::kSpc];
      float cpv[S::kSpc], ncv[S::kSpc], tv[S::kSpc];
#pragma unroll
      for (int i = 0; i < S::kSpc; ++i) {
        const int fl = i * kThreads + tid;
        const int r = (off + fl) >> log_k;
        my_sid[i] = sg.sid[fl];
        cpv[i] = sg.cps[fl];
        a[i] = sg.asg[r];
        ncv[i] = sg.ncs[r];
      }
      if (k == 0) {  // the previous tile's deltas have landed everywhere
        if (t > 0) cluster_wait<kR>();
        c0 = tab_get<kR>(tab, 0);
      }
#pragma unroll
      for (int i = 0; i < S::kSpc; ++i)
        tv[i] = tab_get<kR>(tab, my_sid[i]);
#pragma unroll
      for (int i = 0; i < S::kSpc; ++i) {
        const int q = k * S::kSpc + i;
        const int r = (off + i * kThreads + tid) >> log_k;
        const int j = lane & (K - 1);
        const int gb = lane - j;  // the read's first lane
        const bool has = a[i] >= 0;
        const int cur =
            __shfl_sync(rsem::kFullMask, my_sid[i], gb + max(a[i], 0));
        const float own = (has && my_sid[i] == cur) ? 1.0f : 0.0f;
        const float w = __fmul_rn(fmaxf(__fsub_rn(tv[i], own), 0.0f), cpv[i]);
        const float w0 = __fmul_rn(
            fmaxf(__fsub_rn(c0, has ? 0.0f : 1.0f), 0.0f), ncv[i]);
        const float u = read_uniform(h, p.chain0 + c, r << log_k);
        float tot = w, pre = w;
        for (int o = 1; o < K; o <<= 1)
          tot = __fadd_rn(tot, __shfl_xor_sync(rsem::kFullMask, tot, o));
        for (int o = 1; o < K; o <<= 1) {
          const float up = __shfl_up_sync(rsem::kFullMask, pre, o);
          if (j >= o) pre = __fadd_rn(pre, up);
        }
        const float target = __fmul_rn(u, __fadd_rn(tot, w0));
        const bool pick_noise = target < w0;
        const float t2 = __fsub_rn(target, w0);
        int last = w > 0.0f ? j : -1;
        for (int o = 1; o < K; o <<= 1)
          last = max(last, __shfl_xor_sync(rsem::kFullMask, last, o));
        int chosen = pre > t2 ? j : last;
        for (int o = 1; o < K; o <<= 1)
          chosen = min(chosen, __shfl_xor_sync(rsem::kFullMask, chosen, o));
        const int nw = (!pick_noise && chosen >= 0) ? chosen : -1;
        const int nsid =
            __shfl_sync(rsem::kFullMask, my_sid[i], gb + max(nw, 0));
        rec_old[q] = rec_new[q] = -1;
        if (j == 0 && nw != a[i]) {
          if (has) {
            atomicAdd(d + cur, -1);
            rec_old[q] = cur;
          }
          if (nw >= 0) {
            atomicAdd(d + nsid, 1);
            rec_new[q] = nsid;
          }
          dn += (nw >= 0 ? 1 : 0) - (has ? 1 : 0);
          asg_c[rbase + r] = nw;
        }
      }
      if (k < S::kChunks - 1) {
        __syncthreads();  // stage consumed
        if (tid == 0 && g + kStages < total)
          issue_chunk<kCh>(p, ring, ctl, asg_c, (g + kStages) / S::kChunks,
                           rank * S::kSlice +
                               ((g + kStages) % S::kChunks) * kCh,
                           (g + kStages) % kStages);
      }
    }
    // the tile's noise delta goes to every CTA's own counter
    dn = warp_sum(dn);
    if (lane == 0 && dn != 0)
#pragma unroll
      for (int r = 0; r < kR; ++r)
        atomicAdd(at_rank<kR>(&ctl.dnoise[t & 1], r), dn);
    cluster_sync<kR>();  // every read of the tile has sampled and recorded
    const int g = (t + 1) * S::kChunks - 1;
    // warp 1 issues the next copies while warp 0 applies the noise
    if (tid == 32 && g + kStages < total)
      issue_chunk<kCh>(p, ring, ctl, asg_c, (g + kStages) / S::kChunks,
                       rank * S::kSlice + ((g + kStages) % S::kChunks) * kCh,
                       (g + kStages) % kStages);
    if (tid == 0) {
      if (rank == 0)
        tab[0] = __fsub_rn(tab_get<kR>(tab, 0),
                           (float)ctl.dnoise[t & 1]);
      ctl.dnoise[t & 1] = 0;
    }
#pragma unroll
    for (int q = 0; q < S::kSpt; ++q) {
      if (rec_old[q] >= 0) flush<kR>(d, tab, rec_old[q]);
      if (rec_new[q] >= 0) flush<kR>(d, tab, rec_new[q]);
    }
    cluster_arrive<kR>();  // waited for before the next tile's gathers
  }
  if (p.n_tiles > 0) cluster_wait<kR>();
}

// K >= 64: one CTA per chain; reductions across warps in shared memory.
__global__ void __launch_bounds__(kThreads, 1) wide_kernel(const Params p) {
  using S = Split<1>;
  constexpr int kCh = S::kCh;
  constexpr int kPerThread = S::kSpt;
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* const ring = smem;
  Ctrl& ctl = *reinterpret_cast<Ctrl*>(smem + Stage<kCh>::kRingBytes);
  Wide& wd =
      *reinterpret_cast<Wide*>(smem + Stage<kCh>::kRingBytes + kCtrlBytes);

  const int c = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int log_k = p.log_k;
  const int K = 1 << log_k;
  const int rpt = kTileSlots >> log_k;
  const int total = p.n_tiles * S::kChunks;
  float* const tab = p.table + (int64_t)c * p.T;
  int32_t* const asg_c = p.assign + (int64_t)c * p.n_reads;
  int32_t* const d = p.dscratch + (int64_t)c * p.T;
  const uint32_t h_sweep = p.seed_part + p.sweep * kGolden;
  for (int r = tid; r < kMaxWideReads; r += kThreads) {
    wd.last[r] = -1;
    wd.chosen[r] = INT_MAX;
  }
  start<1, kCh, S::kChunks>(p, ring, ctl, asg_c, 0);

  for (int t = 0; t < p.n_tiles; ++t) {
    const int64_t rbase = (int64_t)t * rpt;
    const uint32_t h = mix32(h_sweep + (uint32_t)t * kTileMul);
    const float c0 = tab[0];
    int dn = 0;
    // pass 1: stage the tile; per slot its sid, table entry and conprb,
    // per read its assignment, current sid and noise weight
    int my_sid[kPerThread];
    float tv[kPerThread], cpv[kPerThread];
#pragma unroll
    for (int k = 0; k < S::kChunks; ++k) {
      const int g = t * S::kChunks + k;
      mbar_wait(&ctl.full[g % kStages], (g / kStages) & 1);
      const StageView sg =
          stage_view<kCh>(p, ring, asg_c, t, k * kCh, g % kStages);
#pragma unroll
      for (int i = 0; i < S::kSpc; ++i) {
        const int q = k * S::kSpc + i;
        my_sid[q] = sg.sid[i * kThreads + tid];
        cpv[q] = sg.cps[i * kThreads + tid];
      }
#pragma unroll
      for (int i = 0; i < S::kSpc; ++i) {
        const int q = k * S::kSpc + i;
        tv[q] = tab[my_sid[q]];
      }
#pragma unroll
      for (int i = 0; i < S::kSpc; ++i) {
        const int q = k * S::kSpc + i;
        const int f = q * kThreads + tid;
        const int r = f >> log_k, j = f & (K - 1);
        const int a = sg.asg[r];
        if (j == a) wd.rd_cur[r] = my_sid[q];
        if (j == 0) {
          wd.rd_a[r] = a;
          wd.rd_w0[r] = __fmul_rn(
              fmaxf(__fsub_rn(c0, a >= 0 ? 0.0f : 1.0f), 0.0f), sg.ncs[r]);
        }
      }
      __syncthreads();
      if (tid == 0 && g + kStages < total)
        issue_chunk<kCh>(p, ring, ctl, asg_c, (g + kStages) / S::kChunks,
                         ((g + kStages) % S::kChunks) * kCh,
                         (g + kStages) % kStages);
    }
    // weights; butterfly sums within warps, then across the read's warps
    // on one value per warp
#pragma unroll
    for (int q = 0; q < kPerThread; ++q) {
      const int f = q * kThreads + tid;
      const int r = f >> log_k, j = f & (K - 1);
      const int a = wd.rd_a[r];
      const float own = (a >= 0 && my_sid[q] == wd.rd_cur[r]) ? 1.0f : 0.0f;
      const float w = __fmul_rn(fmaxf(__fsub_rn(tv[q], own), 0.0f), cpv[q]);
      wd.pre[f] = w;
      if (w > 0.0f) atomicMax(&wd.last[r], j);
      float v = w;
      for (int o = 1; o < 32; o <<= 1)
        v = __fadd_rn(v, __shfl_xor_sync(rsem::kFullMask, v, o));
      if (lane == 0) wd.part[f >> 5] = v;
    }
    __syncthreads();
    for (int o = 1; o < (K >> 5); o <<= 1) {
      float v = 0.0f;
      if (tid < kGroups) v = __fadd_rn(wd.part[tid], wd.part[tid ^ o]);
      __syncthreads();
      if (tid < kGroups) wd.part[tid] = v;
      __syncthreads();
    }
    // Hillis-Steele within each read's part of a 128-slot row
    const int width = K < kLanes ? K : kLanes;
    for (int o = 1; o < width; o <<= 1) {
      float v[kPerThread];
#pragma unroll
      for (int q = 0; q < kPerThread; ++q) {
        const int f = q * kThreads + tid;
        v[q] = (f & (width - 1)) >= o ? __fadd_rn(wd.pre[f], wd.pre[f - o])
                                      : wd.pre[f];
      }
      __syncthreads();
#pragma unroll
      for (int q = 0; q < kPerThread; ++q) wd.pre[q * kThreads + tid] = v[q];
      __syncthreads();
    }
    if (K > kLanes) {  // then across the rows of a read
      const int rpr = K / kLanes;
      if (tid < kRowsPerTile) {
        const float rt = wd.pre[tid * kLanes + kLanes - 1];
        wd.row_total[tid] = rt;
        wd.row_acc[tid] = rt;
      }
      __syncthreads();
      for (int o = 1; o < rpr; o <<= 1) {
        float v = 0.0f;
        if (tid < kRowsPerTile)
          v = (tid & (rpr - 1)) >= o
                  ? __fadd_rn(wd.row_acc[tid], wd.row_acc[tid - o])
                  : wd.row_acc[tid];
        __syncthreads();
        if (tid < kRowsPerTile) wd.row_acc[tid] = v;
        __syncthreads();
      }
#pragma unroll
      for (int q = 0; q < kPerThread; ++q) {
        const int f = q * kThreads + tid;
        const int row = f / kLanes;
        wd.pre[f] = __fadd_rn(wd.pre[f],
                              __fsub_rn(wd.row_acc[row], wd.row_total[row]));
      }
      __syncthreads();
    }
    uint32_t noise = 0;  // bit q: slot q's read picks noise
#pragma unroll
    for (int q = 0; q < kPerThread; ++q) {
      const int f = q * kThreads + tid;
      const int r = f >> log_k, j = f & (K - 1);
      const float w0 = wd.rd_w0[r];
      const float u = read_uniform(h, p.chain0 + c, r << log_k);
      const float target = __fmul_rn(u, __fadd_rn(wd.part[f >> 5], w0));
      if (target < w0) noise |= 1u << q;
      const float t2 = __fsub_rn(target, w0);
      atomicMin(&wd.chosen[r], wd.pre[f] > t2 ? j : wd.last[r]);
    }
    __syncthreads();
    uint32_t rec = 0;  // bit q: +1 at my_sid[q]; bit 8+q: -1 at rd_cur
#pragma unroll
    for (int q = 0; q < kPerThread; ++q) {
      const int f = q * kThreads + tid;
      const int r = f >> log_k, j = f & (K - 1);
      const int chosen = wd.chosen[r];
      const int nw = (!(noise >> q & 1u) && chosen >= 0) ? chosen : -1;
      const int a = wd.rd_a[r];
      if (nw == a) continue;
      if (j == nw) {
        atomicAdd(d + my_sid[q], 1);
        rec |= 1u << q;
      }
      if (j == 0) {
        if (a >= 0) {
          atomicAdd(d + wd.rd_cur[r], -1);
          rec |= 256u << q;
        }
        dn += (nw >= 0 ? 1 : 0) - (a >= 0 ? 1 : 0);
        asg_c[rbase + r] = nw;
      }
    }
    dn = warp_sum(dn);
    if (lane == 0 && dn != 0) atomicAdd(&ctl.dnoise[0], dn);
    __syncthreads();  // every read has sampled; all deltas are recorded
    if (tid == 0) {
      tab[0] = __fsub_rn(tab[0], (float)ctl.dnoise[0]);
      ctl.dnoise[0] = 0;
    }
#pragma unroll
    for (int q = 0; q < kPerThread; ++q) {
      const int f = q * kThreads + tid;
      const int r = f >> log_k;
      if (rec >> q & 1u) flush<1>(d, tab, my_sid[q]);
      if (rec >> (8 + q) & 1u) flush<1>(d, tab, wd.rd_cur[r]);
      if ((f & (K - 1)) == 0) {
        wd.last[r] = -1;
        wd.chosen[r] = INT_MAX;
      }
    }
    __syncthreads();
  }
}

template <typename Kernel>
int launch(Kernel kernel, const Params& p, int C, int cluster, int64_t smem,
           cudaStream_t stream) {
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(C * cluster));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = (size_t)smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = cluster > 1 ? 1 : 0;
  e = cudaLaunchKernelEx(&cfg, kernel, p);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

}  // namespace

// One sweep of a part's tiles for every chain, in place. sid/cps: [n_tiles *
// 8192]; ncs: [n_tiles * 8192 / K]; assign: [C, n_reads] slot of each read
// (-1 = noise); table: [C, T] f32 counts + pseudo (index 0 = noise; sids are
// >= 1); dscratch: [C, T] int32 zeros (left zero); chain0: the global index
// of chain 0, whose uniforms chain c draws as chain chain0 + c (a rank that
// holds chains 4-7 of 8 passes 4). sid, cps, ncs and assign must be 16-byte
// aligned.
extern "C" int rsem_gibbs_sweep(const int32_t* sid, const float* cps,
                                const float* ncs, int32_t* assign,
                                float* table, int32_t* dscratch, int n_tiles,
                                int log_k, int C, int64_t n_reads, int64_t T,
                                uint32_t seed_part, uint32_t sweep,
                                uint32_t chain0, cudaStream_t stream) {
  if (n_tiles == 0 || C == 0) return (int)cudaGetLastError();
  if (log_k < 0 || (1 << log_k) > kTileSlots || T <= 0 || T > INT_MAX ||
      n_reads != (int64_t)n_tiles * (kTileSlots >> log_k) ||
      dscratch == nullptr || !aligned16(sid) || !aligned16(cps) ||
      !aligned16(ncs) || !aligned16(assign))
    return (int)cudaErrorInvalidValue;
  const Params p{sid,     cps,   ncs,     assign,    table, dscratch, n_tiles,
                 log_k,   n_reads, T,     seed_part, sweep, chain0};
  if (log_k > 5) return launch(wide_kernel, p, C, 1, kWideSmem, stream);
  return launch(narrow_kernel, p, C, kCluster, kNarrowSmem, stream);
}
