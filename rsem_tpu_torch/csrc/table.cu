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
// Gather (K2): one warp per index row, each lane loading 16 bytes (int4:
// four indices) so a warp reads a 128-column row in one coalesced request;
// grid-stride over rows with a grid capped near residency; the table is
// copied into shared memory when it fits in 48 KB (every main-path table
// does: <= 8,192 slots), else read through the read-only cache (__ldg) by
// the same kernel; each row is summed in f64 (free here: the kernel waits
// on memory) and written as f32.
//
// Scatter (K3): what holds it back beyond the stream is the shared-memory
// table: a float atomicAdd to shared memory is a compare-and-swap loop on
// sm_90 (a load and a CAS per try), lanes of one row collide on a slot
// (the slot is the read's quality and bases, so ~25 lanes of one
// instruction hit ~23 words) and retry, and distinct slots share banks.
// The design:
//  * 512-thread blocks, as many as stay resident, each warp taking batches
//    of 8 consecutive rows (grid-stride over batches; 8 rather than 32
//    spreads inputs of ~100k rows over more warps);
//  * a warp loads its batch's 8 weights in one request (and the next
//    batch's one batch ahead) and ballots the non-zero ones: rows of weight
//    0 are skipped without loading their indices (a converged posterior
//    zeroes most hits);
//  * a row is one or more units of 32 int4 (128 columns); the next unit's
//    indices are loaded before this unit's atomics are issued;
//  * each block keeps R copies of the f32 table in shared memory (R the
//    largest power of two <= 16 whose copies fit a quarter of the 227 KB:
//    16 up to 908 slots, as the noise tables have, 8 up to 1,816, as the
//    1,000-slot profile table, ..., 1 from 7,265 slots on, with fewer
//    blocks per SM above 14,528 and one at the limit, 58,112), warp w
//    adding into copy w % R, so fewer warps contend for one word;
//  * the flush sums a block's copies per slot in f64 and adds the non-zero
//    slots into the caller's f64 table with one atomic each; nothing is
//    allocated per launch.
// Measured and not kept: combining equal slots with __match_any_sync (its
// MATCH instruction cost more than the retries it saved), a copy per lane
// (conflict-free, but too little shared memory for enough warps), combining
// a lane's equal slots first, a per-lane cp.async staging ring, a hand-made
// batched CAS, and a [blocks, size] scratch reduced by a second kernel in
// place of the f64 atomics (no faster).

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

constexpr int kScatterThreads = 512;
constexpr int kScatterWarps = kScatterThreads / 32;
constexpr int kBatchRows = 8;  // rows per batch of a warp (lanes 0-7)

// One warp's walk over its batches of kBatchRows rows: yields the units
// (row, 128-column chunk, weight) of the rows whose weight is not 0, in
// order. Every member is warp-uniform but `wl`/`wl_next` (this lane's row
// of the batch).
struct RowCursor {
  const float* w;
  int64_t rows, n_batch, stride, batch;
  float wl, wl_next;  // this lane's weight in the batch and the next one
  float w_row;
  unsigned mask;  // non-zero rows of the batch not started yet
  int bit, chunk, n_chunk, lane;

  __device__ float load_w(int64_t b) const {
    const int64_t r = b * kBatchRows + lane;
    return (lane < kBatchRows && b < n_batch && r < rows) ? __ldg(w + r)
                                                          : 0.f;
  }
  __device__ void start() {
    wl = load_w(batch);
    wl_next = load_w(batch + stride);
    mask = __ballot_sync(rsem::kFullMask, wl != 0.f);
    bit = -1;
  }
  // the next unit; false when the warp's batches are done (and after)
  __device__ bool next(int64_t& row, int& c, float& wr) {
    for (;;) {
      if (bit >= 0 && chunk < n_chunk) {
        row = batch * kBatchRows + bit;
        c = chunk++;
        wr = w_row;
        return true;
      }
      if (mask) {
        bit = __ffs(mask) - 1;
        mask &= mask - 1;
        chunk = 0;
        w_row = __shfl_sync(rsem::kFullMask, wl, bit);
        continue;
      }
      if (batch >= n_batch) return false;
      batch += stride;
      if (batch >= n_batch) return false;
      wl = wl_next;
      wl_next = load_w(batch + stride);
      mask = __ballot_sync(rsem::kFullMask, wl != 0.f);
      bit = -1;
    }
  }
};

__device__ __forceinline__ int4 load_unit(const int4* __restrict__ idx,
                                          int vec, int64_t row, int chunk,
                                          int lane) {
  const int v = chunk * 32 + lane;
  return v < vec ? __ldg(idx + row * vec + v) : make_int4(-1, -1, -1, -1);
}

__device__ __forceinline__ void hist_add(float* h, unsigned size, int i,
                                         float w) {
  if ((unsigned)i < size) atomicAdd(h + i, w);
}

__global__ void __launch_bounds__(kScatterThreads)
    scatter_add_kernel(const int4* __restrict__ idx, int64_t rows,
                       int vec, const float* __restrict__ w, int size,
                       int copies, double* __restrict__ acc) {
  extern __shared__ float s_hist[];
  const int n_tab = copies * size;
  for (int i = threadIdx.x; i < n_tab; i += kScatterThreads) s_hist[i] = 0.f;
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* h = s_hist + (warp % copies) * size;
  RowCursor cur;
  cur.w = w;
  cur.rows = rows;
  cur.n_batch = (rows + kBatchRows - 1) / kBatchRows;
  cur.stride = (int64_t)gridDim.x * kScatterWarps;
  cur.batch = (int64_t)blockIdx.x * kScatterWarps + warp;
  cur.n_chunk = (vec + 31) >> 5;
  cur.lane = lane;
  cur.start();
  const unsigned usize = (unsigned)size;
  int64_t row;
  int chunk;
  float wr = 0.f, wr_next = 0.f;
  bool have = cur.next(row, chunk, wr);
  int4 q = have ? load_unit(idx, vec, row, chunk, lane) : int4{};
  while (have) {
    const bool have_next = cur.next(row, chunk, wr_next);
    const int4 q_next =
        have_next ? load_unit(idx, vec, row, chunk, lane) : int4{};
    hist_add(h, usize, q.x, wr);
    hist_add(h, usize, q.y, wr);
    hist_add(h, usize, q.z, wr);
    hist_add(h, usize, q.w, wr);
    have = have_next;
    q = q_next;
    wr = wr_next;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < size; i += kScatterThreads) {
    double v = 0.0;
    for (int c = 0; c < copies; ++c) v += (double)s_hist[c * size + i];
    if (v != 0.0) atomicAdd(acc + i, v);
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
  const size_t table = (size_t)size * sizeof(float);
  if (table > kMaxSmem) return (int)cudaErrorInvalidValue;
  int copies = 1;
  while (copies * 2 <= kScatterWarps && table * copies * 2 <= kMaxSmem / 4)
    copies *= 2;
  const int smem = (int)(table * copies);
  // the shared-memory opt-in and the resident blocks per SM are asked once
  // per device and table size, not before every launch: a launch on ~100k
  // rows runs for tens of microseconds, and the host should not add its
  // driver queries to each
  thread_local int dev_of = -1, sms = 0, smem_of = -1, per_sm = 0;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev != dev_of || smem != smem_of) {
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess && (size_t)smem > kDefaultSmem)
      e = cudaFuncSetAttribute(scatter_add_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, scatter_add_kernel, kScatterThreads, smem);
    if (e != cudaSuccess) {
      dev_of = -1;
      return (int)e;
    }
    dev_of = dev;
    smem_of = smem;
  }
  const int64_t batches = (rows + kBatchRows - 1) / kBatchRows;
  const int64_t need = (batches + kScatterWarps - 1) / kScatterWarps;
  const int64_t cap = (int64_t)sms * (per_sm > 0 ? per_sm : 1);
  scatter_add_kernel<<<(int)(need < cap ? need : cap), kScatterThreads, smem,
                       stream>>>(reinterpret_cast<const int4*>(idx), rows,
                                 cols / 4, w, size, copies, acc);
  return (int)cudaGetLastError();
}

extern "C" const char* rsem_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
