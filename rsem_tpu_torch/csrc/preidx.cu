// PreIdx build (K4): the frozen per-(hit, read position) profile-table
// indices, flat = (key * 5 + refc) * 5 + readc.
//
// Replaces rsem_tpu/ops/conprb.py: _lane_shift_kernel (and the key
// composition of precompute_profile_indices_fused around it). On the TPU
// each hit's L-wide reference span was cut out of 64-aligned windows by a
// row gather plus a per-row lane-shift kernel, then flipped, complemented
// and combined with the read's codes and qualities by XLA.
//
// What bounds it on the H100: bytes. It writes H * cols * 4 bytes
// (1.28 GB for 2.5M hits x 128 columns) and reads each hit's read row
// (codes and qualities, 2 * L bytes) and reference span (L bytes) once.
//
// Design: one thread per (hit, column), consecutive threads on consecutive
// columns of one row, so the int32 stores and the byte loads of the read
// row and the reference span are coalesced. The reference code is read
// straight from the concatenated codes (no window layout, no shift): for
// dir 0 codes[off + pos + j], for dir 1 codes[off + tl - 1 - pos - j]
// complemented when < 4. Positions outside [0, n_codes) read 0, as the
// zero-padded windows of the TPU build do. Lanes with j >= read length and
// the pad columns carry the sentinel slot. Offsets are int64: at 10M reads
// H * cols passes 2^31.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads) preidx_kernel(
    const uint8_t* __restrict__ ref_codes, int64_t n_codes,
    const int64_t* __restrict__ offsets, const int32_t* __restrict__ tot_len,
    const uint8_t* __restrict__ read_codes,
    const uint8_t* __restrict__ read_quals,  // nullptr: key is the position
    const int32_t* __restrict__ read_lens, int read_width,
    const int32_t* __restrict__ rid, const int32_t* __restrict__ sid,
    const int32_t* __restrict__ pos, const int32_t* __restrict__ dir,
    const int32_t* __restrict__ ins,  // non-null: mate 2 of a pair
    int64_t n_hits, int cols, int sentinel, int32_t* __restrict__ out) {
  const int64_t total = n_hits * (int64_t)cols;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; t < total;
       t += stride) {
    const int64_t h = t / cols;
    const int j = (int)(t - h * cols);
    const int32_t r = __ldg(rid + h);
    int32_t v = sentinel;
    if (j < __ldg(read_lens + r)) {
      const int32_t s = __ldg(sid + h);
      const int64_t off = __ldg(offsets + s);
      const int32_t tl = __ldg(tot_len + s);
      int32_t p = __ldg(pos + h);
      int32_t d = __ldg(dir + h);
      if (ins != nullptr) {  // mate 2 walks the opposite strand
        p = tl - p - __ldg(ins + h);
        d = 1 - d;
      }
      const int64_t q = d ? off + tl - 1 - p - j : off + p + j;
      int32_t refc = (q >= 0 && q < n_codes) ? (int32_t)__ldg(ref_codes + q) : 0;
      if (d && refc < 4) refc = 3 - refc;
      const int64_t ri = (int64_t)r * read_width + j;
      const int32_t readc = __ldg(read_codes + ri);
      const int32_t key = read_quals ? (int32_t)__ldg(read_quals + ri) : j;
      v = (key * 5 + refc) * 5 + readc;
    }
    out[t] = v;
  }
}

}  // namespace

// out: [n_hits, cols] int32, fully written.
extern "C" int rsem_preidx(const uint8_t* ref_codes, int64_t n_codes,
                           const int64_t* offsets, const int32_t* tot_len,
                           const uint8_t* read_codes,
                           const uint8_t* read_quals, const int32_t* read_lens,
                           int read_width, const int32_t* rid,
                           const int32_t* sid, const int32_t* pos,
                           const int32_t* dir, const int32_t* ins,
                           int64_t n_hits, int cols, int sentinel,
                           int32_t* out, cudaStream_t stream) {
  if (n_hits == 0) return (int)cudaGetLastError();
  if (cols < read_width) return (int)cudaErrorInvalidValue;
  const int grid = rsem::grid_for(n_hits * (int64_t)cols, kThreads, 16);
  preidx_kernel<<<grid, kThreads, 0, stream>>>(
      ref_codes, n_codes, offsets, tot_len, read_codes, read_quals, read_lens,
      read_width, rid, sid, pos, dir, ins, n_hits, cols, sentinel, out);
  return (int)cudaGetLastError();
}
