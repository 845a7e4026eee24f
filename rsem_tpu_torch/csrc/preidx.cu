// PreIdx build (K4): the frozen per-(hit, read position) profile-table
// indices, flat = (key * 5 + refc) * 5 + readc.
//
// Replaces rsem_tpu/ops/conprb.py: _lane_shift_kernel (and the key
// composition of precompute_profile_indices_fused around it). On the TPU
// each hit's L-wide reference span was cut out of 64-aligned windows by a
// row gather plus a per-row lane-shift kernel, then flipped, complemented
// and combined with the read's codes and qualities by XLA.
//
// What bounds it on the H100: the write, then latency. It stores H * cols
// * 4 bytes (1.28 GB for 2.5M hits x 128 columns, read by nothing until
// the next kernel) and reads each hit's read row (codes and qualities,
// 2 * L bytes) and reference span (L bytes), under a fifth of the bytes;
// but each row's span sits at a random place in the codes, so a warp
// that waits for one row at a time leaves the memory system idle, and a
// thread per element would spend its issue slots on a 64-bit division and
// a chain of metadata loads per element.
//
// Design: a warp owns 32 consecutive hit rows. Lane i loads row i's
// metadata (rid, sid, pos, dir, insert length, then read length, offset
// and transcript length) with one coalesced load per array and works out
// the row's read-row start, first reference position and flags; the warp
// then walks its rows, taking each row's values from its lane with
// __shfl_sync, and fetches the next row's bytes before it composes the
// current one, so two rows are in flight per warp. Each lane composes 4
// consecutive columns and writes them with one 16-byte streaming store
// (st.global.cs: the output passes L2 once): one store per lane for 128
// columns, two for 256. The 4 read codes, 4 qualities and 4 reference
// codes a lane needs come as one 32-bit word each, from at most two
// aligned words and a funnel shift, so rows of any alignment (L = 150:
// rows 2-aligned; a read array whose base is off by a byte) cost two loads,
// not four, and bounds are checked only on a row's last chunk and on spans
// that reach past the codes. Two columns share one 32-bit multiply-add
// (16-bit halves). For dir 1 the span is descending: the word at q - j - 3
// .. q - j is byte-reversed and complemented where < 4. Reference positions
// outside [0, n_codes) read 0, as the zero-padded windows of the TPU build
// do; columns at or past the read length, and the pad columns, carry the
// sentinel slot. Offsets are int64: at 10M reads H * cols passes 2^31.

#include "common.cuh"

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kThreads = kWarpsPerBlock * 32;

// Bytes base[a .. a+3] as one little-endian word. `base` is 4-aligned; a
// word is loaded only when it holds a byte of [lo, hi), so no load leaves
// the allocation (allocations are 4-aligned and a multiple of 4 long).
// Bytes outside [lo, hi) are unspecified.
__device__ __forceinline__ uint32_t load4(const uint8_t* __restrict__ base,
                                          int64_t a, int64_t lo, int64_t hi) {
  const int64_t w = a & ~(int64_t)3;  // floor(a / 4) * 4, also for a < 0
  const int sh = (int)(a - w) * 8;
  uint32_t x = 0, y = 0;
  if (w + 3 >= lo && w < hi)
    x = __ldg(reinterpret_cast<const uint32_t*>(base + w));
  if (sh != 0 && w + 7 >= lo && w + 4 < hi)
    y = __ldg(reinterpret_cast<const uint32_t*>(base + w + 4));
  return __funnelshift_r(x, y, sh);
}

// Two bytes of v (selector 0x4140: bytes 0, 1; 0x4342: bytes 2, 3) in the
// low bytes of the two 16-bit halves of a word, so one 32-bit multiply-add
// composes two columns (each half stays below 2^16: 255 * 25 + 24).
__device__ __forceinline__ uint32_t spread(uint32_t v, unsigned sel) {
  return __byte_perm(v, 0, sel);
}

struct Inputs {
  const uint8_t* ref;  // 4-aligned bases; positions are offset by the skews
  int64_t ref_lo, ref_hi;
  const uint8_t* codes;
  const uint8_t* quals;  // nullptr: key is the position
  int codes_skew, quals_skew;
};

// One row as the warp sees it: read-row start, first reference position
// (in the 4-aligned base) and flags (read length, dir 1, span inside).
struct Row {
  int64_t row, q;
  uint32_t flags;
  __device__ int len() const { return (int)(flags & 0xffffu); }
  __device__ bool rev() const { return flags & (1u << 16); }
  __device__ bool inside() const { return flags & (1u << 17); }
};

struct Words {
  uint32_t rc, qc, fc;  // read codes, qualities, reference codes
};

// The 4 bytes of each array that columns j0 .. j0+3 of the row need.
__device__ __forceinline__ Words fetch(const Inputs& in, const Row& r,
                                       int j0) {
  Words w{0u, 0u, 0u};
  const int len = r.len();
  if (j0 >= len) return w;
  // reference bytes a .. a+3 (dir 1: columns j0+3 .. j0)
  const int64_t a = r.rev() ? r.q - j0 - 3 : r.q + j0;
  const int64_t ca = r.row + in.codes_skew + j0;
  const int64_t qa = r.row + in.quals_skew + j0;
  if (j0 + 3 < len && r.inside()) {
    // interior: all 4 bytes lie in their arrays, so no checks
    w.rc = load4(in.codes, ca, ca, ca + 4);
    if (in.quals) w.qc = load4(in.quals, qa, qa, qa + 4);
    w.fc = load4(in.ref, a, a, a + 4);
  } else {  // the row's last chunk, or a span past the codes' ends
    w.rc = load4(in.codes, ca, ca - j0, ca - j0 + len);
    if (in.quals) w.qc = load4(in.quals, qa, qa - j0, qa - j0 + len);
    w.fc = load4(in.ref, a, in.ref_lo, in.ref_hi);
#pragma unroll
    for (int m = 0; m < 4; ++m)  // outside the codes: 0
      if (a + m < in.ref_lo || a + m >= in.ref_hi) w.fc &= ~(0xffu << (8 * m));
  }
  return w;
}

// Columns j0 .. j0+3: (key * 5 + refc) * 5 + readc, the sentinel past the
// read length.
__device__ __forceinline__ int4 compose(const Inputs& in, const Row& r,
                                        int j0, Words w, int sentinel) {
  const int len = r.len();
  if (j0 >= len) return make_int4(sentinel, sentinel, sentinel, sentinel);
  uint32_t fc = w.fc;
  if (r.rev()) {  // reverse; 3 - c = c ^ 3 for the codes c < 4
    fc = __byte_perm(fc, 0, 0x0123);
    const uint32_t t = fc & 0xfcfcfcfcu;  // zero bytes: c < 4
    const uint32_t zero =
        ~(((t & 0x7f7f7f7fu) + 0x7f7f7f7fu) | t | 0x7f7f7f7fu);
    fc ^= (zero >> 7) * 3u;
  }
  uint32_t lo2 = spread(fc, 0x4140) * 5u + spread(w.rc, 0x4140);
  uint32_t hi2 = spread(fc, 0x4342) * 5u + spread(w.rc, 0x4342);
  if (in.quals) {
    lo2 += spread(w.qc, 0x4140) * 25u;
    hi2 += spread(w.qc, 0x4342) * 25u;
  }
  int c[4] = {(int)(lo2 & 0xffffu), (int)(lo2 >> 16), (int)(hi2 & 0xffffu),
              (int)(hi2 >> 16)};
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    if (!in.quals) c[m] += (j0 + m) * 25;
    if (j0 + m >= len) c[m] = sentinel;
  }
  return make_int4(c[0], c[1], c[2], c[3]);
}

__global__ void __launch_bounds__(kThreads) preidx_kernel(
    Inputs in, const int64_t* __restrict__ offsets,
    const int32_t* __restrict__ tot_len, const int32_t* __restrict__ read_lens,
    int read_width, const int32_t* __restrict__ rid,
    const int32_t* __restrict__ sid, const int32_t* __restrict__ pos,
    const int32_t* __restrict__ dir,
    const int32_t* __restrict__ ins,  // non-null: mate 2 of a pair
    int64_t n_hits, int cols, int sentinel, int32_t* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_chunks = (cols + 127) / 128;
  const int64_t n_groups = (n_hits + 31) / 32;
  for (int64_t g = (int64_t)blockIdx.x * kWarpsPerBlock + warp; g < n_groups;
       g += (int64_t)gridDim.x * kWarpsPerBlock) {
    // lane i describes row g * 32 + i
    const int64_t h = g * 32 + lane;
    Row mine{0, 0, 0u};
    if (h < n_hits) {
      const int32_t r = __ldg(rid + h);
      const int32_t s = __ldg(sid + h);
      int32_t p = __ldg(pos + h);
      int32_t d = __ldg(dir + h);
      const int32_t tl = __ldg(tot_len + s);
      if (ins != nullptr) {  // mate 2 walks the opposite strand
        p = tl - p - __ldg(ins + h);
        d = 1 - d;
      }
      const int64_t off = __ldg(offsets + s);
      const int len = min(__ldg(read_lens + r), read_width);
      const bool rev = d == 1;
      const int64_t q = (rev ? off + tl - 1 - p : off + p) + in.ref_lo;
      const int64_t lo = rev ? q - len + 1 : q;  // the span's first byte
      const bool inside =
          len == 0 || (lo >= in.ref_lo && lo + len <= in.ref_hi);
      mine.row = (int64_t)r * read_width;
      mine.q = q;
      mine.flags = (uint32_t)len | (rev ? 1u << 16 : 0u) |
                   (inside ? 1u << 17 : 0u);
    }
    auto row_of = [&](int k) {
      return Row{__shfl_sync(rsem::kFullMask, mine.row, k),
                 __shfl_sync(rsem::kFullMask, mine.q, k),
                 __shfl_sync(rsem::kFullMask, mine.flags, k)};
    };
    // (row, chunk) units in order; the next unit's loads are issued
    // before this unit's words are used, so two rows are in flight
    const int rows = (int)min((int64_t)32, n_hits - g * 32);
    int k = 0, c = 0;
    Row r = row_of(0);
    Words w = fetch(in, r, lane * 4);
    while (true) {
      int kn = k, cn = c + 1;
      if (cn == n_chunks) {
        cn = 0;
        ++kn;
      }
      Row rn = r;
      Words wn{0u, 0u, 0u};
      if (kn < rows) {
        if (kn != k) rn = row_of(kn);
        wn = fetch(in, rn, lane * 4 + 128 * cn);
      }
      const int j0 = lane * 4 + 128 * c;
      if (j0 < cols)
        __stcs(reinterpret_cast<int4*>(out + (g * 32 + k) * (int64_t)cols +
                                       j0),
               compose(in, r, j0, w, sentinel));
      if (kn >= rows) break;
      k = kn;
      c = cn;
      r = rn;
      w = wn;
    }
  }
}

// A byte pointer as a 4-aligned base plus the byte offset of `p` in it.
inline const uint8_t* aligned_base(const uint8_t* p, int* skew) {
  const uintptr_t u = reinterpret_cast<uintptr_t>(p);
  *skew = (int)(u & 3u);
  return reinterpret_cast<const uint8_t*>(u & ~(uintptr_t)3);
}

}  // namespace

// out: [n_hits, cols] int32, 16-byte aligned, fully written; cols a
// multiple of 4 and >= read_width.
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
  if (cols < read_width || cols % 4 != 0 ||
      reinterpret_cast<uintptr_t>(out) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  int ref_skew = 0, codes_skew = 0, quals_skew = 0;
  const uint8_t* ref_base = aligned_base(ref_codes, &ref_skew);
  const uint8_t* codes_base = aligned_base(read_codes, &codes_skew);
  const uint8_t* quals_base =
      read_quals ? aligned_base(read_quals, &quals_skew) : nullptr;
  const Inputs in{ref_base, ref_skew, ref_skew + n_codes, codes_base,
                  quals_base, codes_skew, quals_skew};
  const int grid = rsem::resident_grid(preidx_kernel, kThreads,
                                       (n_hits + 31) / 32, kWarpsPerBlock);
  preidx_kernel<<<grid, kThreads, 0, stream>>>(
      in, offsets, tot_len, read_lens, read_width, rid, sid, pos, dir, ins,
      n_hits, cols, sentinel, out);
  return (int)cudaGetLastError();
}
