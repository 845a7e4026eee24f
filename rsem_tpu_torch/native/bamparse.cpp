// Native BAM ingestion sidecar: BGZF-compressed BAM -> flat read/hit arrays.
//
// The port's copy of the JAX package's sidecar (same source, same outputs).
// Replaces the per-record Python decode loop in rsem_tpu_torch/io/sam.py for
// BAM and SAM-text inputs (the reference streams records through htslib in
// parseIt.cpp:90-152
// and SamParser.h; this is an independent minimal BGZF+BAM codec tuned for
// bulk ingestion: parallel block inflate into one contiguous buffer, then a
// single pointer-walk over records).
//
// Semantics mirror rsem_tpu_torch.io.sam.parse_alignments exactly (grouping by
// canonical read name, N0/N1/N2 classification via the aligner filter tag,
// strand-local coordinate flip, single-M cigar validation, mate adjacency
// checks); the Python path remains as the oracle (use_native=False).
//
// C ABI (ctypes): bamparse_run() does the whole parse; the caller then reads
// sizes via bamparse_sizes(), allocates numpy buffers, and copies the flat
// arrays out with bamparse_export(). All outputs are flat (concatenated
// sequences + per-read lengths); padding into [N, L] matrices happens
// vectorized on the Python side.

#include <array>
#include <unordered_map>
#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <cmath>
#include <string>
#include <thread>
#include <vector>

#include <zlib.h>
#ifdef USE_LIBDEFLATE
#include <libdeflate.h>
#endif
#include <chrono>

namespace {

constexpr int FLAG_PAIRED = 0x1;
constexpr int FLAG_UNMAPPED = 0x4;
constexpr int FLAG_REVERSE = 0x10;
constexpr int FLAG_READ1 = 0x40;
constexpr int FLAG_READ2 = 0x80;

// BAM 4-bit nibble -> base code (A C G T N; -1 = ambiguity code)
const int8_t NIB2ID[16] = {-1, 0, 1, -1, 2, -1, -1, -1,
                           3, -1, -1, -1, -1, -1, -1, 4};

struct CatArrays {
  // one unaligned category (N0 or N2); flat oriented payloads
  std::vector<uint8_t> seq1, qual1, seq2, qual2;
  std::vector<int32_t> len1, len2;
  int64_t n = 0;
};

// per-category streaming read statistics (mirrors io/reads.py ReadStats:
// length histogram, quality Markov-chain counts, noise base counts over
// non-low-quality reads; reference: estimateFromReads,
// SingleModel.h:273-315). MAXL bounds read length (reference maxL=1000).
constexpr int STAT_MAXL = 4096;
constexpr int STAT_QSIZE = 100;
constexpr int STAT_NCODES = 5;

struct CatStats {
  std::vector<int64_t> len_counts;           // [STAT_MAXL+1]
  std::vector<int64_t> q_init;               // [QSIZE]
  std::vector<int64_t> q_tran;               // [QSIZE*QSIZE]
  std::vector<int64_t> noise;                // [QSIZE*NCODES]
  int64_t n_reads = 0;
  CatStats()
      : len_counts(STAT_MAXL + 1, 0), q_init(STAT_QSIZE, 0),
        q_tran(STAT_QSIZE * STAT_QSIZE, 0),
        noise(STAT_QSIZE * STAT_NCODES, 0) {}
};

struct Parser {
  // config
  bool paired = false, has_qual = false;
  bool has_polya = false;
  int seed_len = 25;
  std::vector<int32_t> e2i;        // [n_targets] external tid -> internal sid
  std::vector<int64_t> target_len; // [n_targets]
  char ftag[2] = {0, 0};
  bool has_ftag = false;

  // outputs
  std::vector<uint8_t> seq1, qual1, seq2, qual2; // N1 flat payloads
  std::vector<int32_t> len1, len2;               // N1 read lengths
  std::vector<int32_t> nh;                       // hits per N1 read
  std::vector<int32_t> hit_sid;                  // signed (sign = strand)
  std::vector<int32_t> hit_pos;                  // strand-local 0-based
  std::vector<int32_t> hit_ins;                  // fragment length (paired)
  std::vector<uint8_t> lq1_flags, lq2_flags;     // per-mate low-quality (N1)
  CatArrays cat0, cat2;
  CatStats st[3];  // index = read category (0/1/2)
  int64_t n_iso_multi = 0;  // N1 reads spanning >1 distinct isoform

  std::string err;
};

// poly(A)-artifact low-quality rule, exact mirror of
// io/reads.py calc_low_quality (reference: SingleReadQ.h:63-95)
bool calc_lq(const std::vector<uint8_t> &s, bool has_polya, int seed_len) {
  int64_t l = (int64_t)s.size();
  if (l < seed_len) return true;
  if (!has_polya) return false;
  constexpr int OLEN = 25;
  int64_t numA = 0, numT = 0, numAO = 0, numTO = 0;
  for (int64_t j = 0; j < l; j++) {
    if (s[j] == 0) {
      numA++;
      if (j < OLEN) numAO++;
    } else if (s[j] == 3) {
      numT++;
      if (j >= l - OLEN) numTO++;
    }
  }
  int64_t t1 =
      (int64_t)(0.9 * (double)l - 1.5 * std::sqrt((double)l) + 0.5);
  int64_t t2 = (OLEN - 1) / 2 + 1;
  bool a_art = (numA >= t1) && (numAO >= t2);
  bool t_art = (numA < t1) && (numT >= t1) && (numTO >= t2);
  return a_art || t_art;
}

// one mate's contribution to a category's stats (io/reads.py add_reads)
void stat_add_mate(CatStats &st, const std::vector<uint8_t> &s,
                   const std::vector<uint8_t> &q, bool has_qual,
                   bool collect_noise) {
  int64_t l = (int64_t)s.size();
  st.n_reads++;
  if (l <= STAT_MAXL) st.len_counts[l]++;
  if (has_qual && l > 0) {
    st.q_init[q[0]]++;
    for (int64_t j = 1; j < l; j++)
      st.q_tran[(int64_t)q[j - 1] * STAT_QSIZE + q[j]]++;
    if (collect_noise)
      for (int64_t j = 0; j < l; j++)
        st.noise[(int64_t)q[j] * STAT_NCODES + s[j]]++;
  } else if (collect_noise) {
    for (int64_t j = 0; j < l; j++) st.noise[s[j]]++;
  }
}

struct RawRecord {
  const uint8_t *p; // start of the fixed 32-byte core
  int32_t block_size;
  int32_t tid, pos, l_seq, flag, n_cigar, l_read_name;
  const uint8_t *name;  // NUL-terminated
  const uint8_t *cigar; // n_cigar uint32
  const uint8_t *seq;   // (l_seq+1)/2 packed nibbles
  const uint8_t *qual;  // l_seq bytes
  const uint8_t *tags;  // to p + block_size
};

inline int32_t rd_i32(const uint8_t *p) {
  int32_t v;
  std::memcpy(&v, p, 4);
  return v;
}
inline uint32_t rd_u32(const uint8_t *p) {
  uint32_t v;
  std::memcpy(&v, p, 4);
  return v;
}
inline uint16_t rd_u16(const uint8_t *p) {
  uint16_t v;
  std::memcpy(&v, p, 2);
  return v;
}

bool parse_record(const uint8_t *p, int32_t block_size, RawRecord *r,
                  std::string *err) {
  if (block_size < 32) {
    *err = "truncated BAM record";
    return false;
  }
  r->p = p;
  r->block_size = block_size;
  r->tid = rd_i32(p);
  r->pos = rd_i32(p + 4);
  r->l_read_name = p[8];
  r->n_cigar = rd_u16(p + 12);
  r->flag = rd_u16(p + 14);
  r->l_seq = rd_i32(p + 16);
  const uint8_t *q = p + 32;
  r->name = q;
  q += r->l_read_name;
  r->cigar = q;
  q += 4ll * r->n_cigar;
  r->seq = q;
  q += (r->l_seq + 1) / 2;
  r->qual = q;
  q += r->l_seq;
  r->tags = q;
  if (q > p + block_size) {
    *err = "truncated BAM record body";
    return false;
  }
  return true;
}

// integer value of a 2-char tag (0 if absent / non-integer)
int64_t find_int_tag(const RawRecord &r, const char tag[2]) {
  const uint8_t *q = r.tags;
  const uint8_t *end = r.p + r.block_size;
  while (q + 3 <= end) {
    char t0 = (char)q[0], t1 = (char)q[1], typ = (char)q[2];
    const uint8_t *v = q + 3;
    int64_t val = 0;
    int vlen = 0;
    switch (typ) {
    case 'c': val = (int8_t)v[0]; vlen = 1; break;
    case 'C': val = v[0]; vlen = 1; break;
    case 's': val = (int16_t)rd_u16(v); vlen = 2; break;
    case 'S': val = rd_u16(v); vlen = 2; break;
    case 'i': val = rd_i32(v); vlen = 4; break;
    case 'I': val = (int64_t)rd_u32(v); vlen = 4; break;
    case 'f': vlen = 4; break;
    case 'A': vlen = 1; break;
    case 'Z':
    case 'H': {
      const uint8_t *z = v;
      while (z < end && *z) z++;
      vlen = (int)(z - v) + 1;
      break;
    }
    case 'B': {
      char sub = (char)v[0];
      int32_t n = rd_i32(v + 1);
      int esz = (sub == 'c' || sub == 'C') ? 1
                : (sub == 's' || sub == 'S') ? 2 : 4;
      vlen = 5 + n * esz;
      break;
    }
    default:
      return 0; // unknown tag type: stop scanning (mirrors Python break)
    }
    if (t0 == tag[0] && t1 == tag[1]) {
      if (typ == 'c' || typ == 'C' || typ == 's' || typ == 'S' ||
          typ == 'i' || typ == 'I')
        return val;
      return 0;
    }
    q = v + vlen;
  }
  return 0;
}

// decode seq/qual in original read orientation (reverse-complement when the
// reverse flag is set; reference: sam_utils.h bam_get_read_seq)
bool decode_oriented(const RawRecord &r, bool want_qual,
                     std::vector<uint8_t> *seq_out,
                     std::vector<uint8_t> *qual_out, std::string *err) {
  int l = r.l_seq;
  bool rev = (r.flag & FLAG_REVERSE) != 0;
  size_t base = seq_out->size();
  seq_out->resize(base + l);
  uint8_t *s = seq_out->data() + base;
  for (int i = 0; i < l; i++) {
    int nib = (i & 1) ? (r.seq[i >> 1] & 0xF) : (r.seq[i >> 1] >> 4);
    int8_t c = NIB2ID[nib];
    if (c < 0) {
      *err = "Found ambiguity code in BAM SEQ field";
      return false;
    }
    if (rev) {
      uint8_t cc = (c < 4) ? (uint8_t)(3 - c) : (uint8_t)c;
      s[l - 1 - i] = cc;
    } else {
      s[i] = (uint8_t)c;
    }
  }
  if (want_qual) {
    if (l > 0 && r.qual[0] == 0xFF) {
      *err = "expected quality scores but the BAM record has none";
      return false;
    }
    size_t qb = qual_out->size();
    qual_out->resize(qb + l);
    uint8_t *qd = qual_out->data() + qb;
    if (rev)
      for (int i = 0; i < l; i++) qd[l - 1 - i] = r.qual[i];
    else
      std::memcpy(qd, r.qual, l);
  }
  return true;
}

// exactly one M/=/X op spanning the read (reference: bam_check_cigar)
bool check_cigar(const RawRecord &r) {
  if (r.n_cigar != 1) return false;
  uint32_t v = rd_u32(r.cigar);
  int op = v & 0xF; // 0=M 7='=' 8=X
  if (!(op == 0 || op == 7 || op == 8)) return false;
  return (int32_t)(v >> 4) == r.l_seq;
}

size_t canonical_len(const uint8_t *name) {
  size_t i = 0;
  for (; name[i]; i++) {
    char c = (char)name[i];
    if (c == ' ' || c == '\t' || c == '\n' || c == '\r' || c == '\v' ||
        c == '\f')
      break;
  }
  return i;
}

// ---------------------------------------------------------------------------
// BGZF: scan block extents, then inflate all blocks in parallel into one
// contiguous buffer (output offsets are exact: each member trailer carries
// ISIZE).
struct BgzfBlock {
  size_t in_off;   // offset of deflate payload in file buffer
  size_t in_len;   // payload length
  size_t out_off;  // offset in decompressed buffer
  size_t out_len;  // ISIZE
};

bool scan_bgzf(const std::vector<uint8_t> &buf, std::vector<BgzfBlock> *blocks,
               size_t *total_out, std::string *err) {
  size_t off = 0, out = 0;
  const size_t n = buf.size();
  while (off < n) {
    if (off + 18 > n) {
      *err = "truncated BGZF header";
      return false;
    }
    const uint8_t *h = buf.data() + off;
    if (!(h[0] == 0x1f && h[1] == 0x8b && h[2] == 8)) {
      *err = "not a BGZF/gzip stream";
      return false;
    }
    uint8_t flg = h[3];
    size_t p = off + 10;
    size_t bsize = 0;
    if (flg & 4) { // FEXTRA
      uint16_t xlen = rd_u16(buf.data() + p);
      size_t xend = p + 2 + xlen;
      p += 2;
      while (p + 4 <= xend) {
        uint8_t si1 = buf[p], si2 = buf[p + 1];
        uint16_t slen = rd_u16(buf.data() + p + 2);
        if (si1 == 'B' && si2 == 'C' && slen == 2)
          bsize = (size_t)rd_u16(buf.data() + p + 4) + 1;
        p += 4 + slen;
      }
      p = xend;
    }
    if (bsize == 0) {
      // not a BGZF member (plain gzip): bail to slow path
      *err = "gzip member without BC subfield (not BGZF)";
      return false;
    }
    if (flg & 8) { // FNAME
      while (p < n && buf[p]) p++;
      p++;
    }
    if (flg & 16) { // FCOMMENT
      while (p < n && buf[p]) p++;
      p++;
    }
    if (flg & 2) p += 2; // FHCRC
    size_t member_end = off + bsize;
    if (member_end > n || p + 8 > member_end) {
      *err = "truncated BGZF block";
      return false;
    }
    uint32_t isize = rd_u32(buf.data() + member_end - 4);
    BgzfBlock b;
    b.in_off = p;
    b.in_len = member_end - 8 - p;
    b.out_off = out;
    b.out_len = isize;
    if (isize) blocks->push_back(b);
    out += isize;
    off = member_end;
  }
  *total_out = out;
  return true;
}

bool inflate_blocks(const std::vector<uint8_t> &in,
                    const std::vector<BgzfBlock> &blocks, uint8_t *out,
                    int n_threads, std::string *err) {
  std::atomic<size_t> next(0);
  std::atomic<bool> ok(true);
  auto worker = [&]() {
#ifdef USE_LIBDEFLATE
    // libdeflate's raw-deflate decompressor is ~2-3x zlib's inflate on
    // BGZF-sized blocks (whole-buffer API, no streaming state machine)
    struct libdeflate_decompressor *d = libdeflate_alloc_decompressor();
    if (!d) {
      ok = false;
      return;
    }
    for (;;) {
      size_t i = next.fetch_add(1);
      if (i >= blocks.size() || !ok.load(std::memory_order_relaxed)) break;
      const BgzfBlock &b = blocks[i];
      size_t actual = 0;
      enum libdeflate_result rc = libdeflate_deflate_decompress(
          d, in.data() + b.in_off, b.in_len, out + b.out_off, b.out_len,
          &actual);
      if (rc != LIBDEFLATE_SUCCESS || actual != b.out_len) ok = false;
    }
    libdeflate_free_decompressor(d);
#else
    z_stream zs;
    std::memset(&zs, 0, sizeof(zs));
    if (inflateInit2(&zs, -15) != Z_OK) {
      ok = false;
      return;
    }
    for (;;) {
      size_t i = next.fetch_add(1);
      if (i >= blocks.size() || !ok.load(std::memory_order_relaxed)) break;
      const BgzfBlock &b = blocks[i];
      inflateReset(&zs);
      zs.next_in = const_cast<Bytef *>(in.data() + b.in_off);
      zs.avail_in = (uInt)b.in_len;
      zs.next_out = out + b.out_off;
      zs.avail_out = (uInt)b.out_len;
      int rc = inflate(&zs, Z_FINISH);
      if (rc != Z_STREAM_END || zs.avail_out != 0) ok = false;
    }
    inflateEnd(&zs);
#endif
  };
  std::vector<std::thread> ts;
  int nt = n_threads < 1 ? 1 : n_threads;
  for (int t = 0; t < nt; t++) ts.emplace_back(worker);
  for (auto &t : ts) t.join();
  if (!ok) {
    *err = "BGZF inflate failed";
    return false;
  }
  return true;
}

// ---------------------------------------------------------------------------
// grouped parse (mirrors rsem_tpu_torch.io.sam.parse_alignments)

struct GroupState {
  std::string name;
  int val = -2;
  // pending payload (oriented); promoted to the right bucket at flush
  std::vector<uint8_t> s1, q1, s2, q2;
  std::vector<std::array<int32_t, 3>> hits;
};

class Walker {
public:
  Parser *P;
  GroupState cur;

  bool flush() {
    if (cur.val < 0) return true;
    // low-quality flags + per-category streaming stats
    bool lq1 = calc_lq(cur.s1, P->has_polya, P->seed_len);
    bool lq2 = P->paired ? calc_lq(cur.s2, P->has_polya, P->seed_len) : false;
    bool lq = P->paired
                  ? ((lq1 && lq2) || (int64_t)cur.s1.size() < P->seed_len ||
                     (int64_t)cur.s2.size() < P->seed_len)
                  : lq1;
    if ((size_t)cur.s1.size() > STAT_MAXL ||
        (P->paired && (size_t)cur.s2.size() > STAT_MAXL)) {
      P->err = "read longer than 4096 bases";
      return false;
    }
    if (!lq) {
      CatStats &st = P->st[cur.val];
      bool noise = (cur.val == 0);
      stat_add_mate(st, cur.s1, cur.q1, P->has_qual, noise);
      if (P->paired) stat_add_mate(st, cur.s2, cur.q2, P->has_qual, noise);
    }
    if (cur.val == 1) {
      P->lq1_flags.push_back(lq1 ? 1 : 0);
      if (P->paired) P->lq2_flags.push_back(lq2 ? 1 : 0);
    }
    if (cur.val == 1) {
      P->len1.push_back((int32_t)cur.s1.size());
      P->seq1.insert(P->seq1.end(), cur.s1.begin(), cur.s1.end());
      if (P->has_qual)
        P->qual1.insert(P->qual1.end(), cur.q1.begin(), cur.q1.end());
      if (P->paired) {
        P->len2.push_back((int32_t)cur.s2.size());
        P->seq2.insert(P->seq2.end(), cur.s2.begin(), cur.s2.end());
        if (P->has_qual)
          P->qual2.insert(P->qual2.end(), cur.q2.begin(), cur.q2.end());
      }
      P->nh.push_back((int32_t)cur.hits.size());
      // reads whose hits span >1 distinct isoform (HitContainer.h:
      // calcNumIsoformMultiReads; strand sign excluded from the key)
      int32_t first = cur.hits.empty() ? 0 : std::abs(cur.hits[0][0]);
      for (auto &h : cur.hits)
        if (std::abs(h[0]) != first) {
          P->n_iso_multi++;
          break;
        }
      for (auto &h : cur.hits) {
        P->hit_sid.push_back(h[0]);
        P->hit_pos.push_back(h[1]);
        if (P->paired) P->hit_ins.push_back(h[2]);
      }
    } else {
      CatArrays &c = (cur.val == 0) ? P->cat0 : P->cat2;
      c.n++;
      c.len1.push_back((int32_t)cur.s1.size());
      c.seq1.insert(c.seq1.end(), cur.s1.begin(), cur.s1.end());
      if (P->has_qual) c.qual1.insert(c.qual1.end(), cur.q1.begin(), cur.q1.end());
      if (P->paired) {
        c.len2.push_back((int32_t)cur.s2.size());
        c.seq2.insert(c.seq2.end(), cur.s2.begin(), cur.s2.end());
        if (P->has_qual)
          c.qual2.insert(c.qual2.end(), cur.q2.begin(), cur.q2.end());
      }
    }
    cur.val = -2;
    cur.hits.clear();
    return true;
  }

  int read_type_of(const RawRecord &r) {
    if (!(r.flag & FLAG_UNMAPPED)) return 1;
    if (P->has_ftag && find_int_tag(r, P->ftag) > 0) return 2;
    return 0;
  }

  bool step_se(const RawRecord &r) {
    if (r.flag & FLAG_PAIRED) {
      P->err = "found a paired-end read";
      return false;
    }
    int val = read_type_of(r);
    size_t nl = canonical_len(r.name);
    bool name_eq = cur.name.size() == nl &&
                   std::memcmp(cur.name.data(), r.name, nl) == 0;
    if (val == 1 && name_eq && cur.val >= 0 && cur.val != 1) {
      P->err = "read " + std::string((const char *)r.name, nl) +
               " is both unalignable and alignable according to the input "
               "file";
      return false;
    }
    bool same = (val == 1) && name_eq && cur.val == 1;
    if (!same) {
      flush();
      cur.val = val;
      cur.name.assign((const char *)r.name, nl);
      cur.s1.clear();
      cur.q1.clear();
      if (!decode_oriented(r, P->has_qual, &cur.s1, &cur.q1, &P->err))
        return false;
    }
    if (val == 1) {
      if (r.tid < 0 || r.tid >= (int32_t)P->e2i.size()) {
        P->err = "alignment target id out of range";
        return false;
      }
      if (!check_cigar(r)) {
        P->err = "RSEM does not support gapped alignments (read " +
                 std::string((const char *)r.name, nl) + ")";
        return false;
      }
      int32_t sid = P->e2i[r.tid];
      int32_t l = r.l_seq;
      if (r.flag & FLAG_REVERSE)
        cur.hits.push_back({-sid, (int32_t)(P->target_len[r.tid] - r.pos - l), 0});
      else
        cur.hits.push_back({sid, r.pos, 0});
    }
    return true;
  }

  bool step_pe(RawRecord r1, RawRecord r2) {
    if (!(r1.flag & FLAG_READ1)) std::swap(r1, r2);
    if (!((r1.flag & FLAG_PAIRED) && (r2.flag & FLAG_PAIRED))) {
      P->err = "one of the mates is not paired-end (mates must be adjacent)";
      return false;
    }
    if (!((r1.flag & FLAG_READ1) && (r2.flag & FLAG_READ2))) {
      P->err = "adjacent records are not the two mates of a paired-end read";
      return false;
    }
    bool m1 = !(r1.flag & FLAG_UNMAPPED), m2 = !(r2.flag & FLAG_UNMAPPED);
    if (m1 != m2) {
      P->err = "RSEM does not support partial alignments";
      return false;
    }
    int val;
    if (m1 && m2) {
      val = 1;
    } else if (P->has_ftag && (find_int_tag(r1, P->ftag) > 0 ||
                               find_int_tag(r2, P->ftag) > 0)) {
      val = 2;
    } else {
      val = 0;
    }
    size_t nl = canonical_len(r1.name);
    bool name_eq = cur.name.size() == nl &&
                   std::memcmp(cur.name.data(), r1.name, nl) == 0;
    if (val == 1 && name_eq && cur.val >= 0 && cur.val != 1) {
      P->err = "read " + std::string((const char *)r1.name, nl) +
               " is both unalignable and alignable according to the input "
               "file";
      return false;
    }
    bool same = (val == 1) && cur.val == 1 && name_eq;
    if (!same) {
      flush();
      cur.val = val;
      cur.name.assign((const char *)r1.name, nl);
      cur.s1.clear();
      cur.q1.clear();
      cur.s2.clear();
      cur.q2.clear();
      if (!decode_oriented(r1, P->has_qual, &cur.s1, &cur.q1, &P->err))
        return false;
      if (!decode_oriented(r2, P->has_qual, &cur.s2, &cur.q2, &P->err))
        return false;
    }
    if (val == 1) {
      if (r1.tid < 0 || r1.tid >= (int32_t)P->e2i.size()) {
        P->err = "alignment target id out of range";
        return false;
      }
      if (!(check_cigar(r1) && check_cigar(r2))) {
        P->err = "RSEM does not support gapped alignments (read " +
                 std::string((const char *)r1.name, nl) + ")";
        return false;
      }
      if (r1.tid != r2.tid) {
        P->err = "the two mates align to different transcripts "
                 "(discordant alignment)";
        return false;
      }
      int32_t sid = P->e2i[r1.tid];
      int32_t l1 = r1.l_seq, l2 = r2.l_seq;
      if (r1.flag & FLAG_REVERSE)
        cur.hits.push_back({-sid,
                            (int32_t)(P->target_len[r1.tid] - r1.pos - l1),
                            r1.pos + l1 - r2.pos});
      else
        cur.hits.push_back({sid, r1.pos, r2.pos + l2 - r1.pos});
    }
    return true;
  }
};


// ---------------------------------------------------------------------------
// SAM-text ingestion: each line is re-encoded as an in-memory BAM record and
// fed through the same Walker, so grouping/classification/stat semantics are
// shared with the BAM path byte for byte. Mirrors io/sam.py SamReader.
namespace samtext {

// base char -> code (A C G T N, case-insensitive); -1 = unknown
inline int8_t base_code(uint8_t c) {
  switch (c) {
  case 'A': case 'a': return 0;
  case 'C': case 'c': return 1;
  case 'G': case 'g': return 2;
  case 'T': case 't': return 3;
  case 'N': case 'n': return 4;
  default: return -1;
  }
}
const uint8_t CODE2NIB[5] = {1, 2, 4, 8, 15};

struct LineView { const char *p; size_t n; };

// encode one SAM line into `rec` (BAM record layout, without the leading
// block_size); returns encoded byte count, 0 to skip, -1 on error (err set)
int64_t encode_line(const char *line, size_t len,
                    const std::unordered_map<std::string, int32_t> &tid_of,
                    bool want_qual, const char ftag[2], bool has_ftag,
                    std::vector<uint8_t> *rec, std::string *err) {
  const char *f[12];
  size_t fl[12];
  int nf = 0;
  const char *q = line, *endp = line + len;
  while (nf < 12 && q <= endp) {
    const char *t = (const char *)memchr(q, '\t', endp - q);
    f[nf] = q;
    fl[nf] = (t ? t : endp) - q;
    nf++;
    if (!t) break;
    q = t + 1;
  }
  if (nf < 11) return 0;  // malformed line: skipped (SamReader parity)

  auto to_int = [](const char *s2, size_t n2) -> long long {
    long long v = 0;
    bool neg = n2 && s2[0] == '-';
    for (size_t i = neg ? 1 : 0; i < n2; i++) v = v * 10 + (s2[i] - '0');
    return neg ? -v : v;
  };
  int flag = (int)to_int(f[1], fl[1]);
  int32_t tid = -1;
  if (!(fl[2] == 1 && f[2][0] == '*')) {
    auto it = tid_of.find(std::string(f[2], fl[2]));
    if (it == tid_of.end()) {
      *err = "RSEM can not recognize reference sequence name " +
             std::string(f[2], fl[2]) + "!";
      return -1;
    }
    tid = it->second;
  }
  int32_t pos = (int32_t)to_int(f[3], fl[3]) - 1;
  int32_t l_seq = (fl[9] == 1 && f[9][0] == '*') ? 0 : (int32_t)fl[9];

  // cigar: single op only (multi-op handled as n_cigar>1 -> walker rejects
  // mapped records via check_cigar); "*" -> none
  uint32_t cigar_word = 0;
  int n_cigar = 0;
  if (!(fl[5] == 1 && f[5][0] == '*')) {
    size_t i = 0;
    long long n2 = 0;
    while (i < fl[5] && f[5][i] >= '0' && f[5][i] <= '9')
      n2 = n2 * 10 + (f[5][i++] - '0');
    char op = i < fl[5] ? f[5][i] : 0;
    int opc = op == 'M' ? 0 : op == '=' ? 7 : op == 'X' ? 8 : op == 'I' ? 1
              : op == 'D' ? 2 : op == 'N' ? 3 : op == 'S' ? 4 : op == 'H' ? 5
              : op == 'P' ? 6 : 0;
    cigar_word = ((uint32_t)n2 << 4) | (uint32_t)opc;
    n_cigar = 1;
    if (i + 1 < fl[5]) n_cigar = 2;  // >1 op: forces check_cigar failure
  }

  int name_len = (int)fl[0];
  if (name_len > 254) name_len = 254;
  int64_t total = 32 + (name_len + 1) + 4LL * n_cigar + (l_seq + 1) / 2 +
                  l_seq + (has_ftag ? 7 : 0);
  rec->assign(total, 0);
  uint8_t *o = rec->data();
  std::memcpy(o, &tid, 4);
  std::memcpy(o + 4, &pos, 4);
  o[8] = (uint8_t)(name_len + 1);
  uint16_t nc16 = (uint16_t)n_cigar;
  std::memcpy(o + 12, &nc16, 2);
  uint16_t fl16 = (uint16_t)flag;
  std::memcpy(o + 14, &fl16, 2);
  std::memcpy(o + 16, &l_seq, 4);
  uint8_t *w = o + 32;
  std::memcpy(w, f[0], name_len);
  w[name_len] = 0;
  w += name_len + 1;
  if (n_cigar >= 1) { std::memcpy(w, &cigar_word, 4); w += 4; }
  if (n_cigar == 2) { uint32_t z = 0; std::memcpy(w, &z, 4); w += 4; }
  for (int32_t i = 0; i < l_seq; i++) {
    int8_t c = base_code((uint8_t)f[9][i]);
    if (c < 0) {
      *err = std::string("Found unknown sequence letter '") + f[9][i] + "'";
      return -1;
    }
    uint8_t nib = CODE2NIB[c];
    if (i & 1) w[i >> 1] |= nib; else w[i >> 1] = (uint8_t)(nib << 4);
  }
  w += (l_seq + 1) / 2;
  if (fl[10] == 1 && f[10][0] == '*') {
    std::memset(w, 0xFF, l_seq);
  } else {
    for (int32_t i = 0; i < l_seq && i < (int32_t)fl[10]; i++) {
      int qv = (uint8_t)f[10][i] - 33;
      if (qv < 0 || qv > 93) {
        *err = "Quality score out of range [33, 126]";
        return -1;
      }
      w[i] = (uint8_t)qv;
    }
  }
  w += l_seq;
  if (has_ftag) {
    // attach the aligner filter tag when present on the line (type i)
    long long val = 0;
    bool found = false;
    for (int k = 11; k < nf; k++) {
      if (fl[k] >= 5 && f[k][0] == ftag[0] && f[k][1] == ftag[1] &&
          f[k][2] == ':' && f[k][3] == 'i' && f[k][4] == ':') {
        val = to_int(f[k] + 5, fl[k] - 5);
        found = true;
        break;
      }
    }
    if (found) {
      w[0] = (uint8_t)ftag[0];
      w[1] = (uint8_t)ftag[1];
      w[2] = 'i';
      int32_t v32 = (int32_t)val;
      std::memcpy(w + 3, &v32, 4);
    } else {
      rec->resize(total - 7);
    }
  }
  return (int64_t)rec->size();
}

} // namespace samtext

struct Handle {
  Parser P;
};

} // namespace

extern "C" {

// returns opaque handle (caller must bamparse_free) or NULL; errbuf gets the
// message on failure
void *bamparse_run(const char *path, int paired, int has_qual,
                   const int32_t *e2i, const int64_t *target_lens,
                   int n_targets, const char *filter_tag, int n_threads,
                   int has_polya, int seed_len,
                   char *errbuf, int errbuf_len) {
  auto fail = [&](const std::string &msg) -> void * {
    std::snprintf(errbuf, errbuf_len, "%s", msg.c_str());
    return nullptr;
  };
  const bool timing = std::getenv("RSEM_TPU_INGEST_TIMING") != nullptr;
  auto tick = std::chrono::steady_clock::now();
  auto lap = [&](const char *what) {
    if (!timing) return;
    auto now = std::chrono::steady_clock::now();
    std::fprintf(stderr, "[bamparse] %-10s %.3fs\n", what,
                 std::chrono::duration<double>(now - tick).count());
    tick = now;
  };
  FILE *f = std::fopen(path, "rb");
  if (!f) return fail("cannot open file");
  std::fseek(f, 0, SEEK_END);
  long fsize = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  std::vector<uint8_t> buf(fsize);
  if (fsize && std::fread(buf.data(), 1, fsize, f) != (size_t)fsize) {
    std::fclose(f);
    return fail("short read");
  }
  std::fclose(f);
  lap("read");

  std::string err;
  std::vector<BgzfBlock> blocks;
  size_t total_out = 0;
  if (!scan_bgzf(buf, &blocks, &total_out, &err)) return fail(err);
  lap("scan");
  std::vector<uint8_t> out(total_out);
  if (!inflate_blocks(buf, blocks, out.data(), n_threads, &err))
    return fail(err);
  buf.clear();
  buf.shrink_to_fit();
  lap("inflate");

  // header: magic, l_text, text, n_ref, per-ref name+len
  const uint8_t *p = out.data();
  const uint8_t *end = p + out.size();
  if (out.size() < 12 || std::memcmp(p, "BAM\x01", 4) != 0)
    return fail("not a BAM file");
  int32_t l_text = rd_i32(p + 4);
  p += 8 + l_text;
  if (p + 4 > end) return fail("truncated BAM header");
  int32_t n_ref = rd_i32(p);
  p += 4;
  if (n_ref != n_targets) return fail("header target count mismatch");
  for (int i = 0; i < n_ref; i++) {
    if (p + 4 > end) return fail("truncated BAM header refs");
    int32_t l_name = rd_i32(p);
    p += 4 + l_name + 4;
  }
  if (p > end) return fail("truncated BAM header refs");

  Handle *h = new Handle();
  Parser &P = h->P;
  P.paired = paired != 0;
  P.has_qual = has_qual != 0;
  P.has_polya = has_polya != 0;
  P.seed_len = seed_len;
  P.e2i.assign(e2i, e2i + n_targets);
  P.target_len.assign(target_lens, target_lens + n_targets);
  if (filter_tag && filter_tag[0] && filter_tag[1]) {
    P.ftag[0] = filter_tag[0];
    P.ftag[1] = filter_tag[1];
    P.has_ftag = true;
  }
  // reserve from a crude estimate to avoid repeated growth
  size_t est_records = out.size() / 96 + 16;
  P.nh.reserve(est_records);
  P.hit_sid.reserve(est_records);
  P.hit_pos.reserve(est_records);

  Walker w;
  w.P = &P;
  bool pending = false;
  RawRecord r1;
  while (p < end) {
    if (p + 4 > end) {
      delete h;
      return fail("truncated record length");
    }
    int32_t bs = rd_i32(p);
    p += 4;
    if (p + bs > end) {
      delete h;
      return fail("truncated record");
    }
    RawRecord r;
    if (!parse_record(p, bs, &r, &P.err)) {
      std::string e = P.err;
      delete h;
      return fail(e);
    }
    p += bs;
    if (P.paired) {
      if (!pending) {
        r1 = r;
        pending = true;
      } else {
        pending = false;
        if (!w.step_pe(r1, r)) {
          std::string e = P.err;
          delete h;
          return fail(e);
        }
      }
    } else {
      if (!w.step_se(r)) {
        std::string e = P.err;
        delete h;
        return fail(e);
      }
    }
  }
  if (pending) {
    delete h;
    return fail("paired-end file has an odd number of records");
  }
  w.flush();
  lap("walk");
  return h;
}

// sizes layout (int64[18]):
//  0: N1            1: n_hits        2: seq1_total    3: seq2_total
//  4: cat0.n        5: cat0 seq1 tot 6: cat0 seq2 tot
//  7: cat2.n        8: cat2 seq1 tot 9: cat2 seq2 tot
// 10: n_iso_multi   11..17: reserved 0
void bamparse_sizes(void *vh, int64_t *sizes) {
  Parser &P = ((Handle *)vh)->P;
  sizes[0] = (int64_t)P.len1.size();
  sizes[1] = (int64_t)P.hit_sid.size();
  sizes[2] = (int64_t)P.seq1.size();
  sizes[3] = (int64_t)P.seq2.size();
  sizes[4] = P.cat0.n;
  sizes[5] = (int64_t)P.cat0.seq1.size();
  sizes[6] = (int64_t)P.cat0.seq2.size();
  sizes[7] = P.cat2.n;
  sizes[8] = (int64_t)P.cat2.seq1.size();
  sizes[9] = (int64_t)P.cat2.seq2.size();
  sizes[10] = P.n_iso_multi;
  for (int i = 11; i < 18; i++) sizes[i] = 0;
}

static void copy32(const std::vector<int32_t> &v, int32_t *dst) {
  if (!v.empty() && dst) std::memcpy(dst, v.data(), v.size() * 4);
}
static void copy8(const std::vector<uint8_t> &v, uint8_t *dst) {
  if (!v.empty() && dst) std::memcpy(dst, v.data(), v.size());
}

void bamparse_export_n1(void *vh, uint8_t *seq1, uint8_t *qual1, int32_t *len1,
                        uint8_t *seq2, uint8_t *qual2, int32_t *len2,
                        int32_t *nh, int32_t *sid, int32_t *pos,
                        int32_t *ins) {
  Parser &P = ((Handle *)vh)->P;
  copy8(P.seq1, seq1);
  copy8(P.qual1, qual1);
  copy32(P.len1, len1);
  copy8(P.seq2, seq2);
  copy8(P.qual2, qual2);
  copy32(P.len2, len2);
  copy32(P.nh, nh);
  copy32(P.hit_sid, sid);
  copy32(P.hit_pos, pos);
  copy32(P.hit_ins, ins);
}

void bamparse_export_cat(void *vh, int cat, uint8_t *seq1, uint8_t *qual1,
                         int32_t *len1, uint8_t *seq2, uint8_t *qual2,
                         int32_t *len2) {
  Parser &P = ((Handle *)vh)->P;
  CatArrays &c = (cat == 0) ? P.cat0 : P.cat2;
  copy8(c.seq1, seq1);
  copy8(c.qual1, qual1);
  copy32(c.len1, len1);
  copy8(c.seq2, seq2);
  copy8(c.qual2, qual2);
  copy32(c.len2, len2);
}

// per-mate low-quality flags of the N1 reads (uint8 0/1); lq2 may be NULL
// for single-end
void bamparse_export_lq(void *vh, uint8_t *lq1, uint8_t *lq2) {
  Parser &P = ((Handle *)vh)->P;
  copy8(P.lq1_flags, lq1);
  if (lq2) copy8(P.lq2_flags, lq2);
}

// one category's streaming stats, packed as int64:
//   [0]                n_reads (non-lq mate additions)
//   [1 .. MAXL+1]      len_counts (length histogram, index = length)
//   [.. +QSIZE]        q_init
//   [.. +QSIZE*QSIZE]  q_tran (row-major)
//   [.. +QSIZE*NCODES] noise
// total = 1 + (STAT_MAXL+1) + 100 + 10000 + 500 int64s
void bamparse_export_stats(void *vh, int cat, int64_t *out) {
  Parser &P = ((Handle *)vh)->P;
  CatStats &st = P.st[cat];
  int64_t *p = out;
  *p++ = st.n_reads;
  std::memcpy(p, st.len_counts.data(), st.len_counts.size() * 8);
  p += st.len_counts.size();
  std::memcpy(p, st.q_init.data(), st.q_init.size() * 8);
  p += st.q_init.size();
  std::memcpy(p, st.q_tran.data(), st.q_tran.size() * 8);
  p += st.q_tran.size();
  std::memcpy(p, st.noise.data(), st.noise.size() * 8);
}

void bamparse_free(void *vh) { delete (Handle *)vh; }

// SAM-text counterpart of bamparse_run: `names` is the NUL-separated
// target-name blob in the same order as e2i/target_lens (the alignment
// file's header order). Handles plain and whole-stream-gzip SAM.
void *samparse_run(const char *path, int paired, int has_qual,
                   const char *names, const int32_t *e2i,
                   const int64_t *target_lens, int n_targets,
                   const char *filter_tag, int has_polya, int seed_len,
                   char *errbuf, int errbuf_len) {
  auto fail = [&](const std::string &msg) -> void * {
    std::snprintf(errbuf, errbuf_len, "%s", msg.c_str());
    return nullptr;
  };
  FILE *f = std::fopen(path, "rb");
  if (!f) return fail("cannot open file");
  std::fseek(f, 0, SEEK_END);
  long fsize = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  std::vector<uint8_t> raw(fsize);
  if (fsize && std::fread(raw.data(), 1, fsize, f) != (size_t)fsize) {
    std::fclose(f);
    return fail("short read");
  }
  std::fclose(f);

  std::vector<uint8_t> text;
  if (raw.size() >= 2 && raw[0] == 0x1f && raw[1] == 0x8b) {
    // whole-stream gzip (not BGZF-parallel: .sam.gz is one member)
    z_stream zs;
    std::memset(&zs, 0, sizeof(zs));
    if (inflateInit2(&zs, 15 + 32) != Z_OK) return fail("zlib init failed");
    text.resize(raw.size() * 4 + 4096);
    zs.next_in = raw.data();
    zs.avail_in = (uInt)raw.size();
    size_t done = 0;
    for (;;) {
      zs.next_out = text.data() + done;
      zs.avail_out = (uInt)(text.size() - done);
      int rc = inflate(&zs, Z_NO_FLUSH);
      done = text.size() - zs.avail_out;
      if (rc == Z_STREAM_END) break;
      if (rc != Z_OK && rc != Z_BUF_ERROR) {
        inflateEnd(&zs);
        return fail("gzip inflate failed");
      }
      if (zs.avail_out == 0) text.resize(text.size() * 2);
      else if (rc == Z_BUF_ERROR) break;
    }
    inflateEnd(&zs);
    text.resize(done);
  } else {
    text.swap(raw);
  }

  std::unordered_map<std::string, int32_t> tid_of;
  const char *np = names;
  for (int i = 0; i < n_targets; i++) {
    size_t l = std::strlen(np);
    tid_of.emplace(std::string(np, l), i);
    np += l + 1;
  }

  Handle *h = new Handle();
  Parser &P = h->P;
  P.paired = paired != 0;
  P.has_qual = has_qual != 0;
  P.has_polya = has_polya != 0;
  P.seed_len = seed_len;
  P.e2i.assign(e2i, e2i + n_targets);
  P.target_len.assign(target_lens, target_lens + n_targets);
  bool has_ftag = false;
  char ftag[2] = {0, 0};
  if (filter_tag && filter_tag[0] && filter_tag[1]) {
    ftag[0] = filter_tag[0];
    ftag[1] = filter_tag[1];
    has_ftag = true;
    P.ftag[0] = ftag[0];
    P.ftag[1] = ftag[1];
    P.has_ftag = true;
  }

  Walker w;
  w.P = &P;
  bool pending = false;
  std::vector<uint8_t> rec1, rec2;
  RawRecord r1, r;
  const char *q = (const char *)text.data();
  const char *endp = q + text.size();
  while (q < endp) {
    const char *nl = (const char *)memchr(q, '\n', endp - q);
    size_t ll = (nl ? nl : endp) - q;
    if (ll && q[ll - 1] == '\r') ll--;
    if (ll == 0 || q[0] == '@') {
      q = nl ? nl + 1 : endp;
      continue;
    }
    std::vector<uint8_t> &rec = (P.paired && !pending) ? rec1 : rec2;
    int64_t n = samtext::encode_line(q, ll, tid_of, P.has_qual, ftag,
                                     has_ftag, &rec, &P.err);
    q = nl ? nl + 1 : endp;
    if (n < 0) {
      std::string e = P.err;
      delete h;
      return fail(e);
    }
    if (n == 0) continue;
    RawRecord *tgt = (P.paired && !pending) ? &r1 : &r;
    if (!parse_record(rec.data(), (int32_t)rec.size(), tgt, &P.err)) {
      std::string e = P.err;
      delete h;
      return fail(e);
    }
    bool okstep;
    if (P.paired) {
      if (!pending) {
        pending = true;
        continue;
      }
      pending = false;
      okstep = w.step_pe(r1, r);
    } else {
      okstep = w.step_se(r);
    }
    if (!okstep) {
      std::string e = P.err;
      delete h;
      return fail(e);
    }
  }
  if (pending) {
    delete h;
    return fail("paired-end file has an odd number of records");
  }
  w.flush();
  return h;
}


// ---------------------------------------------------------------------------
// parallel BGZF compression (the write-side counterpart of inflate_blocks):
// split `len` bytes into <=65280-byte members, deflate them across threads
// (libdeflate when built with it, else zlib), emit the standard BGZF member
// framing (18-byte gzip header with BC subfield + CRC32 + ISIZE trailer).
// `out` must have room for bgzf_compress_bound(len) bytes; returns the
// actual output size, or -1 on failure. Replaces the single-thread Python
// zlib loop in io/bamio.BgzfWriter for bulk BAM writeback (the reference
// parallelizes this via hts_set_threads, BamWriter.h:72).
constexpr int64_t BGZF_CHUNK = 0xFF00;  // 65280
constexpr int64_t BGZF_SLACK = 1024;    // per-member worst-case overhead

int64_t bgzf_compress_bound(int64_t len) {
  int64_t nb = len <= 0 ? 1 : (len + BGZF_CHUNK - 1) / BGZF_CHUNK;
  return nb * (BGZF_CHUNK + BGZF_SLACK + 26);
}

int64_t bgzf_compress(const uint8_t *data, int64_t len, int level,
                      int n_threads, uint8_t *out) {
  int64_t nb = len <= 0 ? 0 : (len + BGZF_CHUNK - 1) / BGZF_CHUNK;
  std::vector<int64_t> out_off(nb + 1, 0);
  int64_t stride = BGZF_CHUNK + BGZF_SLACK + 26;
  std::vector<uint8_t> tmp(nb * stride);
  std::vector<int64_t> sizes(nb, -1);
  std::atomic<int64_t> next(0);
  std::atomic<bool> ok(true);
  auto worker = [&]() {
#ifdef USE_LIBDEFLATE
    struct libdeflate_compressor *c =
        libdeflate_alloc_compressor(level < 1 ? 1 : (level > 12 ? 12 : level));
    if (!c) { ok = false; return; }
#endif
    for (;;) {
      int64_t i = next.fetch_add(1);
      if (i >= nb || !ok.load(std::memory_order_relaxed)) break;
      const uint8_t *src = data + i * BGZF_CHUNK;
      int64_t n = std::min(BGZF_CHUNK, len - i * BGZF_CHUNK);
      uint8_t *dst = tmp.data() + i * stride;
      size_t csz = 0;
#ifdef USE_LIBDEFLATE
      csz = libdeflate_deflate_compress(c, src, (size_t)n, dst + 18,
                                        (size_t)(stride - 26));
      uint32_t crc = libdeflate_crc32(0, src, (size_t)n);
#else
      z_stream zs;
      std::memset(&zs, 0, sizeof(zs));
      if (deflateInit2(&zs, level, Z_DEFLATED, -15, 8,
                       Z_DEFAULT_STRATEGY) != Z_OK) { ok = false; break; }
      zs.next_in = const_cast<Bytef *>(src);
      zs.avail_in = (uInt)n;
      zs.next_out = dst + 18;
      zs.avail_out = (uInt)(stride - 26);
      int rc = deflate(&zs, Z_FINISH);
      csz = (rc == Z_STREAM_END) ? (size_t)zs.total_out : 0;
      deflateEnd(&zs);
      uint32_t crc = (uint32_t)crc32(0, src, (uInt)n);
#endif
      if (csz == 0) { ok = false; break; }
      uint16_t bsize = (uint16_t)(csz + 25);  // total-1
      const uint8_t hdr[18] = {31, 139, 8, 4, 0, 0, 0, 0, 0, 0xFF,
                               6, 0, 66, 67, 2, 0,
                               (uint8_t)(bsize & 0xFF),
                               (uint8_t)(bsize >> 8)};
      std::memcpy(dst, hdr, 18);
      uint32_t isize = (uint32_t)n;
      std::memcpy(dst + 18 + csz, &crc, 4);
      std::memcpy(dst + 18 + csz + 4, &isize, 4);
      sizes[i] = 18 + (int64_t)csz + 8;
    }
#ifdef USE_LIBDEFLATE
    libdeflate_free_compressor(c);
#endif
  };
  std::vector<std::thread> ts;
  int nt = n_threads < 1 ? 1 : n_threads;
  for (int t = 0; t < nt; t++) ts.emplace_back(worker);
  for (auto &t : ts) t.join();
  if (!ok) return -1;
  int64_t total = 0;
  for (int64_t i = 0; i < nb; i++) {
    std::memcpy(out + total, tmp.data() + i * stride, sizes[i]);
    total += sizes[i];
  }
  return total;
}

} // extern "C"
