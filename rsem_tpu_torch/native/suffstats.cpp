// Host sidecar of the hybrid and native EM backends (engine/em.py):
// exact float64 conprbs, the cached-conprb E-step and the model's
// sufficient statistics, multithreaded with std::thread.
//
// Copy of rsem_tpu/native/suffstats.cpp; keep the two identical in their
// arithmetic (tests/test_torch_native.py holds them bit for bit). The
// per-(hit, base) scatter-adds into tiny tables (profile 2500 bins, noise
// 500, fragment-length <=1000, RSPD 20) are cache-resident random writes.
// This mirrors the reference's per-thread model-helper update/collect
// cycle (EM.cpp:177-247, SingleModel.h update, PairedEndQModel.h update)
// including the exact single-end + user-mld remarginalized RSPD update
// (SingleModel.h:178-199).
//
// Built by rsem_tpu_torch/native/__init__.py with
// g++ -O3 -shared -fPIC -std=c++17 -pthread into rsem_tpu_torch/_build/.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

constexpr int NCODES = 5;

struct Args {
  // hits
  int64_t n_hits;
  const int32_t* rid;
  const int32_t* sid;
  const int8_t* dir;
  const int32_t* pos;
  const int32_t* insert_len;  // null if single-end
  const float* frac;          // [H]
  // reads (mate1)
  const uint8_t* codes1;  // [N, L]
  const uint8_t* quals1;  // null if no qual
  const int32_t* lens1;
  // mate2 (paired)
  const uint8_t* codes2;
  const uint8_t* quals2;
  const int32_t* lens2;
  int64_t n_reads;
  int64_t max_len;
  const float* frac_noise;  // [N]
  // reference
  const uint8_t* ref_codes;
  const int64_t* ref_offsets;  // [M+2]
  const int32_t* tot_len;      // [M+1]
  const int32_t* full_len;     // [M+1]
  // model static config
  int has_qual;
  int paired;
  int est_rspd;
  int B;
  double probF;
  int pro_len;
  int gld_lb, gld_ub;    // fragment dist window
  int mld_lb, mld_ub;    // mate dist window (single-end user-mld mode)
  int use_mld_single;
  // distributions for the remarginalized RSPD update (single + mld)
  const double* gld_pdf;  // [gspan+1]
  const double* gld_cdf;
  const double* mld_pdf;  // [mspan+1]
  const double* mld_cdf;
  const double* rspd_pdf;  // [B+2]
  const double* rspd_cdf;
};

inline int ref_base(const Args& a, int32_t s, int64_t p, int d) {
  int64_t tl = a.tot_len[s];
  int64_t idx = d ? (a.ref_offsets[s] + tl - 1 - p) : (a.ref_offsets[s] + p);
  int c = a.ref_codes[idx];
  if (d) c = (c < 4) ? 3 - c : c;
  return c;
}

struct Acc {
  std::vector<double> pro;   // [pro_len*25]
  std::vector<double> npro;  // [500] or [5]
  std::vector<double> gld;   // [gspan]
  std::vector<double> rspd;  // [B]
  void init(const Args& a) {
    pro.assign((size_t)a.pro_len * 25, 0.0);
    npro.assign(a.has_qual ? 500 : 5, 0.0);
    gld.assign(a.gld_ub - a.gld_lb, 0.0);
    rspd.assign(a.B, 0.0);
  }
  void merge(const Acc& o) {
    for (size_t i = 0; i < pro.size(); i++) pro[i] += o.pro[i];
    for (size_t i = 0; i < npro.size(); i++) npro[i] += o.npro[i];
    for (size_t i = 0; i < gld.size(); i++) gld[i] += o.gld[i];
    for (size_t i = 0; i < rspd.size(); i++) rspd[i] += o.rspd[i];
  }
};

inline void update_profile(const Args& a, Acc& acc, const uint8_t* codes,
                           const uint8_t* quals, int len, int32_t s,
                           int64_t p, int d, double frac) {
  for (int j = 0; j < len; j++) {
    int rc = ref_base(a, s, p + j, d);
    int key = a.has_qual ? quals[j] : j;
    acc.pro[(size_t)(key * 5 + rc) * 5 + codes[j]] += frac;
  }
}

inline void rspd_update(const Args& a, Acc& acc, int64_t fpos, int64_t fl,
                        double frac) {
  // fractional-bin spreading (RSPD.h:43-59)
  if (fpos >= fl) return;
  int B = a.B;
  double lo = (double)fpos / fl;
  int i = (int)(fpos * (int64_t)B / fl) + 1;
  int last = (int)(((fpos + 1) * (int64_t)B - 1) / fl) + 1;
  double aa = lo;
  for (; i < last; i++) {
    double b = (double)i / B;
    acc.rspd[i - 1] += (b - aa) * fl * frac;
    aa = b;
  }
  double b = (double)(fpos + 1) / fl;
  acc.rspd[i - 1] += (b - aa) * fl * frac;
}

inline double gld_adj(const Args& a, int len, int64_t refL) {
  if (len <= a.gld_lb || len > a.gld_ub || refL <= a.gld_lb) return 0.0;
  int span = a.gld_ub - a.gld_lb;
  int64_t di = std::min<int64_t>(a.gld_ub, refL) - a.gld_lb;
  double denom = a.gld_cdf[di];
  if (denom < 1e-300) return 0.0;
  return a.gld_pdf[len - a.gld_lb] / denom;
}

inline double mld_adj(const Args& a, int len, int64_t refL) {
  if (len <= a.mld_lb || len > a.mld_ub || refL <= a.mld_lb) return 0.0;
  int64_t di = std::min<int64_t>(a.mld_ub, refL) - a.mld_lb;
  double denom = a.mld_cdf[di];
  if (denom < 1e-300) return 0.0;
  return a.mld_pdf[len - a.mld_lb] / denom;
}

inline double rspd_adj(const Args& a, int64_t fpos, int64_t effL, int64_t fl) {
  if (fpos < 0 || fpos >= fl || effL < 1) return 0.0;
  if (!a.est_rspd) return 1.0 / (double)effL;
  auto eval = [&](int64_t p) {
    int i = (int)(p * (int64_t)a.B / fl);
    double val = (double)p / fl * a.B;
    return a.rspd_cdf[i] + (val - i) * a.rspd_pdf[i + 1];
  };
  double denom = eval(std::min(effL, fl));
  if (denom < 1e-300) return 0.0;
  return (eval(fpos + 1) - eval(fpos)) / denom;
}

void worker(const Args& a, int64_t lo, int64_t hi, Acc& acc) {
  acc.init(a);
  const double ORIVALVE = 0.1;
  for (int64_t h = lo; h < hi; h++) {
    double f = a.frac[h];
    if (f < 1e-300) continue;
    int32_t r = a.rid[h];
    int32_t s = a.sid[h];
    int d = a.dir[h];
    int64_t p = a.pos[h];
    int64_t tl = a.tot_len[s];
    int64_t fl = a.full_len[s];
    const uint8_t* c1 = a.codes1 + (size_t)r * a.max_len;
    const uint8_t* q1 = a.has_qual ? a.quals1 + (size_t)r * a.max_len : nullptr;
    int l1 = a.lens1[r];

    if (a.paired) {
      int64_t ins = a.insert_len[h];
      acc.gld[std::min<int64_t>(std::max<int64_t>(ins - a.gld_lb - 1, 0),
                                (int64_t)acc.gld.size() - 1)] += f;
      if (a.est_rspd) {
        int64_t fpos = d ? tl - p - ins : p;
        rspd_update(a, acc, fpos, fl, f);
      }
      update_profile(a, acc, c1, q1, l1, s, p, d, f);
      const uint8_t* c2 = a.codes2 + (size_t)r * a.max_len;
      const uint8_t* q2 = a.has_qual ? a.quals2 + (size_t)r * a.max_len : nullptr;
      int l2 = a.lens2[r];
      update_profile(a, acc, c2, q2, l2, s, tl - p - ins, 1 - d, f);
    } else {
      if (a.est_rspd) {
        if (a.probF >= ORIVALVE && d == 0) {
          rspd_update(a, acc, p, fl, f);
        } else if (a.probF < ORIVALVE && d == 1) {
          if (a.use_mld_single) {
            // remarginalize over fragment lengths (SingleModel.h:178-199)
            int minL = std::max((int64_t)l1, (int64_t)a.gld_lb + 1);
            int maxL = (int)std::min<int64_t>(tl - p, a.gld_ub);
            double sum = 0.0;
            std::vector<double> fv(std::max(maxL - minL + 1, 0), 0.0);
            for (int fragLen = minL; fragLen <= maxL; fragLen++) {
              int64_t pf = tl - p - fragLen;
              int64_t effL = std::min(fl, tl - fragLen + 1);
              fv[fragLen - minL] = gld_adj(a, fragLen, tl) *
                                   rspd_adj(a, pf, effL, fl) *
                                   mld_adj(a, l1, fragLen);
              sum += fv[fragLen - minL];
            }
            if (sum >= 1e-300)
              for (int fragLen = minL; fragLen <= maxL; fragLen++)
                rspd_update(a, acc, tl - p - fragLen, fl,
                            f * (fv[fragLen - minL] / sum));
          } else {
            rspd_update(a, acc, tl - p - l1, fl, f);
          }
        }
      }
      update_profile(a, acc, c1, q1, l1, s, p, d, f);
    }
  }
}

void noise_worker(const Args& a, int64_t lo, int64_t hi, Acc& acc) {
  for (int64_t r = lo; r < hi; r++) {
    double f = a.frac_noise[r];
    if (f < 1e-300) continue;
    const uint8_t* c1 = a.codes1 + (size_t)r * a.max_len;
    int l1 = a.lens1[r];
    if (a.has_qual) {
      const uint8_t* q1 = a.quals1 + (size_t)r * a.max_len;
      for (int j = 0; j < l1; j++) acc.npro[q1[j] * 5 + c1[j]] += f;
      if (a.paired) {
        const uint8_t* c2 = a.codes2 + (size_t)r * a.max_len;
        const uint8_t* q2 = a.quals2 + (size_t)r * a.max_len;
        int l2 = a.lens2[r];
        for (int j = 0; j < l2; j++) acc.npro[q2[j] * 5 + c2[j]] += f;
      }
    } else {
      for (int j = 0; j < l1; j++) acc.npro[c1[j]] += f;
      if (a.paired) {
        const uint8_t* c2 = a.codes2 + (size_t)r * a.max_len;
        int l2 = a.lens2[r];
        for (int j = 0; j < l2; j++) acc.npro[c2[j]] += f;
      }
    }
  }
}

// ------------------------------------------------------------------ //
// conprb: per-hit alignment likelihood, exact float64 reference math   //
// (SingleModel.h:95-146, SingleQModel.h:101-151, PairedEndModel.h:90-  //
// 135, PairedEndQModel.h:94-138)                                       //
// ------------------------------------------------------------------ //
struct CArgs : Args {
  const double* pro;      // [pro_len*25] linear probabilities
  const double* npro;     // [500] or [5]
  const double* mw;       // [M+1]
  const int32_t* mask_start;  // [M+1]
  double ori[2];
  int seed_len;
  const uint8_t* lq;  // [N] low-quality flags
  double* out_conprb;  // [H]
  double* out_ncp;     // [N]
};

inline double profile_prob(const CArgs& a, const uint8_t* codes,
                           const uint8_t* quals, int len, int32_t s,
                           int64_t p, int d) {
  double prob = 1.0;
  for (int j = 0; j < len; j++) {
    int rc = ref_base(a, s, p + j, d);
    int key = a.has_qual ? quals[j] : j;
    prob *= a.pro[(size_t)(key * 5 + rc) * 5 + codes[j]];
  }
  return prob;
}

void conprb_worker(const CArgs& a, int64_t lo, int64_t hi) {
  for (int64_t h = lo; h < hi; h++) {
    int32_t r = a.rid[h];
    int32_t s = a.sid[h];
    int d = a.dir[h];
    int64_t p = a.pos[h];
    int64_t tl = a.tot_len[s];
    int64_t fl = a.full_len[s];
    int64_t ms = a.mask_start[s];
    const uint8_t* c1 = a.codes1 + (size_t)r * a.max_len;
    const uint8_t* q1 = a.has_qual ? a.quals1 + (size_t)r * a.max_len : nullptr;
    int l1 = a.lens1[r];
    double prob = 0.0;

    if (a.lq[r]) { a.out_conprb[h] = 0.0; continue; }

    if (a.paired) {
      int64_t ins = a.insert_len[h];
      int64_t fpos = d ? tl - p - ins : p;
      int64_t effL = std::min(fl, tl - ins + 1);
      if (fpos >= fl || (fpos >= ms && fpos < fl)) { a.out_conprb[h] = 0.0; continue; }
      prob = a.ori[d] * gld_adj(a, (int)ins, tl) * rspd_adj(a, fpos, effL, fl);
      prob *= mld_adj(a, l1, ins) * profile_prob(a, c1, q1, l1, s, p, d);
      const uint8_t* c2 = a.codes2 + (size_t)r * a.max_len;
      const uint8_t* q2 = a.has_qual ? a.quals2 + (size_t)r * a.max_len : nullptr;
      int l2 = a.lens2[r];
      prob *= mld_adj(a, l2, ins) *
              profile_prob(a, c2, q2, l2, s, tl - p - ins, 1 - d);
    } else {
      int64_t fpos = d ? tl - p - l1 : p;
      int64_t seed_pos = d ? tl - p - a.seed_len : p;
      if (seed_pos >= fl || (seed_pos >= ms && seed_pos < fl)) {
        a.out_conprb[h] = 0.0;
        continue;
      }
      double value;
      if (a.use_mld_single) {
        int minL = std::max((int64_t)l1, (int64_t)a.gld_lb + 1);
        int maxL = (int)std::min<int64_t>(tl - p, a.gld_ub);
        value = 0.0;
        for (int fragLen = minL; fragLen <= maxL; fragLen++) {
          int64_t pf = d ? tl - p - fragLen : p;
          int64_t effL = std::min(fl, tl - fragLen + 1);
          value += gld_adj(a, fragLen, tl) * rspd_adj(a, pf, effL, fl) *
                   mld_adj(a, l1, fragLen);
        }
      } else {
        int64_t effL = std::min(fl, tl - (int64_t)l1 + 1);
        value = gld_adj(a, l1, tl) * rspd_adj(a, fpos, effL, fl);
      }
      prob = a.ori[d] * value * profile_prob(a, c1, q1, l1, s, p, d);
    }
    if (prob < 1e-300) prob = 0.0;
    a.out_conprb[h] = (a.mw[s] < 1e-300 ? 0.0 : prob / a.mw[s]);
  }
}

void noise_conprb_worker(const CArgs& a, int64_t lo, int64_t hi) {
  for (int64_t r = lo; r < hi; r++) {
    if (a.lq[r]) { a.out_ncp[r] = 0.0; continue; }
    const uint8_t* c1 = a.codes1 + (size_t)r * a.max_len;
    int l1 = a.lens1[r];
    double prob;
    // length term: mld pdf if present else gld pdf (getNoiseConPrb)
    auto len_pdf = [&](int len) {
      if (a.paired || a.use_mld_single) {
        if (len <= a.mld_lb || len > a.mld_ub) return 0.0;
        return a.mld_pdf[len - a.mld_lb];
      }
      if (len <= a.gld_lb || len > a.gld_ub) return 0.0;
      return a.gld_pdf[len - a.gld_lb];
    };
    auto noise_prob = [&](const uint8_t* c, const uint8_t* q, int len) {
      double pr = 1.0;
      for (int j = 0; j < len; j++)
        pr *= a.has_qual ? a.npro[q[j] * 5 + c[j]] : a.npro[c[j]];
      return pr;
    };
    const uint8_t* q1 = a.has_qual ? a.quals1 + (size_t)r * a.max_len : nullptr;
    prob = len_pdf(l1) * noise_prob(c1, q1, l1);
    if (a.paired) {
      const uint8_t* c2 = a.codes2 + (size_t)r * a.max_len;
      const uint8_t* q2 = a.has_qual ? a.quals2 + (size_t)r * a.max_len : nullptr;
      int l2 = a.lens2[r];
      prob *= len_pdf(l2) * noise_prob(c2, q2, l2);
    }
    if (prob < 1e-300) prob = 0.0;
    a.out_ncp[r] = prob;  // mw[0] == 1 always
  }
}

}  // namespace

extern "C" void conprb(
    int64_t n_hits, const int32_t* rid, const int32_t* sid, const int8_t* dir,
    const int32_t* pos, const int32_t* insert_len,
    const uint8_t* codes1, const uint8_t* quals1, const int32_t* lens1,
    const uint8_t* codes2, const uint8_t* quals2, const int32_t* lens2,
    int64_t n_reads, int64_t max_len, const uint8_t* lq,
    const uint8_t* ref_codes, const int64_t* ref_offsets,
    const int32_t* tot_len, const int32_t* full_len,
    const int32_t* mask_start, int has_qual, int paired, int est_rspd, int B,
    double probF, int pro_len, int seed_len, int gld_lb, int gld_ub,
    int mld_lb, int mld_ub, int use_mld_single, const double* gld_pdf,
    const double* gld_cdf, const double* mld_pdf, const double* mld_cdf,
    const double* rspd_pdf, const double* rspd_cdf, const double* pro,
    const double* npro, const double* mw, int n_threads, double* out_conprb,
    double* out_ncp) {
  CArgs a{};
  a.n_hits = n_hits; a.rid = rid; a.sid = sid; a.dir = dir; a.pos = pos;
  a.insert_len = insert_len; a.frac = nullptr;
  a.codes1 = codes1; a.quals1 = quals1; a.lens1 = lens1;
  a.codes2 = codes2; a.quals2 = quals2; a.lens2 = lens2;
  a.n_reads = n_reads; a.max_len = max_len; a.frac_noise = nullptr;
  a.ref_codes = ref_codes; a.ref_offsets = ref_offsets;
  a.tot_len = tot_len; a.full_len = full_len;
  a.has_qual = has_qual; a.paired = paired; a.est_rspd = est_rspd; a.B = B;
  a.probF = probF; a.pro_len = pro_len;
  a.gld_lb = gld_lb; a.gld_ub = gld_ub; a.mld_lb = mld_lb; a.mld_ub = mld_ub;
  a.use_mld_single = use_mld_single;
  a.gld_pdf = gld_pdf; a.gld_cdf = gld_cdf; a.mld_pdf = mld_pdf;
  a.mld_cdf = mld_cdf; a.rspd_pdf = rspd_pdf; a.rspd_cdf = rspd_cdf;
  a.pro = pro; a.npro = npro; a.mw = mw; a.mask_start = mask_start;
  a.ori[0] = probF; a.ori[1] = 1.0 - probF;
  a.seed_len = seed_len; a.lq = lq;
  a.out_conprb = out_conprb; a.out_ncp = out_ncp;

  int nt = std::max(1, n_threads);
  std::vector<std::thread> threads;
  int64_t per = (n_hits + nt - 1) / nt;
  for (int t = 0; t < nt; t++) {
    int64_t lo = t * per, hi = std::min<int64_t>(n_hits, lo + per);
    threads.emplace_back([&, lo, hi] { conprb_worker(a, lo, hi); });
  }
  for (auto& th : threads) th.join();
  threads.clear();
  int64_t perr = (n_reads + nt - 1) / nt;
  for (int t = 0; t < nt; t++) {
    int64_t lo = t * perr, hi = std::min<int64_t>(n_reads, lo + perr);
    threads.emplace_back([&, lo, hi] { noise_conprb_worker(a, lo, hi); });
  }
  for (auto& th : threads) th.join();
}

// One E-step over cached conprbs: per-read responsibilities + expected
// counts (EM.cpp:199-244 with needCalcConPrb=false). Used for the model
// rounds' fracs, the final counts and the native backend's theta loop.
extern "C" void em_count_step(
    int64_t n_reads, const int64_t* read_offsets, const int32_t* sid,
    const double* conprb, const double* ncp, const double* theta, int64_t M,
    int n_threads, double* out_frac, double* out_frac_noise,
    double* out_counts) {
  int nt = std::max(1, n_threads);
  std::vector<std::vector<double>> counts(nt);
  std::vector<std::thread> threads;
  int64_t per = (n_reads + nt - 1) / nt;
  for (int t = 0; t < nt; t++) {
    int64_t lo = t * per, hi = std::min<int64_t>(n_reads, lo + per);
    threads.emplace_back([&, t, lo, hi] {
      auto& cv = counts[t];
      cv.assign(M + 1, 0.0);
      for (int64_t i = lo; i < hi; i++) {
        int64_t fr = read_offsets[i], to = read_offsets[i + 1];
        double w0 = theta[0] * ncp[i];
        if (w0 < 1e-300) w0 = 0.0;
        double sum = w0;
        for (int64_t j = fr; j < to; j++) {
          double w = theta[sid[j]] * conprb[j];
          if (w < 1e-300) w = 0.0;
          out_frac[j] = w;
          sum += w;
        }
        if (sum >= 1e-300) {
          double inv = 1.0 / sum;
          out_frac_noise[i] = w0 * inv;
          cv[0] += out_frac_noise[i];
          for (int64_t j = fr; j < to; j++) {
            out_frac[j] *= inv;
            cv[sid[j]] += out_frac[j];
          }
        } else {
          out_frac_noise[i] = 0.0;
          for (int64_t j = fr; j < to; j++) out_frac[j] = 0.0;
        }
      }
    });
  }
  for (auto& th : threads) th.join();
  for (int64_t m = 0; m <= M; m++) {
    double s = 0.0;
    for (int t = 0; t < nt; t++) s += counts[t][m];
    out_counts[m] = s;
  }
}

extern "C" void suffstats(
    int64_t n_hits, const int32_t* rid, const int32_t* sid, const int8_t* dir,
    const int32_t* pos, const int32_t* insert_len, const float* frac,
    const uint8_t* codes1, const uint8_t* quals1, const int32_t* lens1,
    const uint8_t* codes2, const uint8_t* quals2, const int32_t* lens2,
    int64_t n_reads, int64_t max_len, const float* frac_noise,
    const uint8_t* ref_codes, const int64_t* ref_offsets,
    const int32_t* tot_len, const int32_t* full_len, int has_qual, int paired,
    int est_rspd, int B, double probF, int pro_len, int gld_lb, int gld_ub,
    int mld_lb, int mld_ub, int use_mld_single, const double* gld_pdf,
    const double* gld_cdf, const double* mld_pdf, const double* mld_cdf,
    const double* rspd_pdf, const double* rspd_cdf, int n_threads,
    double* out_pro, double* out_npro, double* out_gld, double* out_rspd) {
  Args a{n_hits, rid,   sid,     dir,     pos,     insert_len, frac,
         codes1, quals1, lens1,  codes2,  quals2,  lens2,      n_reads,
         max_len, frac_noise, ref_codes, ref_offsets, tot_len, full_len,
         has_qual, paired, est_rspd, B, probF, pro_len, gld_lb, gld_ub,
         mld_lb, mld_ub, use_mld_single, gld_pdf, gld_cdf, mld_pdf, mld_cdf,
         rspd_pdf, rspd_cdf};

  int nt = std::max(1, n_threads);
  std::vector<Acc> accs(nt);
  std::vector<std::thread> threads;
  int64_t per = (n_hits + nt - 1) / nt;
  for (int t = 0; t < nt; t++) {
    int64_t lo = t * per, hi = std::min<int64_t>(n_hits, lo + per);
    threads.emplace_back([&, t, lo, hi] { worker(a, lo, hi, accs[t]); });
  }
  for (auto& th : threads) th.join();
  threads.clear();
  // noise pass (over reads)
  std::vector<Acc> naccs(nt);
  int64_t perr = (n_reads + nt - 1) / nt;
  for (int t = 0; t < nt; t++) {
    int64_t lo = t * perr, hi = std::min<int64_t>(n_reads, lo + perr);
    naccs[t].init(a);
    threads.emplace_back([&, t, lo, hi] { noise_worker(a, lo, hi, naccs[t]); });
  }
  for (auto& th : threads) th.join();

  for (int t = 1; t < nt; t++) accs[0].merge(accs[t]);
  std::vector<double> npro(a.has_qual ? 500 : 5, 0.0);
  for (int t = 0; t < nt; t++)
    for (size_t i = 0; i < npro.size(); i++) npro[i] += naccs[t].npro[i];

  std::memcpy(out_pro, accs[0].pro.data(), accs[0].pro.size() * sizeof(double));
  std::memcpy(out_npro, npro.data(), npro.size() * sizeof(double));
  std::memcpy(out_gld, accs[0].gld.data(), accs[0].gld.size() * sizeof(double));
  std::memcpy(out_rspd, accs[0].rspd.data(), accs[0].rspd.size() * sizeof(double));
}
