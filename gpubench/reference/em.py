"""The plain reference: RSEM's EM for paired-end reads with qualities.

It works out, from the sample's reads, alignments and read statistics alone,
what RSEM computes (EM.cpp, PairedEndQModel.h, WriteResults.h):

1. the model's first estimate from the read statistics, then
   `UPDATE_MODEL_ROUNDS` rounds of: each hit's conditional probability
   (conprb) from the current model, the E-step, theta's M-step and the
   model's refit from the posterior-weighted statistics (quality profile,
   noise profile, fragment-length and read-start histograms);
2. the final model's conprbs, frozen;
3. theta-only rounds until RSEM's stop rule holds (every theta >= 1e-7
   moved by less than 1e-3, at least 20 rounds);
4. the expected counts at the last theta, TPM and FPKM (polishTheta,
   calcExpressionValues) and their sums per gene.

It is plain torch (any device) for the per-hit work and numpy float64 for
the model (`model.py`), both written from RSEM's equations; it imports
nothing of the program. `Precision` sets the floating types of the per-hit
work: the reference runs in float64 throughout. The configuration states
float32 for every per-hit and per-read value, theta, and a hit's sum over
its read positions, and float64 for sums over hits and reads: `STATED`
computes so, a second witness of how far a sound run at that precision lies
from the float64 reference. The control (`CONTROL`) computes one step
lower: the values and position sums in bfloat16, the sums over hits and
reads in float32.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, NamedTuple

import numpy as np
import torch

from . import model as rm
from .model import EPSILON, ReadModel

# EM.cpp: theta's stop rule, and the rounds that refit the model
STOP_CRITERIA = 1e-3
THETA_CUT = 1e-7
MIN_ROUND = 20
MAX_ROUND = 10000
UPDATE_MODEL_ROUNDS = 10

NEG_INF = float("-inf")
LOG_EPS = math.log(1e-300)
CHUNK = 1 << 22  # hits (or reads) per step of the per-position passes


class Precision(NamedTuple):
    value: torch.dtype  # per-hit, per-read values and theta
    position: torch.dtype  # a hit's sum over its read positions
    acc: torch.dtype  # sums over hits or reads


REFERENCE = Precision(torch.float64, torch.float64, torch.float64)
STATED = Precision(torch.float32, torch.float32, torch.float64)
CONTROL = Precision(torch.bfloat16, torch.bfloat16, torch.float32)


@dataclass
class Expression:
    """What the comparison reads, [M+1] per isoform (entry 0 the noise
    isoform) and [G] per gene, float64 numpy."""

    counts: np.ndarray
    tpm: np.ndarray
    fpkm: np.ndarray
    eel: np.ndarray
    gene_counts: np.ndarray
    gene_tpm: np.ndarray
    gene_fpkm: np.ndarray
    rounds: int


def _length_prob(pdf, cdf, length, ref_len, dt):
    """LenDist::getAdjustedProb: P(length) given that it fits ref_len, 0
    where ref_len admits no length of the distribution."""
    top = pdf.shape[0] - 1
    den = cdf[ref_len.clamp(0, top)]
    num = torch.where((length >= 1) & (length <= top),
                      pdf[length.clamp(0, top)], 0.0)
    ok = den > 0
    return torch.where(ok, num / torch.where(ok, den, 1.0), 0.0).to(dt)


def _read_start_cdf(rspd, cdf, fpos, full_len, dt):
    """RSPD::evalCDF: the bins' mass before position fpos, linear inside a
    bin."""
    B = rspd.shape[0] - 1
    i = torch.div(fpos * B, full_len, rounding_mode="floor")
    val = fpos.to(dt) / full_len.to(dt) * B
    return cdf[i] + (val - i.to(dt)) * rspd[i]


def _log(x):
    return torch.where(x > 0, torch.log(torch.where(x > 0, x, 1.0)), NEG_INF)


class PlainEM:
    """One sample's reference EM on `device` in precision `prec`."""

    def __init__(self, ann, raw, cfg: Dict, device, prec: Precision):
        self.prec, self.dev = prec, torch.device(device)
        flags = cfg["rsem"]
        self.est_rspd = bool(flags["estimate_rspd"])
        self.bins = int(flags["num_rspd_bins"])
        self.min_frag = int(flags["fragment_length_min"])
        self.max_frag = int(flags["fragment_length_max"])
        self.prob_forward = float(cfg["forward_prob"])
        self.M = ann.M
        self.gene_of = np.asarray(ann.iso_gene)
        self.n_genes = ann.n_genes
        self.tlen = np.asarray(ann.tlen, dtype=np.int64)
        full = np.concatenate([[0], self.tlen])
        self.n0 = int(raw.n0)
        self.n1 = int(raw.n1)
        self.stats = raw.stats
        dev = self.dev

        def t(x):
            return torch.as_tensor(np.ascontiguousarray(x), device=dev)

        self.sid = t(raw.sid).long()
        self.rid = t(raw.rid).long()
        self.dir = t(raw.dir).long()
        self.pos = t(raw.pos).long()
        self.ins = t(raw.ins).long()
        self.fl = t(full)[self.sid]
        self.l1 = t(raw.lens).long()[self.rid]
        self.l2 = self.l1  # both mates of one length
        self.keys = self._profile_keys(ann, raw)
        self.nkeys = [self._noise_keys(t(c), t(q))
                      for c, q in ((raw.codes1, raw.quals1),
                                   (raw.codes2, raw.quals2))]

    def _noise_keys(self, codes, quals):
        """Per read and mate, [N, L] int16 keys quality*5 + base of the
        noise profile."""
        out = torch.empty(codes.shape, dtype=torch.int16, device=self.dev)
        for a in range(0, codes.shape[0], CHUNK):
            out[a:a + CHUNK] = (quals[a:a + CHUNK].long() * 5
                                + codes[a:a + CHUNK].long()).to(torch.int16)
        return out

    # ------------------------------------------------------------------ #
    def _profile_keys(self, ann, raw):
        """Per hit and mate, [H, L] int16 keys (quality*5 + reference
        base)*5 + read base of the quality profile, the reference base
        taken on the hit's strand (SamParser.h strand-local positions)."""
        dev = self.dev
        codes = torch.as_tensor(ann.codes, device=dev)
        off = torch.as_tensor(ann.offsets, device=dev)
        tl = torch.as_tensor(ann.tlen, device=dev)
        L = raw.codes1.shape[1]
        j = torch.arange(L, device=dev)[None, :]
        out = []
        for c_np, q_np, mate2 in ((raw.codes1, raw.quals1, False),
                                  (raw.codes2, raw.quals2, True)):
            rc = torch.as_tensor(c_np, device=dev)
            rq = torch.as_tensor(q_np, device=dev)
            keys = torch.empty((len(self.sid), L), dtype=torch.int16,
                               device=dev)
            for a in range(0, len(self.sid), CHUNK):
                sl = slice(a, a + CHUNK)
                s0 = self.sid[sl] - 1
                p, d = self.pos[sl], self.dir[sl]
                if mate2:
                    p = tl[s0] - p - self.ins[sl]
                    d = 1 - d
                rev = (d == 1)[:, None]
                q = torch.where(rev, off[s0, None] + tl[s0, None] - 1
                                - p[:, None] - j, off[s0, None] + p[:, None]
                                + j)
                refc = codes[q].long()
                refc = torch.where(rev & (refc < 4), 3 - refc, refc)
                r = self.rid[sl]
                keys[sl] = ((rq[r].long() * 5 + refc) * 5
                            + rc[r].long()).to(torch.int16)
            out.append(keys)
        return out

    # ------------------------------------------------------------------ #
    def _tables(self, model: ReadModel) -> Dict[str, torch.Tensor]:
        """The model's tables, and the cumulative sums its queries divide
        by, in the value type."""
        with np.errstate(divide="ignore"):
            tabs = {"log_ori": np.log(model.ori),
                    "gld": model.gld, "gld_cdf": np.cumsum(model.gld),
                    "mld": model.mld, "mld_cdf": np.cumsum(model.mld),
                    "rspd": model.rspd,
                    "rspd_cdf": np.concatenate([[0.0], np.cumsum(
                        model.rspd[:-1])]),
                    "log_pro": np.log(model.qpro),
                    "log_npro": np.log(model.nqpro),
                    "log_mw": np.log(np.where(model.mw < EPSILON, 0.0,
                                              model.mw))}
        return {k: torch.as_tensor(np.asarray(v, dtype=np.float64),
                                   device=self.dev).to(self.prec.value)
                for k, v in tabs.items()}

    def _conprbs(self, model: ReadModel):
        """(log conprb [H], log noise conprb [N]) of the current model:
        each per-hit factor (orientation, fragment length, read start,
        mate lengths) and its logarithm in the value type, the profile's
        log sum over the read positions in the position type."""
        vt, _pt, _at = self.prec
        tb = self._tables(model)
        sid, d, pos, ins, fl = self.sid, self.dir, self.pos, self.ins, self.fl
        tl = fl
        fpos = torch.where(d == 1, tl - pos - ins, pos)
        effL = torch.minimum(fl, tl - ins + 1)
        g = _length_prob(tb["gld"], tb["gld_cdf"], ins, tl, vt)
        m1 = _length_prob(tb["mld"], tb["mld_cdf"], self.l1, ins, vt)
        m2 = _length_prob(tb["mld"], tb["mld_cdf"], self.l2, ins, vt)
        ok = (fpos >= 0) & (fpos < fl) & (effL >= 1)
        if self.est_rspd:
            fc = torch.minimum(fpos.clamp(min=0), fl - 1)
            ec = torch.minimum(effL.clamp(min=1), fl)
            rs, rc = tb["rspd"], tb["rspd_cdf"]
            den = _read_start_cdf(rs, rc, ec, fl, vt)
            num = (_read_start_cdf(rs, rc, fc + 1, fl, vt)
                   - _read_start_cdf(rs, rc, fc, fl, vt))
            r = torch.where(den > 0, num / torch.where(den > 0, den, 1.0),
                            0.0)
        else:
            r = 1.0 / effL.clamp(min=1).to(vt)
        r = torch.where(ok, r, 0.0).to(vt)
        lp = tb["log_ori"][d] + _log(g) + _log(r) + _log(m1) + _log(m2)
        log_pro = tb["log_pro"].reshape(-1)
        for keys in self.keys:
            lp = lp + self._key_sum(log_pro, keys)
        lp = torch.where(fpos >= fl, NEG_INF, lp.to(vt))
        lp = torch.where(lp < LOG_EPS, NEG_INF, lp)
        log_mw = tb["log_mw"][sid]
        lcp = torch.where(log_mw > NEG_INF, lp - log_mw, NEG_INF).to(vt)

        # noise: each mate's bases under the noise profile times the mate
        # length's probability (getNoiseConPrb); every mate has length L
        log_npro = tb["log_npro"].reshape(-1)
        L = self.nkeys[0].shape[1]
        p_len = float(model.mld[L]) if L < len(model.mld) else 0.0
        len_term = math.log(p_len) if p_len > 0 else NEG_INF
        lnp = 2 * len_term + sum(self._key_sum(log_npro, k)
                                 for k in self.nkeys)
        lnp = torch.where(lnp < LOG_EPS, NEG_INF, lnp).to(vt)
        return lcp, lnp

    def _key_sum(self, table, keys):
        """Per row, the sum over positions of table[key], in the position
        type."""
        pt = self.prec.position
        out = torch.empty(keys.shape[0], dtype=pt, device=self.dev)
        for a in range(0, keys.shape[0], CHUNK):
            out[a:a + CHUNK] = table[keys[a:a + CHUNK].long()].to(pt).sum(
                1, dtype=pt)
        return out

    # ------------------------------------------------------------------ #
    def _estep(self, log_theta, lcp, lnp):
        """(frac_hit [H], frac_noise [N]) at theta (EM.cpp:199-244)."""
        vt, _pt, at = self.prec
        n = self.n1
        lw = (log_theta[self.sid] + lcp).to(at)
        lw0 = (log_theta[0] + lnp).to(at)
        lw = torch.where(lw < LOG_EPS, NEG_INF, lw)
        lw0 = torch.where(lw0 < LOG_EPS, NEG_INF, lw0)
        mx = torch.full((n,), NEG_INF, dtype=at, device=self.dev)
        mx.scatter_reduce_(0, self.rid, lw, "amax", include_self=True)
        mx = torch.maximum(mx, lw0)
        mx = torch.where(mx > NEG_INF, mx, 0.0)
        e = torch.where(lw > NEG_INF, torch.exp(lw - mx[self.rid]), 0.0)
        e0 = torch.where(lw0 > NEG_INF, torch.exp(lw0 - mx), 0.0)
        den = torch.zeros(n, dtype=at, device=self.dev).index_add_(
            0, self.rid, e) + e0
        den = torch.where(den > 0, den, 1.0)
        return (e / den[self.rid]).to(vt), (e0 / den).to(vt)

    def _counts(self, fh, fn):
        at = self.prec.acc
        c = torch.zeros(self.M + 1, dtype=at, device=self.dev)
        c.index_add_(0, self.sid, fh.to(at))
        c[0] += fn.to(at).sum() + self.n0
        return c

    def _suffstats(self, fh, fn) -> Dict:
        """The posterior-weighted statistics of the refit (PairedEndQModel::
        update): profile and noise-profile counts, the fragment-length and
        read-start histograms, float64 numpy."""
        at = self.prec.acc
        L = self.keys[0].shape[1]
        pro = torch.zeros(2500, dtype=at, device=self.dev)
        for keys in self.keys:
            for a in range(0, keys.shape[0], CHUNK):
                k = keys[a:a + CHUNK].long().reshape(-1)
                w = fh[a:a + CHUNK].to(at)[:, None].expand(-1, L).reshape(-1)
                pro += torch.bincount(k, weights=w, minlength=2500)[:2500]
        npro = torch.zeros(500, dtype=at, device=self.dev)
        for keys in self.nkeys:
            for a in range(0, keys.shape[0], CHUNK):
                k = keys[a:a + CHUNK].long().reshape(-1)
                w = fn[a:a + CHUNK].to(at)[:, None].expand(-1, L).reshape(-1)
                npro += torch.bincount(k, weights=w, minlength=500)[:500]
        top = self.max_frag
        gld = torch.zeros(top + 1, dtype=at, device=self.dev).index_add_(
            0, self.ins.clamp(0, top), fh.to(at))
        out = {"pro": pro.reshape(100, 5, 5), "npro": npro.reshape(100, 5),
               "gld": gld}
        if self.est_rspd:
            B = self.bins
            d, pos, ins, fl = self.dir, self.pos, self.ins, self.fl
            fpos = torch.where(d == 1, fl - pos - ins, pos)
            frac = torch.where(fpos < fl, fh.to(at), 0.0)
            full = fl.clamp(min=1).to(at)
            lo = fpos.to(at) / full
            hi = (fpos.to(at) + 1.0) / full
            edges = torch.arange(B + 1, dtype=at, device=self.dev) / B
            rs = torch.zeros(B, dtype=at, device=self.dev)
            for a in range(0, len(fpos), CHUNK):
                sl = slice(a, a + CHUNK)
                seg = (torch.minimum(hi[sl, None], edges[None, 1:])
                       - torch.maximum(lo[sl, None], edges[None, :-1]))
                rs += (seg.clamp(min=0.0) * full[sl, None]
                       * frac[sl, None]).sum(0)
            out["rspd"] = rs
        return {k: v.double().cpu().numpy() for k, v in out.items()}

    # ------------------------------------------------------------------ #
    def run(self) -> Expression:
        """RSEM's EM to its own stop, and the expression values there."""
        vt, _pt, at = self.prec
        M = self.M
        model = rm.first_estimate(self.stats, self.tlen, self.min_frag,
                                  self.max_frag, self.bins, self.prob_forward)
        theta = torch.empty(M + 1, dtype=at, device=self.dev)
        theta[0] = max(self.n0 / (self.n0 + self.n1), 1e-8)
        theta[1:] = (1.0 - theta[0]) / M
        theta = theta.to(vt)
        rounds = 0
        for _ in range(UPDATE_MODEL_ROUNDS):
            lcp, lnp = self._conprbs(model)
            fh, fn = self._estep(_log(theta), lcp, lnp)
            c = self._counts(fh, fn)
            theta = (c / c.sum()).to(vt)
            model = rm.refit(model, self._suffstats(fh, fn), self.tlen)
            rounds += 1
        lcp, lnp = self._conprbs(model)
        while True:
            fh, fn = self._estep(_log(theta), lcp, lnp)
            c = self._counts(fh, fn)
            new = (c / c.sum()).to(vt)
            rounds += 1
            keep = theta >= THETA_CUT
            rel = (new - theta).abs().to(at) / torch.where(
                keep, theta, 1.0).to(at)
            moving = int(((rel >= STOP_CRITERIA) & keep).sum())
            theta = new
            if rounds >= MIN_ROUND and (moving == 0 or rounds >= MAX_ROUND):
                break
        return self._expression(theta, lcp, lnp, rm.effective_lengths(model.gld, self.tlen), model.mw,
                                rounds)

    def _expression(self, theta, lcp, lnp, eel, mw, rounds) -> Expression:
        """The final E-step's expected counts at theta, TPM and FPKM, and
        their sums per gene."""
        fh, fn = self._estep(_log(theta), lcp, lnp)
        counts = self._counts(fh, fn).double().cpu().numpy()
        theta64 = theta.double().cpu().numpy()
        tpm, fpkm = expression_values(polish_theta(theta64, eel, mw), eel)
        G = self.n_genes
        gene = self.gene_of

        def per_gene(x):
            return np.bincount(gene, weights=x[1:], minlength=G)

        return Expression(counts, tpm, fpkm, eel, per_gene(counts),
                          per_gene(tpm), per_gene(fpkm), rounds)


def polish_theta(theta: np.ndarray, eel: np.ndarray, mw: np.ndarray
                 ) -> np.ndarray:
    """WriteResults.h:55-75 (polishTheta)."""
    out = theta.astype(np.float64).copy()
    bad = (mw[1:] < EPSILON) | (eel[1:] < EPSILON)
    out[1:][bad] = 0.0
    good = ~bad
    out[1:][good] = out[1:][good] / mw[1:][good]
    out[0] = out[0] / mw[0]
    return out / out.sum()


def expression_values(theta: np.ndarray, eel: np.ndarray):
    """WriteResults.h:77-104 (calcExpressionValues): (tpm, fpkm) [M+1]."""
    M = len(theta) - 1
    ok = eel[1:] >= EPSILON
    frac = np.where(ok, theta[1:], 0.0)
    s = frac.sum()
    frac = frac / (s if s >= EPSILON else 1.0)
    fpkm = np.zeros(M + 1)
    fpkm[1:] = np.where(ok, frac * 1e9 / np.where(ok, eel[1:], 1.0), 0.0)
    s2 = fpkm[1:].sum()
    tpm = np.zeros(M + 1)
    tpm[1:] = fpkm[1:] / (s2 if s2 >= EPSILON else 1.0) * 1e6
    return tpm, fpkm


def reference_expression(ann, raw, cfg: Dict, device,
                         prec: Precision = REFERENCE) -> Expression:
    """The reference's (or, with CONTROL or STATED, that precision's)
    expression values of one sample, at RSEM's own stop."""
    return PlainEM(ann, raw, cfg, device, prec).run()
