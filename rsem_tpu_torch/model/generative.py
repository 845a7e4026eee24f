"""The generative read model: host-side state, estimation, and serialization.

One class covers all four reference model variants (SingleModel.h,
SingleQModel.h, PairedEndModel.h, PairedEndQModel.h) via ModelSpec's static
flags. Per-EM-round sufficient statistics are accumulated on device by the
ops kernels; `finish_round` folds them back here in float64 (normalize +
masking-weight recompute), matching the reference's collect/finish cycle
(EM.cpp:400-404).
"""

from __future__ import annotations

import io as _io
from typing import Dict, Optional

import numpy as np

from ..constants import EPSILON, MINEEL, NCODES, QSIZE
from .lendist import LenDist
from .noise import NoiseProfile, NoiseQProfile
from .orientation import Orientation
from .profile import Profile, QProfile
from .qualdist import QualDist
from .rspd import RSPD
from .spec import ModelSpec


class GenerativeModel:
    def __init__(self, spec: ModelSpec, refs=None):
        """refs: refprep.Reference (needed for calcMW/eel); may be None for
        pure serialization use."""
        self.spec = spec
        self.refs = refs
        self.ori = Orientation(spec.probF)
        self.gld = LenDist(spec.minL, spec.maxL)
        self.mld: Optional[LenDist] = (
            LenDist(spec.mate_minL, spec.mate_maxL) if spec.has_mld else None
        )
        self.rspd = RSPD(spec.est_rspd, spec.B)
        self.qd: Optional[QualDist] = QualDist() if spec.has_qual else None
        if spec.has_qual:
            self.pro = QProfile()
        else:
            self.pro = Profile(spec.maxL)
        self.npro = NoiseQProfile() if spec.has_qual else NoiseProfile()
        self.mw: Optional[np.ndarray] = None
        # device-window snapshots (set by freeze_windows)
        self.gld_window = (spec.minL - 1, spec.maxL)
        self.mld_window = (spec.mate_minL, spec.mate_maxL) if spec.has_mld else None

    # ------------------------------------------------------------------ #
    # estimation from the initial read pass                               #
    # ------------------------------------------------------------------ #
    def estimate_from_stats(self, stats: Dict[int, "ReadStats"]):
        """First pass over all read categories (reference:
        SingleModel.h:273-315, PairedEndQModel.h:241-289).

        stats[cat].len_counts feed gld (single) or mld (paired/with-mld);
        qual transition counts feed qd; stats[0].noise feeds the fixed noise
        counts."""
        spec = self.spec
        target = self.mld if self.mld is not None else self.gld
        target.init()
        max_needed = max(len(s.len_counts) for s in stats.values())
        for cat in range(3):
            s = stats.get(cat)
            if s is None or s.n_reads == 0:
                continue
            counts = s.len_counts
            lens = np.flatnonzero(counts)
            if lens.size:
                assert lens.min() > target.lb and lens.max() <= target.ub, (
                    f"Observed read length outside ({target.lb}, {target.ub}]"
                )
                target.update(lens, counts[lens])
            if self.qd is not None:
                self.qd.update_counts(s.q_init, s.q_tran)
        target.finish()

        if spec.use_mld_single:
            self.gld = LenDist(spec.minL, spec.maxL)
            self.gld.set_as_normal(
                spec.mean, spec.sd, max(self.mld.minL, spec.minL), spec.maxL
            )
        if self.qd is not None:
            self.qd.finish()

        noise0 = stats.get(0)
        if noise0 is not None:
            if spec.has_qual:
                self.npro.update_c_counts(noise0.noise)
            else:
                self.npro.update_c_counts(noise0.noise.sum(axis=0))
        self.npro.calc_init_params()

        self.freeze_windows()
        self.calc_mw()

    def freeze_windows(self):
        """Snapshot static device windows after the initial estimation; all
        jitted shapes derive from these."""
        self.gld_window = (self.gld.lb, self.gld.ub) if not self.spec.paired else (
            self.spec.minL - 1,
            self.spec.maxL,
        )
        if self.mld is not None:
            self.mld_window = (self.mld.lb, self.mld.ub)

    # ------------------------------------------------------------------ #
    # per-round model re-estimation from device sufficient statistics     #
    # ------------------------------------------------------------------ #
    def finish_round(self, suff: Dict[str, np.ndarray]):
        """suff keys: 'pro' (profile counts), 'npro' (noise counts),
        optionally 'rspd' ([B] bin masses) and 'gld' ([gspan] insert-length
        counts, paired only). Mirrors init/collect/finish
        (e.g. PairedEndQModel.h:296-316)."""
        spec = self.spec
        if spec.paired and "gld" in suff:
            lb0, ub0 = self.gld_window
            gld = LenDist(lb0 + 1, ub0)
            gld.pdf[:] = 0.0
            gld.pdf[1:] = np.asarray(suff["gld"], dtype=np.float64)
            gld.finish()
            self.gld = gld
        if spec.est_rspd and "rspd" in suff:
            self.rspd.set_pdf(np.asarray(suff["rspd"], dtype=np.float64))
        self.pro.finish_from_counts(np.asarray(suff["pro"], dtype=np.float64))
        self.npro.finish_from_counts(np.asarray(suff["npro"], dtype=np.float64))
        # single: mw depends on rspd only when estimated (SingleModel.h:326-329);
        # paired: gld changes every update round so always recompute
        # (PairedEndQModel.h:302-307).
        if spec.paired or spec.est_rspd:
            self.calc_mw()

    # ------------------------------------------------------------------ #
    # masking weights (reference: calcMW)                                 #
    # ------------------------------------------------------------------ #
    def calc_mw(self):
        M = self.refs.M if self.refs is not None else 0
        self.mw = np.ones(M + 1)
        if self.refs is None or not self.spec.has_polya:
            return
        full = self.refs.full_len[1:].astype(np.int64)
        tot = self.refs.tot_len[1:].astype(np.int64)
        ms = self.refs.mask_start[1:].astype(np.int64)
        value = np.zeros(M)

        if self.spec.paired:
            # PairedEndQModel.h:445-479: forward-only, seedPos = fpos
            end = np.minimum(full, tot - self.gld.minL + 1)
            win_lo, win_hi = ms, np.minimum(full, end)  # [lo, hi)
            value += self._mask_sum(win_lo, win_hi, full, tot, mate_factor=False,
                                    reverse=False)
        else:
            # SingleModel.h:462-524
            seed_len = self.spec.seed_len
            end = np.minimum(full, tot - seed_len + 1)
            win_lo, win_hi = ms, np.minimum(full, end)
            probF, probR = self.ori.prob[0], self.ori.prob[1]
            value += probF * self._mask_sum(
                win_lo, win_hi, full, tot, mate_factor=True, reverse=False
            )
            value += probR * self._mask_sum(
                win_lo, win_hi, full, tot, mate_factor=True, reverse=True
            )
            # reverse-strand poly(A) region: seedPos in [end, totLen-seedLen]
            value += probR * self._mask_sum(
                end, tot - seed_len + 1, full, tot, mate_factor=True,
                reverse=True, bounded_minL=True
            )

        mw = 1.0 - value
        mw[mw < 1e-8] = 0.0
        self.mw[1:] = mw

    def _mask_sum(
        self,
        win_lo: np.ndarray,
        win_hi: np.ndarray,
        full: np.ndarray,
        tot: np.ndarray,
        mate_factor: bool,
        reverse: bool,
        bounded_minL: bool = False,
    ) -> np.ndarray:
        """Sum over seed positions [win_lo, win_hi) and fragment lengths of
        gldAdj * rspdAdj * [mldCumFactor], per transcript. Chunked numpy."""
        M = len(full)
        out = np.zeros(M)
        widths = np.maximum(win_hi - win_lo, 0)
        if widths.sum() == 0:
            return out
        gld = self.gld
        frag = np.arange(gld.lb + 1, gld.ub + 1)  # [F]
        F = len(frag)
        seed_len = self.spec.seed_len

        idx = np.flatnonzero(widths > 0)
        # flatten (transcript, window position) pairs
        tr = np.repeat(idx, widths[idx])
        seed_pos = np.concatenate(
            [np.arange(win_lo[i], win_hi[i]) for i in idx]
        ) if idx.size else np.zeros(0, dtype=np.int64)

        CH = 2048
        for s in range(0, len(tr), CH):
            t = tr[s : s + CH]
            sp = seed_pos[s : s + CH][:, None]  # [C,1]
            fl = full[t][:, None]
            tl = tot[t][:, None]
            fr = frag[None, :]  # [1,F]
            if not reverse:
                in_range = fr <= (tl - sp)
                pfpos = np.broadcast_to(sp, (len(t), F))
            else:
                hi = sp + seed_len
                in_range = fr <= np.minimum(gld.ub, hi)
                if bounded_minL:
                    in_range &= fr >= np.maximum(gld.minL, hi - fl + 1)
                pfpos = hi - fr
            effL = np.minimum(fl, tl - fr + 1)
            gl = gld.adjusted_prob_vec(fr, tl)
            # clamp out-of-range pfpos to keep the vectorized rspd eval legal
            pf = np.clip(pfpos, 0, fl - 1)
            rp = self.rspd.adjusted_prob_vec(pf, np.maximum(effL, 1), fl)
            term = np.where(in_range & (effL >= 1), gl * rp, 0.0)
            if mate_factor and self.mld is not None:
                mf = self.mld.adjusted_cumulative_prob_vec(
                    np.minimum(self.mld.maxL, fr), np.broadcast_to(fr, (len(t), F))
                )
                term = term * mf
            np.add.at(out, t, term.sum(axis=1))
        return out

    # ------------------------------------------------------------------ #
    # expected effective lengths (reference: WriteResults.h:25-53)        #
    # ------------------------------------------------------------------ #
    def calc_eel(self) -> np.ndarray:
        assert self.refs is not None
        gld = self.gld
        lb, ub, span = gld.lb, gld.ub, gld.span
        pdf, cdf = gld.pdf, gld.cdf
        clen = np.zeros(span + 1)
        clen[1:] = np.cumsum(pdf[1:] * (lb + np.arange(1, span + 1)))

        M = self.refs.M
        tot = self.refs.tot_len[1:].astype(np.int64)
        full = self.refs.full_len[1:].astype(np.int64)
        pos1 = np.maximum(np.minimum(tot - full + 1, ub) - lb, 0)
        pos2 = np.maximum(np.minimum(tot, ub) - lb, 0)
        eel = np.zeros(M + 1)
        eel[1:] = np.where(
            pos2 == 0,
            0.0,
            full * cdf[pos1]
            + ((cdf[pos2] - cdf[pos1]) * (tot + 1) - (clen[pos2] - clen[pos1])),
        )
        eel[eel < MINEEL] = 0.0
        return eel

    # ------------------------------------------------------------------ #
    # device export                                                       #
    # ------------------------------------------------------------------ #
    def device_arrays(self) -> Dict[str, np.ndarray]:
        """Arrays the conprb/suffstat kernels consume (fixed shapes)."""
        out: Dict[str, np.ndarray] = {}
        with np.errstate(divide="ignore"):
            out["log_ori"] = np.log(self.ori.prob)
            gpdf, gcdf = self.gld.device_arrays(*self.gld_window)
            out["gld_pdf"] = gpdf
            out["gld_cdf"] = gcdf
            out["log_gld_pdf"] = np.log(gpdf)
            out["log_gld_cdf"] = np.log(gcdf)
            if self.mld is not None:
                mpdf, mcdf = self.mld.device_arrays(*self.mld_window)
                out["mld_pdf"] = mpdf
                out["mld_cdf"] = mcdf
                out["log_mld_pdf"] = np.log(mpdf)
                out["log_mld_cdf"] = np.log(mcdf)
            out["rspd_pdf"] = self.rspd.pdf.copy()
            out["rspd_cdf"] = self.rspd.cdf.copy()
            out["log_pro"] = np.log(self.pro.p)
            out["log_npro"] = np.log(self.npro.p)
            out["log_mw"] = np.log(np.where(self.mw < EPSILON, 0.0, self.mw))
        return out

    # ------------------------------------------------------------------ #
    # .model serialization (spec: model_file_description.txt)             #
    # ------------------------------------------------------------------ #
    def write(self, path: str):
        spec = self.spec
        with open(path, "w") as fo:
            fo.write(f"{spec.model_type}\n\n")
            self.ori.write(fo)
            fo.write("\n")
            self.gld.write(fo)
            fo.write("\n")
            if spec.paired:
                self.mld.write(fo)
                fo.write("\n")
            else:
                if self.mld is not None:
                    fo.write("1\n")
                    self.mld.write(fo)
                else:
                    fo.write("0\n")
                fo.write("\n")
            self.rspd.write(fo)
            fo.write("\n")
            if self.qd is not None:
                self.qd.write(fo)
                fo.write("\n")
            self.pro.write(fo)
            fo.write("\n")
            self.npro.write(fo)
            if self.mw is not None:
                M = len(self.mw) - 1
                fo.write(f"\n{M}\n")
                fo.write(" ".join(f"{x:.15g}" for x in self.mw) + "\n")

    @classmethod
    def read(cls, path: str, refs=None, spec: Optional[ModelSpec] = None) -> "GenerativeModel":
        with open(path) as f:
            tok = iter(f.read().split())
        model_type = int(next(tok))
        probF = float(next(tok))
        gld = LenDist.from_tokens(tok)
        mld = None
        if model_type >= 2:
            mld = LenDist.from_tokens(tok)
        else:
            if int(next(tok)) > 0:
                mld = LenDist.from_tokens(tok)
        rspd = RSPD.from_tokens(tok)
        has_qual = model_type in (1, 3)
        qd = QualDist.from_tokens(tok) if has_qual else None
        pro = QProfile.from_tokens(tok) if has_qual else Profile.from_tokens(tok)
        npro = (
            NoiseQProfile.from_tokens(tok) if has_qual else NoiseProfile.from_tokens(tok)
        )
        mw = None
        try:
            M = int(next(tok))
            mw = np.array([float(next(tok)) for _ in range(M + 1)])
        except StopIteration:
            pass

        if spec is None:
            spec = ModelSpec(
                model_type=model_type,
                est_rspd=rspd.est_rspd,
                B=rspd.B,
                minL=gld.minL if model_type >= 2 else 1,
                maxL=gld.maxL if model_type >= 2 else max(gld.maxL, 1000),
                mean=1.0 if (model_type < 2 and mld is not None) else -1.0,
                probF=probF,
            )
        out = cls(spec, refs)
        out.ori = Orientation(probF)
        out.gld = gld
        out.mld = mld
        out.rspd = rspd
        out.qd = qd
        out.pro = pro
        out.npro = npro
        out.mw = mw
        out.freeze_windows()
        return out
