"""Read start position distribution over B bins (reference: RSPD.h)."""

from __future__ import annotations

import numpy as np

from ..constants import EPSILON, RSPD_DEFAULT_B


class RSPD:
    def __init__(self, est_rspd: bool, B: int = RSPD_DEFAULT_B):
        self.est_rspd = est_rspd
        self.B = B
        # index 0 and B+1 stay zero (B+1 padding lets evalCDF read pdf[i+1])
        self.pdf = np.zeros(B + 2)
        self.cdf = np.zeros(B + 2)
        self.pdf[1 : B + 1] = 1.0 / B
        self.cdf[1 : B + 1] = np.arange(1, B + 1) / B

    def init(self):
        assert self.est_rspd
        self.pdf[:] = 0.0
        self.cdf[:] = 0.0

    def set_pdf(self, pdf_bins: np.ndarray):
        """Set from B unnormalized bin masses and finish."""
        assert len(pdf_bins) == self.B
        self.pdf[:] = 0.0
        self.pdf[1 : self.B + 1] = pdf_bins
        self.finish()

    def update(self, fpos: int, full_len: int, frac: float):
        """Spread fractional mass of position fpos across overlapped bins
        (reference: RSPD.h:43-59)."""
        assert self.est_rspd
        if fpos >= full_len:
            return
        B = self.B
        lo = fpos / full_len
        hi = (fpos + 1) / full_len
        for i in range(1, B + 1):
            overlap = min(hi, i / B) - max(lo, (i - 1) / B)
            if overlap > 0:
                self.pdf[i] += overlap * full_len * frac

    def finish(self):
        assert self.est_rspd
        s = self.pdf[1 : self.B + 1].sum()
        self.pdf[1 : self.B + 1] /= s
        self.cdf[:] = 0.0
        self.cdf[1 : self.B + 1] = np.cumsum(self.pdf[1 : self.B + 1])

    def eval_cdf(self, fpos: int, full_len: int) -> float:
        i = fpos * self.B // full_len
        val = fpos / full_len * self.B
        return float(self.cdf[i] + (val - i) * self.pdf[i + 1])

    def get_adjusted_prob(self, fpos: int, effL: int, full_len: int) -> float:
        assert 0 <= fpos < full_len and effL <= full_len
        if not self.est_rspd:
            return 1.0 / effL
        denom = self.eval_cdf(effL, full_len)
        if denom < EPSILON:
            return 0.0
        return (self.eval_cdf(fpos + 1, full_len) - self.eval_cdf(fpos, full_len)) / denom

    # --- vectorized queries (numpy; used by calcMW) ------------------------
    def eval_cdf_vec(self, fpos, full_len) -> np.ndarray:
        fpos = np.asarray(fpos, dtype=np.int64)
        full_len = np.asarray(full_len, dtype=np.int64)
        i = fpos * self.B // full_len
        val = fpos / full_len * self.B
        return self.cdf[i] + (val - i) * self.pdf[i + 1]

    def adjusted_prob_vec(self, fpos, effL, full_len) -> np.ndarray:
        if not self.est_rspd:
            return 1.0 / np.asarray(effL, dtype=np.float64)
        denom = self.eval_cdf_vec(effL, full_len)
        num = self.eval_cdf_vec(np.asarray(fpos) + 1, full_len) - self.eval_cdf_vec(
            fpos, full_len
        )
        with np.errstate(invalid="ignore", divide="ignore"):
            return np.where(denom >= EPSILON, num / np.where(denom == 0, 1, denom), 0.0)

    # --- serialization -----------------------------------------------------
    def write(self, fo):
        fo.write(f"{int(self.est_rspd)}\n")
        if self.est_rspd:
            fo.write(f"{self.B}\n")
            fo.write(
                " ".join(f"{x:.10g}" for x in self.pdf[1 : self.B + 1]) + "\n"
            )

    @classmethod
    def from_tokens(cls, tok) -> "RSPD":
        est = int(next(tok)) != 0
        if est:
            B = int(next(tok))
            out = cls(True, B)
            pdf = np.array([float(next(tok)) for _ in range(B)])
            out.pdf[:] = 0.0
            out.pdf[1 : B + 1] = pdf
            out.cdf[:] = 0.0
            out.cdf[1 : B + 1] = np.cumsum(pdf)
            return out
        return cls(False)
