"""Length distribution over an (lb, ub] support (reference: LenDist.h).

Host-side estimation and serialization run in float64 numpy; `device_arrays`
exports fixed-shape pdf/cdf vectors over the *configured* window so jitted
kernels never see shape changes from trimming (trim only zeroes sub-EPSILON
tails, which are exact zeros in float32 anyway).
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np

from ..constants import EPSILON, RANGE


def _normal_cdf(x: float, mean: float, sd: float) -> float:
    return 0.5 * (1.0 + math.erf((x - mean) / (sd * math.sqrt(2.0))))


class LenDist:
    def __init__(self, minL: int = 1, maxL: int = 1000):
        self.lb = minL - 1
        self.ub = maxL
        assert self.span > 0
        self.pdf = np.zeros(self.span + 1)
        self.pdf[1:] = 1.0 / self.span
        self.cdf = np.zeros(self.span + 1)
        self.cdf[1:] = np.cumsum(self.pdf[1:])

    @property
    def span(self) -> int:
        return self.ub - self.lb

    @property
    def minL(self) -> int:
        return self.lb + 1

    @property
    def maxL(self) -> int:
        return self.ub

    def init(self):
        self.pdf[:] = 0.0
        self.cdf[:] = 0.0

    def update(self, length, frac=1.0):
        """Accumulate observations; length may be an int or array."""
        lengths = np.atleast_1d(np.asarray(length, dtype=np.int64))
        fracs = np.broadcast_to(np.asarray(frac, dtype=np.float64), lengths.shape)
        assert ((lengths > self.lb) & (lengths <= self.ub)).all()
        np.add.at(self.pdf, lengths - self.lb, fracs)

    def finish(self):
        s = self.pdf[1:].sum()
        if s <= EPSILON:
            raise ValueError("No valid read to estimate the length distribution!")
        self.pdf[1:] /= s
        self.cdf[1:] = np.cumsum(self.pdf[1:])
        self.trim()

    def trim(self):
        """Drop sub-EPSILON tails (reference: LenDist.h trim)."""
        nz = np.flatnonzero(self.pdf[1:] >= EPSILON)
        if nz.size == 0:
            return
        newlb, newub = int(nz[0]), int(nz[-1]) + 1
        if newlb == 0 and newub == self.span:
            return
        pdf = np.zeros(newub - newlb + 1)
        cdf = np.zeros(newub - newlb + 1)
        pdf[1:] = self.pdf[newlb + 1 : newub + 1]
        cdf[1:] = self.cdf[newlb + 1 : newub + 1]
        self.lb += newlb
        self.ub = self.lb + (newub - newlb)
        self.pdf, self.cdf = pdf, cdf

    def set_as_normal(self, mean: float, sd: float, minL: int, maxL: int):
        """Discretized Normal clipped to RANGE bins (reference:
        LenDist.h:113-179)."""
        meanL = int(mean + 0.5)
        if sd < EPSILON:
            if meanL < minL or meanL > maxL:
                raise ValueError(
                    "Length distribution's probability mass is not within the "
                    f"possible range! MeanL = {meanL}, MinL = {minL}, MaxL = {maxL}"
                )
            self.lb, self.ub = meanL - 1, meanL
            self.pdf = np.array([0.0, 1.0])
            self.cdf = np.array([0.0, 1.0])
            return

        if maxL - minL + 1 > RANGE:
            if meanL <= minL:
                maxL = minL + RANGE - 1
            elif meanL >= maxL:
                minL = maxL - RANGE + 1
            else:
                lg = mean - (minL - 0.5)
                rg = (maxL + 0.5) - mean
                half = RANGE / 2.0
                if lg < half:
                    maxL = minL + RANGE - 1
                elif rg < half:
                    minL = maxL - RANGE + 1
                else:
                    minL = int(mean - half + 1.0)
                    maxL = int(mean + half)
        assert maxL - minL + 1 <= RANGE

        self.lb, self.ub = minL - 1, maxL
        span = self.span
        edges = np.array(
            [_normal_cdf(self.lb + i + 0.5, mean, sd) for i in range(span + 1)]
        )
        edges[0] = _normal_cdf(minL - 0.5, mean, sd)
        self.pdf = np.zeros(span + 1)
        self.pdf[1:] = np.diff(edges)
        s = self.pdf.sum()
        assert s >= EPSILON
        self.pdf /= s
        self.cdf = np.zeros(span + 1)
        self.cdf[1:] = np.cumsum(self.pdf[1:])
        self.trim()

    # --- queries (host, exact reference semantics) -------------------------
    def get_prob(self, length: int) -> float:
        if length <= self.lb or length > self.ub:
            return 0.0
        return float(self.pdf[length - self.lb])

    def get_adjusted_prob(self, length: int, refL: int) -> float:
        if length <= self.lb or length > self.ub or refL <= self.lb:
            return 0.0
        denom = self.cdf[min(self.ub, refL) - self.lb]
        assert denom >= EPSILON
        return float(self.pdf[length - self.lb] / denom)

    def get_adjusted_cumulative_prob(self, length: int, refL: int) -> float:
        denom = self.cdf[min(self.ub, refL) - self.lb]
        return float(self.cdf[length - self.lb] / denom)

    # --- vectorized queries (numpy, float64; used by calcMW/eel) -----------
    def adjusted_prob_vec(self, length, refL) -> np.ndarray:
        length = np.asarray(length, dtype=np.int64)
        refL = np.asarray(refL, dtype=np.int64)
        valid = (length > self.lb) & (length <= self.ub) & (refL > self.lb)
        denom_idx = np.clip(np.minimum(self.ub, refL) - self.lb, 0, self.span)
        denom = self.cdf[denom_idx]
        p = self.pdf[np.clip(length - self.lb, 0, self.span)]
        with np.errstate(invalid="ignore", divide="ignore"):
            out = np.where(valid & (denom >= EPSILON), p / np.where(denom == 0, 1, denom), 0.0)
        return out

    def adjusted_cumulative_prob_vec(self, length, refL) -> np.ndarray:
        length = np.asarray(length, dtype=np.int64)
        refL = np.asarray(refL, dtype=np.int64)
        denom_idx = np.clip(np.minimum(self.ub, refL) - self.lb, 0, self.span)
        denom = self.cdf[denom_idx]
        c = self.cdf[np.clip(length - self.lb, 0, self.span)]
        with np.errstate(invalid="ignore", divide="ignore"):
            return np.where(denom >= EPSILON, c / np.where(denom == 0, 1, denom), 0.0)

    # --- device export -----------------------------------------------------
    def device_arrays(self, lb0: int, ub0: int) -> Tuple[np.ndarray, np.ndarray]:
        """pdf/cdf over the fixed window (lb0, ub0] (float32-ready f64)."""
        span0 = ub0 - lb0
        pdf = np.zeros(span0 + 1)
        lo = max(self.lb + 1, lb0 + 1)
        hi = min(self.ub, ub0)
        if hi >= lo:
            pdf[lo - lb0 : hi - lb0 + 1] = self.pdf[lo - self.lb : hi - self.lb + 1]
        cdf = np.zeros(span0 + 1)
        cdf[1:] = np.cumsum(pdf[1:])
        return pdf, cdf

    # --- serialization (reference: LenDist.h read/write) -------------------
    def write(self, fo):
        fo.write(f"{self.lb} {self.ub} {self.span}\n")
        fo.write(" ".join(f"{x:.10g}" for x in self.pdf[1:]) + "\n")

    @classmethod
    def from_tokens(cls, tok) -> "LenDist":
        lb, ub, span = int(next(tok)), int(next(tok)), int(next(tok))
        out = cls.__new__(cls)
        out.lb, out.ub = lb, ub
        out.pdf = np.zeros(span + 1)
        for i in range(1, span + 1):
            out.pdf[i] = float(next(tok))
        out.cdf = np.zeros(span + 1)
        out.cdf[1:] = np.cumsum(out.pdf[1:])
        out.trim()
        return out
