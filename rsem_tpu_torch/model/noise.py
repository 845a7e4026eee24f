"""Noise-read base models (reference: NoiseProfile.h, NoiseQProfile.h).

`c` holds base counts from unalignable (N0) reads, fixed after the initial
pass; `p` additionally folds in posterior-weighted counts from alignable reads
at every finish().
"""

from __future__ import annotations

import numpy as np

from ..constants import EPSILON, NCODES, QSIZE


class NoiseProfile:
    def __init__(self):
        self.c = np.zeros(NCODES)
        self.p = np.zeros(NCODES)
        self.logp = 0.0

    def update_c_counts(self, base_counts: np.ndarray):
        self.c += base_counts

    def calc_init_params(self):
        s = (1.0 + self.c).sum()
        self.p = (1.0 + self.c) / s
        self._calc_logp()

    def finish_from_counts(self, counts: np.ndarray):
        s = (counts + self.c).sum()
        self.logp = 0.0
        if s <= EPSILON:
            return
        self.p = (counts + self.c) / s
        self._calc_logp()

    def _calc_logp(self):
        mask = self.c > 0.0
        self.logp = float((self.c[mask] * np.log(self.p[mask])).sum())

    def get_prob(self, read_codes) -> float:
        return float(np.prod(self.p[np.asarray(read_codes)]))

    def write(self, fo):
        fo.write(f"{NCODES}\n")
        fo.write(" ".join(f"{x:.10g}" for x in self.p) + "\n")

    @classmethod
    def from_tokens(cls, tok) -> "NoiseProfile":
        ncodes = int(next(tok))
        assert ncodes == NCODES
        out = cls()
        out.p = np.array([float(next(tok)) for _ in range(NCODES)])
        return out


class NoiseQProfile:
    def __init__(self):
        self.c = np.zeros((QSIZE, NCODES))
        self.p = np.zeros((QSIZE, NCODES))
        self.logp = 0.0

    def update_c_counts(self, qual_base_counts: np.ndarray):
        self.c += qual_base_counts

    def calc_init_params(self):
        s = (1.0 + self.c).sum(axis=1, keepdims=True)
        self.p = (1.0 + self.c) / s
        self._calc_logp()

    def finish_from_counts(self, counts: np.ndarray):
        tot = counts + self.c
        s = tot.sum(axis=1, keepdims=True)
        with np.errstate(invalid="ignore", divide="ignore"):
            self.p = np.where(s <= 0.0, 0.0, tot / np.where(s == 0, 1.0, s))
        self._calc_logp()

    def _calc_logp(self):
        mask = self.c > 0.0
        with np.errstate(divide="ignore"):
            logs = np.where(self.p > 0, np.log(np.where(self.p > 0, self.p, 1.0)), 0.0)
        self.logp = float((self.c[mask] * logs[mask]).sum())

    def get_prob(self, read_codes, qual_codes) -> float:
        return float(
            np.prod(self.p[np.asarray(qual_codes), np.asarray(read_codes)])
        )

    def write(self, fo):
        fo.write(f"{QSIZE} {NCODES}\n")
        for i in range(QSIZE):
            fo.write(" ".join(f"{x:.10g}" for x in self.p[i]) + "\n")

    @classmethod
    def from_tokens(cls, tok) -> "NoiseQProfile":
        size, ncodes = int(next(tok)), int(next(tok))
        assert size == QSIZE and ncodes == NCODES
        out = cls()
        out.p = np.array(
            [float(next(tok)) for _ in range(QSIZE * NCODES)]
        ).reshape(QSIZE, NCODES)
        return out
