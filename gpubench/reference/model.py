"""RSEM's read model for paired-end reads with qualities, in plain numpy
float64, written from RSEM's C++: PairedEndQModel.h and the parts it holds
(Orientation.h, LenDist.h, RSPD.h, QProfile.h, NoiseQProfile.h), calcMW,
and the expected effective lengths of WriteResults.h.

Every length distribution is an array indexed by the length itself (entry
0 and lengths outside the support hold 0), and the read-start distribution
an array of its B bins with one zero bin after them, so that no window or
trim has to be carried along: a trimmed tail of RSEM's holds masses under
1e-300 and changes no sum here. The model's queries per hit (the adjusted
length and read-start probabilities) are in `em.py`.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

import numpy as np

# utils.h
EPSILON = 1e-300
MINEEL = 1.0
NCODES = 5  # A C G T N
QSIZE = 100  # quality scores 0..99 (QProfile.h, NoiseQProfile.h)
PROB_N = 1e-5  # QProfile.h: P(read base N)


@dataclass
class ReadModel:
    """The tables of one model. Lengths index `gld` and `mld` directly."""

    ori: np.ndarray  # [2] P(forward), P(reverse)
    gld: np.ndarray  # [maxL+1] fragment lengths
    mld: np.ndarray  # [maxL+1] mate lengths
    rspd: np.ndarray  # [B+1] bin masses, the last bin 0 (RSPD.h pdf[B+1])
    qpro: np.ndarray  # [QSIZE, 5, 5] P(read base | quality, reference base)
    nqpro: np.ndarray  # [QSIZE, 5] P(read base | quality) of a noise read
    noise_c: np.ndarray  # [QSIZE, 5] base counts of unaligned reads
    mw: np.ndarray  # [M+1] masking weights

    @property
    def bins(self) -> int:
        return len(self.rspd) - 1


def _rows(x: np.ndarray) -> np.ndarray:
    """Each row over the last axis divided by its sum; a row summing under
    EPSILON becomes 0 (QProfile::finish, NoiseQProfile::finish)."""
    s = x.sum(axis=-1, keepdims=True)
    return np.where(s < EPSILON, 0.0, x / np.where(s < EPSILON, 1.0, s))


def phred_profile() -> np.ndarray:
    """QProfile's starting values: a base of quality q is wrong with
    probability 10^(-q/10), spread over the three other bases; a read N has
    probability 1e-5; a reference N gives any base alike."""
    q = np.arange(QSIZE, dtype=np.float64)
    wrong = 10.0 ** (-q / 10.0)
    p = np.empty((QSIZE, NCODES, NCODES))
    p[:, :4, :4] = (wrong / 3.0 * (1.0 - PROB_N))[:, None, None]
    for b in range(4):
        p[:, b, b] = (1.0 - wrong) * (1.0 - PROB_N)
    p[:, :4, 4] = PROB_N
    p[:, 4, :4] = (1.0 - PROB_N) / 4.0
    p[:, 4, 4] = PROB_N
    return p


def first_estimate(stats: Dict, tlen: np.ndarray, min_frag: int,
                   max_frag: int, bins: int, prob_forward: float
                   ) -> ReadModel:
    """PairedEndQModel::estimateFromReads: the mate lengths of every read,
    the noise reads' base counts (calcInitParams adds one to each count),
    every other table at its starting value (fragment lengths uniform over
    min_frag..max_frag, read starts uniform over the bins)."""
    mld = np.zeros(max_frag + 1)
    for s in stats.values():
        counts = np.asarray(s["len_counts"], dtype=np.float64)
        n = min(len(counts), max_frag + 1)
        mld[:n] += counts[:n]
    mld /= mld.sum()
    gld = np.zeros(max_frag + 1)
    gld[min_frag:] = 1.0 / (max_frag - min_frag + 1)
    rspd = np.zeros(bins + 1)
    rspd[:bins] = 1.0 / bins
    c = np.asarray(stats[0]["noise"], dtype=np.float64).copy()
    return ReadModel(ori=np.array([prob_forward, 1.0 - prob_forward]),
                     gld=gld, mld=mld, rspd=rspd, qpro=phred_profile(),
                     nqpro=_rows(1.0 + c), noise_c=c,
                     mw=masking_weights(tlen))


def refit(model: ReadModel, suff: Dict[str, np.ndarray], tlen: np.ndarray
          ) -> ReadModel:
    """PairedEndQModel::finish after a round's updates: the fragment-length
    histogram, the read-start bins (where `suff` has them: with
    --estimate-rspd) and the quality profile normalised, the
    noise profile from its counts plus the unaligned reads' counts, and the
    masking weights again. Orientation and mate lengths stay."""
    gld = np.asarray(suff["gld"], dtype=np.float64)
    if gld.sum() <= EPSILON:
        raise ValueError("no fragment to estimate the length distribution")
    rspd = model.rspd  # uniform unless estimated (RSPD.h)
    if "rspd" in suff:
        rspd = np.zeros(model.bins + 1)
        rspd[:model.bins] = suff["rspd"] / suff["rspd"].sum()
    return ReadModel(ori=model.ori, gld=gld / gld.sum(), mld=model.mld,
                     rspd=rspd, qpro=_rows(np.asarray(suff["pro"])),
                     nqpro=_rows(np.asarray(suff["npro"]) + model.noise_c),
                     noise_c=model.noise_c, mw=masking_weights(tlen))


def masking_weights(tlen: np.ndarray) -> np.ndarray:
    """calcMW (PairedEndQModel): 1 minus the probability that a fragment
    starts at a masked seed position, per transcript, and 1 for noise. A
    reference prepared without poly(A) tails (the configuration's
    `no_polya`) masks no position, so every weight is 1."""
    return np.ones(len(tlen) + 1)


def effective_lengths(gld: np.ndarray, tlen: np.ndarray,
                      chunk: int = 4096) -> np.ndarray:
    """WriteResults.h calcExpectedEffectiveLengths, summed as written out:
    over fragment lengths f, P(f) times the start positions a fragment of
    length f has on the transcript, min(length, length - f + 1) or none;
    under MINEEL it is 0. [M+1], entry 0 (noise) 0."""
    tlen = np.asarray(tlen, dtype=np.int64)
    f = np.arange(len(gld))
    out = np.zeros(len(tlen) + 1)
    for a in range(0, len(tlen), chunk):
        L = tlen[a:a + chunk, None]
        starts = np.clip(np.minimum(L, L - f[None, :] + 1), 0, None)
        out[1 + a:1 + a + len(L)] = starts @ gld
    out[out < MINEEL] = 0.0
    return out
