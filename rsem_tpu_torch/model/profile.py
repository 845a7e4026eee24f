"""Sequencing-error profiles.

Profile: p[pos][refBase][readBase] (reference: Profile.h); QProfile:
p[qual][refBase][readBase] (reference: QProfile.h). Estimation scatter-adds
run on device; init/finish/serialization here in float64.
"""

from __future__ import annotations

import numpy as np

from ..constants import EPSILON, NCODES, QSIZE


def _profile_init(pro_len: int) -> np.ndarray:
    """0.99 of non-N mass to the correct base (reference: Profile.h:47-72)."""
    p = np.zeros((pro_len, NCODES, NCODES))
    N = NCODES - 1
    probN, portionC = 1e-5, 0.99
    probC = portionC * (1.0 - probN)
    probO = (1.0 - portionC) / (NCODES - 2) * (1.0 - probN)
    for j in range(N):
        p[:, j, :N] = probO
        p[:, j, j] = probC
        p[:, j, N] = probN
    p[:, N, :N] = (1.0 - probN) / (NCODES - 1)
    p[:, N, N] = probN
    return p


def _qprofile_init() -> np.ndarray:
    """Phred-derived error rates (reference: QProfile.h:45-76)."""
    p = np.zeros((QSIZE, NCODES, NCODES))
    N = NCODES - 1
    probN = 1e-5
    for q in range(QSIZE):
        probO = np.exp(-q / 10.0 * np.log(10.0))
        probC = (1.0 - probO) * (1.0 - probN)
        probO = probO / (NCODES - 2) * (1.0 - probN)
        for j in range(N):
            p[q, j, :N] = probO
            p[q, j, j] = probC
            p[q, j, N] = probN
        p[q, N, :N] = (1.0 - probN) / (NCODES - 1)
        p[q, N, N] = probN
    return p


def profile_finish(counts: np.ndarray) -> np.ndarray:
    """Normalize each [.., refBase, :] row; rows with sum < EPSILON go all
    zero (reference: Profile.h finish)."""
    s = counts.sum(axis=-1, keepdims=True)
    with np.errstate(invalid="ignore", divide="ignore"):
        p = np.where(s < EPSILON, 0.0, counts / np.where(s == 0, 1.0, s))
    return p


class _BaseProfile:
    def __init__(self, p: np.ndarray):
        self.p = p

    def get_prob(self, read_codes, key_codes, ref_codes) -> float:
        """Product over positions; key is position index (Profile) or quality
        score (QProfile)."""
        return float(
            np.prod(self.p[np.asarray(key_codes), np.asarray(ref_codes),
                           np.asarray(read_codes)])
        )

    def finish_from_counts(self, counts: np.ndarray):
        self.p = profile_finish(counts)

    def write(self, fo):
        dims = self.p.shape
        fo.write(f"{dims[0]} {dims[1]}\n")
        for i in range(dims[0]):
            for j in range(dims[1]):
                fo.write(" ".join(f"{x:.10g}" for x in self.p[i, j]) + "\n")
            if i < dims[0] - 1:
                fo.write("\n")


class Profile(_BaseProfile):
    def __init__(self, maxL: int = 1000):
        super().__init__(_profile_init(maxL))

    @property
    def pro_len(self) -> int:
        return self.p.shape[0]

    @classmethod
    def from_tokens(cls, tok) -> "Profile":
        pro_len, ncodes = int(next(tok)), int(next(tok))
        assert ncodes == NCODES
        out = cls.__new__(cls)
        out.p = np.array(
            [float(next(tok)) for _ in range(pro_len * NCODES * NCODES)]
        ).reshape(pro_len, NCODES, NCODES)
        return out


class QProfile(_BaseProfile):
    def __init__(self):
        super().__init__(_qprofile_init())

    @classmethod
    def from_tokens(cls, tok) -> "QProfile":
        size, ncodes = int(next(tok)), int(next(tok))
        assert size == QSIZE and ncodes == NCODES
        out = cls.__new__(cls)
        out.p = np.array(
            [float(next(tok)) for _ in range(QSIZE * NCODES * NCODES)]
        ).reshape(QSIZE, NCODES, NCODES)
        return out
