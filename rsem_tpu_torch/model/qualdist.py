"""First-order Markov chain over quality scores (reference: QualDist.h).

Estimated once from all reads; used only by the simulator and the .model file.
"""

from __future__ import annotations

import numpy as np

from ..constants import QSIZE


class QualDist:
    def __init__(self):
        self.p_init = np.zeros(QSIZE)
        self.p_tran = np.zeros((QSIZE, QSIZE))

    def update_counts(self, init_counts: np.ndarray, tran_counts: np.ndarray):
        self.p_init += init_counts
        self.p_tran += tran_counts

    def finish(self):
        s = self.p_init.sum()
        if s > 0:
            self.p_init /= s
        row = self.p_tran.sum(axis=1, keepdims=True)
        nz = row[:, 0] > 0.0
        self.p_tran[nz] /= row[nz]

    def get_prob(self, qual_codes) -> float:
        q = np.asarray(qual_codes)
        prob = self.p_init[q[0]]
        if len(q) > 1:
            prob *= np.prod(self.p_tran[q[:-1], q[1:]])
        return float(prob)

    def write(self, fo):
        fo.write(f"{QSIZE}\n")
        fo.write(" ".join(f"{x:.10g}" for x in self.p_init) + "\n")
        for i in range(QSIZE):
            fo.write(" ".join(f"{x:.10g}" for x in self.p_tran[i]) + "\n")

    @classmethod
    def from_tokens(cls, tok) -> "QualDist":
        size = int(next(tok))
        assert size == QSIZE
        out = cls()
        out.p_init = np.array([float(next(tok)) for _ in range(QSIZE)])
        out.p_tran = np.array(
            [float(next(tok)) for _ in range(QSIZE * QSIZE)]
        ).reshape(QSIZE, QSIZE)
        return out
