"""Read storage as padded device-ready arrays + streaming statistics.

Only alignable (N1) reads are kept in full; unalignable (N0) and filtered (N2)
reads are reduced to the sufficient statistics the model estimation needs
(length histogram, quality-transition counts, noise base counts) — the
reference re-streams category FASTQ files instead (ReadReader.h,
SingleModel.h estimateFromReads).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Tuple

import numpy as np

from ..constants import NCODES, OLEN, QSIZE
from ..utils.seq import to_bytes

_A, _T = 0, 3


def calc_low_quality(
    codes: np.ndarray, lens: np.ndarray, has_polya: bool, seed_len: int
) -> np.ndarray:
    """Vectorized poly(A)-artifact filter (reference: SingleReadQ.h:63-95).

    codes: [N, L] padded base codes (pad value irrelevant; masked by lens).
    """
    lens = np.asarray(lens)
    lq = lens < seed_len
    if not has_polya:
        return lq
    N, L = codes.shape
    j = np.arange(L)[None, :]
    valid = j < lens[:, None]
    is_a = (codes == _A) & valid
    is_t = (codes == _T) & valid
    numA = is_a.sum(axis=1)
    numT = is_t.sum(axis=1)
    numAO = (is_a & (j < OLEN)).sum(axis=1)
    numTO = (is_t & (j >= (lens[:, None] - OLEN))).sum(axis=1)
    t1 = (0.9 * lens - 1.5 * np.sqrt(lens.astype(np.float64)) + 0.5).astype(
        np.int64
    )
    t2 = (OLEN - 1) // 2 + 1
    a_artifact = (numA >= t1) & (numAO >= t2)
    t_artifact = (numA < t1) & (numT >= t1) & (numTO >= t2)
    return lq | a_artifact | t_artifact


@dataclass
class ReadArrays:
    """Single-end reads: codes [N, L] uint8, lens [N], quals [N, L] uint8
    (Phred codes 0..93; zeros when has_qual is False), lq [N] bool.

    Immutable once built: the layout's device cache (ops/layout.py) keeps
    the device copy of these arrays for as long as the object lives and
    rebuilds it only when an attribute is replaced or a sampled element
    changes; an in-place edit of an unsampled element is not detected."""

    codes: np.ndarray
    lens: np.ndarray
    quals: Optional[np.ndarray]
    lq: np.ndarray

    @property
    def n(self) -> int:
        return len(self.lens)

    @property
    def max_len(self) -> int:
        return self.codes.shape[1]

    @property
    def has_qual(self) -> bool:
        return self.quals is not None

    @classmethod
    def build(
        cls,
        seq_list: Sequence[np.ndarray],
        qual_list: Optional[Sequence[np.ndarray]],
        has_polya: bool,
        seed_len: int,
        pad_to: Optional[int] = None,
    ) -> "ReadArrays":
        n = len(seq_list)
        lens = np.array([len(s) for s in seq_list], dtype=np.int32)
        L = int(pad_to or (lens.max() if n else 1))
        codes = np.zeros((n, L), dtype=np.uint8)
        for i, s in enumerate(seq_list):
            codes[i, : len(s)] = s
        quals = None
        if qual_list is not None:
            quals = np.zeros((n, L), dtype=np.uint8)
            for i, q in enumerate(qual_list):
                quals[i, : len(q)] = q
        lq = calc_low_quality(codes, lens, has_polya, seed_len)
        return cls(codes, lens, quals, lq)


@dataclass
class PairedReadArrays:
    """Paired-end reads; lq combines mates (reference: PairedEndReadQ.h:60-66)."""

    mate1: ReadArrays
    mate2: ReadArrays
    lq: np.ndarray

    @classmethod
    def build(cls, m1: ReadArrays, m2: ReadArrays, seed_len: int) -> "PairedReadArrays":
        lq = (m1.lq & m2.lq) | (m1.lens < seed_len) | (m2.lens < seed_len)
        return cls(m1, m2, lq)

    @property
    def n(self) -> int:
        return self.mate1.n

    @property
    def has_qual(self) -> bool:
        return self.mate1.has_qual


class ReadStats:
    """Streaming sufficient statistics over one read category
    (reference: estimateFromReads, e.g. PairedEndQModel.h:241-289).

    Low-quality reads are excluded from all statistics. Noise base counts are
    only accumulated when the category is N0 (`collect_noise=True`).
    """

    def __init__(self, max_len: int = 1024):
        self.len_counts = np.zeros(max_len + 1)  # index = read length
        self.q_init = np.zeros(QSIZE)
        self.q_tran = np.zeros((QSIZE, QSIZE))
        self.noise = np.zeros((QSIZE, NCODES))  # summed over quals for no-qual
        self.n_reads = 0

    def _grow(self, need: int):
        if need >= len(self.len_counts):
            new = np.zeros(max(need + 1, 2 * len(self.len_counts)))
            new[: len(self.len_counts)] = self.len_counts
            self.len_counts = new

    def add_reads(
        self,
        codes: np.ndarray,
        lens: np.ndarray,
        quals: Optional[np.ndarray],
        lq: np.ndarray,
        collect_noise: bool,
    ):
        """Add a batch of (possibly padded) reads. For paired data call once
        per mate with the pair-level lq flags."""
        keep = ~np.asarray(lq)
        lens = np.asarray(lens)[keep]
        if lens.size == 0:
            return
        codes = np.asarray(codes)[keep]
        self.n_reads += len(lens)
        self._grow(int(lens.max()))
        self.len_counts[: lens.max() + 1] += np.bincount(
            lens, minlength=int(lens.max()) + 1
        )

        j = np.arange(codes.shape[1])[None, :]
        valid = j < lens[:, None]
        if quals is not None:
            quals = np.asarray(quals)[keep]
            self.q_init += np.bincount(quals[:, 0], minlength=QSIZE)
            vmask = valid[:, 1:].ravel()
            pair = (
                quals[:, :-1].ravel().astype(np.int64) * QSIZE
                + quals[:, 1:].ravel()
            )
            self.q_tran += np.bincount(
                pair, weights=vmask, minlength=QSIZE * QSIZE
            ).reshape(QSIZE, QSIZE)
            if collect_noise:
                key = (
                    quals.ravel().astype(np.int64) * NCODES + codes.ravel()
                )
                self.noise += np.bincount(
                    key, weights=valid.ravel(), minlength=QSIZE * NCODES
                ).reshape(QSIZE, NCODES)
        elif collect_noise:
            self.noise[0] += np.bincount(
                codes[valid], minlength=NCODES
            )[:NCODES]

    def merge(self, other: "ReadStats"):
        self._grow(len(other.len_counts) - 1)
        self.len_counts[: len(other.len_counts)] += other.len_counts
        self.q_init += other.q_init
        self.q_tran += other.q_tran
        self.noise += other.noise
        self.n_reads += other.n_reads
