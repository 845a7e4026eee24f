"""Transcript genomic-coordinate table and mappability lookups.

Mirrors the coordinate bookkeeping of pRSEM/Transcript.py (TSS/TES/body
windows, Transcript.py:106-145) and Prsem.py's all_tr_crd table
(Prsem.py:62-95), derived here directly from the in-memory `.ti` reference
instead of a GTF re-parse.
"""

from __future__ import annotations

import gzip
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np


@dataclass
class TrCoord:
    gene_id: str
    trid: str
    chrom: str
    strand: str
    start: int  # 1-based inclusive genomic span
    end: int
    exons: List[Tuple[int, int]]
    tss: int = 0
    tes: int = 0
    tss_mpp: float = np.nan
    body_mpp: float = np.nan
    tes_mpp: float = np.nan

    def __post_init__(self):
        if self.strand == "+":
            self.tss, self.tes = self.start, self.end
        else:
            self.tss, self.tes = self.end, self.start


def build_coords(ts) -> List[TrCoord]:
    """ts: refprep.Transcripts loaded from a genome-based `.ti` (type 0)."""
    if ts.type != 0:
        raise ValueError(
            "pRSEM requires a reference built from a genome with a GTF "
            "(transcript genomic coordinates are needed)."
        )
    out = []
    for tr in ts.transcripts:
        out.append(
            TrCoord(
                gene_id=tr.gene_id,
                trid=tr.transcript_id,
                chrom=tr.seqname,
                strand=tr.strand,
                start=tr.structure[0][0],
                end=tr.structure[-1][1],
                exons=list(tr.structure),
            )
        )
    return out


class Mappability:
    """Mean mappability over genomic windows, from a bedGraph track.

    The reference shells out to UCSC bigWigSummary over a bigWig file
    (pRSEM/Util.py calculateMappability); this accepts the equivalent
    bedGraph text (chrom start end value, 0-based half-open, optionally
    gzipped). `None` path => uniform mappability 1.0.
    """

    def __init__(self, path: Optional[str] = None):
        self.tracks: Dict[str, Tuple[np.ndarray, np.ndarray, np.ndarray]] = {}
        if path is None:
            return
        by_chrom: Dict[str, List[Tuple[int, int, float]]] = {}
        op = gzip.open if path.endswith(".gz") else open
        with op(path, "rt") as f:
            for line in f:
                if not line.strip() or line.startswith(("track", "#")):
                    continue
                chrom, s, e, v = line.split()[:4]
                by_chrom.setdefault(chrom, []).append(
                    (int(s), int(e), float(v))
                )
        for chrom, ivs in by_chrom.items():
            ivs.sort()
            arr = np.asarray(ivs, dtype=np.float64)
            self.tracks[chrom] = (
                arr[:, 0].astype(np.int64),
                arr[:, 1].astype(np.int64),
                arr[:, 2],
            )

    def mean(self, chrom: str, start: int, end: int) -> float:
        """Mean value over [start, end] (1-based inclusive); bases not
        covered by the track count as 0, matching bigWigSummary mean over
        the full window."""
        if end < start:
            start, end = end, start
        width = end - start + 1
        if not self.tracks:
            return 1.0
        tr = self.tracks.get(chrom)
        if tr is None:
            return 0.0
        starts, ends, vals = tr
        s0, e0 = start - 1, end  # to 0-based half-open
        lo = int(np.searchsorted(ends, s0, side="right"))
        hi = int(np.searchsorted(starts, e0, side="left"))
        if hi <= lo:
            return 0.0
        ov = np.minimum(ends[lo:hi], e0) - np.maximum(starts[lo:hi], s0)
        ov = np.maximum(ov, 0)
        return float((ov * vals[lo:hi]).sum() / width)


def fill_mappability(coords: List[TrCoord], mpp: Mappability,
                     flanking_width: int = 500) -> None:
    """TSS region [tss-w, tss+w]; body [start+w+1, end-w-1] (swapped if
    degenerate); TES region [tes-w, tes+w] (pRSEM/Transcript.py:106-145)."""
    w = flanking_width
    for c in coords:
        c.tss_mpp = mpp.mean(c.chrom, c.tss - w, c.tss + w)
        b1, b2 = c.start + w + 1, c.end - w - 1
        if b1 >= b2:
            b1, b2 = b2, b1
        c.body_mpp = mpp.mean(c.chrom, b1, b2)
        c.tes_mpp = mpp.mean(c.chrom, c.tes - w, c.tes + w)
