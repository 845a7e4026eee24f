"""TSS-peak features (process-rnaseq.R prepTSSPeakFeatures:480-547).

Each transcript gets tss_pk = 1 when any ChIP-seq peak overlaps its
[tss - w, tss + w] window (strand-blind interval overlap, R's
getRegionPeakOLTrID)."""

from __future__ import annotations

import gzip
from typing import Dict, List, Tuple

import numpy as np

from .coords import TrCoord


def read_peaks(path: str) -> Dict[str, np.ndarray]:
    """Read a BED/narrowPeak(.gz) file; returns {chrom: [n,2] array of
    1-based inclusive intervals} merged and sorted. BED inputs are 0-based
    half-open, so [s, e) becomes [s+1, e]."""
    by_chrom: Dict[str, List[Tuple[int, int]]] = {}
    op = gzip.open if path.endswith(".gz") else open
    with op(path, "rt") as f:
        for line in f:
            if not line.strip() or line.startswith(("track", "browser", "#")):
                continue
            fields = line.split()
            chrom, s, e = fields[0], int(fields[1]), int(fields[2])
            by_chrom.setdefault(chrom, []).append((s + 1, e))
    out = {}
    for chrom, ivs in by_chrom.items():
        ivs.sort()
        merged = []
        for s, e in ivs:
            if merged and s <= merged[-1][1] + 1:
                merged[-1] = (merged[-1][0], max(merged[-1][1], e))
            else:
                merged.append((s, e))
        out[chrom] = np.asarray(merged, dtype=np.int64).reshape(-1, 2)
    return out


def tss_peak_flags(coords: List[TrCoord], peaks: Dict[str, np.ndarray],
                   flanking_width: int = 500) -> np.ndarray:
    """[len(coords)] int array: 1 if a peak overlaps the TSS window."""
    flags = np.zeros(len(coords), dtype=np.int64)
    for i, c in enumerate(coords):
        pk = peaks.get(c.chrom)
        if pk is None or not len(pk):
            continue
        lo, hi = c.tss - flanking_width, c.tss + flanking_width
        # first merged peak with end >= lo; overlap iff its start <= hi
        k = int(np.searchsorted(pk[:, 1], lo, side="left"))
        if k < len(pk) and pk[k, 0] <= hi:
            flags[i] = 1
    return flags
