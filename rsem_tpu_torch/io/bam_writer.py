"""Posterior-weighted transcript BAM writeback.

Streams the input SAM/BAM a second time and attaches each mapped record (or
mate pair) to the next hit in file order — the same implicit protocol the
reference uses (BamWriter.h:83-105 with HitWrapper.h:18-27): alignable reads'
hits were collected in input order, and filtered/unalignable reads appear as
unmapped records, so mapped records correspond 1:1 with hits.

`--sampling-for-bam` mirrors EM.cpp:507-527: per read, draw one category from
(noise, hit_1..hit_k) by posterior mass; the chosen hit gets weight 1.0 and
the rest 0.0 (noise chosen -> all zeros). All-zero posteriors stay zero.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from .bamio import (
    BamRecWriter,
    PROGRAM_NAME,
    open_rec_reader,
    prb_to_mapq,
)
from .hits import HitArrays


def sample_hit_weights(
    hits: HitArrays,
    frac_hit: np.ndarray,
    frac_noise: np.ndarray,
    seed: Optional[int],
) -> np.ndarray:
    """Vectorized posterior sampling (EM.cpp:507-527). Returns new per-hit
    weights in {0.0, 1.0}."""
    rng = np.random.RandomState(seed if seed is not None else None)
    frac_hit = np.asarray(frac_hit, dtype=np.float64)
    frac_noise = np.asarray(frac_noise, dtype=np.float64)
    starts = hits.read_offsets[:-1].astype(np.int64)
    ends = hits.read_offsets[1:].astype(np.int64)
    n_reads = hits.n_reads
    u = rng.random_sample(n_reads)

    # global cumsum restarted per read; within read r the hit h has
    # cumulative mass cum[h] - base[r]
    cum = np.cumsum(frac_hit)
    base = np.concatenate([[0.0], cum])[starts]
    seg_total = np.concatenate([[0.0], cum])[ends] - base
    total = frac_noise + seg_total

    EPSILON = 1e-300  # utils.h:19, EM.cpp:521
    t = u * total - frac_noise  # mass beyond the noise slot
    live = (total >= EPSILON) & (t >= 0)
    weights = np.zeros_like(frac_hit)
    if live.any():
        ridx = np.nonzero(live)[0]
        # first hit whose within-read cumulative mass exceeds t
        chosen = np.searchsorted(cum, base[ridx] + t[ridx], side="right")
        chosen = np.minimum(chosen, ends[ridx] - 1)
        weights[chosen] = 1.0
    return weights


def write_transcript_bam(
    input_path: str,
    output_path: str,
    hits: HitArrays,
    frac_hit: np.ndarray,
    frac_noise: Optional[np.ndarray] = None,
    paired: bool = False,
    sampling: bool = False,
    seed: Optional[int] = None,
    command: Optional[str] = None,
) -> int:
    """Re-stream `input_path`, patch MAPQ + ZW on mapped records, write BAM.

    Returns the number of records written.
    """
    weights = np.asarray(frac_hit, dtype=np.float64)
    if sampling:
        if frac_noise is None:
            raise ValueError("sampling-for-bam needs the noise posterior")
        weights = sample_hit_weights(hits, weights, frac_noise, seed)

    reader = open_rec_reader(input_path)
    header = reader.header
    header.insert_pg(PROGRAM_NAME, command)
    cursor = 0
    n_hits = len(weights)
    written = 0
    with BamRecWriter(output_path, header) as out:
        if paired:
            it = iter(reader)
            for rec in it:
                rec2 = next(it)
                if rec.is_mapped and rec2.is_mapped:
                    if cursor >= n_hits:
                        raise ValueError(
                            "More mapped pairs in input than hits from parsing"
                        )
                    w = float(weights[cursor])
                    cursor += 1
                    mapq = prb_to_mapq(w)
                    for r in (rec, rec2):
                        r.mapq = mapq
                        r.set_float_tag("ZW", w)
                out.write(rec)
                out.write(rec2)
                written += 2
        else:
            for rec in reader:
                if rec.is_mapped:
                    if cursor >= n_hits:
                        raise ValueError(
                            "More mapped records in input than hits from parsing"
                        )
                    w = float(weights[cursor])
                    cursor += 1
                    rec.mapq = prb_to_mapq(w)
                    rec.set_float_tag("ZW", w)
                out.write(rec)
                written += 1
    reader.close()
    if cursor != n_hits:
        raise ValueError(
            f"Input/hit mismatch: consumed {cursor} hits, expected {n_hits}"
        )
    return written
