"""ChIP-seq input leg for pRSEM (pRSEM/ChIPSeqExperiment.py,
ChIPSeqReplicate.py, prsem-calculate-expression:15-55).

The reference aligns ChIP-seq FASTQ with bowtie, converts alignments to
tagAlign, calls peaks with SPP (phantompeakqualtools run_spp.R) and keeps
reproducible peaks via IDR. This module is a native equivalent:

  * FASTQ -> alignment via the existing bowtie wrapper (aligners.py), kept
    external exactly like the reference (bowtie is not re-implemented);
  * SAM/BAM -> tagAlign with the reference's uniquely-mapped filter
    (filterSam2Bed.c: MAPQ > 0, unmapped/secondary dropped);
  * fragment length by strand cross-correlation of 5' read-start tracks —
    the statistic at the core of SPP/phantompeakqualtools;
  * peak calling by fraglen-extended binned coverage with a Poisson test
    against the scaled control (or genome background), BH-style threshold,
    adjacent significant bins merged — a documented SPP-equivalent
    contract (same inputs, same narrowPeak-style output);
  * reproducibility: pooled peaks kept only when overlapped by a peak in
    every replicate — the role IDR plays in the reference pipeline
    (idrCode/batch-consistency-analysis.r), as a deterministic overlap
    contract.

All outputs (pooled ``.tagAlign.gz``, ``idr_target_vs_control.regionPeak.gz``)
use the reference's file naming so downstream feature code is shared.
"""

from __future__ import annotations

import gzip
import os
import shlex
import subprocess
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .partition import read_tagalign

DEFAULT_BIN = 50
DEFAULT_PVAL = 1e-5
MIN_FRAGLEN, MAX_FRAGLEN = 50, 500


# --------------------------------------------------------------------- #
# alignment -> tagAlign                                                  #
# --------------------------------------------------------------------- #
def sam_to_tagalign(sam_path: str, out_path: str) -> int:
    """Write uniquely-mapped alignments as gzipped tagAlign (BED6)
    (pRSEM/filterSam2Bed.c: drop unmapped/secondary; uniqueness is
    enforced upstream by bowtie -m 1). Returns the reads written."""
    from ..io.sam import open_alignment_file

    reader = open_alignment_file(sam_path)
    names = reader.target_names
    n = 0
    with gzip.open(out_path, "wt") as out:
        for rec in reader:
            if not rec.is_mapped or (rec.flag & 0x100):
                continue
            span = sum(ln for ln, op in rec.cigar if op in "MDN=X")
            chrom = names[rec.tid]
            strand = "-" if rec.is_rev else "+"
            out.write(
                f"{chrom}\t{rec.pos}\t{rec.pos + span}\tN\t1000\t{strand}\n"
            )
            n += 1
    return n


def align_chipseq_fastq(
    fastqs: Sequence[str],
    bowtie_index: str,
    out_tagalign: str,
    bowtie_path: str = "",
    n_threads: int = 1,
    quiet: bool = True,
) -> int:
    """Align ChIP-seq FASTQ files with bowtie (prsem-calculate-expression's
    alignReadByBowtie: -q -v 2 -m 1 --best --strata), then convert to
    tagAlign. Requires bowtie on PATH (or bowtie_path)."""
    binary = os.path.join(bowtie_path, "bowtie") if bowtie_path else "bowtie"
    sam_path = out_tagalign.replace(".tagAlign.gz", "") + ".chipseq.sam"
    cmd = (
        f"{shlex.quote(binary)} -q -v 2 -m 1 --best --strata -p {n_threads} "
        f"-S {shlex.quote(bowtie_index)} "
        f"{shlex.quote(','.join(fastqs))} {shlex.quote(sam_path)}"
    )
    subprocess.run(cmd, shell=True, check=True,
                   capture_output=quiet)
    try:
        return sam_to_tagalign(sam_path, out_tagalign)
    finally:
        if os.path.exists(sam_path):
            os.remove(sam_path)


def pool_tagaligns(paths: Sequence[str], out_path: str) -> None:
    """Concatenate replicate tagAligns into the pooled Rep0 file
    (ChIPSeqExperiment.poolTagAlign)."""
    with gzip.open(out_path, "wt") as out:
        for p in paths:
            op = gzip.open if p.endswith(".gz") else open
            with op(p, "rt") as f:
                for line in f:
                    out.write(line)


# --------------------------------------------------------------------- #
# fragment length: strand cross-correlation (SPP's statistic)            #
# --------------------------------------------------------------------- #
def estimate_fragment_length(reads, max_shift: int = MAX_FRAGLEN,
                             bin_size: int = 5) -> int:
    """Shift (bp) maximizing the correlation between +strand and -strand
    5'-end coverage, the SPP/phantompeakqualtools cross-correlation
    estimate. Falls back to the mean read length when signal is too thin."""
    best_shift, best_corr = 0, -np.inf
    num = np.zeros((max_shift - MIN_FRAGLEN) // bin_size + 1)
    shifts = np.arange(MIN_FRAGLEN, max_shift + 1, bin_size)
    total = 0
    for ch, (s0, e0, strand) in reads.items():
        if len(s0) < 100:
            continue
        pos5 = np.where(strand == 0, s0, e0 - 1)
        span_lo, span_hi = int(pos5.min()), int(pos5.max())
        nb = (span_hi - span_lo) // bin_size + 2
        if nb < 10 or nb > 50_000_000:
            continue
        fwd = np.bincount((pos5[strand == 0] - span_lo) // bin_size,
                          minlength=nb).astype(np.float64)
        rev = np.bincount((pos5[strand == 1] - span_lo) // bin_size,
                          minlength=nb).astype(np.float64)
        if fwd.sum() == 0 or rev.sum() == 0:
            continue
        fwd -= fwd.mean()
        rev -= rev.mean()
        # correlation at each shift via FFT cross-correlation
        n_fft = int(2 ** np.ceil(np.log2(2 * nb)))
        xc = np.fft.irfft(
            np.fft.rfft(fwd, n_fft).conj() * np.fft.rfft(rev, n_fft), n_fft
        )
        w = len(pos5)
        num += w * xc[shifts // bin_size]
        total += w
    if total == 0:
        lens = [int(np.mean(e0 - s0)) for _, (s0, e0, _) in reads.items()
                if len(s0)]
        return int(np.mean(lens)) if lens else 150
    k = int(np.argmax(num))
    return int(shifts[k])


# --------------------------------------------------------------------- #
# peak calling                                                           #
# --------------------------------------------------------------------- #
@dataclass
class PeakCall:
    peaks: Dict[str, np.ndarray]  # {chrom: [n,2] 1-based inclusive}
    fraglen: int
    n_target: int
    n_control: int


def _binned_frag_coverage(reads, fraglen: int, bin_size: int
                          ) -> Dict[str, np.ndarray]:
    """Fragment-extended coverage counted at fragment midpoints per bin."""
    cov = {}
    for ch, (s0, e0, strand) in reads.items():
        fs = np.where(strand == 0, s0, e0 - fraglen)
        mid = fs + fraglen // 2
        mid = np.maximum(mid, 0)
        nb = int(mid.max()) // bin_size + 2 if len(mid) else 1
        cov[ch] = np.bincount(mid // bin_size, minlength=nb).astype(
            np.float64)
    return cov


def call_peaks(
    target,
    control=None,
    fraglen: Optional[int] = None,
    bin_size: int = DEFAULT_BIN,
    pvalue: float = DEFAULT_PVAL,
) -> PeakCall:
    """Poisson enrichment peaks of target vs (scaled) control.

    For each bin the expected count is max(control-rate * scale,
    genome-average) and bins with Poisson sf(count-1, mu) < pvalue are
    significant; adjacent significant bins merge into one peak."""
    from scipy.stats import poisson

    if fraglen is None:
        fraglen = estimate_fragment_length(target)
    n_t = sum(len(v[0]) for v in target.values())
    n_c = sum(len(v[0]) for v in control.values()) if control else 0
    tcov = _binned_frag_coverage(target, fraglen, bin_size)
    ccov = _binned_frag_coverage(control, fraglen, bin_size) if control \
        else {}
    scale = (n_t / n_c) if n_c else 0.0

    peaks: Dict[str, np.ndarray] = {}
    for ch, tc in tcov.items():
        genome_mu = max(tc.sum() / max(len(tc), 1), 1e-3)
        cc = ccov.get(ch)
        if cc is not None:
            cc_al = np.zeros_like(tc)
            n = min(len(cc), len(tc))
            cc_al[:n] = cc[:n] * scale
            # local lambda: smoothed control (5-bin window) vs genome bg
            k = np.ones(5) / 5.0
            local = np.convolve(cc_al, k, mode="same")
            mu = np.maximum(local, genome_mu)
        else:
            mu = np.full_like(tc, genome_mu)
        sig = poisson.sf(tc - 1, mu) < pvalue
        if not sig.any():
            continue
        idx = np.flatnonzero(sig)
        breaks = np.flatnonzero(np.diff(idx) > 1)
        starts = np.concatenate([[idx[0]], idx[breaks + 1]])
        ends = np.concatenate([idx[breaks], [idx[-1]]])
        ivs = np.stack(
            [starts * bin_size + 1, (ends + 1) * bin_size], axis=1
        ).astype(np.int64)
        peaks[ch] = ivs
    return PeakCall(peaks=peaks, fraglen=fraglen, n_target=n_t,
                    n_control=n_c)


def reproducible_peaks(
    pooled: Dict[str, np.ndarray],
    replicate_peaks: Sequence[Dict[str, np.ndarray]],
) -> Dict[str, np.ndarray]:
    """Pooled peaks overlapped by a peak in EVERY replicate call — the
    reproducibility filter IDR provides in the reference pipeline."""
    if not replicate_peaks:
        return pooled
    out: Dict[str, np.ndarray] = {}
    for ch, ivs in pooled.items():
        keep = np.ones(len(ivs), dtype=bool)
        for rp in replicate_peaks:
            r = rp.get(ch)
            if r is None or not len(r):
                keep[:] = False
                break
            # overlap test against merged replicate peaks
            k = np.searchsorted(r[:, 1], ivs[:, 0], side="left")
            ok = (k < len(r)) & (r[np.minimum(k, len(r) - 1), 0] <= ivs[:, 1])
            keep &= ok
        if keep.any():
            out[ch] = ivs[keep]
    return out


def write_peaks(peaks: Dict[str, np.ndarray], path: str) -> None:
    """narrowPeak-style 10-column BED (.gz), 0-based half-open, as the
    feature code expects of idr_target_vs_control.regionPeak.gz."""
    with gzip.open(path, "wt") as f:
        for ch in sorted(peaks):
            for s1, e1 in peaks[ch]:
                f.write(f"{ch}\t{s1 - 1}\t{e1}\t.\t0\t.\t0\t-1\t-1\t-1\n")


# --------------------------------------------------------------------- #
# experiment orchestration                                               #
# --------------------------------------------------------------------- #
@dataclass
class ChipSeqConfig:
    target_read_files: List[str] = field(default_factory=list)  # FASTQ reps
    control_read_files: List[str] = field(default_factory=list)
    target_tagalign_files: List[str] = field(default_factory=list)  # or BED
    control_tagalign_files: List[str] = field(default_factory=list)
    bowtie_index: str = ""
    bowtie_path: str = ""
    n_threads: int = 1
    bin_size: int = DEFAULT_BIN
    pvalue: float = DEFAULT_PVAL


@dataclass
class ChipSeqResult:
    peak_file: str  # idr_target_vs_control.regionPeak.gz
    target_signals: str  # pooled target tagAlign.gz
    fraglen: int


def run_chipseq_experiment(cfg: ChipSeqConfig, temp_dir: str,
                           log=print) -> ChipSeqResult:
    """FASTQ/tagAlign replicates -> pooled tagAlign + reproducible peaks
    (the ChIPSeqExperiment.getFastqEncoding/alignRead/poolTagAlign/
    callPeaksBySPP/runIDR sequence, natively)."""
    os.makedirs(temp_dir, exist_ok=True)

    def materialize(read_files, tag_files, label):
        tags = list(tag_files)
        for i, fq in enumerate(read_files):
            out = os.path.join(temp_dir, f"{label}Rep{i + 1}.tagAlign.gz")
            n = align_chipseq_fastq(
                fq.split(","), cfg.bowtie_index, out,
                bowtie_path=cfg.bowtie_path, n_threads=cfg.n_threads,
            )
            log(f"pRSEM ChIP-seq: aligned {label} rep {i + 1}: {n} reads")
            tags.append(out)
        return tags

    t_tags = materialize(cfg.target_read_files, cfg.target_tagalign_files,
                         "target")
    c_tags = materialize(cfg.control_read_files, cfg.control_tagalign_files,
                         "control")
    if not t_tags:
        raise ValueError("pRSEM ChIP-seq: no target replicates provided")

    pooled_t = os.path.join(temp_dir, "target.tagAlign.gz")
    pool_tagaligns(t_tags, pooled_t)
    pooled_reads = read_tagalign(pooled_t)

    control_reads = None
    if c_tags:
        pooled_c = os.path.join(temp_dir, "control.tagAlign.gz")
        pool_tagaligns(c_tags, pooled_c)
        control_reads = read_tagalign(pooled_c)

    fraglen = estimate_fragment_length(pooled_reads)
    pooled_call = call_peaks(pooled_reads, control_reads, fraglen=fraglen,
                             bin_size=cfg.bin_size, pvalue=cfg.pvalue)
    log(f"pRSEM ChIP-seq: fraglen={fraglen}, pooled peaks="
        f"{sum(len(v) for v in pooled_call.peaks.values())}")

    rep_calls = []
    if len(t_tags) > 1:
        for p in t_tags:
            rc = call_peaks(read_tagalign(p), control_reads,
                            fraglen=fraglen, bin_size=cfg.bin_size,
                            pvalue=cfg.pvalue)
            rep_calls.append(rc.peaks)
    final = reproducible_peaks(pooled_call.peaks, rep_calls)

    peak_file = os.path.join(temp_dir, "idr_target_vs_control.regionPeak.gz")
    write_peaks(final, peak_file)
    return ChipSeqResult(peak_file=peak_file, target_signals=pooled_t,
                         fraglen=fraglen)
