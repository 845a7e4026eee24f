"""pRSEM orchestration (pRSEM/prsem-calculate-expression + Prsem.py).

`learn_prior` runs the full flow for any of the 15 partition models:
training-set selection, ChIP-seq evidence (user peak file, target/control
FASTQ or tagAlign replicates, or multi-target experiments), feature
construction, partitioning, partitioned Dirichlet-multinomial fit, the
informativeness test where the reference defines one (pk / cmb_lgt), and
the reference's artifact set (`*_prsem.all_tr_features`,
`*_prsem.all_tr_prior`, `*_prsem.pval_LL`, `*_prsem.training_tr_crd`).
The calculate-expression driver then reruns Gibbs with the prior.
`run_testing_procedure` is the rsem-run-prsem-testing-procedure
equivalent: everything up to the informativeness test, no Gibbs."""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

import numpy as np

from .coords import Mappability, TrCoord, build_coords
from .features import read_peaks, tss_peak_flags
from .partition import (
    PARTITION_MODELS,
    TranscriptFeatures,
    cap_stacked_reads,
    compute_partition,
    count_region_signal,
    count_tss_reads_within,
    read_tagalign,
    region_peak_flags,
)
from .prior import (
    INFORMATIVE_DATA_MAX_P_VALUE,
    fit_partitioned_dm,
    informative_pvalue,
    write_prior_file,
)
from .training import (
    FLANKING_WIDTH,
    TRAINING_GENE_MIN_LEN,
    TRAINING_MIN_MAPPABILITY,
    select_training_set,
)

_SIGNAL_MODELS = frozenset(
    m for m in PARTITION_MODELS if m not in ("pk", "cmb_lgt")
)


@dataclass
class PrsemConfig:
    partition_model: str = "pk"
    # evidence source 1: a called peak file (BED/narrowPeak[.gz])
    chipseq_peak_file: str = ""
    # evidence source 2: raw ChIP-seq reads (comma-separated FASTQ per rep)
    chipseq_target_read_files: List[str] = field(default_factory=list)
    chipseq_control_read_files: List[str] = field(default_factory=list)
    # evidence source 3: multi-target experiments (cmb_lgt)
    chipseq_read_files_multi_targets: List[str] = field(default_factory=list)
    chipseq_bed_files_multi_targets: List[str] = field(default_factory=list)
    cap_stacked_chipseq_reads: bool = False
    n_max_stacked_chipseq_reads: int = 5
    # pooled target tagAlign for the signal features (made by the ChIP-seq
    # leg, or supplied directly alongside --chipseq-peak-file)
    chipseq_target_signals: str = ""
    fraglen: int = 0  # 0 = estimate by strand cross-correlation
    bowtie_index: str = ""
    bowtie_path: str = ""
    n_threads: int = 1
    temp_dir: str = ""
    mappability_file: Optional[str] = None  # bedGraph(.gz)
    flanking_width: int = FLANKING_WIDTH
    min_mappability: float = TRAINING_MIN_MAPPABILITY
    min_gene_len: int = TRAINING_GENE_MIN_LEN
    max_pvalue: float = INFORMATIVE_DATA_MAX_P_VALUE


@dataclass
class PrsemResult:
    prior: np.ndarray  # [M+1] pseudo-counts, index 0 (noise) = 0
    alpha: np.ndarray  # per-partition concentrations
    pvalue: float
    loglikelihood: float
    informative: bool
    partition: np.ndarray  # [M] partition code per isoform
    is_training: np.ndarray  # [M]


class UninformativeDataError(RuntimeError):
    pass


def _gc_fraction(ref, ts) -> np.ndarray:
    """GC content of each transcript's sequence, poly(A) tail excluded
    (pRSEM Util.py's per-transcript GC over the extracted sequence),
    counted over the reference's base codes (C=1, G=2) at once."""
    out = np.zeros(ts.M, dtype=np.float64)
    isgc = (ref.codes == 1) | (ref.codes == 2)
    cum = np.zeros(len(isgc) + 1, dtype=np.int64)
    np.cumsum(isgc, out=cum[1:])
    lo = ref.offsets[1:ts.M + 1]
    n = ref.full_len[1:ts.M + 1]
    gc = cum[lo + n] - cum[lo]
    ok = n > 0
    out[ok] = gc[ok] / n[ok]
    return out


def _regions(coords: Sequence[TrCoord], which: str, w: int):
    """1-based inclusive (chrom, lo, hi) windows: TSS/TES = +/-w around the
    site, body = [start+w+1, end-w-1] (prepPeakSignalGCLenFeatures,
    R:319-332)."""
    out = []
    for c in coords:
        if which == "tss":
            out.append((c.chrom, c.tss - w, c.tss + w))
        elif which == "tes":
            out.append((c.chrom, c.tes - w, c.tes + w))
        else:
            b1, b2 = c.start + w + 1, c.end - w - 1
            if b1 > b2:
                b1, b2 = b2, b1
            out.append((c.chrom, b1, b2))
    return out


def _write_features(path: str, coords, feats: TranscriptFeatures,
                    partition: np.ndarray):
    have_sig = len(feats.tss_sig) > 0
    with open(path, "w") as f:
        cols = ["geneid", "trid", "chrom", "strand", "start", "end", "tss",
                "tss_mpp", "body_mpp", "tes_mpp", "pme_count", "tss_pk",
                "is_training", "partition"]
        if have_sig:
            cols += ["body_pk", "tes_pk", "tss_sig", "body_sig", "tes_sig",
                     "efflen", "GC_fraction"]
        f.write("\t".join(cols) + "\n")
        for i, c in enumerate(coords):
            def _m(x):
                return "NA" if np.isnan(x) else f"{x:5.3f}"
            row = [c.gene_id, c.trid, c.chrom, c.strand, str(c.start),
                   str(c.end), str(c.tss), _m(c.tss_mpp), _m(c.body_mpp),
                   _m(c.tes_mpp), f"{feats.pme_count[i]:.2f}",
                   str(int(feats.tss_pk[i]) if len(feats.tss_pk) else 0),
                   str(int(feats.is_training[i])), str(int(partition[i]))]
            if have_sig:
                row += [str(int(feats.body_pk[i])),
                        str(int(feats.tes_pk[i])),
                        f"{feats.tss_sig[i]:.6g}",
                        f"{feats.body_sig[i]:.6g}",
                        f"{feats.tes_sig[i]:.6g}",
                        f"{feats.efflen[i]:.2f}",
                        f"{feats.gc_fraction[i]:.4f}"]
            f.write("\t".join(row) + "\n")


def _write_training(path: str, coords, idxs):
    with open(path, "w") as f:
        f.write("geneid\ttrid\tchrom\tstrand\tstart\tend\t"
                "tss_mpp\tbody_mpp\ttes_mpp\n")
        for i in idxs:
            c = coords[i]
            f.write(
                f"{c.gene_id}\t{c.trid}\t{c.chrom}\t{c.strand}\t"
                f"{c.start}\t{c.end}\t{c.tss_mpp:5.3f}\t{c.body_mpp:5.3f}\t"
                f"{c.tes_mpp:5.3f}\n"
            )


def _resolve_chipseq(cfg: PrsemConfig, log):
    """Return (peak_file, target_signals, fraglen) — running the native
    alignment/peak/reproducibility leg when raw reads were given."""
    if cfg.chipseq_peak_file:
        return cfg.chipseq_peak_file, cfg.chipseq_target_signals, cfg.fraglen
    if not cfg.chipseq_target_read_files:
        raise ValueError(
            "pRSEM needs --chipseq-peak-file or --chipseq-target-read-files"
        )
    from .chipseq import ChipSeqConfig, run_chipseq_experiment

    temp = cfg.temp_dir or "."
    res = run_chipseq_experiment(
        ChipSeqConfig(
            target_read_files=[f for f in cfg.chipseq_target_read_files
                               if not _is_bedlike(f)],
            target_tagalign_files=[f for f in cfg.chipseq_target_read_files
                                   if _is_bedlike(f)],
            control_read_files=[f for f in cfg.chipseq_control_read_files
                                if not _is_bedlike(f)],
            control_tagalign_files=[f for f in cfg.chipseq_control_read_files
                                    if _is_bedlike(f)],
            bowtie_index=cfg.bowtie_index,
            bowtie_path=cfg.bowtie_path,
            n_threads=cfg.n_threads,
        ),
        temp,
        log=log,
    )
    return res.peak_file, res.target_signals, res.fraglen


def _is_bedlike(path: str) -> bool:
    p = path[:-3] if path.endswith(".gz") else path
    return p.endswith((".bed", ".tagAlign", ".tagalign"))


def _multi_target_signals(cfg: PrsemConfig, coords, log) -> Dict[str, np.ndarray]:
    """Per-target log10 TSS read-density signals for cmb_lgt
    (prepMultiTargetsFeatures + prepTSSSignalsFeatures, R:155-255)."""
    w = cfg.flanking_width
    regions = _regions(coords, "tss", w)
    out: Dict[str, np.ndarray] = {}
    sources: List[str] = []
    if cfg.chipseq_bed_files_multi_targets:
        sources = list(cfg.chipseq_bed_files_multi_targets)
        as_bed = True
    else:
        sources = list(cfg.chipseq_read_files_multi_targets)
        as_bed = False
    for i, src in enumerate(sources):
        tgtid = f"target{i + 1}"
        if as_bed:
            reads = read_tagalign(src)
        else:
            from .chipseq import align_chipseq_fastq

            temp = cfg.temp_dir or "."
            ta = os.path.join(temp, f"{tgtid}.tagAlign.gz")
            align_chipseq_fastq(src.split(","), cfg.bowtie_index, ta,
                                bowtie_path=cfg.bowtie_path,
                                n_threads=cfg.n_threads)
            reads = read_tagalign(ta)
        if cfg.cap_stacked_chipseq_reads:
            reads = cap_stacked_reads(reads,
                                      cfg.n_max_stacked_chipseq_reads)
        nrd, n_tot = count_tss_reads_within(regions, reads)
        sig = np.where(
            n_tot > 0, nrd * 1e9 / (2 * w + 1) / max(n_tot, 1), 0.0
        )
        out[tgtid] = np.where(sig > 0, np.log10(np.maximum(sig, 1e-300)),
                              -4.0)
        log(f"pRSEM cmb_lgt: {tgtid}: {n_tot} reads, "
            f"{int((nrd > 0).sum())} TSS windows hit")
    return out


def build_features(
    ts,
    pme_count: np.ndarray,
    cfg: PrsemConfig,
    ref=None,
    efflen: Optional[np.ndarray] = None,
    pme_tpm: Optional[np.ndarray] = None,
    log=print,
):
    """coords + training set + the model's feature columns."""
    coords = build_coords(ts)
    M = len(coords)
    pme_count = np.asarray(pme_count, dtype=np.float64)
    assert len(pme_count) == M

    mpp = Mappability(cfg.mappability_file)
    train_idx = select_training_set(
        coords, mpp, min_gene_len=cfg.min_gene_len,
        min_mpp=cfg.min_mappability, flanking_width=cfg.flanking_width,
    )
    if not train_idx:
        raise RuntimeError("pRSEM training set is empty")
    is_training = np.zeros(M, dtype=np.int64)
    is_training[train_idx] = 1

    feats = TranscriptFeatures(
        trids=[c.trid for c in coords],
        pme_count=pme_count,
        is_training=is_training,
    )

    model = cfg.partition_model
    if model == "cmb_lgt":
        if pme_tpm is None:
            raise ValueError("cmb_lgt needs posterior mean TPM (is_expr)")
        feats.pme_tpm = np.asarray(pme_tpm, dtype=np.float64)
        feats.target_log10_tss_sig = _multi_target_signals(cfg, coords, log)
        return coords, train_idx, feats

    peak_file, target_signals, fraglen = _resolve_chipseq(cfg, log)
    peaks = read_peaks(peak_file)
    feats.tss_pk = tss_peak_flags(coords, peaks, cfg.flanking_width)

    if model in _SIGNAL_MODELS:
        if target_signals == "":
            raise ValueError(
                f"partition model {model} needs ChIP-seq target signals "
                "(give raw reads, or --chipseq-peak-file plus a pooled "
                "tagAlign via chipseq_target_signals)"
            )
        if ref is None or efflen is None:
            raise ValueError(
                f"partition model {model} needs the reference sequences "
                "(GC) and effective lengths"
            )
        w = cfg.flanking_width
        feats.body_pk = region_peak_flags(_regions(coords, "body", w), peaks)
        feats.tes_pk = region_peak_flags(_regions(coords, "tes", w), peaks)
        reads = read_tagalign(target_signals)
        if fraglen <= 0:
            from .chipseq import estimate_fragment_length

            fraglen = estimate_fragment_length(reads)
            log(f"pRSEM: estimated ChIP-seq fragment length {fraglen}")
        feats.tss_sig = count_region_signal(
            _regions(coords, "tss", w), reads, fraglen)
        feats.body_sig = count_region_signal(
            _regions(coords, "body", w), reads, fraglen)
        feats.tes_sig = count_region_signal(
            _regions(coords, "tes", w), reads, fraglen)
        feats.efflen = np.asarray(efflen, dtype=np.float64)
        feats.gc_fraction = _gc_fraction(ref, ts)
    return coords, train_idx, feats


def learn_prior(
    ts,
    pme_count: np.ndarray,
    cfg: PrsemConfig,
    imd_name: Optional[str] = None,
    stat_name: Optional[str] = None,
    ref=None,
    efflen: Optional[np.ndarray] = None,
    pme_tpm: Optional[np.ndarray] = None,
    log=print,
) -> PrsemResult:
    """ts: refprep.Transcripts (genome mode); pme_count: [M] posterior mean
    counts in .ti order (isoforms.results posterior_mean_count column)."""
    if cfg.partition_model not in PARTITION_MODELS:
        raise ValueError(
            f"unknown partition model {cfg.partition_model!r}; choose from "
            f"{', '.join(PARTITION_MODELS)}"
        )
    coords, train_idx, feats = build_features(
        ts, pme_count, cfg, ref=ref, efflen=efflen, pme_tpm=pme_tpm, log=log
    )
    M = len(coords)
    pme_count = feats.pme_count
    trn = np.asarray(train_idx, dtype=np.int64)

    part = compute_partition(cfg.partition_model, feats)
    alpha, logl = fit_partitioned_dm(pme_count[trn], part.trn_partition,
                                     part.n_parts)
    priors = alpha[part.partition]
    prior_full = np.concatenate([[0.0], priors])

    # informativeness: defined for pk (peak vs no-peak counts,
    # genPriorByTSSPeak R:464-468) and cmb_lgt (partition 1 vs 0, R:74-78);
    # the signal models use their prior unconditionally
    # (genPriorByPeakSignalGCLen writes no pval_LL).
    if cfg.partition_model in ("pk", "cmb_lgt"):
        hi = pme_count[trn][part.trn_partition == part.n_parts - 1]
        lo = pme_count[trn][part.trn_partition == 0]
        pval = informative_pvalue(hi, lo)
        informative = pval <= cfg.max_pvalue
    else:
        pval = float("nan")
        informative = True

    if imd_name:
        _write_training(f"{imd_name}_prsem.training_tr_crd", coords,
                        train_idx)
        _write_features(f"{imd_name}_prsem.all_tr_features", coords, feats,
                        part.partition)
        write_prior_file(f"{imd_name}_prsem.all_tr_prior", priors,
                         [c.trid for c in coords])
    if stat_name:
        with open(f"{stat_name}_prsem.pval_LL", "w") as f:
            f.write("pvalue\tloglikelihood\n")
            f.write(f"{pval:.10g}\t{logl:.10g}\n")

    if not informative:
        log(
            "Warning: external data is NOT informative for RNA-seq "
            f"quantification (p-value {pval:.10e} > {cfg.max_pvalue:.3f})"
        )
    return PrsemResult(
        prior=prior_full, alpha=alpha, pvalue=pval, loglikelihood=logl,
        informative=informative, partition=part.partition,
        is_training=feats.is_training,
    )


def run_testing_procedure(
    ts,
    pme_count: np.ndarray,
    cfg: PrsemConfig,
    imd_name: Optional[str] = None,
    stat_name: Optional[str] = None,
    ref=None,
    efflen: Optional[np.ndarray] = None,
    pme_tpm: Optional[np.ndarray] = None,
    log=print,
) -> PrsemResult:
    """rsem-run-prsem-testing-procedure: report the informativeness p-value
    and the DM log-likelihood without rerunning Gibbs."""
    res = learn_prior(ts, pme_count, cfg, imd_name=imd_name,
                      stat_name=stat_name, ref=ref, efflen=efflen,
                      pme_tpm=pme_tpm, log=log)
    log(f"p-value\t{res.pvalue:.10g}")
    log(f"log-likelihood\t{res.loglikelihood:.10g}")
    return res
