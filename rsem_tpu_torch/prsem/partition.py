"""All 15 pRSEM partition models (pRSEM/process-rnaseq.R:90-971).

Each model partitions the training transcripts using ChIP-seq evidence,
fits the partitioned Dirichlet-multinomial (prior.fit_partitioned_dm) on
training posterior-mean counts, and assigns every transcript the alpha of
its partition as its Gibbs pseudo-count prior:

  * ``pk``          — TSS-peak indicator (genPriorByTSSPeak, R:444-477)
  * ``pk_lgtnopk``  — peak / logistic-regression split of no-peak
                      (getSampleAndPriorByPeakLogitNoPeak, R:859-920)
  * ``lm3..lm6``    — OLS of log10 counts on peak+signal+GC+len features,
                      predictions cut into 3..6 equal-width bins
                      (getSampleAndPriorByLM, R:772-802)
  * ``nopk_lm2pk..nopk_lm5pk`` — partition 0 = no TSS peak; peak
                      transcripts binned by an OLS fit on the peak subset
                      (getSampleAndPriorByPeakLM lm_on_wpk=T, R:805-856)
  * ``pk_lm2nopk..pk_lm5nopk`` — partition 0 = with TSS peak; no-peak
                      transcripts binned by an OLS fit on the no-peak
                      subset (lm_on_wpk=F)
  * ``cmb_lgt``     — logistic regression of expressed-status on per-target
                      log10 TSS signals from multiple ChIP-seq experiments
                      (genPriorByCombinedTSSSignals, R:23-87)

Numerics follow R exactly: log10 transforms floor at -4 for non-positive
values, ``cut`` uses R's 0.1%-range extension, and new data reuses the
training breaks with data-range bounds (createPartitionForNewData,
R:714-724).
"""

from __future__ import annotations

import gzip
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

PARTITION_MODELS = (
    "pk", "pk_lgtnopk",
    "lm3", "lm4", "lm5", "lm6",
    "nopk_lm2pk", "nopk_lm3pk", "nopk_lm4pk", "nopk_lm5pk",
    "pk_lm2nopk", "pk_lm3nopk", "pk_lm4nopk", "pk_lm5nopk",
    "cmb_lgt",
)

_LM_BINS = {"lm3": 3, "lm4": 4, "lm5": 5, "lm6": 6}
_PEAK_LM = {  # name -> (nbin, lm_on_wpk)
    "nopk_lm2pk": (2, True), "nopk_lm3pk": (3, True),
    "nopk_lm4pk": (4, True), "nopk_lm5pk": (5, True),
    "pk_lm2nopk": (2, False), "pk_lm3nopk": (3, False),
    "pk_lm4nopk": (4, False), "pk_lm5nopk": (5, False),
}


def _log10_floor(x: np.ndarray, floor: float = -4.0) -> np.ndarray:
    """R: ifelse(x > 0, log10(x), -4)."""
    x = np.asarray(x, dtype=np.float64)
    out = np.full(x.shape, floor)
    pos = x > 0
    out[pos] = np.log10(x[pos])
    return out


@dataclass
class TranscriptFeatures:
    """The all_tr_features table (prepPeakSignalGCLenFeatures, R:258-368),
    one row per transcript in .ti order."""

    trids: List[str]
    pme_count: np.ndarray
    is_training: np.ndarray  # 0/1
    tss_pk: np.ndarray = field(default_factory=lambda: np.zeros(0))
    body_pk: np.ndarray = field(default_factory=lambda: np.zeros(0))
    tes_pk: np.ndarray = field(default_factory=lambda: np.zeros(0))
    tss_sig: np.ndarray = field(default_factory=lambda: np.zeros(0))
    body_sig: np.ndarray = field(default_factory=lambda: np.zeros(0))
    tes_sig: np.ndarray = field(default_factory=lambda: np.zeros(0))
    efflen: np.ndarray = field(default_factory=lambda: np.zeros(0))
    gc_fraction: np.ndarray = field(default_factory=lambda: np.zeros(0))
    pme_tpm: np.ndarray = field(default_factory=lambda: np.zeros(0))
    # per-target log10 TSS signals for cmb_lgt: {targetid: [M]}
    target_log10_tss_sig: Dict[str, np.ndarray] = field(default_factory=dict)

    def design_columns(self) -> Dict[str, np.ndarray]:
        """Derived regression columns (R:133-143)."""
        gc_mean = float(np.mean(self.gc_fraction)) if len(self.gc_fraction) \
            else 1.0
        gc_ratio = np.asarray(self.gc_fraction, dtype=np.float64)
        gc_ratio = np.where(gc_mean > 0, gc_ratio / gc_mean, 0.0)
        return {
            "log10_count": np.log10(self.pme_count + 1.0),
            "log10_tss_sig": _log10_floor(self.tss_sig),
            "log10_body_sig": _log10_floor(self.body_sig),
            "log10_tes_sig": _log10_floor(self.tes_sig),
            "log10_eff_len": _log10_floor(self.efflen),
            "log10_GC_ov_mean": _log10_floor(gc_ratio),
            "tss_pk": np.asarray(self.tss_pk, dtype=np.float64),
            "body_pk": np.asarray(self.body_pk, dtype=np.float64),
            "tes_pk": np.asarray(self.tes_pk, dtype=np.float64),
            "no_tss_pk": 1.0 - np.asarray(self.tss_pk, dtype=np.float64),
            "no_body_pk": 1.0 - np.asarray(self.body_pk, dtype=np.float64),
            "no_tes_pk": 1.0 - np.asarray(self.tes_pk, dtype=np.float64),
        }


# --------------------------------------------------------------------- #
# ChIP-seq signal features                                               #
# --------------------------------------------------------------------- #
def read_tagalign(path: str):
    """tagAlign/BED(.gz): returns {chrom: (start0[n], end0[n], strand[n])}
    with 0-based half-open coordinates (columns 1-3,6)."""
    by_chrom: Dict[str, List[Tuple[int, int, int]]] = {}
    op = gzip.open if path.endswith(".gz") else open
    with op(path, "rt") as f:
        for line in f:
            if not line.strip() or line.startswith(("track", "browser", "#")):
                continue
            t = line.split()
            strand = 1 if len(t) >= 6 and t[5] == "-" else 0
            by_chrom.setdefault(t[0], []).append(
                (int(t[1]), int(t[2]), strand))
    out = {}
    for ch, rows in by_chrom.items():
        arr = np.asarray(rows, dtype=np.int64)
        out[ch] = (arr[:, 0], arr[:, 1], arr[:, 2])
    return out


def cap_stacked_reads(reads, n_max: int):
    """Keep at most n_max reads per identical (start, end, strand) stack
    (prepTSSSignalsFeatures, R:225-231)."""
    out = {}
    for ch, (s, e, st) in reads.items():
        order = np.lexsort((st, e, s))
        s2, e2, st2 = s[order], e[order], st[order]
        new = np.ones(len(s2), dtype=bool)
        new[1:] = (np.diff(s2) != 0) | (np.diff(e2) != 0) | (np.diff(st2) != 0)
        run_id = np.cumsum(new) - 1
        run_start = np.flatnonzero(new)
        rank = np.arange(len(s2)) - run_start[run_id]
        keep = rank < n_max
        out[ch] = (s2[keep], e2[keep], st2[keep])
    return out


def count_region_signal(
    regions: Sequence[Tuple[str, int, int]],
    reads,
    fraglen: int,
) -> np.ndarray:
    """Per-region fragment-nucleotide density (countRegionSignal,
    R:385-441): extend each read to fraglen from its 5' end, keep fragments
    whose midpoint falls inside the region, sum clipped overlap lengths,
    divide by region width. Regions are 1-based inclusive (chrom, s, e)."""
    out = np.zeros(len(regions), dtype=np.float64)
    by_chrom: Dict[str, List[int]] = {}
    for i, (ch, _s, _e) in enumerate(regions):
        by_chrom.setdefault(ch, []).append(i)
    for ch, idxs in by_chrom.items():
        if ch not in reads:
            continue
        s0, e0, strand = reads[ch]
        # tagAlign lists reads; R uses 1-based starts from fread, so the
        # fragment is [start, start+fraglen-1] (+) or [end-fraglen+1, end]
        # (-) in 1-based terms; inputs here are 0-based half-open.
        start1 = s0 + 1
        end1 = e0
        fs = np.where(strand == 0, start1, end1 - fraglen)
        fe = fs + fraglen - 1
        mid = (fs + fe) / 2.0
        order = np.argsort(mid, kind="stable")
        fs, fe, mid = fs[order], fe[order], mid[order]
        for i in idxs:
            _, rs, re_ = regions[i]
            if re_ < rs:
                rs, re_ = re_, rs
            lo = int(np.searchsorted(mid, rs, side="left"))
            hi = int(np.searchsorted(mid, re_, side="right"))
            if hi <= lo:
                continue
            ov = (np.minimum(fe[lo:hi], re_)
                  - np.maximum(fs[lo:hi], rs) + 1)
            out[i] = float(np.maximum(ov, 0).sum()) / (re_ - rs + 1)
    return out


def count_tss_reads_within(
    regions: Sequence[Tuple[str, int, int]],
    reads,
) -> Tuple[np.ndarray, int]:
    """Number of reads fully within each region + total read count
    (prepTSSSignalsFeatures: findOverlaps type='within', R:240-247)."""
    out = np.zeros(len(regions), dtype=np.int64)
    n_tot = sum(len(v[0]) for v in reads.values())
    by_chrom: Dict[str, List[int]] = {}
    for i, (ch, _s, _e) in enumerate(regions):
        by_chrom.setdefault(ch, []).append(i)
    for ch, idxs in by_chrom.items():
        if ch not in reads:
            continue
        s0, e0, _ = reads[ch]
        start1, end1 = s0 + 1, e0
        order = np.argsort(start1, kind="stable")
        s_sorted = start1[order]
        e_sorted = end1[order]
        for i in idxs:
            _, rs, re_ = regions[i]
            lo = int(np.searchsorted(s_sorted, rs, side="left"))
            hi = int(np.searchsorted(s_sorted, re_, side="right"))
            if hi > lo:
                out[i] = int((e_sorted[lo:hi] <= re_).sum())
    return out, n_tot


def region_peak_flags(
    regions: Sequence[Tuple[str, int, int]],
    peaks: Dict[str, np.ndarray],
) -> np.ndarray:
    """1 where any peak overlaps the (1-based inclusive) region
    (getRegionPeakOLTrID, R:537-547); peaks as from features.read_peaks
    (merged, sorted [n,2])."""
    flags = np.zeros(len(regions), dtype=np.int64)
    for i, (ch, lo, hi) in enumerate(regions):
        pk = peaks.get(ch)
        if pk is None or not len(pk):
            continue
        if hi < lo:
            lo, hi = hi, lo
        k = int(np.searchsorted(pk[:, 1], lo, side="left"))
        if k < len(pk) and pk[k, 0] <= hi:
            flags[i] = 1
    return flags


# --------------------------------------------------------------------- #
# regression machinery (R lm / glm-binomial / cut)                       #
# --------------------------------------------------------------------- #
_LM_TERMS = (
    # the lm formula of getSampleAndPriorByLM (R:774-778)
    ("tss_pk",), ("tss_pk", "log10_tss_sig"), ("no_tss_pk", "log10_tss_sig"),
    ("body_pk",), ("body_pk", "log10_body_sig"),
    ("no_body_pk", "log10_body_sig"),
    ("tes_pk",), ("tes_pk", "log10_tes_sig"), ("no_tes_pk", "log10_tes_sig"),
    ("log10_eff_len",), ("log10_GC_ov_mean",),
)

_PEAK_LM_TERMS = (
    # the formula shared by getSampleAndPriorByPeakLM and
    # getSampleAndPriorByPeakLogitNoPeak (R:813-817, 871-875)
    ("log10_tss_sig",),
    ("body_pk",), ("body_pk", "log10_body_sig"),
    ("no_body_pk", "log10_body_sig"),
    ("tes_pk",), ("tes_pk", "log10_tes_sig"), ("no_tes_pk", "log10_tes_sig"),
    ("log10_eff_len",), ("log10_GC_ov_mean",),
)


def _design(cols: Dict[str, np.ndarray], terms, rows: np.ndarray):
    mats = [np.ones(int(rows.sum()) if rows.dtype == bool else len(rows))]
    for term in terms:
        v = np.ones_like(mats[0])
        for name in term:
            v = v * cols[name][rows]
        mats.append(v)
    return np.column_stack(mats)


def ols_fit(X: np.ndarray, y: np.ndarray) -> np.ndarray:
    beta, *_ = np.linalg.lstsq(X, y, rcond=None)
    return beta


def logit_fit(X: np.ndarray, y: np.ndarray, max_iter: int = 50,
              ridge: float = 1e-8) -> np.ndarray:
    """IRLS logistic regression (R glm family='binomial'); a tiny ridge
    keeps separable training sets finite."""
    beta = np.zeros(X.shape[1])
    for _ in range(max_iter):
        eta = np.clip(X @ beta, -30, 30)
        p = 1.0 / (1.0 + np.exp(-eta))
        w = np.maximum(p * (1 - p), 1e-10)
        z = eta + (y - p) / w
        XtW = X.T * w
        A = XtW @ X + ridge * np.eye(X.shape[1])
        new = np.linalg.solve(A, XtW @ z)
        if np.max(np.abs(new - beta)) < 1e-10:
            beta = new
            break
        beta = new
    return beta


def logit_predict(X: np.ndarray, beta: np.ndarray) -> np.ndarray:
    return 1.0 / (1.0 + np.exp(-np.clip(X @ beta, -30, 30)))


def r_cut_breaks(x: np.ndarray, nbin: int) -> np.ndarray:
    """Break points of R's cut(x, nbin): equal-width bins over range(x),
    outermost bounds pushed out by diff(range)/1000."""
    lo, hi = float(np.min(x)), float(np.max(x))
    if hi == lo:
        hi = lo + 1.0  # degenerate; R extends by 0.5 either side / 1000
    breaks = np.linspace(lo, hi, nbin + 1)
    dx = (hi - lo) / 1000.0
    breaks[0] -= dx
    breaks[-1] += dx
    return breaks


def cut_codes(x: np.ndarray, breaks: np.ndarray) -> np.ndarray:
    """0-based bin codes for intervals (breaks[i], breaks[i+1]] (R cut
    right=TRUE); values outside -> clamped to nearest bin (R would produce
    NA; createPartitionForNewData widens bounds so this only guards fp)."""
    codes = np.searchsorted(breaks, x, side="left") - 1
    return np.clip(codes, 0, len(breaks) - 2)


def breaks_for_new_data(breaks: np.ndarray, x: np.ndarray) -> np.ndarray:
    """createPartitionForNewData (R:714-724): keep interior breaks, set the
    outer bounds from the new data's range +/- 1e-4."""
    out = breaks.copy()
    out[0] = float(np.min(x)) - 1e-4
    out[-1] = float(np.max(x)) + 1e-4
    return out


# --------------------------------------------------------------------- #
# partition models                                                       #
# --------------------------------------------------------------------- #
@dataclass
class PartitionResult:
    partition: np.ndarray  # [M] 0-based partition code per transcript
    n_parts: int
    trn_partition: np.ndarray  # training subset codes (fit input)


def compute_partition(model: str, feats: TranscriptFeatures
                      ) -> PartitionResult:
    """Partition codes for the whole transcriptome + the training subset
    (the two factors handed to getFitByMLDM / fit$par indexing in R)."""
    if model not in PARTITION_MODELS:
        raise ValueError(
            f"unknown partition model {model!r}; choose from "
            f"{', '.join(PARTITION_MODELS)}"
        )
    trn = np.asarray(feats.is_training, dtype=bool)
    allm = np.ones(len(feats.pme_count), dtype=bool)
    cols = feats.design_columns()

    if model == "pk":
        part = np.asarray(feats.tss_pk, dtype=np.int64)
        return PartitionResult(part, 2, part[trn])

    if model in _LM_BINS:
        nbin = _LM_BINS[model]
        X_trn = _design(cols, _LM_TERMS, trn)
        beta = ols_fit(X_trn, cols["log10_count"][trn])
        trn_prd = X_trn @ beta
        breaks = r_cut_breaks(trn_prd, nbin)
        trn_part = cut_codes(trn_prd, breaks)
        X_all = _design(cols, _LM_TERMS, allm)
        all_prd = X_all @ beta
        all_part = cut_codes(all_prd, breaks_for_new_data(breaks, all_prd))
        return PartitionResult(all_part, nbin, trn_part)

    if model in _PEAK_LM:
        nbin, lm_on_wpk = _PEAK_LM[model]
        pk_type = 1 if lm_on_wpk else 0
        tss_pk = np.asarray(feats.tss_pk, dtype=np.int64)
        sub_trn = trn & (tss_pk == pk_type)
        if not sub_trn.any():
            raise RuntimeError(
                f"partition model {model}: no training transcripts with "
                f"tss_pk == {pk_type}"
            )
        X_sub = _design(cols, _PEAK_LM_TERMS, sub_trn)
        beta = ols_fit(X_sub, cols["log10_count"][sub_trn])
        sub_prd = X_sub @ beta
        breaks = r_cut_breaks(sub_prd, nbin)
        # partition 0 = the off-subset; 1..nbin = bins of the lm subset
        trn_part = np.zeros(int(trn.sum()), dtype=np.int64)
        on_within_trn = (tss_pk[trn] == pk_type)
        trn_part[on_within_trn] = cut_codes(sub_prd, breaks) + 1

        all_part = np.zeros(len(tss_pk), dtype=np.int64)
        sub_all = tss_pk == pk_type
        X_all = _design(cols, _PEAK_LM_TERMS, sub_all)
        all_prd = X_all @ beta
        all_part[sub_all] = cut_codes(
            all_prd, breaks_for_new_data(breaks, all_prd)) + 1
        return PartitionResult(all_part, nbin + 1, trn_part)

    if model == "pk_lgtnopk":
        tss_pk = np.asarray(feats.tss_pk, dtype=np.int64)
        sub_trn = trn & (tss_pk == 0)
        if not sub_trn.any():
            raise RuntimeError(
                "partition model pk_lgtnopk: no no-peak training transcripts"
            )
        has_cnt = (np.asarray(feats.pme_count) > 0).astype(np.float64)
        X_sub = _design(cols, _PEAK_LM_TERMS, sub_trn)
        beta = logit_fit(X_sub, has_cnt[sub_trn])
        # levels: 0 = 'no pk, no cnt', 1 = 'no pk, has cnt', 2 = 'w/ pk'
        trn_part = np.full(int(trn.sum()), 2, dtype=np.int64)
        nopk_trn = tss_pk[trn] == 0
        trn_part[nopk_trn] = (logit_predict(X_sub, beta) > 0.5).astype(
            np.int64)

        all_part = np.full(len(tss_pk), 2, dtype=np.int64)
        sub_all = tss_pk == 0
        X_all = _design(cols, _PEAK_LM_TERMS, sub_all)
        all_part[sub_all] = (logit_predict(X_all, beta) > 0.5).astype(
            np.int64)
        return PartitionResult(all_part, 3, trn_part)

    # cmb_lgt: logistic regression of expressed-status on per-target
    # log10 TSS signals (genPriorByCombinedTSSSignals, R:54-66)
    tgt = feats.target_log10_tss_sig
    if not tgt:
        raise ValueError(
            "partition model cmb_lgt requires per-target TSS signals"
        )
    names = sorted(tgt)
    X_all = np.column_stack(
        [np.ones(len(feats.pme_count))] + [tgt[n] for n in names]
    )
    is_expr = ((np.asarray(feats.pme_count) > 0)
               & (np.asarray(feats.pme_tpm) >= 1.0)).astype(np.float64)
    beta = logit_fit(X_all[trn], is_expr[trn])
    prob = logit_predict(X_all, beta)
    all_part = (prob > 0.5).astype(np.int64)
    return PartitionResult(all_part, 2, all_part[trn])
