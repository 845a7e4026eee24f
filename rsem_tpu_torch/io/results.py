"""Expression value computation and results tables.

Math mirrors WriteResults.h (polishTheta :55-75, calcExpressionValues :77-104,
writeResultsEM :125-355); output files carry the canonical column headers the
reference's driver attaches via collectResults (rsem_perl_utils.pm:37-41).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np

from ..constants import EPSILON


def polish_theta(theta: np.ndarray, eel: np.ndarray, mw: np.ndarray) -> np.ndarray:
    """Divide by masking weights, zero unusable isoforms, renormalize."""
    out = theta.astype(np.float64).copy()
    M = len(out) - 1
    bad = (mw[1:] < EPSILON) | (eel[1:] < EPSILON)
    out[1:][bad] = 0.0
    with np.errstate(divide="ignore", invalid="ignore"):
        out[1:][~bad] = out[1:][~bad] / mw[1:][~bad]
    out[0] = out[0] / mw[0]
    s = out.sum()
    assert s >= EPSILON, "No effective length is no less than MINEEL!"
    return out / s


def calc_expression_values(
    theta: np.ndarray, eel: np.ndarray
) -> Tuple[np.ndarray, np.ndarray]:
    """(tpm, fpkm), both [M+1] with index 0 zero."""
    M = len(theta) - 1
    frac = np.where(eel[1:] >= EPSILON, theta[1:], 0.0)
    denom = frac.sum()
    if denom < EPSILON:
        denom = 1.0
    frac = frac / denom
    fpkm = np.zeros(M + 1)
    with np.errstate(divide="ignore", invalid="ignore"):
        fpkm[1:] = np.where(eel[1:] >= EPSILON, frac * 1e9 / np.where(eel[1:] == 0, 1, eel[1:]), 0.0)
    denom2 = fpkm[1:].sum()
    if denom2 < EPSILON:
        denom2 = 1.0
    tpm = np.zeros(M + 1)
    tpm[1:] = fpkm[1:] / denom2 * 1e6
    return tpm, fpkm


@dataclass
class GeneLevel:
    lengths: np.ndarray
    eels: np.ndarray
    counts: np.ndarray
    tpm: np.ndarray
    fpkm: np.ndarray
    isopct: np.ndarray  # per isoform [M+1]


def gene_level_values(
    gi, tlens: np.ndarray, eel: np.ndarray, counts: np.ndarray,
    tpm: np.ndarray, fpkm: np.ndarray
) -> GeneLevel:
    """TPM-weighted gene lengths + summed expression (WriteResults.h:160-190).

    gi: refprep.GroupInfo (.grp); all per-isoform arrays are [M+1]."""
    m = gi.m
    M = len(tlens) - 1
    sids = np.arange(1, M + 1)
    gids = gi.gids_of(sids)
    gene_counts = np.bincount(gids, weights=counts[1:], minlength=m)
    gene_tpm = np.bincount(gids, weights=tpm[1:], minlength=m)
    gene_fpkm = np.bincount(gids, weights=fpkm[1:], minlength=m)

    isopct = np.zeros(M + 1)
    glens = np.zeros(m)
    gene_eels = np.zeros(m)
    n_iso = np.diff(gi.starts).astype(np.float64)
    expressed = gene_tpm >= EPSILON
    with np.errstate(divide="ignore", invalid="ignore"):
        isopct[1:] = np.where(
            expressed[gids], tpm[1:] / np.where(gene_tpm[gids] == 0, 1, gene_tpm[gids]), 0.0
        )
    w = np.where(expressed[gids], isopct[1:], 1.0 / n_iso[gids])
    glens = np.bincount(gids, weights=tlens[1:] * w, minlength=m)
    gene_eels = np.bincount(gids, weights=eel[1:] * w, minlength=m)
    return GeneLevel(glens, gene_eels, gene_counts, gene_tpm, gene_fpkm, isopct)


def transcript_level_values(
    ta, tlens: np.ndarray, eel: np.ndarray, counts: np.ndarray,
    tpm: np.ndarray, fpkm: np.ndarray
) -> GeneLevel:
    """Allele mode: aggregate alleles into transcripts over the .ta grouping
    (WriteResults.h:185-212). Returned GeneLevel.isopct is AlleleIsoPct —
    each allele's share of its transcript's TPM ([M+1])."""
    return gene_level_values(ta, tlens, eel, counts, tpm, fpkm)


def within_gene_pct(gt, trans_tpm: np.ndarray, gene_tpm: np.ndarray) -> np.ndarray:
    """Allele mode: transcript's share of its gene's TPM, [m_trans]
    (WriteResults.h:214-221). gt: gene -> transcript GroupInfo."""
    m_trans = len(trans_tpm)
    tids = np.arange(m_trans)
    gids = gt.gids_of(tids)
    pct = np.zeros(m_trans)
    expressed = gene_tpm[gids] >= EPSILON
    with np.errstate(divide="ignore", invalid="ignore"):
        pct[expressed] = trans_tpm[expressed] / gene_tpm[gids][expressed]
    return pct


ALLELE_TITLE = [
    "allele_id", "transcript_id", "gene_id", "length", "effective_length",
    "expected_count", "TPM", "FPKM", "AlleleIsoPct", "AlleleGenePct",
]
ALLELE_TITLE_PME = [
    "posterior_mean_count", "posterior_standard_deviation_of_count",
    "pme_TPM", "pme_FPKM", "AlleleIsoPct_from_pme_TPM",
    "AlleleGenePct_from_pme_TPM",
]


ISO_TITLE = [
    "transcript_id", "gene_id", "length", "effective_length", "expected_count",
    "TPM", "FPKM", "IsoPct",
]
ISO_TITLE_PME = [
    "posterior_mean_count", "posterior_standard_deviation_of_count",
    "pme_TPM", "pme_FPKM", "IsoPct_from_pme_TPM",
]
ISO_TITLE_CI = [
    "TPM_ci_lower_bound", "TPM_ci_upper_bound",
    "TPM_coefficient_of_quartile_variation",
    "FPKM_ci_lower_bound", "FPKM_ci_upper_bound",
    "FPKM_coefficient_of_quartile_variation",
]
GENE_TITLE = [
    "gene_id", "transcript_id(s)", "length", "effective_length",
    "expected_count", "TPM", "FPKM",
]
GENE_TITLE_PME = [
    "posterior_mean_count", "posterior_standard_deviation_of_count",
    "pme_TPM", "pme_FPKM",
]
GENE_TITLE_CI = ISO_TITLE_CI


def _fmt(x) -> str:
    return f"{x:.2f}"


def write_isoform_results(
    path: str,
    transcripts,
    tlens: np.ndarray,
    eel: np.ndarray,
    counts: np.ndarray,
    tpm: np.ndarray,
    fpkm: np.ndarray,
    isopct: np.ndarray,
    append_names: bool = False,
    extra_cols: Optional[List[Tuple[List[str], np.ndarray]]] = None,
):
    """sample.isoforms.results; extra_cols: list of (titles, [M+1] or [k, M+1]
    value blocks) appended per stage (Gibbs, CI)."""
    M = transcripts.M
    titles = list(ISO_TITLE)
    blocks = []
    if extra_cols:
        for t, vals in extra_cols:
            titles.extend(t)
            blocks.append(np.atleast_2d(vals))
    with open(path, "w") as f:
        f.write("\t".join(titles) + "\n")
        for i in range(1, M + 1):
            tr = transcripts.get(i)
            tid = tr.transcript_id
            gid = tr.gene_id
            if append_names and tr.transcript_name:
                tid += "_" + tr.transcript_name
            if append_names and tr.gene_name:
                gid += "_" + tr.gene_name
            row = [
                tid, gid, str(int(tlens[i])), _fmt(eel[i]), _fmt(counts[i]),
                _fmt(tpm[i]), _fmt(fpkm[i]), _fmt(isopct[i] * 100),
            ]
            for vals in blocks:
                row.extend(_fmt(v[i]) for v in vals)
            f.write("\t".join(row) + "\n")


def write_allele_results(
    path: str,
    transcripts,
    tlens: np.ndarray,
    eel: np.ndarray,
    counts: np.ndarray,
    tpm: np.ndarray,
    fpkm: np.ndarray,
    allele_iso_pct: np.ndarray,  # [M+1] share of transcript TPM
    allele_gene_pct: np.ndarray,  # [M+1] share of gene TPM
    append_names: bool = False,
    extra_cols: Optional[List[Tuple[List[str], np.ndarray]]] = None,
):
    """sample.alleles.results (WriteResults.h:259-290 + allele headers
    rsem_perl_utils.pm:37). allele_id is the Transcript seqname in
    allele-specific references (synthesisRef convention)."""
    M = transcripts.M
    titles = list(ALLELE_TITLE)
    blocks = []
    if extra_cols:
        for t, vals in extra_cols:
            titles.extend(t)
            blocks.append(np.atleast_2d(vals))
    with open(path, "w") as f:
        f.write("\t".join(titles) + "\n")
        for i in range(1, M + 1):
            tr = transcripts.get(i)
            tid = tr.transcript_id
            gid = tr.gene_id
            if append_names and tr.transcript_name:
                tid += "_" + tr.transcript_name
            if append_names and tr.gene_name:
                gid += "_" + tr.gene_name
            row = [
                tr.seqname, tid, gid, str(int(tlens[i])), _fmt(eel[i]),
                _fmt(counts[i]), _fmt(tpm[i]), _fmt(fpkm[i]),
                _fmt(allele_iso_pct[i] * 100), _fmt(allele_gene_pct[i] * 100),
            ]
            for vals in blocks:
                row.extend(_fmt(v[i]) for v in vals)
            f.write("\t".join(row) + "\n")


def write_transcript_results_allele(
    path: str,
    transcripts,
    ta,
    gt,
    tl: GeneLevel,  # transcript-level aggregation from transcript_level_values
    iso_pct: np.ndarray,  # [m_trans] share of gene TPM
    append_names: bool = False,
    extra_cols: Optional[List[Tuple[List[str], np.ndarray]]] = None,
):
    """Isoform table in allele mode: one row per transcript (ta group),
    IsoPct relative to the gene (WriteResults.h:292-330)."""
    m_trans = ta.m
    titles = list(ISO_TITLE)
    blocks = []
    if extra_cols:
        for t, vals in extra_cols:
            titles.extend(t)
            blocks.append(np.atleast_2d(vals))
    with open(path, "w") as f:
        f.write("\t".join(titles) + "\n")
        for i in range(m_trans):
            b, _ = ta.span(i)
            tr = transcripts.get(b)
            tid = tr.transcript_id
            gid = tr.gene_id
            if append_names and tr.transcript_name:
                tid += "_" + tr.transcript_name
            if append_names and tr.gene_name:
                gid += "_" + tr.gene_name
            row = [
                tid, gid, _fmt(tl.lengths[i]), _fmt(tl.eels[i]),
                _fmt(tl.counts[i]), _fmt(tl.tpm[i]), _fmt(tl.fpkm[i]),
                _fmt(iso_pct[i] * 100),
            ]
            for vals in blocks:
                row.extend(_fmt(v[i]) for v in vals)
            f.write("\t".join(row) + "\n")


def write_simulation_results(
    out_prefix: str,
    transcripts,
    gi,
    eel: np.ndarray,
    counts: np.ndarray,
    tlens: np.ndarray,
):
    """Ground-truth tables for simulated reads
    (reference: WriteResults.h:481-635, writeResultsSimulation)."""
    M = transcripts.M
    tpm, fpkm = calc_expression_values(counts, eel)
    gl = gene_level_values(gi, tlens, eel, counts, tpm, fpkm)

    with open(f"{out_prefix}.sim.isoforms.results", "w") as f:
        f.write(
            "transcript_id\tgene_id\tlength\teffective_length\tcount\tTPM\t"
            "FPKM\tIsoPct\n"
        )
        for i in range(1, M + 1):
            tr = transcripts.get(i)
            f.write(
                f"{tr.transcript_id}\t{tr.gene_id}\t{int(tlens[i])}\t"
                f"{eel[i]:.2f}\t{counts[i]:.2f}\t{tpm[i]:.2f}\t{fpkm[i]:.2f}\t"
                f"{gl.isopct[i] * 100:.2f}\n"
            )
    with open(f"{out_prefix}.sim.genes.results", "w") as f:
        f.write(
            "gene_id\ttranscript_id(s)\tlength\teffective_length\tcount\tTPM\t"
            "FPKM\n"
        )
        for g in range(gi.m):
            b, e = gi.span(g)
            tids = []
            for j in range(b, e):
                tid = transcripts.get(j).transcript_id
                if not tids or tids[-1] != tid:
                    tids.append(tid)
            f.write(
                f"{transcripts.get(b).gene_id}\t{','.join(tids)}\t"
                f"{gl.lengths[g]:.2f}\t{gl.eels[g]:.2f}\t{gl.counts[g]:.2f}\t"
                f"{gl.tpm[g]:.2f}\t{gl.fpkm[g]:.2f}\n"
            )


def write_gene_results(
    path: str,
    transcripts,
    gi,
    gl: GeneLevel,
    append_names: bool = False,
    extra_cols: Optional[List[Tuple[List[str], np.ndarray]]] = None,
):
    m = gi.m
    titles = list(GENE_TITLE)
    blocks = []
    if extra_cols:
        for t, vals in extra_cols:
            titles.extend(t)
            blocks.append(np.atleast_2d(vals))
    with open(path, "w") as f:
        f.write("\t".join(titles) + "\n")
        for g in range(m):
            b, e = gi.span(g)
            tr0 = transcripts.get(b)
            gid = tr0.gene_id
            if append_names and tr0.gene_name:
                gid += "_" + tr0.gene_name
            tids = []
            for j in range(b, e):
                tr = transcripts.get(j)
                tid = tr.transcript_id
                if append_names and tr.transcript_name:
                    tid += "_" + tr.transcript_name
                if not tids or tids[-1] != tid:
                    tids.append(tid)
            row = [
                gid, ",".join(tids), _fmt(gl.lengths[g]), _fmt(gl.eels[g]),
                _fmt(gl.counts[g]), _fmt(gl.tpm[g]), _fmt(gl.fpkm[g]),
            ]
            for vals in blocks:
                row.extend(_fmt(v[g]) for v in vals)
            f.write("\t".join(row) + "\n")
