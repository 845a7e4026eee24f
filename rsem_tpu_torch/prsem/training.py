"""Training-set selection (pRSEM/Prsem.py buildTrainingSet +
process-rnaseq.R selTrainingTr).

A transcript enters the training set when:
  1. its gene has exactly one isoform and spans >= min_gene_len
     (Prsem.py:61-71, TRAINING_GENE_MIN_LEN=1003);
  2. TSS/body/TES mappability all exceed min_mpp (selTrainingTr, R:570-574);
  3. it is not nested within another transcript's span, strand-blind
     (R:576-579);
  4. its exons are not all contained in other transcripts' exons (R:581-585);
  5. no other transcript's TSS falls in its [tss-w, tss+w] window
     (R:587-597).
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

from .coords import Mappability, TrCoord, fill_mappability

TRAINING_GENE_MIN_LEN = 1003  # pRSEM/Param.py:13
TRAINING_MIN_MAPPABILITY = 0.8  # pRSEM/Param.py:14
FLANKING_WIDTH = 500  # pRSEM/Param.py:15


def _single_isoform_candidates(coords: List[TrCoord],
                               min_gene_len: int) -> List[int]:
    by_gene: Dict[str, List[int]] = {}
    for i, c in enumerate(coords):
        by_gene.setdefault(c.gene_id, []).append(i)
    out = []
    for _, idxs in by_gene.items():
        if len(idxs) != 1:
            continue
        c = coords[idxs[0]]
        if c.end - c.start + 1 >= min_gene_len:
            out.append(idxs[0])
    return sorted(out)


def _by_chrom(coords: List[TrCoord]) -> Dict[str, List[int]]:
    by_chrom: Dict[str, List[int]] = {}
    for i, c in enumerate(coords):
        by_chrom.setdefault(c.chrom, []).append(i)
    return by_chrom


def _contained_in_other(s: np.ndarray, e: np.ndarray) -> np.ndarray:
    """[n] bool: interval k = [s[k], e[k]] lies within some other interval
    of the arrays. One sorted sweep: ordered by start, then end descending,
    every interval before k starts at or before s[k], so k is contained iff
    the running maximum of the ends before it reaches e[k], or the next
    interval is identical to it."""
    n = len(s)
    order = np.lexsort((-e, s))
    ss, es = s[order], e[order]
    before = np.full(n, np.iinfo(np.int64).min, dtype=np.int64)
    if n > 1:
        before[1:] = np.maximum.accumulate(es)[:-1]
    dom = before >= es
    dom[:-1] |= (ss[1:] == ss[:-1]) & (es[1:] == es[:-1])
    out = np.empty(n, dtype=bool)
    out[order] = dom
    return out


def _nested_within_other(coords: List[TrCoord], cand: List[int]) -> set:
    """Candidate indices whose [start,end] lies within another transcript's
    span on the same chromosome (strand ignored, transcripts of the same id
    excluded). A GTF that puts one transcript_id under two gene_ids gives
    two transcripts of that id (prepare-reference accepts it); a candidate
    whose id is shared so is checked against the others directly."""
    nested = set()
    by_chrom = _by_chrom(coords)
    for ch, cs in _by_chrom([coords[i] for i in cand]).items():
        idxs = by_chrom[ch]
        s = np.array([coords[j].start for j in idxs], dtype=np.int64)
        e = np.array([coords[j].end for j in idxs], dtype=np.int64)
        trids = [coords[j].trid for j in idxs]
        dup = _shared(trids)
        dom = _contained_in_other(s, e)
        pos = {j: k for k, j in enumerate(idxs)}
        for i in (cand[k] for k in cs):
            k = pos[i]
            if trids[k] in dup:
                other = np.array([t != trids[k] for t in trids])
                hit = bool(np.any(other & (s <= s[k]) & (e[k] <= e)))
            else:
                hit = bool(dom[k])
            if hit:
                nested.add(i)
    return nested


def _shared(trids: List[str]) -> set:
    seen, dup = set(), set()
    for t in trids:
        (dup if t in seen else seen).add(t)
    return dup


def _exons_all_covered(coords: List[TrCoord], cand: List[int]) -> set:
    """Candidate indices where every exon is contained in some exon of a
    transcript of another id on the same chromosome (strand ignored). One
    sweep over all the chromosome's exons; a candidate whose id is shared
    (see _nested_within_other) is checked against the others' exons
    directly. A transcript's exons must be sorted and disjoint, as
    prepare-reference --gtf merges them, so that none of its own exons can
    contain another."""
    covered = set()
    by_chrom = _by_chrom(coords)
    for ch, cs in _by_chrom([coords[i] for i in cand]).items():
        idxs = by_chrom[ch]
        trids = [coords[j].trid for j in idxs]
        dup = _shared(trids)
        n_ex = np.array([len(coords[j].exons) for j in idxs], dtype=np.int64)
        first = np.zeros(len(idxs) + 1, dtype=np.int64)
        np.cumsum(n_ex, out=first[1:])
        ex = np.array([x for j in idxs for x in coords[j].exons],
                      dtype=np.int64).reshape(-1, 2)
        owner = np.repeat(np.arange(len(idxs)), n_ex)
        clash = (owner[1:] == owner[:-1]) & (ex[1:, 0] <= ex[:-1, 1])
        if clash.any():
            raise ValueError(
                f"transcript {trids[owner[1:][clash][0]]} has overlapping or "
                "unsorted exons; pRSEM needs a reference built by "
                "prepare-reference --gtf")
        dom = _contained_in_other(ex[:, 0], ex[:, 1])
        pos = {j: k for k, j in enumerate(idxs)}
        for i in (cand[k] for k in cs):
            k = pos[i]
            if not n_ex[k]:
                continue
            own = ex[first[k]:first[k + 1]]
            if trids[k] in dup:
                other = np.array([trids[o] != trids[k] for o in owner])
                s, e = ex[other, 0], ex[other, 1]
                hit = all(np.any((s <= es) & (ee <= e)) for es, ee in own)
            else:
                hit = bool(dom[first[k]:first[k + 1]].all())
            if hit:
                covered.add(i)
    return covered


def _tss_region_conflicts(coords: List[TrCoord], cand: List[int],
                          flanking_width: int) -> set:
    """Candidate indices whose TSS window contains another transcript's TSS."""
    by_chrom: Dict[str, List[int]] = {}
    for i, c in enumerate(coords):
        by_chrom.setdefault(c.chrom, []).append(i)
    # per chromosome: TSS positions sorted, with the owning index alongside
    tss_sorted: Dict[str, tuple] = {}
    for ch, idxs in by_chrom.items():
        pos = np.array([coords[j].tss for j in idxs], dtype=np.int64)
        order = np.argsort(pos, kind="stable")
        tss_sorted[ch] = (pos[order], [idxs[k] for k in order])
    bad = set()
    for i in cand:
        c = coords[i]
        pos, owners = tss_sorted[c.chrom]
        lo = int(np.searchsorted(pos, c.tss - flanking_width, side="left"))
        hi = int(np.searchsorted(pos, c.tss + flanking_width, side="right"))
        for k in range(lo, hi):
            if coords[owners[k]].trid != c.trid:
                bad.add(i)
                break
    return bad


def select_training_set(
    coords: List[TrCoord],
    mappability: Mappability,
    min_gene_len: int = TRAINING_GENE_MIN_LEN,
    min_mpp: float = TRAINING_MIN_MAPPABILITY,
    flanking_width: int = FLANKING_WIDTH,
) -> List[int]:
    """Returns sorted indices (into coords) of training transcripts; fills
    tss/body/tes mappability on the single-isoform candidates as a side
    effect (NaN elsewhere, as in Prsem.py's all_tr_crd)."""
    cand = _single_isoform_candidates(coords, min_gene_len)
    fill_mappability([coords[i] for i in cand], mappability, flanking_width)
    cand = [
        i for i in cand
        if coords[i].tss_mpp > min_mpp
        and coords[i].body_mpp > min_mpp
        and coords[i].tes_mpp > min_mpp
    ]
    nested = _nested_within_other(coords, cand)
    cand = [i for i in cand if i not in nested]
    covered = _exons_all_covered(coords, cand)
    cand = [i for i in cand if i not in covered]
    conflicts = _tss_region_conflicts(coords, cand, flanking_width)
    return [i for i in cand if i not in conflicts]
