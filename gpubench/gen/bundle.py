"""The generated annotation and samples as the program's own input types.

`Reference`, `GroupInfo`, `AlignmentBundle` and `ModelSpec` are what the
port's calculate-expression holds once it has loaded the reference and
parsed a sample (`pipeline/calculate_expression.py`); the harness hands
these to the system under test. The plain reference never sees them: it
reads the raw arrays of `gen/synth.py`.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from rsem_tpu_torch.io.hits import CntStats, HitArrays
from rsem_tpu_torch.io.reads import PairedReadArrays, ReadArrays, ReadStats
from rsem_tpu_torch.io.sam import AlignmentBundle
from rsem_tpu_torch.model import ModelSpec
from rsem_tpu_torch.refprep.reference import Reference
from rsem_tpu_torch.refprep.transcripts import GroupInfo

from .synth import Annotation, RawSample

READ_TYPE = 3  # paired-end with qualities


def reference_of(ann: Annotation) -> Reference:
    """The .seq of the annotation: no poly(A) tails, so tot_len = full_len
    and nothing is masked."""
    ref = Reference.__new__(Reference)
    M = ann.M
    ref.names = [""] + [f"T{i + 1}" for i in range(M)]
    ref.full_len = np.concatenate([[0], ann.tlen]).astype(np.int64)
    ref.tot_len = ref.full_len.copy()
    ref.mask_start = ref.full_len.copy()
    ref.codes = ann.codes
    ref.offsets = np.concatenate([[0], ann.offsets]).astype(np.int64)
    return ref


def groups_of(ann: Annotation) -> GroupInfo:
    """The .grp of the annotation (gene -> isoforms)."""
    return GroupInfo(ann.gene_starts)


def spec_of(cfg: Dict) -> ModelSpec:
    """ModelSpec as calculate-expression builds it from the configuration's
    flags."""
    flags = cfg["rsem"]
    return ModelSpec(
        model_type=READ_TYPE, est_rspd=bool(flags["estimate_rspd"]),
        B=int(flags["num_rspd_bins"]), minL=int(flags["fragment_length_min"]),
        maxL=int(flags["fragment_length_max"]), mate_minL=1,
        mate_maxL=int(flags["fragment_length_max"]), mean=-1.0, sd=0.0,
        probF=float(cfg["forward_prob"]), seed_len=int(flags["seed_length"]),
        has_polya=False)


def _stats(d: Dict) -> ReadStats:
    st = ReadStats()
    st.len_counts = np.asarray(d["len_counts"], dtype=np.float64).copy()
    st.q_init = np.asarray(d["q_init"], dtype=np.float64).copy()
    st.q_tran = np.asarray(d["q_tran"], dtype=np.float64).copy()
    st.noise = np.asarray(d["noise"], dtype=np.float64).copy()
    st.n_reads = int(d["n_reads"])
    return st


def bundle_of(raw: RawSample, seed_len: int) -> AlignmentBundle:
    """The AlignmentBundle that ingest (`io.parse_alignments` and
    `finalize_cnt`) would return for the sample."""
    lq = np.zeros(raw.n1, dtype=bool)
    m1 = ReadArrays(raw.codes1, raw.lens, raw.quals1, lq)
    m2 = ReadArrays(raw.codes2, raw.lens.copy(), raw.quals2, lq.copy())
    reads = PairedReadArrays.build(m1, m2, seed_len)
    hits = HitArrays(raw.rid, raw.sid, raw.dir, raw.pos, raw.ins,
                     raw.offsets)
    n_iso_multi = sum(c for k, c in raw.hist.items() if k > 1)
    cnt = CntStats(N0=raw.n0, N1=raw.n1, N2=0,
                   n_unique=raw.n1 - raw.n_gene_multi,
                   n_multi=raw.n_gene_multi, n_iso_multi=n_iso_multi,
                   n_hits=raw.n_hits, read_type=READ_TYPE,
                   hist=dict(raw.hist))
    stats = {c: _stats(raw.stats[c]) for c in range(3)}
    return AlignmentBundle(READ_TYPE, reads, hits, stats, cnt,
                           np.zeros(0, dtype=np.int64))
