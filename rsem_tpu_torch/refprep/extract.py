"""Extract transcript sequences from a genome using a GTF annotation.

Equivalent of rsem-extract-reference-transcripts (reference:
extractRef.cpp:132-376): parse the GTF, splice exon intervals out of the
genome FASTA files, drop transcripts whose chromosome is absent, and emit
`.ti`, `.grp`, `.chrlist` and `.transcripts.fa`.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Set, Tuple

from ..utils.seq import canonicalize_genome
from .fasta import read_fasta
from .gtf import parse_gtf
from .transcripts import Transcripts


def load_transcript_to_gene_map(path: str) -> Dict[str, str]:
    """Each non-comment line: `gene_id transcript_id`
    (reference: extractRef.cpp loadMappingInfo)."""
    out: Dict[str, str] = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split()
            out[parts[1]] = parts[0]
    return out


def load_allele_to_gene_map(path: str) -> Dict[str, Tuple[str, str]]:
    """Each line: `gene_id transcript_id allele_id` -> allele_id maps to
    (gene_id, transcript_id) (reference: synthesisRef.cpp:55-65)."""
    out: Dict[str, Tuple[str, str]] = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            g, t, a = line.split()[:3]
            out[a] = (g, t)
    return out


def extract_reference_transcripts(
    ref_name: str,
    gtf_path: str,
    genome_fastas: Iterable[str],
    trusted_sources: Optional[Set[str]] = None,
    tid2gid: Optional[Dict[str, str]] = None,
) -> Tuple[Transcripts, List[str]]:
    """Run the full extraction; writes `.ti/.grp/.chrlist/.transcripts.fa`
    rooted at ref_name. Returns (transcripts, sequences list, 0-indexed).
    """
    ts = parse_gtf(gtf_path, trusted_sources, tid2gid)
    ts.sort()

    # map seqname -> list of 0-based transcript indices
    sn2tr: Dict[str, List[int]] = {}
    for idx, tr in enumerate(ts.transcripts):
        sn2tr.setdefault(tr.seqname, []).append(idx)

    seqs: List[str] = [""] * ts.M
    chrlist: List[Tuple[str, int]] = []
    for path in genome_fastas:
        for tag, raw in read_fasta(path):
            seqname = tag.split()[0]
            if seqname not in sn2tr:
                continue
            genome = canonicalize_genome(raw)
            chrlist.append((seqname, len(genome)))
            for idx in sn2tr[seqname]:
                seqs[idx] = ts.transcripts[idx].extract_seq(genome)
    chrlist.sort()

    # shrink: drop transcripts with absent chromosomes (extractRef.cpp:218-254)
    keep = [i for i, s in enumerate(seqs) if s != ""]
    if len(keep) < ts.M:
        import sys

        dropped = ts.M - len(keep)
        print(
            f"Warning: {dropped} transcripts failed to extract because their "
            "chromosome sequences are absent.",
            file=sys.stderr,
        )
    ts.transcripts = [ts.transcripts[i] for i in keep]
    seqs = [seqs[i] for i in keep]
    if ts.M == 0:
        raise ValueError("The reference contains no transcripts!")

    _write_common(ref_name, ts, seqs, chrlist)
    return ts, seqs


def _write_common(ref_name, ts: Transcripts, seqs, chrlist=None):
    from .transcripts import GroupInfo

    GroupInfo(ts.gene_group_starts()).write(f"{ref_name}.grp")
    ts.write_ti(f"{ref_name}.ti")
    if chrlist is not None:
        with open(f"{ref_name}.chrlist", "w") as f:
            for name, ln in chrlist:
                f.write(f"{name}\t{ln}\n")
    with open(f"{ref_name}.transcripts.fa", "w") as f:
        for tr, seq in zip(ts.transcripts, seqs):
            f.write(f">{tr.transcript_id}\n{seq}\n")
