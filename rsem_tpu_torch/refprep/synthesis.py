"""Build a reference directly from transcript FASTA files.

Equivalent of rsem-synthesis-reference-transcripts (reference:
synthesisRef.cpp:30-227), including the allele-specific mode that emits
`.gt` (gene->transcript) and `.ta` (transcript->allele) group files.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Tuple

from ..utils.seq import canonicalize_genome
from .fasta import read_fasta
from .transcripts import Transcript, Transcripts


def synthesize_reference_transcripts(
    ref_name: str,
    fasta_paths: Iterable[str],
    tid2gid: Optional[Dict[str, str]] = None,
    allele_map: Optional[Dict[str, Tuple[str, str]]] = None,
) -> Tuple[Transcripts, List[str]]:
    """tid2gid: transcript->gene map (--transcript-to-gene-map);
    allele_map: allele->(gene, transcript) (--allele-to-gene-map).
    The FASTA header token is the sequence name (allele id in allele mode).
    Writes `.ti/.grp[/.gt/.ta]/.transcripts.fa`.
    """
    assert tid2gid is None or allele_map is None
    # type 1 = standalone transcript set, 2 = allele-specific
    # (reference: synthesisRef.cpp:24,156)
    ts = Transcripts(type=2 if allele_map is not None else 1)
    name2seq: Dict[str, str] = {}
    for path in fasta_paths:
        for tag, raw in read_fasta(path):
            seqname = tag.split()[0]
            seq = canonicalize_genome(raw)
            assert len(seq) > 0
            name2seq[seqname] = seq
            transcript_id = gene_id = seqname
            if allele_map is not None:
                if seqname not in allele_map:
                    raise ValueError(
                        f"Mapping info is not correct, cannot find allele "
                        f"{seqname}'s transcript_id!"
                    )
                gene_id, transcript_id = allele_map[seqname]
            elif tid2gid is not None:
                if seqname not in tid2gid:
                    raise ValueError(
                        f"Mapping info is not correct, cannot find "
                        f"{seqname}'s gene_id!"
                    )
                gene_id = tid2gid[seqname]
            ts.add(
                Transcript(
                    transcript_id=transcript_id,
                    gene_id=gene_id,
                    seqname=seqname,
                    strand="+",
                    structure=[(1, len(seq))],
                )
            )
    if ts.M < 1:
        raise ValueError("Number of transcripts in the reference is less than 1!")
    ts.sort()
    seqs = [name2seq[t.seqname] for t in ts.transcripts]

    from .extract import _write_common

    _write_common(ref_name, ts, seqs, chrlist=None)
    # transcripts.fa in this mode is keyed by seqname (synthesisRef.cpp:125-131)
    with open(f"{ref_name}.transcripts.fa", "w") as f:
        for tr, seq in zip(ts.transcripts, seqs):
            f.write(f">{tr.seqname}\n{seq}\n")

    if allele_map is not None:
        _write_allele_groups(ref_name, ts)
    return ts, seqs


def _write_allele_groups(ref_name: str, ts: Transcripts):
    """gt: per gene, start index into the ta array; ta: per distinct
    transcript, start sid (reference: synthesisRef.cpp:87-114)."""
    gt: List[int] = []
    ta: List[int] = []
    cur_gene = cur_tid = None
    for i, tr in enumerate(ts.transcripts, start=1):
        if tr.gene_id != cur_gene:
            gt.append(len(ta))
            cur_gene = tr.gene_id
        if tr.transcript_id != cur_tid:
            ta.append(i)
            cur_tid = tr.transcript_id
    gt.append(len(ta))
    ta.append(ts.M + 1)
    with open(f"{ref_name}.gt", "w") as f:
        for v in gt:
            f.write(f"{v}\n")
    with open(f"{ref_name}.ta", "w") as f:
        for v in ta:
            f.write(f"{v}\n")
