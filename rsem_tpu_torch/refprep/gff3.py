"""GFF3 -> GTF conversion (reference semantics: rsem-gff3-to-gtf).

Feature types are bucketed into gene / transcript / exon classes; exon rows
attach to every Parent; overlapping or adjacent intervals are merged; output is
one GTF `exon` row per merged interval carrying gene_id/transcript_id (and
names when available).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Set, Tuple

TYPE_GENE = {
    "gene", "snRNA_gene", "transposable_element_gene", "ncRNA_gene",
    "telomerase_RNA_gene", "rRNA_gene", "tRNA_gene", "snoRNA_gene", "mt_gene",
    "miRNA_gene", "lincRNA_gene", "RNA", "VD_gene_segment",
}
TYPE_TRANSCRIPT = {
    "transcript", "primary_transcript", "mRNA", "ncRNA", "tRNA", "rRNA",
    "snRNA", "snoRNA", "miRNA", "pseudogenic_transcript", "lincRNA",
    "NMD_transcript_variant", "aberrant_processed_transcript",
    "nc_primary_transcript", "processed_pseudogene", "mRNA_TE_gene",
}
TYPE_EXON = {
    "exon", "CDS", "five_prime_UTR", "three_prime_UTR", "UTR",
    "noncoding_exon", "pseudogenic_exon",
}
# Either gene or transcript depending on whether a Parent is present.
TYPE_EITHER = {
    "pseudogene", "V_gene_segment", "C_gene_segment", "J_gene_segment",
    "processed_transcript",
}


class _Tx:
    __slots__ = ("tid", "gid", "tname", "ttype", "source", "seqid", "strand",
                 "set_t", "intervals")

    def __init__(self, tid: str, seqid: str, strand: str):
        self.tid = tid
        self.gid: Optional[str] = None
        self.tname: Optional[str] = None
        self.ttype: Optional[str] = None
        self.source: Optional[str] = None
        self.seqid = seqid
        self.strand = strand
        self.set_t = False
        self.intervals: List[Tuple[int, int]] = []


def _parse_attrs(raw: str, line_no: int) -> Dict[str, object]:
    raw = raw[:-1] if raw.endswith(";") else raw
    out: Dict[str, object] = {}
    for attribute in raw.split(";"):
        fields = attribute.split("=")
        if len(fields) != 2:
            raise ValueError(
                f"Fail to parse attribute {attribute!r} at GFF3 line {line_no}"
            )
        tag, value = fields
        out[tag] = value.split(",") if tag == "Parent" else value
    return out


def _merge(intervals: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    intervals = sorted(intervals)
    merged = [intervals[0]]
    for start, end in intervals[1:]:
        cs, ce = merged[-1]
        if ce + 1 >= start:
            merged[-1] = (cs, max(ce, end))
        else:
            merged.append((start, end))
    return merged


def gff3_to_gtf(
    gff3_path: str,
    gtf_path: str,
    rna_patterns: str = "mRNA",
    genes_as_transcripts: bool = False,
) -> int:
    """Convert; returns number of transcripts written."""
    patterns: Set[str] = set(rna_patterns.split(",")) if rna_patterns else set()
    gid2gname: Dict[str, Optional[str]] = {}
    tid2pos: Dict[str, int] = {}
    transcripts: List[_Tx] = []
    num_trans = 0

    def get_tx(tid: str, seqid: str, strand: str, line_no: int) -> _Tx:
        pos = tid2pos.get(tid)
        if pos is None:
            tx = _Tx(tid, seqid, strand)
            tid2pos[tid] = len(transcripts)
            transcripts.append(tx)
            return tx
        if pos < 0:
            raise ValueError(
                f"GFF3 line {line_no} describes already-flushed transcript {tid}"
            )
        tx = transcripts[pos]
        if tx.seqid != seqid or tx.strand != strand:
            raise ValueError(
                f"GFF3 line {line_no}: seqid/strand inconsistent for {tid}"
            )
        return tx

    with open(gff3_path) as fin, open(gtf_path, "w") as fout:

        def flush():
            nonlocal num_trans, transcripts
            for tx in transcripts:
                tid2pos[tx.tid] = -1
                if (not tx.set_t or not tx.intervals
                        or (patterns and tx.ttype not in patterns)):
                    continue
                if tx.gid not in gid2gname:
                    raise ValueError(
                        f"Cannot recognize transcript {tx.tid}'s parent "
                        f"{tx.gid}; a gene feature might be missing."
                    )
                gname = gid2gname[tx.gid]
                attrs = f'gene_id "{tx.gid}"; transcript_id "{tx.tid}";'
                if gname is not None:
                    attrs += f' gene_name "{gname}";'
                if tx.tname is not None:
                    attrs += f' transcript_name "{tx.tname}";'
                for start, end in _merge(tx.intervals):
                    fout.write(
                        f"{tx.seqid}\t{tx.source}\texon\t{start}\t{end}\t.\t"
                        f"{tx.strand}\t.\t{attrs}\n"
                    )
                num_trans += 1
            transcripts = []

        line_no = 0
        for line in fin:
            line = line.strip()
            line_no += 1
            if line.startswith("##FASTA"):
                break
            if line.startswith("###"):
                flush()
                continue
            if line.startswith("#"):
                continue
            fields = line.split("\t")
            if len(fields) != 9:
                raise ValueError(f"GFF3 line {line_no} does not have 9 fields")
            seqid, source, otype = fields[0], fields[1], fields[2]
            start, end, strand = int(fields[3]), int(fields[4]), fields[6]

            if otype in TYPE_GENE:
                ftype = "gene"
            elif otype in TYPE_TRANSCRIPT:
                ftype = "transcript"
            elif otype in TYPE_EXON:
                ftype = "exon"
            elif otype in TYPE_EITHER:
                ftype = "either"
            else:
                continue
            attrs = _parse_attrs(fields[8], line_no)

            if ftype == "either":
                ftype = "transcript" if attrs.get("Parent") else "gene"

            if ftype == "gene":
                gid = attrs.get("ID")
                if gid is None:
                    raise ValueError(f"GFF3 line {line_no} lacks ID")
                if gid in gid2gname:
                    raise ValueError(f"Gene {gid} appears multiple times!")
                gid2gname[gid] = attrs.get("Name")
                if genes_as_transcripts:
                    ftype, otype = "transcript", "transcript"
                    attrs["Parent"] = [gid]

            if ftype == "transcript":
                tid = attrs.get("ID")
                if tid is None:
                    raise ValueError(f"GFF3 line {line_no} lacks ID")
                tx = get_tx(tid, seqid, strand, line_no)
                if tx.set_t:
                    raise ValueError(f"Transcript {tid} appears multiple times!")
                tx.set_t = True
                parents = attrs.get("Parent")
                if not parents or len(parents) != 1:
                    raise ValueError(
                        f"Transcript {tid} must have exactly one Parent"
                    )
                tx.gid = parents[0]
                tx.tname = attrs.get("Name")
                tx.ttype = otype
                tx.source = source

            if ftype == "exon":
                parents = attrs.get("Parent")
                if not parents:
                    raise ValueError(f"GFF3 line {line_no}: exon lacks Parent")
                for parent in parents:
                    get_tx(parent, seqid, strand, line_no).intervals.append(
                        (start, end)
                    )

        flush()
    return num_trans
