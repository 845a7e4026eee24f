"""GTF parsing (reference semantics: GTFItem.h, extractRef.cpp:132-216).

Only 'exon' features from trusted sources are kept; exons are grouped by
(gene_id, transcript_id) after a stable sort, and overlapping/adjacent exons
are merged into intervals.
"""

from __future__ import annotations

import re
from typing import Dict, List, Optional, Set

from .transcripts import Transcript, Transcripts

_ATTR_RE = re.compile(r'(\S+)\s+"([^"]*)"')


def _parse_attributes(left: str) -> Dict[str, str]:
    """Extract gene_id / transcript_id / gene_name / transcript_name from the
    attribute field.  Mirrors the reference's quote-aware ';' splitting
    (GTFItem.h parseAttributes); values must be double-quoted."""
    out: Dict[str, str] = {}
    # split on ';' not inside quotes
    depth = False
    start = 0
    parts: List[str] = []
    for i, ch in enumerate(left):
        if ch == '"':
            depth = not depth
        elif ch == ";" and not depth:
            parts.append(left[start:i])
            start = i + 1
    # reference requires a trailing ';' per attribute (get_an_attribute returns
    # False for the last unterminated chunk), so the tail is ignored.
    for part in parts:
        m = _ATTR_RE.match(part.strip())
        if m and m.group(1) in (
            "gene_id",
            "transcript_id",
            "gene_name",
            "transcript_name",
        ):
            out.setdefault(m.group(1), m.group(2))
    return out


class GTFExon:
    __slots__ = (
        "seqname",
        "source",
        "start",
        "end",
        "strand",
        "gene_id",
        "transcript_id",
        "gene_name",
        "transcript_name",
        "left",
    )

    def __init__(self, seqname, source, start, end, strand, attrs, left):
        self.seqname = seqname
        self.source = source
        self.start = start
        self.end = end
        self.strand = strand
        self.gene_id = attrs.get("gene_id", "")
        self.transcript_id = attrs.get("transcript_id", "")
        self.gene_name = attrs.get("gene_name", "")
        self.transcript_name = attrs.get("transcript_name", "")
        self.left = left


def parse_gtf(
    gtf_path: str,
    trusted_sources: Optional[Set[str]] = None,
    tid2gid: Optional[Dict[str, str]] = None,
) -> Transcripts:
    """Parse a GTF file into a sorted Transcripts collection (type 0).

    trusted_sources: if given, only exons whose source column is in the set
    are used (reference: extractRef.cpp isTrusted).
    tid2gid: optional transcript->gene map overriding gene_id attributes
    (--transcript-to-gene-map).
    """
    exons: List[GTFExon] = []
    with open(gtf_path) as f:
        for line in f:
            if line.startswith("#"):
                continue
            fields = line.rstrip("\n").split("\t")
            if len(fields) < 9:
                continue
            seqname, source, feature, start, end, _score, strand, _frame = fields[:8]
            left = fields[8]
            if feature != "exon":
                continue
            if trusted_sources and source not in trusted_sources:
                continue
            start_i, end_i = int(start), int(end)
            if start_i > end_i or start_i < 1:
                continue  # discarded with a warning in the reference
            if strand not in "+-":
                raise ValueError(f"GTF strand is neither '+' nor '-': {line!r}")
            attrs = _parse_attributes(left)
            if not attrs.get("gene_id") or not attrs.get("transcript_id"):
                raise ValueError(f"GTF line missing gene_id/transcript_id: {line!r}")
            if tid2gid is not None:
                tid = attrs["transcript_id"]
                if tid not in tid2gid:
                    raise ValueError(f"Mapping file lacks gene_id for {tid}")
                attrs["gene_id"] = tid2gid[tid]
            exons.append(
                GTFExon(seqname, source, start_i, end_i, strand, attrs, left)
            )

    # sort by (gene_id, transcript_id, start) like the reference's GTFItem <
    exons.sort(key=lambda e: (e.gene_id, e.transcript_id, e.start))

    ts = Transcripts(type=0)
    i, n = 0, len(exons)
    while i < n:
        j = i
        tid = exons[i].transcript_id
        while j < n and exons[j].transcript_id == tid:
            j += 1
        ts.add(_build_transcript(exons[i:j]))
        i = j
    if ts.M == 0:
        raise ValueError("The reference contains no transcripts!")
    return ts


def _build_transcript(group: List[GTFExon]) -> Transcript:
    """Merge a transcript's exons into intervals (reference:
    extractRef.cpp:89-130): adjacent/overlapping exons merge when
    next.start <= cur_end + 1."""
    first = group[0]
    gene_name, transcript_name = "", ""
    structure = []
    cur_s, cur_e = -1, -1
    for e in group:
        if e.strand != first.strand:
            raise ValueError(
                f"Transcript {first.transcript_id} has exons from different "
                "orientations!"
            )
        if e.seqname != first.seqname:
            raise ValueError(
                f"Transcript {first.transcript_id} has exons on multiple "
                "chromosomes!"
            )
        if e.gene_name:
            if not gene_name:
                gene_name = e.gene_name
            elif gene_name != e.gene_name:
                raise ValueError(
                    f"Transcript {first.transcript_id} is associated with "
                    "multiple gene names!"
                )
        if e.transcript_name:
            if not transcript_name:
                transcript_name = e.transcript_name
            elif transcript_name != e.transcript_name:
                raise ValueError(
                    f"Transcript {first.transcript_id} is associated with "
                    "multiple transcript names!"
                )
        if cur_e + 1 < e.start:
            if cur_s > 0:
                structure.append((cur_s, cur_e))
            cur_s = e.start
        cur_e = max(cur_e, e.end)
    if cur_s > 0:
        structure.append((cur_s, cur_e))

    return Transcript(
        transcript_id=first.transcript_id,
        gene_id=first.gene_id,
        seqname=first.seqname,
        strand=first.strand,
        structure=structure,
        left=first.left,
        transcript_name=transcript_name,
        gene_name=gene_name,
    )
