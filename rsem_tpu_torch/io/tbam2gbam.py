"""Transcript-coordinate BAM -> genome-coordinate BAM (rsem-tbam2gbam).

Behavioral parity with the reference converter (BamConverter.h,
sam_utils.h:137-208 tr2chr, bc_aux.h CollapseMap):

  - each alignment's transcript interval is mapped through the exon
    structure into a genome position + M/N cigar (polyA overhang -> I ops)
  - '-'-strand transcripts flip the strand flags, negate the insert size,
    reverse-complement SEQ, reverse QUAL, and reverse-complement the MD tag
  - XS:A:<strand> is (re)added iff the genome cigar contains an N gap
  - alignments of one read that land on identical genome coordinates
    (tid, pos, strand, cigar — both mates for paired) are collapsed,
    summing their ZW posteriors; MAPQ is recomputed from the summed weight
  - unmapped records pass through unchanged

The noise-isoform convention and file protocol are unchanged from the
reference driver (rsem-calculate-expression:650-652).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from ..refprep.transcripts import Transcript, Transcripts
from .bamio import (
    BamHeader,
    BamRec,
    BamRecWriter,
    FLAG_MATE_REVERSE,
    FLAG_REVERSE,
    open_rec_reader,
    prb_to_mapq,
)

_OP_M = 0
_OP_I = 1
_OP_N = 3


def tr2chr(tr: Transcript, sp: int, ep: int) -> Tuple[int, np.ndarray]:
    """Map 1-based inclusive transcript interval [sp, ep] (in the oriented,
    polyA-padded coordinate frame the aligner saw) to a 0-based genome
    position + cigar words (sam_utils.h:137-208)."""
    length = tr.length
    structure = tr.structure
    s = len(structure)
    ops: List[int] = []

    if tr.strand == "-":
        sp, ep = length - ep + 1, length - sp + 1

    if ep < 1 or sp > length:
        # read aligned entirely to the polyA tail
        pos = structure[-1][1] if sp > length else structure[0][0] - 1
        ops.append(((ep - sp + 1) << 4) | _OP_I)
        return pos, np.asarray(ops, dtype=np.uint32)

    if sp < 1:
        ops.append(((1 - sp) << 4) | _OP_I)
        sp = 1

    oldlen = curlen = 0
    i = 0
    for i in range(s):
        oldlen = curlen
        curlen += structure[i][1] - structure[i][0] + 1
        if curlen >= sp:
            break
    pos = structure[i][0] + (sp - oldlen - 1) - 1  # 0-based

    while curlen < ep and i < s:
        ops.append(((curlen - sp + 1) << 4) | _OP_M)
        i += 1
        if i >= s:
            continue
        ops.append(((structure[i][0] - structure[i - 1][1] - 1) << 4) | _OP_N)
        oldlen = curlen
        sp = oldlen + 1
        curlen += structure[i][1] - structure[i][0] + 1

    if i >= s:
        ops.append(((ep - length) << 4) | _OP_I)
    else:
        ops.append(((ep - sp + 1) << 4) | _OP_M)
    return pos, np.asarray(ops, dtype=np.uint32)


def _reverse_md(md: str) -> str:
    """Reverse-complement an MD:Z value (BamConverter.h:252-294): number
    runs stay intact, mismatch letters complement, ^-deletions keep the ^
    prefix, and the token order reverses."""
    comp = {"A": "T", "C": "G", "G": "C", "T": "A"}
    tokens: List[str] = []
    i = 0
    n = len(md)
    while i < n:
        if md[i].isdigit():
            j = i
            while j < n and md[j].isdigit():
                j += 1
            tokens.append(md[i:j])
            i = j
        else:
            j = i
            if md[j] == "^":
                j += 1
            while j < n and not md[j].isdigit():
                j += 1
            seg = md[i:j]
            if seg.startswith("^"):
                body = seg[1:]
                seg = "^" + "".join(comp.get(c, c) for c in reversed(body))
            else:
                seg = "".join(comp.get(c, c) for c in reversed(seg))
            tokens.append(seg)
            i = j
    return "".join(reversed(tokens))


def _convert(rec: BamRec, tr: Transcript, chr_tid: int):
    pos = rec.pos
    readlen = rec.l_seq
    if readlen <= 0:
        raise ValueError(
            f"Alignment for {rec.name} has SEQ '*'; cannot convert coordinates"
        )
    rec.tid = chr_tid
    if rec.is_paired:
        rec.mtid = chr_tid
    rec.mapq = 255

    if tr.strand == "-":
        rec.flag ^= FLAG_REVERSE
        if rec.is_paired:
            rec.flag ^= FLAG_MATE_REVERSE
            rec.tlen = -rec.tlen
        rec.reverse_complement()
        md = rec.get_tag("MD")
        if isinstance(md, str):
            rec.set_string_tag("MD", _reverse_md(md))

    new_pos, cigar = tr2chr(tr, pos + 1, pos + readlen)
    assert new_pos >= 0
    rec.pos = new_pos
    rec.cigar = cigar

    # XS:A tag iff spliced (BamConverter.h:296-303)
    rec.del_tag("XS")
    if any((int(v) & 0xF) == _OP_N for v in cigar):
        rec.set_char_tag("XS", tr.strand)


def _collapse_key(rec: BamRec) -> tuple:
    """bc_aux.h SingleEndT ordering: tid, pos, strand, cigar."""
    return (rec.tid, rec.pos, int(rec.is_rev), len(rec.cigar),
            tuple(int(v) for v in rec.cigar))


class _CollapseMap:
    def __init__(self):
        self.map: Dict[tuple, list] = {}

    def insert(self, b: BamRec, b2: Optional[BamRec], prb: float):
        key = _collapse_key(b)
        if b2 is not None:
            key = key + _collapse_key(b2)
        slot = self.map.get(key)
        if slot is None:
            self.map[key] = [b, b2, prb]
        else:
            slot[2] += prb

    def flush(self, out: BamRecWriter):
        """Records with a ZW tag get the summed weight + recomputed MAPQ;
        otherwise the original MAPQ is kept (BamConverter.h:199-216)."""
        for key in sorted(self.map):
            b, b2, prb = self.map[key]
            has_zw = b.find_tag("ZW") is not None
            if has_zw:
                b.set_float_tag("ZW", float(prb))
                b.mapq = prb_to_mapq(float(prb))
            out.write(b)
            if b2 is not None:
                if has_zw:
                    b2.set_float_tag("ZW", float(prb))
                    b2.mapq = b.mapq
                out.write(b2)
        self.map.clear()


def read_chrlist(path: str) -> Tuple[List[str], List[int]]:
    names: List[str] = []
    lens: List[int] = []
    with open(path) as f:
        for line in f:
            parts = line.split()
            if len(parts) >= 2:
                names.append(parts[0])
                lens.append(int(parts[1]))
    return names, lens


def tbam2gbam(
    reference_name: str,
    input_bam: str,
    output_bam: str,
    command: Optional[str] = None,
) -> int:
    """Convert a transcript BAM into genome coordinates. Returns #records."""
    ts = Transcripts.read_ti(f"{reference_name}.ti")
    if ts.type != 0:
        raise ValueError(
            "Genome information is not provided (reference was built from a "
            "transcript fasta); cannot convert the transcript BAM"
        )
    chr_names, chr_lens = read_chrlist(f"{reference_name}.chrlist")
    chr_map = {n: i for i, n in enumerate(chr_names)}

    reader = open_rec_reader(input_bam)
    in_header = reader.header
    # external tid -> internal transcript (Transcripts::buildMappings)
    name2sid = {t.transcript_id: sid for sid, t in
                enumerate(ts.transcripts, start=1)}
    e2i = [name2sid.get(n, 0) for n in in_header.target_names]

    header = BamHeader(in_header.text, in_header.target_names,
                       in_header.target_lens)
    header.replace_sq(chr_names, chr_lens)
    header.insert_pg("rsem-tbam2gbam", command)

    written = 0
    collapse = _CollapseMap()
    cqname = None
    with BamRecWriter(output_bam, header) as out:
        it = iter(reader)
        for rec in it:
            rec2 = None
            if rec.is_paired:
                rec2 = next(it)
                if not rec.is_read1:
                    rec, rec2 = rec2, rec
                if rec.is_mapped != rec2.is_mapped:
                    raise ValueError(
                        f"Read {rec.canonical_name}: partial alignments are "
                        "not supported"
                    )
            qname = rec.canonical_name
            if rec.is_mapped:
                if rec2 is not None and rec.tid != rec2.tid:
                    raise ValueError(
                        f"Read {qname}: mates aligned to different transcripts"
                    )
                sid = e2i[rec.tid]
                if sid == 0:
                    raise ValueError(
                        f"Unknown transcript {in_header.target_names[rec.tid]}"
                    )
                tr = ts.get(sid)
                chr_tid = chr_map[tr.seqname]
                _convert(rec, tr, chr_tid)
                if rec2 is not None:
                    _convert(rec2, tr, chr_tid)
                    rec.mpos = rec2.pos
                    rec2.mpos = rec.pos

                if qname != cqname:
                    written += _flush_count(collapse, out)
                    cqname = qname
                zw = rec.get_tag("ZW")
                collapse.insert(rec, rec2, float(zw) if zw is not None else 1.0)
            else:
                written += _flush_count(collapse, out)
                cqname = qname
                out.write(rec)
                written += 1
                if rec2 is not None:
                    out.write(rec2)
                    written += 1
        written += _flush_count(collapse, out)
    reader.close()
    return written


def _flush_count(collapse: _CollapseMap, out: BamRecWriter) -> int:
    n = sum(1 + (1 if v[1] is not None else 0) for v in collapse.map.values())
    collapse.flush(out)
    return n
