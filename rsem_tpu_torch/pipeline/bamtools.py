"""Alignment-file utilities: rsem-get-unique, rsem-sam-validator,
rsem-scan-for-paired-end-reads, convert-sam-for-rsem.

Behavioral parity with the reference executables (getUnique.cpp,
samValidator.cpp, scanForPairedEndReads.cpp, convert-sam-for-rsem); built on
this framework's own BAM codec instead of htslib.
"""

from __future__ import annotations

import os
import sys
from typing import List, Optional

from ..io.bamio import (
    BamRec,
    BamRecWriter,
    FLAG_READ1,
    FLAG_READ2,
    FLAG_REVERSE,
    open_rec_reader,
)
from ..io.bamsort import sort_bam

_FLAG_PROPER = 0x2


# --------------------------------------------------------------------- #
# rsem-get-unique (getUnique.cpp)                                        #
# --------------------------------------------------------------------- #
def get_unique(input_path: str, output_path: str) -> int:
    """Keep only reads with exactly one (pair of) aligned record(s); any
    read with an unaligned record is dropped too. Returns #records kept."""
    reader = open_rec_reader(input_path)
    written = 0
    with BamRecWriter(output_path, reader.header) as out:
        group: List[BamRec] = []
        unaligned = False
        cqname = None

        def flush():
            nonlocal written
            if unaligned or not group:
                return
            paired = group[0].is_paired
            if (paired and len(group) != 2) or (not paired and len(group) != 1):
                return
            for r in group:
                out.write(r)
                written += 1

        for rec in reader:
            if rec.name != cqname:
                flush()
                cqname = rec.name
                group = []
                unaligned = False
            unaligned = unaligned or not rec.is_mapped
            group.append(rec)
        flush()
    reader.close()
    return written


# --------------------------------------------------------------------- #
# rsem-sam-validator (samValidator.cpp)                                  #
# --------------------------------------------------------------------- #
def _check_read(rec: BamRec, target_lens, log) -> bool:
    for ln, op in rec.cigar_ops():
        if op == "N":
            log(f"Skipped region is detected (cigar N) for read {rec.name}! "
                "Align reads to a set of transcript sequences, not a genome.")
            return False
        if op in "ID":
            log(f"Indel alignment is detected (cigar {op}) for read "
                f"{rec.name}! Indel alignments are not supported.")
            return False
        if op in "SHP":
            log(f"Clipping or padding is detected (cigar {op}) for read "
                f"{rec.name}! Clipping/padding is not supported.")
            return False
    if rec.pos < 0 or rec.end_pos() > target_lens[rec.tid]:
        log(f"Read {rec.name} aligns to [{rec.pos}, {rec.end_pos()}) of a "
            f"transcript of length {target_lens[rec.tid]}, exceeding its "
            "boundary!")
        return False
    return True


def validate_alignments(input_path: str, log=print) -> bool:
    """Full rule set of samValidator.cpp:26-185."""
    reader = open_rec_reader(input_path)
    lens = reader.header.target_lens
    used = set()
    cqname = None
    creadlen = creadlen2 = None
    ispaired: Optional[bool] = None

    it = iter(reader)
    for rec in it:
        qname = rec.canonical_name
        if ispaired is None:
            ispaired = rec.is_paired
        elif ispaired != rec.is_paired:
            log("Both single-end and paired-end reads detected! A mixture is "
                "not supported.")
            return False

        if ispaired:
            try:
                rec2 = next(it)
            except StopIteration:
                log(f"Only one mate found for paired-end read {qname}!")
                return False
            if rec2.canonical_name != qname or not rec2.is_paired:
                log(f"Only one mate found for paired-end read {qname}! Mates "
                    "must be adjacent.")
                return False
            if not ((rec.is_read1 and rec2.is_read2) or
                    (rec2.is_read1 and rec.is_read2)):
                log(f"The two mates of read {qname} are both marked as the "
                    "same mate!")
                return False
            nmapped = int(rec.is_mapped) + int(rec2.is_mapped)
            if nmapped == 1:
                log(f"Paired-end read {qname} has an alignment with only one "
                    "mate aligned! Mixed alignments are not supported.")
                return False
            if not rec.is_read1:
                rec, rec2 = rec2, rec
            if nmapped == 2:
                if rec.tid != rec2.tid:
                    log(f"Paired-end read {qname} has a discordant alignment!")
                    return False
                strandedness = (int(rec.is_rev) << 1) + int(rec2.is_rev)
                if strandedness not in (1, 2):
                    log(f"Paired-end read {qname} has both mates on the same "
                        "strand!")
                    return False
                tb = rec if rec.pos < rec2.pos else rec2
                if tb.pos < 0 or tb.pos + abs(tb.tlen) > lens[tb.tid]:
                    log(f"Paired-end read {qname} exceeds the transcript's "
                        "boundary!")
                    return False
                if not _check_read(rec, lens, log):
                    return False
                if not _check_read(rec2, lens, log):
                    return False
            readlen, readlen2 = rec.l_seq, rec2.l_seq
        else:
            if rec.is_mapped and not _check_read(rec, lens, log):
                return False
            readlen, readlen2 = rec.l_seq, None

        if cqname != qname:
            if qname in used:
                log(f"The alignments of read {qname} are not grouped "
                    "together!")
                return False
            if cqname is not None:
                used.add(cqname)
            cqname = qname
            creadlen, creadlen2 = readlen, readlen2
        else:
            if creadlen != readlen or (ispaired and creadlen2 != readlen2):
                log(f"Read {qname} has alignments showing different "
                    "read/mate lengths!")
                return False
    reader.close()
    return True


# --------------------------------------------------------------------- #
# rsem-scan-for-paired-end-reads (scanForPairedEndReads.cpp)             #
# --------------------------------------------------------------------- #
def _pattern_code(flag: int) -> int:
    if flag & FLAG_READ1:
        return 1 if (flag & FLAG_REVERSE) else 0
    return 0 if (flag & FLAG_REVERSE) else 1


def _pe_sort_key(r: BamRec):
    p1 = min(r.pos, r.mpos)
    p2 = max(r.pos, r.mpos)
    return (r.tid, p1, p2, _pattern_code(r.flag))


def scan_for_paired_end_reads(input_path: str, output_path: str) -> int:
    """Reorder a name-grouped file so the two mates of each alignment are
    adjacent with mate1 first. Returns #records written."""
    reader = open_rec_reader(input_path)
    written = 0
    with BamRecWriter(output_path, reader.header) as out:
        it = iter(reader)
        rec = next(it, None)
        while rec is not None:
            qname = rec.canonical_name
            if rec.is_paired:
                both: List[BamRec] = []
                partial_1: List[BamRec] = []
                partial_2: List[BamRec] = []
                partial_unknown: List[BamRec] = []

                def add(r: BamRec):
                    if r.is_mapped and (r.flag & _FLAG_PROPER):
                        both.append(r)
                    elif r.is_read1:
                        partial_1.append(r)
                    elif r.is_read2:
                        partial_2.append(r)
                    else:
                        partial_unknown.append(r)

                add(rec)
                rec = next(it, None)
                while rec is not None and rec.canonical_name == qname:
                    if not rec.is_paired:
                        raise ValueError(
                            f"Read {qname} is detected as both single-end "
                            "and paired-end!"
                        )
                    add(rec)
                    rec = next(it, None)

                if len(both) % 2 != 0:
                    raise ValueError(
                        f"Unmatched mates in read {qname}'s full alignments!"
                    )
                if (len(partial_1) + len(partial_2) +
                        len(partial_unknown)) % 2 != 0:
                    raise ValueError(
                        f"Unmatched mates in read {qname}'s partial "
                        "alignments!"
                    )
                both.sort(key=_pe_sort_key)
                for r in both:
                    out.write(r)
                    written += 1
                while partial_1 or partial_2:
                    if partial_1 and partial_2:
                        out.write(partial_1.pop())
                        out.write(partial_2.pop())
                    elif partial_1:
                        out.write(partial_1.pop())
                        out.write(partial_unknown.pop())
                    else:
                        out.write(partial_2.pop())
                        out.write(partial_unknown.pop())
                    written += 2
                while partial_unknown:
                    out.write(partial_unknown.pop())
                    written += 1
            else:
                out.write(rec)
                written += 1
                rec = next(it, None)
                while rec is not None and rec.canonical_name == qname:
                    out.write(rec)
                    written += 1
                    rec = next(it, None)
    reader.close()
    return written


# --------------------------------------------------------------------- #
# convert-sam-for-rsem (Perl driver)                                     #
# --------------------------------------------------------------------- #
def convert_sam_for_rsem(input_path: str, output_name: str,
                         log=print) -> str:
    """Name-sort, regroup mates, validate — the reference's
    convert-sam-for-rsem pipeline. Returns the output BAM path."""
    out_bam = f"{output_name}.bam"
    tmp = f"{output_name}.namesorted.bam"
    sort_bam(input_path, tmp, by="name")
    scan_for_paired_end_reads(tmp, out_bam)
    os.remove(tmp)
    if not validate_alignments(out_bam, log=log):
        raise ValueError(f"Converted file {out_bam} is still not valid!")
    return out_bam
