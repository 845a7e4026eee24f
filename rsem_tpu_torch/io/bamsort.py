"""BAM sorting + BAI indexing (the `samtools sort` / `samtools index` the
reference driver shells out to, rsem-calculate-expression:655-670).

Coordinate sort: (tid, pos), unmapped (tid=-1) records last — samtools order.
Name sort: samtools' strnum_cmp "natural" comparison (digit runs compare
numerically), ties broken by the FLAG read1/read2 bits. That tie-break
puts all read-1 records of a multi-mapped pair before its read-2 records,
which the alignment parser rejects (mates must be adjacent); with
keep_pairs=True the ties are broken by alignment instead: each pair's two
records stay together (read 1 first), the pairs of one name in input order.

The BAI index follows SAM spec §5.2 (UCSC binning + 16kb linear index) and is
readable by htslib/IGV.
"""

from __future__ import annotations

import re
import struct
from typing import List, Optional, Tuple

import numpy as np

from .bamio import BamRec, BamRecReader, BamRecWriter, BgzfWriter, open_rec_reader, reg2bin

_NUM_RE = re.compile(r"(\d+)")


def strnum_key(name: str):
    """samtools strnum_cmp-compatible sort key."""
    parts = _NUM_RE.split(name)
    key = []
    for i, p in enumerate(parts):
        if not p:
            continue
        if i % 2:  # digit run
            key.append((1, len(p.lstrip("0")) or 0, p.lstrip("0") or "0", p))
        else:
            key.append((0, p))
    return tuple(key)


def pair_units(names: List[str], flags: List[int], tids: List[int],
               poss: List[int], mtids: List[int], mposs: List[int]
               ) -> List[int]:
    """Per record, the input index of the first record of its alignment:
    a paired record and its mate (same name, mate fields pointing at each
    other, the other read-1/read-2 bit) share one; any other record is its
    own. Mates need not be adjacent; identical pairs match in input order."""
    unit = list(range(len(names)))
    waiting: dict = {}
    for i, f in enumerate(flags):
        if not f & 0x1:
            continue
        mate = (names[i], mtids[i], mposs[i], tids[i], poss[i],
                (f & 0xC0) ^ 0xC0)
        queue = waiting.get(mate)
        if queue:
            unit[i] = queue.pop(0)
        else:
            key = (names[i], tids[i], poss[i], mtids[i], mposs[i], f & 0xC0)
            waiting.setdefault(key, []).append(i)
    return unit


def sort_bam(
    input_bam: str,
    output_bam: str,
    by: str = "coordinate",
    build_index: bool = False,
    keep_pairs: bool = False,
) -> Optional[str]:
    """Sort a BAM; optionally write `<output_bam>.bai` (coordinate only).
    keep_pairs (name sort only): keep each alignment's mates adjacent.

    In-memory sort: records are kept as raw encoded blobs, so sorting N
    records costs one argsort + one streaming write.
    """
    reader = open_rec_reader(input_bam)
    header = reader.header

    blobs: List[bytes] = []
    tids: List[int] = []
    poss: List[int] = []
    ends: List[int] = []
    names: List[str] = []
    flags: List[int] = []
    mates: List[Tuple[int, int]] = []
    for rec in reader:
        blobs.append(rec.encode())
        tids.append(rec.tid if rec.tid >= 0 else 2**31 - 1)
        poss.append(rec.pos)
        ends.append(rec.end_pos() if rec.is_mapped else rec.pos + 1)
        names.append(rec.canonical_name)
        flags.append(rec.flag)
        mates.append((rec.mtid if rec.mtid >= 0 else 2**31 - 1, rec.mpos))
    reader.close()

    n = len(blobs)
    if by == "coordinate":
        order = np.lexsort((np.asarray(poss), np.asarray(tids)))
    elif by == "name" and keep_pairs:
        unit = pair_units(names, flags, tids, poss, [m[0] for m in mates],
                          [m[1] for m in mates])
        order = sorted(range(n), key=lambda i: (
            strnum_key(names[i]), unit[i], flags[i] & 0xC0))
        order = np.asarray(order, dtype=np.int64)
    elif by == "name":
        order = sorted(
            range(n), key=lambda i: (strnum_key(names[i]), flags[i] & 0xC0)
        )
        order = np.asarray(order, dtype=np.int64)
    else:
        raise ValueError(f"unknown sort order {by!r}")

    # annotate @HD SO:
    so = "coordinate" if by == "coordinate" else "queryname"
    lines = header.text.splitlines()
    if lines and lines[0].startswith("@HD"):
        fields = [f for f in lines[0].split("\t") if not f.startswith("SO:")]
        lines[0] = "\t".join(fields + [f"SO:{so}"])
    else:
        lines.insert(0, f"@HD\tVN:1.4\tSO:{so}")
    header.text = "\n".join(lines) + "\n"

    index = _BaiBuilder(len(header.target_names)) if (
        build_index and by == "coordinate"
    ) else None

    writer = BamRecWriter(output_bam, header)
    for i in order:
        i = int(i)
        vbeg = writer.tell_virtual()
        writer.write_raw(blobs[i])
        vend = writer.tell_virtual()
        if index is not None:
            tid = tids[i]
            if tid == 2**31 - 1:
                index.add_unmapped()
            else:
                index.add(tid, poss[i], ends[i], vbeg, vend)
    writer.close()

    if index is not None:
        bai_path = output_bam + ".bai"
        index.write(bai_path)
        return bai_path
    return None


class _BaiBuilder:
    def __init__(self, n_ref: int):
        self.n_ref = n_ref
        self.bins: List[dict] = [dict() for _ in range(n_ref)]
        self.linear: List[dict] = [dict() for _ in range(n_ref)]
        self.n_no_coor = 0

    def add(self, tid: int, beg: int, end: int, vbeg: int, vend: int):
        b = reg2bin(beg, end)
        chunks = self.bins[tid].setdefault(b, [])
        if chunks and chunks[-1][1] == vbeg:
            chunks[-1] = (chunks[-1][0], vend)
        else:
            chunks.append((vbeg, vend))
        lin = self.linear[tid]
        for win in range(beg >> 14, ((max(end, beg + 1) - 1) >> 14) + 1):
            if win not in lin or vbeg < lin[win]:
                lin[win] = vbeg

    def add_unmapped(self):
        self.n_no_coor += 1

    def write(self, path: str):
        with open(path, "wb") as f:
            f.write(b"BAI\x01" + struct.pack("<i", self.n_ref))
            for tid in range(self.n_ref):
                bins = self.bins[tid]
                f.write(struct.pack("<i", len(bins)))
                for b in sorted(bins):
                    chunks = bins[b]
                    f.write(struct.pack("<Ii", b, len(chunks)))
                    for vbeg, vend in chunks:
                        f.write(struct.pack("<QQ", vbeg, vend))
                lin = self.linear[tid]
                n_intv = (max(lin) + 1) if lin else 0
                f.write(struct.pack("<i", n_intv))
                filled = 0
                for win in range(n_intv):
                    if win in lin:
                        filled = lin[win]
                    f.write(struct.pack("<Q", lin.get(win, filled)))
            f.write(struct.pack("<Q", self.n_no_coor))
