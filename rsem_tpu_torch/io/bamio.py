"""BAM record + BGZF machinery: lossless record passthrough and writing.

This framework writes its own BAM (the reference links htslib for
BamWriter.h / BamConverter.h / samtools sort+index). Records are kept as raw
field bundles (`BamRec`) so posterior writeback only patches MAPQ + ZW and
everything else round-trips byte-identically.

Reference semantics mirrored here:
  - ZW float tag + MAPQ from posterior: BamWriter.h:39-48, sam_utils.h:72-76
  - BGZF framing: htslib spec (SAMv1); EOF marker block required by samtools
  - bin computation: hts_reg2bin (BamConverter.h:189)
"""

from __future__ import annotations

import gzip
import struct
from dataclasses import dataclass, field
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

_CIGAR_OPS = "MIDNSHP=X"
_CIGAR_OP2IDX = {op: i for i, op in enumerate(_CIGAR_OPS)}

# SEQ nibble alphabet "=ACMGRSVTWYHKDBN"
_SEQ_ALPHABET = "=ACMGRSVTWYHKDBN"
_CHAR2NIB = np.zeros(256, dtype=np.uint8)
_CHAR2NIB[:] = 15  # default N
for _i, _c in enumerate(_SEQ_ALPHABET):
    _CHAR2NIB[ord(_c)] = _i
    _CHAR2NIB[ord(_c.lower())] = _i
_NIB2CHAR = np.frombuffer(_SEQ_ALPHABET.encode(), dtype=np.uint8)
# complement in nibble space: A<->T, C<->G, N->N (BamConverter.h:222-233)
_NIB_COMPL = np.arange(16, dtype=np.uint8)
for _a, _b in ((1, 8), (2, 4)):
    _NIB_COMPL[_a], _NIB_COMPL[_b] = _b, _a

FLAG_PAIRED = 0x1
FLAG_UNMAPPED = 0x4
FLAG_MATE_UNMAPPED = 0x8
FLAG_REVERSE = 0x10
FLAG_MATE_REVERSE = 0x20
FLAG_READ1 = 0x40
FLAG_READ2 = 0x80


def reg2bin(beg: int, end: int) -> int:
    """UCSC binning (SAM spec 5.3); end is 0-based exclusive."""
    end -= 1
    if beg >> 14 == end >> 14:
        return ((1 << 15) - 1) // 7 + (beg >> 14)
    if beg >> 17 == end >> 17:
        return ((1 << 12) - 1) // 7 + (beg >> 17)
    if beg >> 20 == end >> 20:
        return ((1 << 9) - 1) // 7 + (beg >> 20)
    if beg >> 23 == end >> 23:
        return ((1 << 6) - 1) // 7 + (beg >> 23)
    if beg >> 26 == end >> 26:
        return ((1 << 3) - 1) // 7 + (beg >> 26)
    return 0


def prb_to_mapq(val: float) -> int:
    """sam_utils.h:72-76."""
    err = 1.0 - val
    if err <= 1e-10:
        return 100
    return int(-10.0 * np.log10(err) + 0.5) & 0xFF


@dataclass
class BamRec:
    """One alignment record with every BAM field preserved."""

    name: str
    flag: int
    tid: int
    pos: int
    mapq: int
    cigar: np.ndarray  # uint32 (len<<4 | op)
    mtid: int
    mpos: int
    tlen: int
    l_seq: int
    seq: bytes  # packed nibbles, (l_seq+1)//2 bytes
    qual: bytes  # l_seq bytes (0xFF.. if '*')
    aux: bytes

    # ---- flags -------------------------------------------------------
    @property
    def is_paired(self) -> bool:
        return bool(self.flag & FLAG_PAIRED)

    @property
    def is_mapped(self) -> bool:
        return not (self.flag & FLAG_UNMAPPED)

    @property
    def is_rev(self) -> bool:
        return bool(self.flag & FLAG_REVERSE)

    @property
    def is_read1(self) -> bool:
        return bool(self.flag & FLAG_READ1)

    @property
    def is_read2(self) -> bool:
        return bool(self.flag & FLAG_READ2)

    @property
    def canonical_name(self) -> str:
        for i, ch in enumerate(self.name):
            if ch in " \t":
                return self.name[:i]
        return self.name

    # ---- cigar -------------------------------------------------------
    def cigar_ops(self) -> Iterator[Tuple[int, str]]:
        for v in self.cigar:
            yield int(v) >> 4, _CIGAR_OPS[int(v) & 0xF]

    def reference_span(self) -> int:
        """Bases consumed on the reference (M/D/N/=/X)."""
        span = 0
        for ln, op in self.cigar_ops():
            if op in "MDN=X":
                span += ln
        return span

    def end_pos(self) -> int:
        """0-based exclusive reference end."""
        return self.pos + max(self.reference_span(), 1)

    # ---- aux tags ----------------------------------------------------
    def find_tag(self, tag: str) -> Optional[Tuple[int, str, int, int]]:
        """Return (tag_start, type_char, value_offset, tag_end) in aux."""
        data = self.aux
        off = 0
        end = len(data)
        want = tag.encode()
        while off + 3 <= end:
            start = off
            t = data[off : off + 2]
            typ = chr(data[off + 2])
            off += 3
            voff = off
            if typ in "cCA":
                off += 1
            elif typ in "sS":
                off += 2
            elif typ in "iIf":
                off += 4
            elif typ in "ZH":
                off = data.index(0, off) + 1
            elif typ == "B":
                sub = chr(data[off])
                (n,) = struct.unpack_from("<i", data, off + 1)
                size = {"c": 1, "C": 1, "s": 2, "S": 2, "i": 4, "I": 4, "f": 4}[sub]
                off += 5 + n * size
            else:
                return None
            if t == want:
                return start, typ, voff, off
        return None

    def get_tag(self, tag: str):
        hit = self.find_tag(tag)
        if hit is None:
            return None
        _, typ, voff, end = hit
        data = self.aux
        if typ == "A":
            return chr(data[voff])
        if typ in "cC":
            v = data[voff]
            return v - 256 if (typ == "c" and v > 127) else v
        if typ in "sS":
            return struct.unpack_from("<h" if typ == "s" else "<H", data, voff)[0]
        if typ in "iI":
            return struct.unpack_from("<i" if typ == "i" else "<I", data, voff)[0]
        if typ == "f":
            return struct.unpack_from("<f", data, voff)[0]
        if typ in "ZH":
            return data[voff : end - 1].decode("latin-1")
        return data[voff:end]

    def set_float_tag(self, tag: str, value: float):
        """Overwrite in place if present, else append (BamWriter.h:41-47)."""
        hit = self.find_tag(tag)
        payload = struct.pack("<f", value)
        if hit is not None and hit[1] == "f":
            start, _, voff, end = hit
            self.aux = self.aux[:voff] + payload + self.aux[end:]
        else:
            if hit is not None:
                start, _, _, end = hit
                self.aux = self.aux[:start] + self.aux[end:]
            self.aux = self.aux + tag.encode() + b"f" + payload

    def del_tag(self, tag: str):
        hit = self.find_tag(tag)
        if hit is not None:
            start, _, _, end = hit
            self.aux = self.aux[:start] + self.aux[end:]

    def set_char_tag(self, tag: str, value: str):
        self.del_tag(tag)
        self.aux = self.aux + tag.encode() + b"A" + value.encode()

    def set_string_tag(self, tag: str, value: str):
        self.del_tag(tag)
        self.aux = self.aux + tag.encode() + b"Z" + value.encode("latin-1") + b"\x00"

    # ---- sequence ----------------------------------------------------
    def seq_nibbles(self) -> np.ndarray:
        packed = np.frombuffer(self.seq, dtype=np.uint8)
        nib = np.empty(len(packed) * 2, dtype=np.uint8)
        nib[0::2] = packed >> 4
        nib[1::2] = packed & 0xF
        return nib[: self.l_seq]

    def set_seq_nibbles(self, nib: np.ndarray):
        self.l_seq = len(nib)
        if len(nib) % 2:
            nib = np.concatenate([nib, np.zeros(1, dtype=np.uint8)])
        self.seq = ((nib[0::2] << 4) | nib[1::2]).astype(np.uint8).tobytes()

    def reverse_complement(self):
        """In-place seq flip + qual reverse (BamConverter.h:220-250)."""
        nib = self.seq_nibbles()
        self.set_seq_nibbles(_NIB_COMPL[nib[::-1]])
        self.qual = self.qual[::-1]

    def seq_string(self) -> str:
        return _NIB2CHAR[self.seq_nibbles()].tobytes().decode()

    # ---- codec -------------------------------------------------------
    def encode(self) -> bytes:
        name_b = self.name.encode("latin-1") + b"\x00"
        bin_ = reg2bin(self.pos, self.end_pos()) if self.pos >= 0 else 4680
        core = struct.pack(
            "<iiBBHHHiiii",
            self.tid,
            self.pos,
            len(name_b),
            self.mapq,
            bin_,
            len(self.cigar),
            self.flag,
            self.l_seq,
            self.mtid,
            self.mpos,
            self.tlen,
        )
        body = (
            core
            + name_b
            + self.cigar.astype("<u4").tobytes()
            + self.seq
            + self.qual
            + self.aux
        )
        return struct.pack("<i", len(body)) + body

    @classmethod
    def decode(cls, data: bytes) -> "BamRec":
        (tid, pos, l_read_name, mapq, _bin, n_cigar, flag, l_seq,
         mtid, mpos, tlen) = struct.unpack_from("<iiBBHHHiiii", data, 0)
        off = 32
        name = data[off : off + l_read_name - 1].decode("latin-1")
        off += l_read_name
        cigar = np.frombuffer(data, dtype="<u4", count=n_cigar, offset=off).copy()
        off += 4 * n_cigar
        nseq = (l_seq + 1) // 2
        seq = data[off : off + nseq]
        off += nseq
        qual = data[off : off + l_seq]
        off += l_seq
        aux = data[off:]
        return cls(name, flag, tid, pos, mapq, cigar, mtid, mpos, tlen,
                   l_seq, seq, qual, aux)

    @classmethod
    def from_sam_fields(cls, fields: Sequence[str], tid_map: Dict[str, int]) -> "BamRec":
        name = fields[0]
        flag = int(fields[1])
        tid = tid_map[fields[2]] if fields[2] != "*" else -1
        pos = int(fields[3]) - 1
        mapq = int(fields[4])
        cig = fields[5]
        cigar: List[int] = []
        if cig != "*":
            n = 0
            for ch in cig:
                if ch.isdigit():
                    n = n * 10 + ord(ch) - 48
                else:
                    cigar.append((n << 4) | _CIGAR_OP2IDX[ch])
                    n = 0
        if fields[6] == "=":
            mtid = tid
        elif fields[6] == "*":
            mtid = -1
        else:
            mtid = tid_map[fields[6]]
        mpos = int(fields[7]) - 1
        tlen = int(fields[8])
        seq_s = fields[9]
        if seq_s == "*":
            l_seq = 0
            seq = b""
        else:
            l_seq = len(seq_s)
            nib = _CHAR2NIB[np.frombuffer(seq_s.encode("latin-1"), dtype=np.uint8)]
            if l_seq % 2:
                nib = np.concatenate([nib, np.zeros(1, dtype=np.uint8)])
            seq = ((nib[0::2] << 4) | nib[1::2]).astype(np.uint8).tobytes()
        qual_s = fields[10]
        if qual_s == "*" or l_seq == 0:
            qual = b"\xff" * l_seq
        else:
            qual = bytes((ord(c) - 33) & 0xFF for c in qual_s)
        aux = bytearray()
        for t in fields[11:]:
            parts = t.split(":", 2)
            if len(parts) != 3:
                continue
            tag, typ, val = parts
            aux += tag.encode()
            if typ == "i":
                aux += b"i" + struct.pack("<i", int(val))
            elif typ == "f":
                aux += b"f" + struct.pack("<f", float(val))
            elif typ == "A":
                aux += b"A" + val.encode()
            elif typ in "ZH":
                aux += typ.encode() + val.encode("latin-1") + b"\x00"
            elif typ == "B":
                sub = val[0]
                nums = val.split(",")[1:]
                aux += b"B" + sub.encode() + struct.pack("<i", len(nums))
                fmt = {"c": "<b", "C": "<B", "s": "<h", "S": "<H",
                       "i": "<i", "I": "<I", "f": "<f"}[sub]
                conv = float if sub == "f" else int
                for x in nums:
                    aux += struct.pack(fmt, conv(x))
        return cls(name, flag, tid, pos, mapq, np.asarray(cigar, dtype=np.uint32),
                   mtid, mpos, tlen, l_seq, seq, qual, bytes(aux))

    def to_sam_line(self, target_names: Sequence[str]) -> str:
        cig = "".join(f"{ln}{op}" for ln, op in self.cigar_ops()) or "*"
        rname = target_names[self.tid] if self.tid >= 0 else "*"
        if self.mtid < 0:
            rnext = "*"
        elif self.mtid == self.tid:
            rnext = "="
        else:
            rnext = target_names[self.mtid]
        seq = self.seq_string() if self.l_seq else "*"
        if self.l_seq and self.qual[:1] != b"\xff":
            qual = "".join(chr(q + 33) for q in self.qual)
        else:
            qual = "*"
        parts = [
            self.name, str(self.flag), rname, str(self.pos + 1),
            str(self.mapq), cig, rnext, str(self.mpos + 1), str(self.tlen),
            seq, qual,
        ]
        off = 0
        data = self.aux
        while off + 3 <= len(data):
            tag = data[off : off + 2].decode("latin-1")
            typ = chr(data[off + 2])
            hit = self.find_tag(tag)
            if hit is None:
                break
            _, _, voff, end = hit
            val = self.get_tag(tag)
            if typ in "cCsSiI":
                parts.append(f"{tag}:i:{val}")
            elif typ == "f":
                parts.append(f"{tag}:f:{val:g}")
            elif typ == "A":
                parts.append(f"{tag}:A:{val}")
            elif typ in "ZH":
                parts.append(f"{tag}:{typ}:{val}")
            off = end
        return "\t".join(parts)


# ---------------------------------------------------------------------- #
# BGZF                                                                    #
# ---------------------------------------------------------------------- #

_BGZF_EOF = bytes.fromhex(
    "1f8b08040000000000ff0600424302001b0003000000000000000000"
)


class BgzfWriter:
    """BGZF writer with virtual-offset tracking (for BAI indexing).

    Complete 65280-byte blocks are batched and compressed in parallel by
    the C++ sidecar (native/bamparse.bgzf_compress; the reference uses
    hts_set_threads, BamWriter.h:72), which raises if it cannot be built;
    a tell_virtual() call forces the batch out first so virtual offsets
    stay exact. close() sends the last, partial block the same way."""

    MAX_BLOCK = 0xFF00
    BATCH_BYTES = 8 << 20

    def __init__(self, path: str, level: int = 6):
        self.f = open(path, "wb")
        self.buf = bytearray()
        self.pending = bytearray()  # complete blocks awaiting compression
        self.coffset = 0  # compressed bytes written so far
        self.level = level

    def tell_virtual(self) -> int:
        self._flush_pending()
        return (self.coffset << 16) | len(self.buf)

    def write(self, data: bytes):
        self.buf += data
        if len(self.buf) >= self.MAX_BLOCK:
            n_blocks = len(self.buf) // self.MAX_BLOCK
            cut = n_blocks * self.MAX_BLOCK
            self.pending += self.buf[:cut]
            del self.buf[:cut]
            if len(self.pending) >= self.BATCH_BYTES:
                self._flush_pending()

    def _flush_pending(self):
        if not self.pending:
            return
        from ..native.bamparse import bgzf_compress

        out = bgzf_compress(self.pending, self.level)
        self.f.write(out)
        self.coffset += len(out)
        self.pending.clear()

    def close(self):
        self.pending += self.buf
        self.buf.clear()
        self._flush_pending()
        self.f.write(_BGZF_EOF)
        self.f.close()

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()


# ---------------------------------------------------------------------- #
# Headers                                                                 #
# ---------------------------------------------------------------------- #

PROGRAM_NAME = "rsem-tpu"


@dataclass
class BamHeader:
    text: str
    target_names: List[str]
    target_lens: List[int]

    def tid_map(self) -> Dict[str, int]:
        return {n: i for i, n in enumerate(self.target_names)}

    def insert_pg(self, program: str, command: Optional[str] = None):
        """SamHeader::insertPG equivalent: append an @PG line."""
        line = f"@PG\tID:{program}\tPN:{program}"
        if command:
            line += f"\tCL:{command}"
        text = self.text
        if text and not text.endswith("\n"):
            text += "\n"
        self.text = text + line + "\n"

    def replace_sq(self, names: Sequence[str], lens: Sequence[int]):
        """SamHeader::replaceSQ from a .chrlist (BamConverter.h:58)."""
        kept = [
            ln for ln in self.text.splitlines() if not ln.startswith("@SQ")
        ]
        sq = [f"@SQ\tSN:{n}\tLN:{l}" for n, l in zip(names, lens)]
        self.text = "\n".join(sq + kept) + "\n" if (sq or kept) else ""
        self.target_names = list(names)
        self.target_lens = [int(x) for x in lens]

    def encode(self) -> bytes:
        text_b = self.text.encode("latin-1")
        out = b"BAM\x01" + struct.pack("<i", len(text_b)) + text_b
        out += struct.pack("<i", len(self.target_names))
        for name, ln in zip(self.target_names, self.target_lens):
            nb = name.encode("latin-1") + b"\x00"
            out += struct.pack("<i", len(nb)) + nb + struct.pack("<i", ln)
        return out


# ---------------------------------------------------------------------- #
# Readers                                                                 #
# ---------------------------------------------------------------------- #


class BamRecReader:
    """Streaming BAM -> BamRec."""

    def __init__(self, path: str):
        self.f = gzip.open(path, "rb")
        if self.f.read(4) != b"BAM\x01":
            raise ValueError(f"{path} is not a BAM file")
        (l_text,) = struct.unpack("<i", self.f.read(4))
        text = self.f.read(l_text).decode("latin-1").rstrip("\x00")
        (n_ref,) = struct.unpack("<i", self.f.read(4))
        names: List[str] = []
        lens: List[int] = []
        for _ in range(n_ref):
            (l_name,) = struct.unpack("<i", self.f.read(4))
            names.append(self.f.read(l_name)[:-1].decode("latin-1"))
            (l_ref,) = struct.unpack("<i", self.f.read(4))
            lens.append(l_ref)
        self.header = BamHeader(text, names, lens)

    def __iter__(self) -> Iterator[BamRec]:
        while True:
            raw = self.f.read(4)
            if len(raw) < 4:
                return
            (block_size,) = struct.unpack("<i", raw)
            yield BamRec.decode(self.f.read(block_size))

    def close(self):
        self.f.close()


class SamRecReader:
    """Streaming SAM text -> BamRec."""

    def __init__(self, path: str):
        self.f = gzip.open(path, "rt") if path.endswith(".gz") else open(path)
        header_lines: List[str] = []
        names: List[str] = []
        lens: List[int] = []
        self._first: Optional[str] = None
        for line in self.f:
            if line.startswith("@"):
                header_lines.append(line.rstrip("\n"))
                if line.startswith("@SQ"):
                    fields = dict(
                        kv.split(":", 1)
                        for kv in line.rstrip("\n").split("\t")[1:]
                        if ":" in kv
                    )
                    names.append(fields["SN"])
                    lens.append(int(fields["LN"]))
            else:
                self._first = line
                break
        text = "\n".join(header_lines) + ("\n" if header_lines else "")
        self.header = BamHeader(text, names, lens)
        self._tid_map = self.header.tid_map()

    def __iter__(self) -> Iterator[BamRec]:
        line = self._first
        while line:
            fields = line.rstrip("\n").split("\t")
            if len(fields) >= 11:
                yield BamRec.from_sam_fields(fields, self._tid_map)
            line = self.f.readline()

    def close(self):
        self.f.close()


def open_rec_reader(path: str):
    """Sniff BAM vs SAM(.gz)."""
    with open(path, "rb") as probe:
        head = probe.read(4)
    if head[:2] == b"\x1f\x8b":
        with gzip.open(path, "rb") as g:
            if g.read(4) == b"BAM\x01":
                return BamRecReader(path)
        return SamRecReader(path)
    return SamRecReader(path)


class BamRecWriter:
    def __init__(self, path: str, header: BamHeader, level: int = 6):
        self.bgzf = BgzfWriter(path, level=level)
        self.bgzf.write(header.encode())

    def tell_virtual(self) -> int:
        return self.bgzf.tell_virtual()

    def write(self, rec: BamRec):
        self.bgzf.write(rec.encode())

    def write_raw(self, encoded: bytes):
        self.bgzf.write(encoded)

    def close(self):
        self.bgzf.close()

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()
