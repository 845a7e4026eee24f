"""SAM/BAM alignment ingestion -> device-ready read + hit arrays.

This is the rsem-parse-alignments equivalent (reference: parseIt.cpp,
SamParser.h) built for an in-memory pipeline: instead of category FASTQ files
and a .dat hit file, it produces ReadArrays/HitArrays plus streaming
ReadStats, with optional interop serialization. The record loop runs in the
C++ sidecar (native/bamparse.py) by default, and in Python on request.

BAM support is a self-contained BGZF + binary record decoder (the reference
vendors htslib; this framework needs no external alignment library for
ingestion).
"""

from __future__ import annotations

import gzip
import os
import struct
import zlib
from dataclasses import dataclass
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from ..utils.seq import to_bytes
from .hits import CntStats, HitArrays
from .reads import PairedReadArrays, ReadArrays, ReadStats

# base codes A C G T N; anything else is an error (reference: utils.h:49-55)
_BASE2ID = np.full(256, -1, dtype=np.int8)
for _c, _i in zip(b"ACGTN", range(5)):
    _BASE2ID[_c] = _i
    _BASE2ID[_c + 32] = _i

# BAM 4-bit nibble codes -> char index (=ACMGRSVTWYHKDBN)
_NIB2ID = np.full(16, -1, dtype=np.int8)
_NIB2ID[1] = 0  # A
_NIB2ID[2] = 1  # C
_NIB2ID[4] = 2  # G
_NIB2ID[8] = 3  # T
_NIB2ID[15] = 4  # N

_FLAG_PAIRED = 0x1
_FLAG_UNMAPPED = 0x4
_FLAG_REVERSE = 0x10
_FLAG_READ1 = 0x40
_FLAG_READ2 = 0x80
_FLAG_SECONDARY = 0x100


@dataclass
class SamRecord:
    name: str
    flag: int
    tid: int  # 0-based target index, -1 unmapped
    pos: int  # 0-based
    cigar: List[Tuple[int, str]]  # (len, op)
    seq_codes: np.ndarray  # base codes, aligned orientation
    qual_codes: Optional[np.ndarray]  # 0..93, aligned orientation
    tags: Dict[str, object]

    @property
    def is_paired(self) -> bool:
        return bool(self.flag & _FLAG_PAIRED)

    @property
    def is_mapped(self) -> bool:
        return not (self.flag & _FLAG_UNMAPPED)

    @property
    def is_rev(self) -> bool:
        return bool(self.flag & _FLAG_REVERSE)

    @property
    def is_read1(self) -> bool:
        return bool(self.flag & _FLAG_READ1)

    def oriented_seq(self) -> np.ndarray:
        """Base codes in original read orientation
        (reference: sam_utils.h bam_get_read_seq)."""
        if self.is_rev:
            c = self.seq_codes[::-1]
            return np.where(c < 4, 3 - c, c).astype(np.uint8)
        return self.seq_codes

    def oriented_qual(self) -> Optional[np.ndarray]:
        if self.qual_codes is None:
            return None
        return self.qual_codes[::-1].copy() if self.is_rev else self.qual_codes


def _parse_cigar_text(cig: str) -> List[Tuple[int, str]]:
    if cig == "*":
        return []
    out = []
    n = 0
    for ch in cig:
        if ch.isdigit():
            n = n * 10 + ord(ch) - 48
        else:
            out.append((n, ch))
            n = 0
    return out


def _canonical_name(raw: str) -> str:
    """Truncate at first whitespace (reference: bam_get_canonical_name)."""
    for i, ch in enumerate(raw):
        if ch in " \t\n\r\x0b\x0c":
            return raw[:i]
    return raw


class SamReader:
    """Streaming SAM text reader."""

    def __init__(self, path: str):
        self.f = gzip.open(path, "rt") if path.endswith(".gz") else open(path)
        self.target_names: List[str] = []
        self.target_lens: List[int] = []
        self._first_line: Optional[str] = None
        for line in self.f:
            if line.startswith("@"):
                if line.startswith("@SQ"):
                    fields = dict(
                        kv.split(":", 1) for kv in line.rstrip("\n").split("\t")[1:]
                        if ":" in kv
                    )
                    self.target_names.append(fields["SN"])
                    self.target_lens.append(int(fields["LN"]))
            else:
                self._first_line = line
                break
        self._tid = {name: i for i, name in enumerate(self.target_names)}

    def __iter__(self) -> Iterator[SamRecord]:
        line = self._first_line
        while line:
            rec = self._parse_line(line)
            if rec is not None:
                yield rec
            line = self.f.readline()

    def _parse_line(self, line: str) -> Optional[SamRecord]:
        fields = line.rstrip("\n").split("\t")
        if len(fields) < 11:
            return None
        flag = int(fields[1])
        rname = fields[2]
        tid = self._tid[rname] if rname != "*" else -1
        seq = fields[9]
        codes = _BASE2ID[to_bytes(seq)]
        if (codes < 0).any():
            bad = seq[int(np.argmax(codes < 0))]
            raise ValueError(f"Found unknown sequence letter {bad!r}")
        qual = fields[10]
        qcodes = None
        if qual != "*":
            qcodes = (to_bytes(qual).astype(np.int16) - 33).astype(np.uint8)
            if (qcodes > 93).any():
                raise ValueError("Quality score out of range [33, 126]")
        tags: Dict[str, object] = {}
        for t in fields[11:]:
            parts = t.split(":", 2)
            if len(parts) == 3:
                tags[parts[0]] = int(parts[2]) if parts[1] == "i" else parts[2]
        return SamRecord(
            name=_canonical_name(fields[0]),
            flag=flag,
            tid=tid,
            pos=int(fields[3]) - 1,
            cigar=_parse_cigar_text(fields[5]),
            seq_codes=codes.astype(np.uint8),
            qual_codes=qcodes,
            tags=tags,
        )

    def close(self):
        self.f.close()


_CIGAR_OPS = "MIDNSHP=X"


class BamReader:
    """Streaming BAM reader (BGZF = concatenated gzip members)."""

    def __init__(self, path: str):
        self.path = path
        self.f = gzip.open(path, "rb")
        magic = self.f.read(4)
        if magic != b"BAM\x01":
            raise ValueError(f"{path} is not a BAM file")
        (l_text,) = struct.unpack("<i", self.f.read(4))
        self.header_text = self.f.read(l_text).decode("latin-1")
        (n_ref,) = struct.unpack("<i", self.f.read(4))
        self.target_names: List[str] = []
        self.target_lens: List[int] = []
        for _ in range(n_ref):
            (l_name,) = struct.unpack("<i", self.f.read(4))
            name = self.f.read(l_name)[:-1].decode("latin-1")
            (l_ref,) = struct.unpack("<i", self.f.read(4))
            self.target_names.append(name)
            self.target_lens.append(l_ref)

    def __iter__(self) -> Iterator[SamRecord]:
        unpack_core = struct.Struct("<iiBBHHHiiii").unpack
        while True:
            raw = self.f.read(4)
            if len(raw) < 4:
                return
            (block_size,) = struct.unpack("<i", raw)
            data = self.f.read(block_size)
            (tid, pos, l_read_name, mapq, _bin, n_cigar, flag, l_seq,
             _next_tid, _next_pos, _tlen) = unpack_core(data[:32])
            off = 32
            name = data[off : off + l_read_name - 1].decode("latin-1")
            off += l_read_name
            cigar = []
            for _ in range(n_cigar):
                (v,) = struct.unpack_from("<I", data, off)
                cigar.append((v >> 4, _CIGAR_OPS[v & 0xF]))
                off += 4
            nseq = (l_seq + 1) // 2
            packed = np.frombuffer(data, dtype=np.uint8, count=nseq, offset=off)
            off += nseq
            nibbles = np.empty(nseq * 2, dtype=np.uint8)
            nibbles[0::2] = packed >> 4
            nibbles[1::2] = packed & 0xF
            codes = _NIB2ID[nibbles[:l_seq]]
            if (codes < 0).any():
                raise ValueError("Found ambiguity code in BAM SEQ field")
            quals = np.frombuffer(data, dtype=np.uint8, count=l_seq, offset=off)
            off += l_seq
            qcodes = None if l_seq and quals[0] == 0xFF else quals.copy()
            tags = self._parse_tags(data, off)
            yield SamRecord(
                name=_canonical_name(name),
                flag=flag,
                tid=tid,
                pos=pos,
                cigar=cigar,
                seq_codes=codes.astype(np.uint8),
                qual_codes=qcodes,
                tags=tags,
            )

    @staticmethod
    def _parse_tags(data: bytes, off: int) -> Dict[str, object]:
        tags: Dict[str, object] = {}
        end = len(data)
        while off + 3 <= end:
            tag = data[off : off + 2].decode("latin-1")
            typ = chr(data[off + 2])
            off += 3
            if typ in "cC":
                val = data[off]
                if typ == "c" and val > 127:
                    val -= 256
                off += 1
            elif typ in "sS":
                (val,) = struct.unpack_from("<h" if typ == "s" else "<H", data, off)
                off += 2
            elif typ in "iI":
                (val,) = struct.unpack_from("<i" if typ == "i" else "<I", data, off)
                off += 4
            elif typ == "f":
                (val,) = struct.unpack_from("<f", data, off)
                off += 4
            elif typ == "A":
                val = chr(data[off])
                off += 1
            elif typ in "ZH":
                nul = data.index(0, off)
                val = data[off:nul].decode("latin-1")
                off = nul + 1
            elif typ == "B":
                sub = chr(data[off])
                (n,) = struct.unpack_from("<i", data, off + 1)
                size = {"c": 1, "C": 1, "s": 2, "S": 2, "i": 4, "I": 4, "f": 4}[sub]
                val = data[off + 5 : off + 5 + n * size]
                off += 5 + n * size
            else:
                break
            tags[tag] = val
        return tags

    def close(self):
        self.f.close()


def open_alignment_file(path: str):
    with open(path, "rb") as probe:
        head = probe.read(4)
    if head == b"CRAM":
        return BamReader(_cram_to_bam(path))
    if head[:2] == b"\x1f\x8b":
        with gzip.open(path, "rb") as g:
            inner = g.read(4)
        if inner == b"BAM\x01":
            return BamReader(path)
        return SamReader(path)
    return SamReader(path)


def _cram_to_bam(path: str) -> str:
    """CRAM ingestion shim: the CRAM codec lives in htslib; rather than
    reimplement its column compression we decode through samtools
    (reference links htslib directly, SamParser.h via sam_open). Produces a
    sibling .cram.bam once and reuses it."""
    import shutil as _shutil
    import subprocess as _sp

    out = path + ".bam"
    if os.path.exists(out) and os.path.getmtime(out) >= os.path.getmtime(path):
        return out
    if _shutil.which("samtools") is None:
        raise RuntimeError(
            f"{path} is a CRAM file; decoding CRAM requires samtools on "
            "PATH (run `samtools view -b -o file.bam file.cram` and pass "
            "the BAM)"
        )
    _sp.run(["samtools", "view", "-b", "-o", out, path], check=True)
    return out


def load_fai(path: str):
    """samtools .fai: name, length, ... — target names/lengths for SAM
    inputs without @SQ header lines (rsem-calculate-expression --fai,
    parseIt's -t list)."""
    names, lens = [], []
    with open(path) as f:
        for line in f:
            t = line.split()
            if not t:
                continue
            names.append(t[0])
            lens.append(int(t[1]))
    return names, lens


@dataclass
class AlignmentBundle:
    """Everything the inference engines need from an alignment file."""

    read_type: int
    reads: object  # ReadArrays (single) or PairedReadArrays (paired), N1 only
    hits: HitArrays
    stats: Dict[int, ReadStats]  # category (0/1/2) -> streaming stats
    cnt: CntStats
    omit: np.ndarray  # internal sids absent from the alignment header

    @property
    def paired(self) -> bool:
        return self.read_type >= 2


def _check_cigar(rec: SamRecord) -> bool:
    """Exactly one M/=/X op spanning the read (reference: bam_check_cigar)."""
    return (
        len(rec.cigar) == 1
        and rec.cigar[0][1] in "M=X"
        and rec.cigar[0][0] == len(rec.seq_codes)
    )


def _padded_from_flat(flat: np.ndarray, lens: np.ndarray, L: int) -> np.ndarray:
    """[sum(lens)] flat payload -> [N, L] zero-padded matrix (vectorized)."""
    n = len(lens)
    if n and flat.size == n * L:
        # uniform read length: the flat payload IS the matrix (zero-copy)
        return flat.reshape(n, L)
    mat = np.zeros((n, L), dtype=np.uint8)
    mask = np.arange(L)[None, :] < lens[:, None]
    mat[mask] = flat
    return mat


def _assemble_native(
    res,
    read_type: int,
    has_polya: bool,
    seed_len: int,
    omit: np.ndarray,
) -> AlignmentBundle:
    """Build the AlignmentBundle from the native sidecar's flat arrays;
    byte-identical to the Python record loop
    (tests/test_torch_native_ingest.py)."""
    paired = read_type >= 2
    has_qual = read_type in (1, 3)

    # per-category streaming stats: computed by the C++ walker alongside
    # the record parse (bamparse.cpp stat_add_mate; exact ReadStats
    # semantics, held in tests/test_torch_native_ingest.py)
    stats = {}
    for cat in range(3):
        st = ReadStats()
        ns = res.stats[cat]
        need = int(np.flatnonzero(ns.len_counts).max(initial=0))
        st._grow(need)
        st.len_counts[: len(ns.len_counts[: need + 1])] = ns.len_counts[
            : need + 1
        ].astype(np.float64)
        st.q_init = ns.q_init.astype(np.float64)
        st.q_tran = ns.q_tran.astype(np.float64)
        st.noise = ns.noise.astype(np.float64)
        st.n_reads = int(ns.n_reads)
        stats[cat] = st

    # N1 reads (low-quality flags also from the walker)
    n1 = res.n1
    L1 = int(res.len1.max()) if n1 else 1
    codes1 = _padded_from_flat(res.seq1, res.len1, L1)
    quals1 = _padded_from_flat(res.qual1, res.len1, L1) if has_qual else None
    lens1 = res.len1.astype(np.int32)
    m1 = ReadArrays(codes1, lens1, quals1, res.lq1.astype(bool))
    if paired:
        L2 = int(res.len2.max()) if n1 else 1
        codes2 = _padded_from_flat(res.seq2, res.len2, L2)
        quals2 = _padded_from_flat(res.qual2, res.len2, L2) if has_qual else None
        lens2 = res.len2.astype(np.int32)
        m2 = ReadArrays(codes2, lens2, quals2, res.lq2.astype(bool))
        reads = PairedReadArrays.build(m1, m2, seed_len)
    else:
        reads = m1

    # hits CSR
    nh = res.nh.astype(np.int64)
    offsets = np.zeros(n1 + 1, dtype=np.int64)
    np.cumsum(nh, out=offsets[1:])
    rid = np.repeat(np.arange(n1, dtype=np.int32), nh)
    ssid = res.sid
    hits = HitArrays(
        rid=rid,
        sid=np.abs(ssid).astype(np.int32),
        dir=(ssid < 0).astype(np.int8),
        pos=res.pos.astype(np.int32),
        insert_len=res.ins.astype(np.int32) if paired else None,
        read_offsets=offsets,
    )

    vals, freqs = np.unique(nh, return_counts=True)
    hist = {int(v): int(f) for v, f in zip(vals, freqs)}
    cnt = CntStats(
        N0=res.cat0.n,
        N1=n1,
        N2=res.cat2.n,
        n_unique=0,
        n_multi=0,
        n_iso_multi=res.n_iso_multi,
        n_hits=hits.n_hits,
        read_type=read_type,
        hist=hist,
    )
    return AlignmentBundle(read_type, reads, hits, stats, cnt, omit)


def parse_alignments(
    path: str,
    transcript_names: Sequence[str],
    read_type: int,
    has_polya: bool,
    seed_len: int,
    filter_tag: str = "XM",
    use_native: bool = True,
    fai: Optional[str] = None,
) -> AlignmentBundle:
    """Parse a SAM/BAM of transcript alignments (reference: parseIt.cpp).

    transcript_names: internal sid order (index 0 unused); names are
    transcript_ids, or seqnames in allele-specific mode
    (Transcripts.h:105-143).

    With use_native (the default), BAM and SAM-text inputs run the record
    loop in the C++ sidecar (native/bamparse.py: parse_bam_native,
    parse_sam_native), built with g++ at first use; if it cannot be built
    the call raises with the compiler's message. use_native=False runs the
    pure-Python loop below, which is also the oracle the sidecar is held
    against.
    """
    paired = read_type >= 2
    has_qual = read_type in (1, 3)
    reader = open_alignment_file(path)
    if fai and not reader.target_names:
        names_f, lens_f = load_fai(fai)
        reader.target_names = names_f
        reader.target_lens = lens_f
        if hasattr(reader, "_tid"):
            reader._tid = {n: i for i, n in enumerate(names_f)}

    M = len(transcript_names) - 1
    name2sid = {}
    for i in range(1, M + 1):
        if transcript_names[i] in name2sid:
            raise ValueError(
                f"RSEM's indices might be corrupted, {transcript_names[i]} "
                "appears more than once!"
            )
        name2sid[transcript_names[i]] = i
    n_targets = len(reader.target_names)
    if not (0 < n_targets <= M):
        raise ValueError(
            f"The SAM/BAM file declares {n_targets} reference sequences but "
            f"RSEM knows {M}!"
        )
    e2i = np.zeros(n_targets, dtype=np.int32)
    appeared = np.zeros(M + 1, dtype=bool)
    for t, tname in enumerate(reader.target_names):
        sid = name2sid.get(tname)
        if sid is None:
            raise ValueError(f"RSEM can not recognize reference sequence name {tname}!")
        if appeared[sid]:
            raise ValueError(f"Reference sequence name {tname} appears more than once!")
        e2i[t] = sid
        appeared[sid] = True
    omit = np.flatnonzero(~appeared[1:]) + 1
    target_lens = np.asarray(reader.target_lens, dtype=np.int64)

    if use_native:
        from ..native import bamparse

        reader.close()
        if isinstance(reader, BamReader):
            # reader.path: a CRAM input's decoded BAM
            res = bamparse.parse_bam_native(
                reader.path, paired, has_qual, e2i, target_lens, filter_tag,
                has_polya=has_polya, seed_len=seed_len)
        else:
            res = bamparse.parse_sam_native(
                path, paired, has_qual, reader.target_names, e2i,
                target_lens, filter_tag, has_polya=has_polya,
                seed_len=seed_len)
        return _assemble_native(res, read_type, has_polya, seed_len, omit)

    stats = {i: ReadStats() for i in range(3)}
    Ncat = [0, 0, 0]
    hist: Dict[int, int] = {}
    n_multi = n_iso_multi = n_hits_total = 0

    # N1 read payloads
    seqs1: List[np.ndarray] = []
    quals1: List[np.ndarray] = []
    seqs2: List[np.ndarray] = []
    quals2: List[np.ndarray] = []
    per_read_hits: List[list] = []

    # pending read state
    cur_name = None
    cur_val = -2
    cur_payload = None  # tuple of oriented seq/qual arrays
    cur_hits: List[tuple] = []

    def get_read_type_se(rec: SamRecord) -> int:
        if rec.is_mapped:
            return 1
        if filter_tag and int(rec.tags.get(filter_tag, 0) or 0) > 0:
            return 2
        return 0

    def get_read_type_pe(r1: SamRecord, r2: SamRecord) -> int:
        if r1.is_mapped and r2.is_mapped:
            return 1
        if filter_tag:
            if int(r1.tags.get(filter_tag, 0) or 0) > 0:
                return 2
            if int(r2.tags.get(filter_tag, 0) or 0) > 0:
                return 2
        return 0

    def flush():
        nonlocal n_hits_total
        if cur_val < 0:
            return
        Ncat[cur_val] += 1
        if cur_val == 1:
            assert cur_hits, f"Alignable read {cur_name} has no hits"
            seqs1.append(cur_payload[0])
            if has_qual:
                quals1.append(cur_payload[1])
            if paired:
                seqs2.append(cur_payload[2])
                if has_qual:
                    quals2.append(cur_payload[3])
            per_read_hits.append(list(cur_hits))
            n_hits_total += len(cur_hits)
            hist[len(cur_hits)] = hist.get(len(cur_hits), 0) + 1
        else:
            assert not cur_hits, (
                f"Read {cur_name} is both unalignable and alignable according "
                "to the input file!"
            )
            # reduce to streaming stats right away (lq computed per batch later)
            _add_unaligned_stats(cur_val, cur_payload)

    def _add_unaligned_stats(cat: int, payload):
        seq1 = payload[0][None, :]
        q1 = payload[1][None, :] if has_qual else None
        from .reads import calc_low_quality

        if paired:
            seq2 = payload[2][None, :]
            q2 = payload[3][None, :] if has_qual else None
            lq1 = calc_low_quality(seq1, [len(payload[0])], has_polya, seed_len)
            lq2 = calc_low_quality(seq2, [len(payload[2])], has_polya, seed_len)
            lq = (lq1 & lq2) | (len(payload[0]) < seed_len) | (len(payload[2]) < seed_len)
            stats[cat].add_reads(seq1, [len(payload[0])], q1, lq, cat == 0)
            stats[cat].add_reads(seq2, [len(payload[2])], q2, lq, cat == 0)
        else:
            lq = calc_low_quality(seq1, [len(payload[0])], has_polya, seed_len)
            stats[cat].add_reads(seq1, [len(payload[0])], q1, lq, cat == 0)

    it = iter(reader)
    while True:
        try:
            rec = next(it)
        except StopIteration:
            break
        if rec.flag & _FLAG_SECONDARY and False:
            pass  # RSEM treats secondary alignments like any other record

        if paired:
            try:
                rec2 = next(it)
            except StopIteration:
                raise ValueError("Paired-end file has an odd number of records")
            if not rec.is_read1:
                rec, rec2 = rec2, rec
            if not (rec.is_paired and rec2.is_paired):
                raise ValueError(
                    f"Read {rec.name}: one of the mates is not paired-end! "
                    "(mates must be adjacent)"
                )
            if not (rec.is_read1 and rec2.flag & _FLAG_READ2):
                raise ValueError(
                    f"Read {rec.name}: adjacent records are not the two mates "
                    "of a paired-end read!"
                )
            if rec.is_mapped != rec2.is_mapped:
                raise ValueError(
                    f"Read {rec.name}: RSEM does not support partial alignments!"
                )
            val = get_read_type_pe(rec, rec2)
            if val != 1 or rec.name != cur_name:
                flush()
                cur_val = val
                cur_name = rec.name
                cur_hits = []
                cur_payload = (
                    rec.oriented_seq(),
                    rec.oriented_qual() if has_qual else None,
                    rec2.oriented_seq(),
                    rec2.oriented_qual() if has_qual else None,
                )
            if val == 1:
                if not (_check_cigar(rec) and _check_cigar(rec2)):
                    raise ValueError(
                        f"Read {rec.name}: RSEM does not support gapped alignments"
                    )
                if rec.tid != rec2.tid:
                    raise ValueError(
                        f"Read {rec.name}: the two mates align to different "
                        "transcripts (discordant alignment)"
                    )
                sid = int(e2i[rec.tid])
                l1, l2 = len(rec.seq_codes), len(rec2.seq_codes)
                if rec.is_rev:
                    cur_hits.append(
                        (-sid, int(target_lens[rec.tid]) - rec.pos - l1,
                         rec.pos + l1 - rec2.pos)
                    )
                else:
                    cur_hits.append((sid, rec.pos, rec2.pos + l2 - rec.pos))
        else:
            if rec.is_paired:
                raise ValueError(f"Read {rec.name}: found a paired-end read!")
            val = get_read_type_se(rec)
            if val != 1 or rec.name != cur_name:
                flush()
                cur_val = val
                cur_name = rec.name
                cur_hits = []
                cur_payload = (
                    rec.oriented_seq(),
                    rec.oriented_qual() if has_qual else None,
                )
            if val == 1:
                if not _check_cigar(rec):
                    raise ValueError(
                        f"Read {rec.name}: RSEM does not support gapped alignments"
                    )
                sid = int(e2i[rec.tid])
                l = len(rec.seq_codes)
                if rec.is_rev:
                    cur_hits.append((-sid, int(target_lens[rec.tid]) - rec.pos - l))
                else:
                    cur_hits.append((sid, rec.pos))
    flush()
    reader.close()

    # Build N1 arrays
    m1 = ReadArrays.build(seqs1, quals1 if has_qual else None, has_polya, seed_len)
    if paired:
        m2 = ReadArrays.build(seqs2, quals2 if has_qual else None, has_polya, seed_len)
        reads = PairedReadArrays.build(m1, m2, seed_len)
        stats[1].add_reads(m1.codes, m1.lens, m1.quals, reads.lq, False)
        stats[1].add_reads(m2.codes, m2.lens, m2.quals, reads.lq, False)
    else:
        reads = m1
        stats[1].add_reads(m1.codes, m1.lens, m1.quals, m1.lq, False)

    hits = HitArrays.from_lists(per_read_hits, paired)

    cnt = CntStats(
        N0=Ncat[0],
        N1=Ncat[1],
        N2=Ncat[2],
        n_unique=0,
        n_multi=0,
        n_iso_multi=hits.n_isoform_multi_reads(),
        n_hits=hits.n_hits,
        read_type=read_type,
        hist=hist,
    )
    return AlignmentBundle(read_type, reads, hits, stats, cnt, omit)


def finalize_cnt(bundle: AlignmentBundle, sid2gid: np.ndarray):
    """Fill in gene-level multi-mapping counts (needs .grp)."""
    n_multi = bundle.hits.n_gene_multi_reads(sid2gid)
    bundle.cnt.n_multi = n_multi
    bundle.cnt.n_unique = bundle.cnt.N1 - n_multi
