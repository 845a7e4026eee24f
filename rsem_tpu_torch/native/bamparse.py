"""ctypes bindings of the BAM/SAM ingest sidecar (bamparse.cpp).

Counterpart of rsem_tpu/native/bamparse.py. The sidecar runs the record
loop of rsem_tpu_torch.io.sam.parse_alignments in C++ (the reference
streams records through htslib, parseIt.cpp:90-152): parallel BGZF block
inflate, one pointer walk over the records, grouping by read name, the
N0/N1/N2 categories and the per-category read statistics. Python reads the
header and builds the numpy containers from the flat arrays returned here
(io/sam._assemble_native), byte-identical to the Python loop. It also
compresses BGZF blocks in parallel for the BAM writer (io/bamio.BgzfWriter).

The library is built with g++ at first use into
`rsem_tpu_torch/_build/native-<hash>/` (native.build_library), with
libdeflate for block inflate and deflate where its header and library are
there, with zlib alone where they are not. There is no Python fallback
here: if neither build succeeds, the call raises with the compiler's
output. Nothing runs at import time.
"""

from __future__ import annotations

import ctypes
import os
from dataclasses import dataclass
from pathlib import Path
from typing import Optional

import numpy as np

from . import GXX_FLAGS, build_library, library_path_for

SRC = Path(__file__).resolve().with_name("bamparse.cpp")
LIB_NAME = "libbamparse.so"
# (g++ flags, libraries), in order of preference
BUILDS = ((GXX_FLAGS + ["-DUSE_LIBDEFLATE"], ["-ldeflate", "-lz"]),
          (GXX_FLAGS, ["-lz"]))

_c_u8p = ctypes.POINTER(ctypes.c_uint8)
_c_i32p = ctypes.POINTER(ctypes.c_int32)
_c_i64p = ctypes.POINTER(ctypes.c_int64)

_lib: Optional[ctypes.CDLL] = None


def build() -> Path:
    """An existing build of bamparse.cpp, else the first of BUILDS that
    compiles. Raises RuntimeError with every attempt's compiler output."""
    for flags, libs in BUILDS:
        path = library_path_for(SRC, LIB_NAME, [*flags, *libs])
        if path.exists():
            return path
    errors = []
    for flags, libs in BUILDS:
        try:
            return build_library(SRC, LIB_NAME, flags, libs)
        except RuntimeError as exc:
            errors.append(str(exc))
    raise RuntimeError("the BAM/SAM ingest sidecar could not be built:\n"
                       + "\n".join(errors))


def uses_libdeflate(path: Path) -> bool:
    """Whether the library at `path` is the libdeflate build."""
    flags, libs = BUILDS[0]
    return path == library_path_for(SRC, LIB_NAME, [*flags, *libs])


def lib() -> ctypes.CDLL:
    """The loaded sidecar (built on first use)."""
    global _lib
    if _lib is not None:
        return _lib
    L = ctypes.CDLL(str(build()))
    L.bamparse_run.restype = ctypes.c_void_p
    L.bamparse_run.argtypes = [
        ctypes.c_char_p, ctypes.c_int, ctypes.c_int,
        _c_i32p, _c_i64p, ctypes.c_int,
        ctypes.c_char_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_char_p, ctypes.c_int,
    ]
    L.samparse_run.restype = ctypes.c_void_p
    L.samparse_run.argtypes = [
        ctypes.c_char_p, ctypes.c_int, ctypes.c_int,
        ctypes.c_char_p, _c_i32p, _c_i64p, ctypes.c_int,
        ctypes.c_char_p, ctypes.c_int, ctypes.c_int,
        ctypes.c_char_p, ctypes.c_int,
    ]
    L.bamparse_sizes.restype = None
    L.bamparse_sizes.argtypes = [ctypes.c_void_p, _c_i64p]
    L.bamparse_export_n1.restype = None
    L.bamparse_export_n1.argtypes = [ctypes.c_void_p] + [
        _c_u8p, _c_u8p, _c_i32p, _c_u8p, _c_u8p, _c_i32p, _c_i32p, _c_i32p,
        _c_i32p, _c_i32p]
    L.bamparse_export_cat.restype = None
    L.bamparse_export_cat.argtypes = [
        ctypes.c_void_p, ctypes.c_int,
        _c_u8p, _c_u8p, _c_i32p, _c_u8p, _c_u8p, _c_i32p,
    ]
    L.bamparse_export_lq.restype = None
    L.bamparse_export_lq.argtypes = [ctypes.c_void_p, _c_u8p, _c_u8p]
    L.bamparse_export_stats.restype = None
    L.bamparse_export_stats.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                        _c_i64p]
    L.bamparse_free.restype = None
    L.bamparse_free.argtypes = [ctypes.c_void_p]
    L.bgzf_compress_bound.restype = ctypes.c_int64
    L.bgzf_compress_bound.argtypes = [ctypes.c_int64]
    L.bgzf_compress.restype = ctypes.c_int64
    L.bgzf_compress.argtypes = [
        _c_u8p, ctypes.c_int64, ctypes.c_int, ctypes.c_int, _c_u8p,
    ]
    _lib = L
    return _lib


def _p8(a: Optional[np.ndarray]):
    if a is None or a.size == 0:
        return _c_u8p()
    return a.ctypes.data_as(_c_u8p)


def _p32(a: Optional[np.ndarray]):
    if a is None or a.size == 0:
        return _c_i32p()
    return a.ctypes.data_as(_c_i32p)


def _threads(n_threads: Optional[int]) -> int:
    return int(n_threads or os.cpu_count() or 1)


STAT_MAXL = 4096
STAT_QSIZE = 100
STAT_NCODES = 5
_STAT_WORDS = 1 + (STAT_MAXL + 1) + STAT_QSIZE + STAT_QSIZE * STAT_QSIZE \
    + STAT_QSIZE * STAT_NCODES


@dataclass
class NativeStats:
    """One category's streaming read statistics, computed in the walker
    (the semantics of io/reads.py ReadStats.add_reads)."""

    n_reads: int
    len_counts: np.ndarray  # [STAT_MAXL+1] int64
    q_init: np.ndarray  # [QSIZE]
    q_tran: np.ndarray  # [QSIZE, QSIZE]
    noise: np.ndarray  # [QSIZE, NCODES]


@dataclass
class CatFlat:
    """One unaligned category's flat payloads."""

    n: int
    seq1: np.ndarray
    qual1: Optional[np.ndarray]
    len1: np.ndarray
    seq2: Optional[np.ndarray]
    qual2: Optional[np.ndarray]
    len2: Optional[np.ndarray]


@dataclass
class NativeParse:
    """Flat arrays from the sidecar, in file order per category."""

    n1: int
    seq1: np.ndarray  # concatenated oriented base codes of N1 mate-1 reads
    qual1: Optional[np.ndarray]
    len1: np.ndarray
    seq2: Optional[np.ndarray]
    qual2: Optional[np.ndarray]
    len2: Optional[np.ndarray]
    nh: np.ndarray  # hits per N1 read
    sid: np.ndarray  # signed sid per hit
    pos: np.ndarray
    ins: Optional[np.ndarray]
    cat0: CatFlat
    cat2: CatFlat
    lq1: np.ndarray  # per-mate low-quality flags (uint8)
    lq2: Optional[np.ndarray]
    stats: dict  # {category: NativeStats}
    n_iso_multi: int


def parse_bam_native(path: str, paired: bool, has_qual: bool,
                     e2i: np.ndarray, target_lens: np.ndarray,
                     filter_tag: str, n_threads: Optional[int] = None,
                     has_polya: bool = False,
                     seed_len: int = 25) -> NativeParse:
    """Parse a BAM in the sidecar. Raises ValueError with the sidecar's
    message on malformed input (as the Python path does), RuntimeError if
    the sidecar cannot be built."""
    L = lib()
    e2i = np.ascontiguousarray(e2i, dtype=np.int32)
    target_lens = np.ascontiguousarray(target_lens, dtype=np.int64)
    errbuf = ctypes.create_string_buffer(512)
    tag = filter_tag.encode() if filter_tag and len(filter_tag) == 2 else b""
    h = L.bamparse_run(
        path.encode(), int(paired), int(has_qual),
        e2i.ctypes.data_as(_c_i32p), target_lens.ctypes.data_as(_c_i64p),
        len(e2i), tag, _threads(n_threads), int(has_polya), int(seed_len),
        errbuf, len(errbuf),
    )
    if not h:
        raise ValueError(errbuf.value.decode(errors="replace"))
    return _export_handle(L, h, paired, has_qual)


def parse_sam_native(path: str, paired: bool, has_qual: bool, target_names,
                     e2i: np.ndarray, target_lens: np.ndarray,
                     filter_tag: str, has_polya: bool = False,
                     seed_len: int = 25) -> NativeParse:
    """The SAM-text counterpart of parse_bam_native (plain or gzip text;
    the same walker: lines are encoded as BAM records inside)."""
    L = lib()
    e2i = np.ascontiguousarray(e2i, dtype=np.int32)
    target_lens = np.ascontiguousarray(target_lens, dtype=np.int64)
    names_blob = b"".join(n.encode() + b"\0" for n in target_names)
    errbuf = ctypes.create_string_buffer(512)
    tag = filter_tag.encode() if filter_tag and len(filter_tag) == 2 else b""
    h = L.samparse_run(
        path.encode(), int(paired), int(has_qual), names_blob,
        e2i.ctypes.data_as(_c_i32p), target_lens.ctypes.data_as(_c_i64p),
        len(e2i), tag, int(has_polya), int(seed_len), errbuf, len(errbuf),
    )
    if not h:
        raise ValueError(errbuf.value.decode(errors="replace"))
    return _export_handle(L, h, paired, has_qual)


def _export_handle(L, h, paired: bool, has_qual: bool) -> NativeParse:
    """Copy a finished parse handle's arrays out and free it."""
    try:
        sizes = np.zeros(18, dtype=np.int64)
        L.bamparse_sizes(h, sizes.ctypes.data_as(_c_i64p))
        (n1, n_hits, s1_tot, s2_tot, c0n, c0s1, c0s2, c2n, c2s1, c2s2) = (
            int(x) for x in sizes[:10])
        n_iso_multi = int(sizes[10])
        seq1 = np.empty(s1_tot, np.uint8)
        qual1 = np.empty(s1_tot, np.uint8) if has_qual else None
        len1 = np.empty(n1, np.int32)
        seq2 = np.empty(s2_tot, np.uint8) if paired else None
        qual2 = np.empty(s2_tot, np.uint8) if (paired and has_qual) else None
        len2 = np.empty(n1, np.int32) if paired else None
        nh = np.empty(n1, np.int32)
        sid = np.empty(n_hits, np.int32)
        pos = np.empty(n_hits, np.int32)
        ins = np.empty(n_hits, np.int32) if paired else None
        L.bamparse_export_n1(
            h, _p8(seq1), _p8(qual1), _p32(len1), _p8(seq2), _p8(qual2),
            _p32(len2), _p32(nh), _p32(sid), _p32(pos), _p32(ins))

        def cat(ci, n, stot1, stot2):
            cs1 = np.empty(stot1, np.uint8)
            cq1 = np.empty(stot1, np.uint8) if has_qual else None
            cl1 = np.empty(n, np.int32)
            cs2 = np.empty(stot2, np.uint8) if paired else None
            cq2 = np.empty(stot2, np.uint8) if (paired and has_qual) \
                else None
            cl2 = np.empty(n, np.int32) if paired else None
            L.bamparse_export_cat(h, ci, _p8(cs1), _p8(cq1), _p32(cl1),
                                  _p8(cs2), _p8(cq2), _p32(cl2))
            return CatFlat(n, cs1, cq1, cl1, cs2, cq2, cl2)

        lq1 = np.empty(n1, np.uint8)
        lq2 = np.empty(n1, np.uint8) if paired else None
        L.bamparse_export_lq(h, _p8(lq1), _p8(lq2))

        stats = {}
        for ci in (0, 1, 2):
            buf = np.zeros(_STAT_WORDS, dtype=np.int64)
            L.bamparse_export_stats(h, ci, buf.ctypes.data_as(_c_i64p))
            o = 1
            lc = buf[o:o + STAT_MAXL + 1]
            o += STAT_MAXL + 1
            qi = buf[o:o + STAT_QSIZE]
            o += STAT_QSIZE
            qt = buf[o:o + STAT_QSIZE * STAT_QSIZE].reshape(STAT_QSIZE,
                                                            STAT_QSIZE)
            o += STAT_QSIZE * STAT_QSIZE
            nz = buf[o:o + STAT_QSIZE * STAT_NCODES].reshape(STAT_QSIZE,
                                                             STAT_NCODES)
            stats[ci] = NativeStats(int(buf[0]), lc, qi, qt, nz)

        return NativeParse(
            n1=n1, seq1=seq1, qual1=qual1, len1=len1, seq2=seq2,
            qual2=qual2, len2=len2, nh=nh, sid=sid, pos=pos, ins=ins,
            cat0=cat(0, c0n, c0s1, c0s2), cat2=cat(2, c2n, c2s1, c2s2),
            lq1=lq1, lq2=lq2, stats=stats, n_iso_multi=n_iso_multi)
    finally:
        L.bamparse_free(h)


def bgzf_compress(data, level: int = 6,
                  n_threads: Optional[int] = None) -> bytes:
    """Parallel BGZF compression of `data` (bytes-like) into complete
    members of at most 65,280 input bytes each (the reference compresses
    with hts_set_threads, BamWriter.h:72). Raises RuntimeError if the
    sidecar cannot be built or a block fails to compress."""
    L = lib()
    buf = np.frombuffer(data, dtype=np.uint8)
    if buf.size == 0:
        return b""
    out = np.empty(int(L.bgzf_compress_bound(buf.size)), dtype=np.uint8)
    n = L.bgzf_compress(buf.ctypes.data_as(_c_u8p), buf.size, int(level),
                        _threads(n_threads), out.ctypes.data_as(_c_u8p))
    if n < 0:
        raise RuntimeError("bgzf_compress: a block failed to compress")
    return out[:n].tobytes()
