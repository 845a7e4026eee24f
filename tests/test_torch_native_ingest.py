"""The port's native BAM/SAM ingest (rsem_tpu_torch/native/bamparse.cpp,
io/sam.parse_alignments(use_native=True)) against its own pure-Python
record loop (use_native=False, the oracle) and against the JAX package's
sidecar (rsem_tpu.io.sam.parse_alignments), byte-identical bundles on the
golden fixtures and crafted edge cases (N0/N2 categories, reverse-strand
hits, multireads, mates); and the BAM writer's BGZF blocks, compressed by
the sidecar, decompressing to the bytes written. Every test runs on both
builds of the sidecar: with libdeflate, and with zlib alone (the build of a
host without libdeflate)."""

import gzip
import os
import shutil
import struct
import zlib

import numpy as np
import pytest
import torch

from rsem_tpu.io.bamio import BgzfWriter as JBgzfWriter
from rsem_tpu.io.sam import parse_alignments as jparse
from rsem_tpu_torch.io import bamio
from rsem_tpu_torch.io.bamio import BamRecWriter, BgzfWriter, open_rec_reader
from rsem_tpu_torch.io.sam import parse_alignments
from rsem_tpu_torch.native import bamparse

GOLD = os.path.join(os.path.dirname(__file__), "goldens")
SIDECAR_BUILDS = dict(zip(("libdeflate", "zlib"), bamparse.BUILDS))
GOLDEN_CASES = [("aln.sam.gz", 1), ("aln.sam.gz", 0), ("aln_pe.sam.gz", 3),
                ("aln_pe.sam.gz", 2)]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain versions run many small ops; in a test run of several
    worker processes torch's intra-op thread pool only adds contention."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True, scope="module", params=list(SIDECAR_BUILDS))
def sidecar_build(request):
    """The sidecar built and loaded with one entry of bamparse.BUILDS only,
    so that neither build stands in for the other."""
    mp = pytest.MonkeyPatch()
    mp.setattr(bamparse, "BUILDS", (SIDECAR_BUILDS[request.param],))
    mp.setattr(bamparse, "_lib", None)
    try:
        path = bamparse.build()
    except RuntimeError as exc:
        mp.undo()
        pytest.skip(f"the {request.param} build does not compile here: {exc}")
    flags, libs = SIDECAR_BUILDS[request.param]
    assert path == bamparse.library_path_for(bamparse.SRC, bamparse.LIB_NAME,
                                             [*flags, *libs])
    yield path
    mp.undo()


def _sam_to_bam(sam_path, bam_path):
    reader = open_rec_reader(sam_path)
    with BamRecWriter(bam_path, reader.header) as w:
        for rec in reader:
            w.write(rec)
    return reader.header


def _gunzip(src, dst):
    with gzip.open(src, "rb") as fi, open(dst, "wb") as fo:
        shutil.copyfileobj(fi, fo)


def _assert_bundles_equal(a, b, has_qual, paired):
    for f in ("N0", "N1", "N2", "n_iso_multi", "n_hits", "hist"):
        assert getattr(a.cnt, f) == getattr(b.cnt, f), f
    np.testing.assert_array_equal(a.omit, b.omit)
    for f in ("rid", "sid", "dir", "pos", "read_offsets") + (
            ("insert_len",) if paired else ()):
        x, y = getattr(a.hits, f), getattr(b.hits, f)
        assert x.dtype == y.dtype, f
        np.testing.assert_array_equal(x, y, err_msg=f)

    def check_mate(x, y):
        for f in ("lens", "codes", "lq") + (("quals",) if has_qual else ()):
            np.testing.assert_array_equal(getattr(x, f), getattr(y, f),
                                          err_msg=f)

    if paired:
        check_mate(a.reads.mate1, b.reads.mate1)
        check_mate(a.reads.mate2, b.reads.mate2)
        np.testing.assert_array_equal(a.reads.lq, b.reads.lq)
    else:
        check_mate(a.reads, b.reads)
    for cat in range(3):
        sa, sb = a.stats[cat], b.stats[cat]
        assert sa.n_reads == sb.n_reads
        n = min(len(sa.len_counts), len(sb.len_counts))
        np.testing.assert_array_equal(sa.len_counts[:n], sb.len_counts[:n])
        assert sa.len_counts[n:].sum() == 0 and sb.len_counts[n:].sum() == 0
        np.testing.assert_array_equal(sa.q_init, sb.q_init)
        np.testing.assert_array_equal(sa.q_tran, sb.q_tran)
        np.testing.assert_array_equal(sa.noise, sb.noise)


@pytest.fixture(scope="module")
def golden_files(tmp_path_factory):
    """Each golden SAM as plain text, gzip text and BAM, with its target
    names."""
    d = tmp_path_factory.mktemp("ingest")
    out = {}
    for fx in sorted({f for f, _ in GOLDEN_CASES}):
        sam = d / fx.replace(".gz", "")
        _gunzip(f"{GOLD}/{fx}", sam)
        bam = d / fx.replace(".sam.gz", ".bam")
        header = _sam_to_bam(str(sam), str(bam))
        out[fx] = dict(sam=str(sam), gz=f"{GOLD}/{fx}", bam=str(bam),
                       names=[""] + list(header.target_names))
    return out


@pytest.mark.parametrize("fixture,read_type", GOLDEN_CASES)
def test_native_matches_python_and_jax_on_goldens(golden_files, fixture,
                                                  read_type):
    """BAM, SAM text and gzip SAM text through the port's sidecar equal the
    port's Python loop and the JAX package's sidecar."""
    g = golden_files[fixture]
    kw = dict(has_polya=False, seed_len=25)
    has_qual, paired = read_type in (1, 3), read_type >= 2
    py = parse_alignments(g["bam"], g["names"], read_type, use_native=False,
                          **kw)
    for src in ("bam", "sam", "gz"):
        nat = parse_alignments(g[src], g["names"], read_type,
                               use_native=True, **kw)
        _assert_bundles_equal(nat, py, has_qual, paired)
    jax_b = jparse(g["bam"], g["names"], read_type, use_native=True, **kw)
    _assert_bundles_equal(nat, jax_b, has_qual, paired)


def _write_sam(path, lines):
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")


def _both(tmp_path, lines, names, read_type, **kw):
    sam = tmp_path / "x.sam"
    _write_sam(sam, lines)
    bam = str(tmp_path / "x.bam")
    _sam_to_bam(str(sam), bam)
    nat = parse_alignments(bam, names, read_type, use_native=True, **kw)
    py = parse_alignments(bam, names, read_type, use_native=False, **kw)
    jax_b = jparse(bam, names, read_type, use_native=True, **kw)
    _assert_bundles_equal(nat, py, read_type in (1, 3), read_type >= 2)
    _assert_bundles_equal(nat, jax_b, read_type in (1, 3), read_type >= 2)
    return nat


def test_native_categories_and_strand(tmp_path):
    """N0 (unmapped), N2 (filter tag), reverse-strand coordinate flip,
    multi-mapping grouping."""
    q30 = "?" * 10
    lines = [
        "@HD\tVN:1.0", "@SQ\tSN:t1\tLN:100", "@SQ\tSN:t2\tLN:80",
        f"r1\t0\tt1\t11\t0\t10M\t*\t0\t0\tACGTACGTAC\t{q30}",
        f"r1\t16\tt2\t21\t0\t10M\t*\t0\t0\tGTACGTACGT\t{q30}",
        f"r2\t0\tt1\t5\t0\t10M\t*\t0\t0\tAAACCCGGGT\t{q30}",
        f"r3\t4\t*\t0\t0\t*\t*\t0\t0\tTTTTTTTTTT\t{q30}\tXM:i:2",
        f"r4\t20\t*\t0\t0\t*\t*\t0\t0\tACGTAAATTT\t{q30}",
    ]
    nat = _both(tmp_path, lines, ["", "t1", "t2"], 1, has_polya=True,
                seed_len=5)
    assert (nat.cnt.N0, nat.cnt.N1, nat.cnt.N2) == (1, 2, 1)
    # strand-local flip: pos = len(t2) - pos0 - L = 80 - 20 - 10 = 50
    assert nat.hits.sid.tolist() == [1, 2, 1]
    assert nat.hits.dir.tolist() == [0, 1, 0]
    assert nat.hits.pos.tolist() == [10, 50, 4]


def test_native_paired_insert(tmp_path):
    q = "?" * 10
    lines = [
        "@HD\tVN:1.0", "@SQ\tSN:t1\tLN:200",
        f"p1\t67\tt1\t11\t0\t10M\t=\t61\t60\tACGTACGTAC\t{q}",
        f"p1\t131\tt1\t61\t0\t10M\t=\t11\t-60\tGGGGGCCCCC\t{q}",
    ]
    nat = _both(tmp_path, lines, ["", "t1"], 3, has_polya=False, seed_len=5)
    assert nat.hits.insert_len.tolist() == [60]


def test_native_rejects_gapped(tmp_path):
    lines = ["@HD\tVN:1.0", "@SQ\tSN:t1\tLN:100",
             f"r1\t0\tt1\t11\t0\t5M2D5M\t*\t0\t0\tACGTACGTAC\t{'?' * 10}"]
    sam = tmp_path / "g.sam"
    _write_sam(sam, lines)
    bam = str(tmp_path / "g.bam")
    _sam_to_bam(str(sam), bam)
    for path in (bam, str(sam)):
        with pytest.raises(ValueError, match="gapped"):
            parse_alignments(path, ["", "t1"], 1, has_polya=False,
                             seed_len=5, use_native=True)


def test_synthetic_bam_native_matches_python(tmp_path):
    """The bulk-encoded ingest BAM (testing.synthetic_bam): every read's
    records adjacent, multireads and unmapped reads, parsed alike by both
    paths and by the JAX package's sidecar."""
    from rsem_tpu_torch.testing import synthetic_bam

    path = str(tmp_path / "syn.bam")
    n_rec = synthetic_bam(path, 3000, M=40, read_len=50, seed=2)
    names = [""] + [f"t{i}" for i in range(40)]
    kw = dict(has_polya=False, seed_len=25)
    nat = parse_alignments(path, names, 1, use_native=True, **kw)
    py = parse_alignments(path, names, 1, use_native=False, **kw)
    _assert_bundles_equal(nat, py, True, False)
    _assert_bundles_equal(nat, jparse(path, names, 1, use_native=True, **kw),
                          True, False)
    assert nat.cnt.N0 + nat.cnt.N1 == 3000 and 0 < nat.cnt.N0 < 150
    assert nat.cnt.n_hits + nat.cnt.N0 == n_rec
    assert nat.hits.dir.any() and not nat.hits.dir.all()


def _bgzf_members(blob):
    """The decompressed payloads of the BGZF members of `blob` (headers,
    sizes and CRCs checked)."""
    out, off = [], 0
    while off < len(blob):
        assert blob[off:off + 4] == b"\x1f\x8b\x08\x04"
        bsize = struct.unpack_from("<H", blob, off + 16)[0] + 1
        member = blob[off:off + bsize]
        data = zlib.decompress(member[18:-8], -15)
        crc, isize = struct.unpack("<II", member[-8:])
        assert isize == len(data) <= 0xFF00 and crc == zlib.crc32(data)
        out.append(data)
        off += bsize
    return out


@pytest.mark.parametrize("level", [1, 6])
def test_bgzf_writer_round_trips(tmp_path, level):
    """BgzfWriter's batched blocks go through the sidecar's compressor: the
    file decompresses to the bytes written (as the JAX package's writer's
    does), in members of at most 65,280 bytes ending in the EOF block, and
    tell_virtual still points at the bytes written so far."""
    rng = np.random.default_rng(level)
    parts = [rng.integers(0, 4, size=n, dtype=np.uint8).tobytes()
             for n in (1000, 70_000, 3, 300_000, 65_280, 12_345)]
    marks = []
    ours, theirs = tmp_path / "a.bgzf", tmp_path / "b.bgzf"
    with BgzfWriter(str(ours), level=level) as w, \
            JBgzfWriter(str(theirs), level=level) as jw:
        for p in parts:
            marks.append(w.tell_virtual())
            w.write(p)
            jw.write(p)
        w.write(b"x" * (9 << 20))  # past BATCH_BYTES: one batched flush
        jw.write(b"x" * (9 << 20))
    data = b"".join(parts) + b"x" * (9 << 20)
    blob = ours.read_bytes()
    assert blob.endswith(bamio._BGZF_EOF)
    assert b"".join(_bgzf_members(blob)) == data
    assert gzip.decompress(blob) == gzip.decompress(theirs.read_bytes())
    for p, v in zip(parts, marks):
        coff, uoff = v >> 16, v & 0xFFFF
        rest = b"".join(_bgzf_members(blob[coff:]))
        assert rest[uoff:uoff + len(p)] == p


def test_bgzf_compress_members():
    """The sidecar's compressor alone: complete members of <= 65,280 input
    bytes, and nothing for no input."""
    data = bytes(range(256)) * 1000
    blob = bamparse.bgzf_compress(data, 6)
    members = _bgzf_members(blob)
    assert b"".join(members) == data
    assert [len(m) for m in members[:-1]] == [0xFF00] * (len(members) - 1)
    assert bamparse.bgzf_compress(b"") == b""
