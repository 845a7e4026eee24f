"""The port's BAM layer beyond ingest (rsem_tpu_torch.io.tbam2gbam,
io.bamsort, io.wiggle, pipeline.bamtools and their CLI commands): the
cases of tests/test_bam.py through the port, and the port against the JAX
package on one input. BAM bytes are compared decompressed: the port's BGZF
writer always compresses through its C++ sidecar, so compressed bytes and
the BAI's virtual offsets may differ from the JAX package's; each BAI is
checked by looking every record of its own BAM up through it."""

import os

import pytest
import torch

from rsem_tpu.__main__ import main as jax_cli
from rsem_tpu.io.bamsort import sort_bam as jax_sort_bam
from rsem_tpu.io.bamsort import strnum_key as jax_strnum_key
from rsem_tpu.io.tbam2gbam import tbam2gbam as jax_tbam2gbam
from rsem_tpu.io.wiggle import bam2readdepth as jax_bam2readdepth
from rsem_tpu.io.wiggle import bam2wig as jax_bam2wig
from rsem_tpu_torch.__main__ import main as port_cli
from rsem_tpu_torch.io.bamio import BamHeader, BamRec, BamRecReader
from rsem_tpu_torch.io.bamsort import sort_bam, strnum_key
from rsem_tpu_torch.io.tbam2gbam import _reverse_md, tbam2gbam, tr2chr
from rsem_tpu_torch.io.wiggle import bam2readdepth, bam2wig, build_depths
from rsem_tpu_torch.pipeline.bamtools import (
    get_unique,
    scan_for_paired_end_reads,
    validate_alignments,
)
from rsem_tpu_torch.refprep.transcripts import Transcript
from rsem_tpu_torch.testing import bai_finds_all, bam_records


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _write_sam(path, lines):
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")


SAM_HEADER = ["@HD\tVN:1.0", "@SQ\tSN:t1\tLN:100", "@SQ\tSN:t2\tLN:200"]


# ---- tests/test_bam.py:138-185 (tr2chr) through the port ---- #
class TestTr2Chr:
    TR_PLUS = Transcript(
        transcript_id="tx", gene_id="g", seqname="chr1", strand="+",
        structure=[(11, 18), (31, 40)],
    )

    @staticmethod
    def _ops(cig):
        return [(int(v) >> 4, int(v) & 0xF) for v in cig]

    def test_within_one_exon(self):
        pos, cig = tr2chr(self.TR_PLUS, 2, 5)
        assert pos == 11
        assert self._ops(cig) == [(4, 0)]

    def test_spliced(self):
        pos, cig = tr2chr(self.TR_PLUS, 5, 12)
        assert pos == 14
        assert self._ops(cig) == [(4, 0), (12, 3), (4, 0)]

    def test_polya_overhang(self):
        _pos, cig = tr2chr(self.TR_PLUS, 15, 22)
        assert self._ops(cig) == [(4, 0), (4, 1)]

    def test_minus_strand_flip(self):
        tr = Transcript(transcript_id="tx", gene_id="g", seqname="chr1",
                        strand="-", structure=[(11, 18)])
        pos, cig = tr2chr(tr, 1, 4)
        assert pos == 14
        assert self._ops(cig) == [(4, 0)]

    def test_reverse_md(self):
        assert _reverse_md("10A5") == "5T10"
        assert _reverse_md("3^ACG4") == "4^CGT3"
        assert _reverse_md("20") == "20"


# ---- tests/test_bam.py:188-270 (alignment tools, sorts) ---- #
class TestBamTools:
    def test_get_unique(self, tmp_path):
        lines = SAM_HEADER + [
            "u1\t0\tt1\t1\t30\t10M\t*\t0\t0\tACGTACGTAC\tIIIIIIIIII",
            "m1\t0\tt1\t1\t30\t10M\t*\t0\t0\tACGTACGTAC\tIIIIIIIIII",
            "m1\t256\tt2\t1\t30\t10M\t*\t0\t0\tACGTACGTAC\tIIIIIIIIII",
            "x1\t4\t*\t0\t0\t*\t*\t0\t0\tACGTACGTAC\tIIIIIIIIII",
        ]
        inp, outp = str(tmp_path / "in.sam"), str(tmp_path / "out.bam")
        _write_sam(inp, lines)
        assert get_unique(inp, outp) == 1
        assert [r.name for r in BamRecReader(outp)] == ["u1"]

    def test_validator_accepts_and_rejects(self, tmp_path):
        quiet = lambda *_: None  # noqa: E731
        cases = [
            ("good", "r1\t0\tt1\t1\t30\t10M\t*\t0\t0\tACGTACGTAC\tIIIIIIIIII",
             True),
            ("indel", "r1\t0\tt1\t1\t30\t5M2I3M\t*\t0\t0\tACGTACGTAC\t"
             "IIIIIIIIII", False),
            ("boundary", "r1\t0\tt1\t98\t30\t10M\t*\t0\t0\tACGTACGTAC\t"
             "IIIIIIIIII", False),
        ]
        for name, line, ok in cases:
            inp = str(tmp_path / f"{name}.sam")
            _write_sam(inp, SAM_HEADER + [line])
            assert validate_alignments(inp, log=quiet) is ok, name

    def test_scan_for_paired_end_reads(self, tmp_path):
        lines = SAM_HEADER + [
            "p1\t131\tt1\t41\t30\t10M\t=\t1\t-50\tACGTACGTAC\tIIIIIIIIII",
            "p1\t67\tt1\t1\t30\t10M\t=\t41\t50\tACGTACGTAC\tIIIIIIIIII",
        ]
        inp, outp = str(tmp_path / "pe.sam"), str(tmp_path / "pe.bam")
        _write_sam(inp, lines)
        assert scan_for_paired_end_reads(inp, outp) == 2
        got = list(BamRecReader(outp))
        assert got[0].is_read1 and got[1].is_read2

    def test_sort_coordinate_and_index(self, tmp_path):
        lines = SAM_HEADER + [
            "b\t0\tt2\t5\t30\t10M\t*\t0\t0\tACGTACGTAC\tIIIIIIIIII",
            "a\t0\tt1\t50\t30\t10M\t*\t0\t0\tACGTACGTAC\tIIIIIIIIII",
            "c\t0\tt1\t2\t30\t10M\t*\t0\t0\tACGTACGTAC\tIIIIIIIIII",
            "u\t4\t*\t0\t0\t*\t*\t0\t0\tACGTACGTAC\tIIIIIIIIII",
        ]
        inp, outp = str(tmp_path / "in.sam"), str(tmp_path / "sorted.bam")
        _write_sam(inp, lines)
        bai = sort_bam(inp, outp, by="coordinate", build_index=True)
        assert [r.name for r in BamRecReader(outp)] == ["c", "a", "b", "u"]
        assert bai and open(bai, "rb").read(4) == b"BAI\x01"
        assert bai_finds_all(outp, bai) == 3

    def test_sort_by_name_natural(self, tmp_path):
        assert strnum_key("r2") < strnum_key("r10")
        lines = SAM_HEADER + [
            f"r{i}\t0\tt1\t1\t30\t10M\t*\t0\t0\tACGTACGTAC\tIIIIIIIIII"
            for i in (10, 2, 1)
        ]
        inp, outp = str(tmp_path / "in.sam"), str(tmp_path / "ns.bam")
        _write_sam(inp, lines)
        sort_bam(inp, outp, by="name")
        assert [r.name for r in BamRecReader(outp)] == ["r1", "r2", "r10"]


@pytest.mark.parametrize("names", [
    ["r10", "r2", "r02", "r002", "r1", "r0", "r00", "a9b", "a10b", "a9c",
     "x", "r"],
    ["S7", "S70", "S007", "S07", "S0", "T1_2", "T1_10", "T01_3"],
])
def test_strnum_key_matches_jax(names):
    """samtools' natural order, zero-padded digit runs included."""
    assert sorted(names, key=strnum_key) == sorted(names, key=jax_strnum_key)
    assert [strnum_key(n) for n in names] == [jax_strnum_key(n)
                                              for n in names]


def test_name_sort_keep_pairs(tmp_path):
    """A multi-mapped pair: samtools' flag tie-break puts both read-1
    records first (as the JAX package's sort does); keep_pairs keeps each
    alignment's mates adjacent, the alignments in input order."""
    s, q = "ACGTACGTAC", "IIIIIIIIII"
    lines = SAM_HEADER + [
        f"p2\t99\tt1\t1\t255\t10M\t=\t41\t50\t{s}\t{q}",
        f"p10\t99\tt2\t5\t255\t10M\t=\t45\t50\t{s}\t{q}",
        f"p10\t147\tt2\t45\t255\t10M\t=\t5\t-50\t{s}\t{q}",
        f"p2\t355\tt2\t1\t255\t10M\t=\t41\t50\t{s}\t{q}",
        f"p2\t147\tt1\t41\t255\t10M\t=\t1\t-50\t{s}\t{q}",
        f"p2\t403\tt2\t41\t255\t10M\t=\t1\t-50\t{s}\t{q}",
    ]
    inp = str(tmp_path / "pe.sam")
    _write_sam(inp, lines)
    jax_sort_bam(inp, str(tmp_path / "j.bam"), by="name")
    sort_bam(inp, str(tmp_path / "p.bam"), by="name")
    sort_bam(inp, str(tmp_path / "k.bam"), by="name", keep_pairs=True)
    flags = lambda p: [(r.name, r.flag) for r in BamRecReader(p)]  # noqa
    assert flags(tmp_path / "p.bam") == flags(tmp_path / "j.bam") == [
        ("p2", 99), ("p2", 355), ("p2", 147), ("p2", 403), ("p10", 99),
        ("p10", 147)]
    assert flags(tmp_path / "k.bam") == [
        ("p2", 99), ("p2", 147), ("p2", 355), ("p2", 403), ("p10", 99),
        ("p10", 147)]


# ---- tests/test_bam.py:273-300 (wiggle) ---- #
class TestWiggle:
    def _sam(self, tmp_path):
        lines = SAM_HEADER + [
            "r1\t0\tt1\t1\t30\t10M\t*\t0\t0\tACGTACGTAC\tIIIIIIIIII\tZW:f:0.5",
            "r1\t0\tt1\t6\t30\t10M\t*\t0\t0\tACGTACGTAC\tIIIIIIIIII\tZW:f:0.5",
            "r2\t0\tt1\t1\t30\t10M\t*\t0\t0\tACGTACGTAC\tIIIIIIIIII",
        ]
        inp = str(tmp_path / "w.sam")
        _write_sam(inp, lines)
        return inp

    def test_depths_fractional(self, tmp_path):
        _n, _l, depths = build_depths(self._sam(tmp_path))
        d = depths[0]
        assert d[0] == pytest.approx(0.5)
        assert d[7] == pytest.approx(1.0)
        assert d[12] == pytest.approx(0.5)
        assert 1 not in depths

    def test_depths_unit_weight(self, tmp_path):
        _n, _l, depths = build_depths(self._sam(tmp_path),
                                      no_fractional_weight=True)
        assert depths[0][0] == pytest.approx(2.0)

    def test_wig_and_readdepth_files(self, tmp_path):
        inp = self._sam(tmp_path)
        wig, rd = str(tmp_path / "o.wig"), str(tmp_path / "o.rd")
        bam2wig(inp, wig, "trackname")
        content = open(wig).read()
        assert content.startswith('track type=wiggle_0 name="trackname"')
        assert "fixedStep chrom=t1 start=1 step=1" in content
        bam2readdepth(inp, rd)
        rows = open(rd).read().splitlines()
        assert rows[0].startswith("t1\t100\t0.5 0.5")
        assert rows[1] == "t2\t200\tNA"


# ---- the port against the JAX package on one genome-reference input ---- #
EXON1 = "ACGTACGTTCGATCGATTGA"  # chr1:1-20
EXON2 = "TTTTCCCCAAAAGGGGACGT"  # chr1:31-50
CHR1 = EXON1 + "GGGGGGGGGG" + EXON2 + "CATGCATGCA" * 4


@pytest.fixture(scope="module")
def genome_case(tmp_path_factory):
    """A GTF reference (a spliced '+' transcript, a spliced '-' transcript
    over the same exons, a one-exon '-' transcript) and a transcript BAM
    with ZW tags, multireads, a pair, MD tags and an unmapped read."""
    from rsem_tpu_torch.pipeline.prepare_reference import main as prep
    from rsem_tpu_torch.utils.seq import revcomp

    d = tmp_path_factory.mktemp("gbam")
    (d / "genome.fa").write_text(f">chr1\n{CHR1}\n")
    (d / "anno.gtf").write_text("".join(
        f'chr1\tsrc\texon\t{a}\t{b}\t.\t{s}\t.\tgene_id "{g}"; '
        f'transcript_id "{t}";\n'
        for a, b, s, g, t in ((1, 20, "+", "g1", "tP"), (31, 50, "+", "g1",
                                                          "tP"),
                              (1, 20, "-", "g2", "tM"), (31, 50, "-", "g2",
                                                         "tM"),
                              (55, 80, "-", "g3", "tR"))))
    cwd = os.getcwd()
    os.chdir(d)
    try:
        assert prep(["--gtf", "anno.gtf", "genome.fa", "gref", "-q"]) == 0
    finally:
        os.chdir(cwd)
    tp = EXON1 + EXON2
    tm = revcomp(EXON1 + EXON2)
    tr = revcomp(CHR1[54:80])
    q = "ABCDEFGHIJKLMNOPQRSTUVWXYZ"
    hdr = BamHeader("@HD\tVN:1.0\n@SQ\tSN:tP\tLN:40\n@SQ\tSN:tM\tLN:40\n"
                    "@SQ\tSN:tR\tLN:26\n", ["tP", "tM", "tR"], [40, 40, 26])
    tid = {"tP": 0, "tM": 1, "tR": 2}
    rows = [
        # a multiread: the same genome bases on tP and tM (collapses)
        ["m1", "0", "tP", "6", "100", "12M", "*", "0", "0", tp[5:17],
         q[:12], "ZW:f:0.25", "MD:Z:3A8"],
        ["m1", "272", "tM", "24", "100", "12M", "*", "0", "0", tm[23:35],
         q[:12], "ZW:f:0.5", "MD:Z:2^T10"],
        ["u1", "16", "tR", "3", "255", "20M", "*", "0", "0", tr[2:22],
         q[:20], "ZW:f:1", "MD:Z:20"],
        ["p1", "99", "tP", "2", "255", "10M", "=", "26", "34", tp[1:11],
         q[:10], "ZW:f:0.9"],
        ["p1", "147", "tP", "26", "255", "10M", "=", "2", "-34", tp[25:35],
         q[:10], "ZW:f:0.9"],
        ["x1", "4", "*", "0", "0", "*", "*", "0", "0", "ACGTACGTAC",
         q[:10]],
    ]
    from rsem_tpu_torch.io.bamio import BamRecWriter

    with BamRecWriter(str(d / "t.bam"), hdr) as w:
        for r in rows:
            w.write(BamRec.from_sam_fields(r, tid))
    return d


def _stream(path):
    recs, _v, header = bam_records(str(path))
    return header, recs


def test_tbam2gbam_matches_jax(genome_case):
    """Equal decompressed record streams and headers; the multiread
    collapses to one record with the summed ZW, '-' strand records are
    flipped."""
    d = genome_case
    n_p = tbam2gbam(str(d / "gref"), str(d / "t.bam"), str(d / "p.bam"))
    n_j = jax_tbam2gbam(str(d / "gref"), str(d / "t.bam"), str(d / "j.bam"))
    assert n_p == n_j == 5
    assert _stream(d / "p.bam") == _stream(d / "j.bam")
    got = {(r.name, r.flag): r for r in BamRecReader(str(d / "p.bam"))}
    m1 = [r for (n, _f), r in got.items() if n == "m1"]
    assert len(m1) == 1 and m1[0].get_tag("ZW") == pytest.approx(0.75)
    u1 = got[("u1", 0)]  # '-' transcript: the strand flag flips back
    assert u1.get_tag("MD") == "20"


@pytest.mark.parametrize("by,index", [("coordinate", True),
                                      ("name", False)])
def test_sort_bam_matches_jax(genome_case, by, index):
    """The port's sort against the JAX package's: equal decompressed
    record streams; the port's BAI finds every record of its BAM."""
    d = genome_case
    src = d / "p.bam"
    if not src.exists():
        tbam2gbam(str(d / "gref"), str(d / "t.bam"), str(src))
    for s in (src, d / "t.bam"):
        p_out, j_out = str(d / f"{s.stem}.{by}.p.bam"), str(
            d / f"{s.stem}.{by}.j.bam")
        bai = sort_bam(str(s), p_out, by=by, build_index=index)
        jax_sort_bam(str(s), j_out, by=by, build_index=index)
        assert _stream(p_out) == _stream(j_out)
        if index:
            assert bai_finds_all(p_out, bai) == sum(
                1 for r in BamRecReader(p_out) if r.tid >= 0)


def test_wiggle_text_matches_jax(genome_case):
    d = genome_case
    src = str(d / "p.bam")
    if not os.path.exists(src):
        tbam2gbam(str(d / "gref"), str(d / "t.bam"), src)
    srt = str(d / "w.sorted.bam")
    sort_bam(src, srt, by="coordinate")
    for frac in (False, True):
        bam2wig(srt, str(d / "p.wig"), "trk", frac)
        jax_bam2wig(srt, str(d / "j.wig"), "trk", frac)
        assert open(d / "p.wig").read() == open(d / "j.wig").read()
    bam2readdepth(srt, str(d / "p.rd"))
    jax_bam2readdepth(srt, str(d / "j.rd"))
    assert open(d / "p.rd").read() == open(d / "j.rd").read()
    assert "chr1\t90\t" in open(d / "p.rd").read()


@pytest.mark.parametrize("cmd,args,outs", [
    ("tbam2gbam", ["gref", "t.bam", "{o}.bam"], [".bam"]),
    ("sort-bam", ["t.bam", "{o}.bam", "--by", "coordinate", "--index"],
     [".bam"]),
    ("sort-bam", ["t.bam", "{o}.bam", "--by", "name"], [".bam"]),
    ("get-unique", ["t.bam", "{o}.bam"], [".bam"]),
    ("sam-validator", ["t.bam"], []),
    ("scan-for-paired-end-reads", ["t.bam", "{o}.bam"], [".bam"]),
    ("bam2wig", ["w.sorted.bam", "{o}.wig", "trk"], [".wig"]),
    ("bam2readdepth", ["w.sorted.bam", "{o}.rd"], [".rd"]),
])
def test_cli_commands_match_jax(genome_case, cmd, args, outs, capsys):
    """Each BAM command through `python -m rsem_tpu_torch` and
    `python -m rsem_tpu`: same exit code, same stdout, same outputs
    (BAMs decompressed)."""
    d = genome_case
    cwd = os.getcwd()
    os.chdir(d)
    try:
        if not os.path.exists("w.sorted.bam"):
            tbam2gbam("gref", "t.bam", "w.bam")
            sort_bam("w.bam", "w.sorted.bam", by="coordinate")
        res = {}
        for side, cli in (("port", port_cli), ("jax", jax_cli)):
            o = f"{cmd}.{side}"
            rc = cli([cmd] + [a.format(o=o) for a in args])
            res[side] = (rc, capsys.readouterr().out)
        assert res["port"] == res["jax"]
        for ext in outs:
            p, j = f"{cmd}.port{ext}", f"{cmd}.jax{ext}"
            if ext == ".bam":  # @PG CL names each side's output file
                (hp, rp), (hj, rj) = _stream(p), _stream(j)
                assert rp == rj
                assert hp[8:].replace(p.encode(), b"<out>") == hj[8:].replace(
                    j.encode(), b"<out>")
            else:
                assert open(p).read() == open(j).read()
    finally:
        os.chdir(cwd)


def test_convert_sam_for_rsem_matches_jax(tmp_path, capsys):
    """convert-sam-for-rsem: name-sort, regroup mates, validate."""
    lines = SAM_HEADER + [
        "p2\t147\tt1\t41\t30\t10M\t=\t1\t-50\tACGTACGTAC\tIIIIIIIIII",
        "p1\t99\tt2\t1\t30\t10M\t=\t41\t50\tACGTACGTAC\tIIIIIIIIII",
        "p2\t99\tt1\t1\t30\t10M\t=\t41\t50\tACGTACGTAC\tIIIIIIIIII",
        "p1\t147\tt2\t41\t30\t10M\t=\t1\t-50\tACGTACGTAC\tIIIIIIIIII",
    ]
    inp = str(tmp_path / "in.sam")
    _write_sam(inp, lines)
    assert port_cli(["convert-sam-for-rsem", inp, "-o",
                     str(tmp_path / "p")]) == 0
    assert jax_cli(["convert-sam-for-rsem", inp, "-o",
                    str(tmp_path / "j")]) == 0
    assert _stream(tmp_path / "p.bam") == _stream(tmp_path / "j.bam")
    names = [(r.name, r.is_read1) for r in BamRecReader(
        str(tmp_path / "p.bam"))]
    assert names == [("p1", True), ("p1", False), ("p2", True),
                     ("p2", False)]
    assert capsys.readouterr().out.count("Output written to") == 2
