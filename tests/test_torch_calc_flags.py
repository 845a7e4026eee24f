"""The port's calculate-expression flags beyond the default path: the genome
BAM and the BAM sorts (tests/test_bam.py:371-415 through the port's CLI,
and chip_smoke.py's phase 14 at a toy size), the input forms of
tests/test_aligners.py:117-140, and an aligner run through a stub aligner,
JAX and port drivers side by side."""

import gzip
import os
import shutil
import stat
import sys

import numpy as np
import pytest
import torch

from rsem_tpu.pipeline.calculate_expression import main as jax_calc
from rsem_tpu_torch.io.bamio import BamRecReader
from rsem_tpu_torch.pipeline.calculate_expression import (
    _resolve_inputs,
    build_parser,
)
from rsem_tpu_torch.pipeline.calculate_expression import main as port_calc
from rsem_tpu_torch.testing import bai_finds_all

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLD = os.path.join(ROOT, "tests", "goldens")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_output_genome_bam(tmp_path, monkeypatch):
    """GTF reference -> transcript alignment -> genome BAM with a spliced
    cigar and XS tag, sorted copies of both BAMs with BAIs that find every
    record (tests/test_bam.py:371-415 through the port)."""
    from rsem_tpu_torch.pipeline.prepare_reference import main as prep

    exon1 = "ACGTACGTACGTACGTACGT"
    exon2 = "TTTTCCCCAAAATTTTCCCC"
    chr1 = exon1 + "GGGGGGGGGG" + exon2
    monkeypatch.chdir(tmp_path)
    (tmp_path / "genome.fa").write_text(f">chr1\n{chr1}\n")
    (tmp_path / "anno.gtf").write_text("".join(
        f'chr1\tsrc\texon\t{a}\t{b}\t.\t+\t.\tgene_id "g1"; '
        'transcript_id "tS";\n' for a, b in ((1, 20), (31, 50))))
    assert prep(["--gtf", "anno.gtf", "genome.fa", "gref", "-q"]) == 0
    tx = exon1 + exon2
    frag = tx[5:35]
    (tmp_path / "aln.sam").write_text("\n".join([
        "@HD\tVN:1.0", f"@SQ\tSN:tS\tLN:{len(tx)}",
        f"j1\t0\ttS\t6\t30\t30M\t*\t0\t0\t{frag}\t{'I' * 30}"]) + "\n")
    assert port_calc(["--alignments", "aln.sam", "gref", "gsample", "-q",
                      "--device", "cpu", "--output-genome-bam",
                      "--sort-bam-by-coordinate", "--time"]) == 0
    got = list(BamRecReader("gsample.genome.bam"))
    assert len(got) == 1
    r = got[0]
    assert r.pos == 5
    assert list(r.cigar_ops()) == [(15, "M"), (10, "N"), (15, "M")]
    assert r.get_tag("XS") == "+"
    assert r.get_tag("ZW") == pytest.approx(1.0)
    for kind in ("genome", "transcript"):
        bam = f"gsample.{kind}.sorted.bam"
        assert bai_finds_all(bam, bam + ".bai") == 1
    stages = open("gsample.time").read()
    for stage in ("bam-output", "tbam2gbam", "sort-bam-by-coordinate"):
        assert f"# {stage}: " in stages, stage


def test_bam_phase_at_toy_size(tmp_path):
    """chip_smoke.py's phase 14 on the CPU at a toy size: paired reads on
    a seeded genome reference, sibling-isoform alignments, --output-genome-
    bam --sort-bam-by-coordinate, then --sort-bam-by-read-name on the
    shuffled SAM (identical .cnt and tables); the phase's own gates."""
    sys.path.insert(0, ROOT)
    try:
        import chip_smoke
    finally:
        sys.path.remove(ROOT)
    launches, out = chip_smoke.phase_genome_bam(
        str(tmp_path), device="cpu", n_pairs=2000, n_genes=24,
        chrom_len=24_000)
    assert all(n == 0 for n in launches.values())  # plain versions on CPU
    assert out["sibling_alignments"] > 0
    assert out["genome_records"] == 4000
    assert out["bai_lookups"] > out["genome_records"]


def test_alignments_flag_styles():
    """The input forms of tests/test_aligners.py:117-140."""
    p = build_parser()
    a = p.parse_args(["--alignments", "x.sam", "ref", "smp"])
    assert _resolve_inputs(a) == ("x.sam", None, "ref", "smp")
    a = p.parse_args(["--alignments", "--", "x.bam", "ref", "smp"])
    assert _resolve_inputs(a) == ("x.bam", None, "ref", "smp")
    a = p.parse_args(["--bam", "x.bam", "ref", "smp"])
    assert _resolve_inputs(a) == ("x.bam", None, "ref", "smp")
    a = p.parse_args(["r1.fq", "ref", "smp"])
    assert _resolve_inputs(a) == (None, ("r1.fq", None), "ref", "smp")
    a = p.parse_args(["--paired-end", "r1.fq", "r2.fq", "ref", "smp"])
    assert _resolve_inputs(a) == (None, ("r1.fq", "r2.fq"), "ref", "smp")
    with pytest.raises(SystemExit):
        _resolve_inputs(p.parse_args(["--paired-end", "r1.fq", "ref",
                                      "smp"]))


def test_missing_aligner_binary_errors(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(FileNotFoundError, match="bowtie"):
        port_calc(["reads.fq", "ref", "smp", "-q", "--device", "cpu"])


def test_jax_flags_accepted_but_prsem():
    """Every option of the JAX driver's parser, pRSEM's included, with the
    same defaults; the port's parser adds --device alone."""
    from rsem_tpu.pipeline.calculate_expression import (
        build_parser as jax_parser,
    )

    def opts(p):
        return {o: a.default for a in p._actions for o in a.option_strings}

    jax_opts, port_opts = opts(jax_parser()), opts(build_parser())
    missing = set(jax_opts) - set(port_opts)
    assert not missing, missing
    assert set(port_opts) - set(jax_opts) == {"--device"}
    for o in ("--run-pRSEM", "--chipseq-peak-file", "--partition-model",
              "--chipseq-target-read-files", "--chipseq-bowtie-index"):
        assert port_opts[o] == jax_opts[o], o


def _stub_aligner(d, sam):
    """A `bowtie2` that ignores its arguments and prints a prepared SAM."""
    exe = d / "bowtie2"
    exe.write_text(f"#!/bin/sh\ncat {sam}\n")
    exe.chmod(exe.stat().st_mode | stat.S_IXUSR)
    return d


def test_stub_aligner_run_matches_jax(tmp_path, monkeypatch):
    """Reads in, aligner run by the driver (a stub given by
    --bowtie2-path that writes the golden SAM): the JAX and the port
    drivers give the same tables at the golden tolerances, and each
    .time starts with an `Aligning reads:` line."""
    for f in ("ref.seq", "ref.ti", "ref.grp"):
        shutil.copy(os.path.join(GOLD, f), tmp_path)
    with gzip.open(os.path.join(GOLD, "aln.sam.gz"), "rb") as fi, \
            open(tmp_path / "prepared.sam", "wb") as fo:
        shutil.copyfileobj(fi, fo)
    bindir = tmp_path / "bin"
    bindir.mkdir()
    _stub_aligner(bindir, tmp_path / "prepared.sam")
    (tmp_path / "reads.fq").write_text("")
    monkeypatch.chdir(tmp_path)
    common = ["--bowtie2", "--bowtie2-path", str(bindir), "-q", "--time",
              "--no-bam-output", "reads.fq", "ref"]
    assert jax_calc(common + ["jax"]) == 0
    assert port_calc(["--device", "cpu"] + common + ["port"]) == 0

    def table(name):
        rows = [l.rstrip("\n").split("\t")
                for l in open(f"{name}.isoforms.results")]
        return {r[0]: r for r in rows[1:]}

    j, p = table("jax"), table("port")
    assert j.keys() == p.keys()
    cnt = np.array([[float(j[k][4]), float(p[k][4])] for k in j])
    tpm = np.array([[float(j[k][5]), float(p[k][5])] for k in j])
    assert np.abs(cnt[:, 0] - cnt[:, 1]).max() < 1.0
    assert (np.abs(tpm[:, 0] - tpm[:, 1]) / 1e6).max() < 2e-4
    assert open("port.stat/port.cnt").read() == open("jax.stat/jax.cnt").read()
    for name in ("jax", "port"):
        first = open(f"{name}.time").readline()
        assert first.startswith("Aligning reads: "), (name, first)
        assert os.path.exists(f"{name}.log")  # the aligner's stderr
