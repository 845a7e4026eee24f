"""The port's prepare-reference (host code: refprep/*, pipeline/
prepare_reference.py, pipeline/aligners.py) against the JAX package's:
every output file byte-identical on the same inputs, the GFF3 converter
and the aligner command lines equal, and the golden reference
reproduced byte for byte through `python -m rsem_tpu_torch`."""

import os

import pytest

from rsem_tpu.pipeline import aligners as jax_aligners
from rsem_tpu.pipeline.prepare_reference import main as jax_prepare
from rsem_tpu.refprep.gff3 import gff3_to_gtf as jax_gff3_to_gtf
from rsem_tpu_torch.__main__ import main as port_main
from rsem_tpu_torch.pipeline import aligners as port_aligners
from rsem_tpu_torch.refprep.gff3 import gff3_to_gtf as port_gff3_to_gtf

GOLD = os.path.join(os.path.dirname(__file__), "goldens")

# the small synthetic inputs of tests/test_refprep.py
GENOME = {
    "chr1": "ACGTACGTACGTACGTACGTAAACCCGGGTTTACGTACGTACGT",
    "chr2": "TTTTGGGGCCCCAAAATTTTGGGGCCCCAAAA",
}
GTF = """\
chr1\tsrc\texon\t1\t8\t.\t+\t.\tgene_id "gA"; transcript_id "tA1";
chr1\tsrc\texon\t13\t20\t.\t+\t.\tgene_id "gA"; transcript_id "tA1";
chr1\tsrc\texon\t1\t20\t.\t+\t.\tgene_id "gA"; transcript_id "tA2";
chr2\tsrc\texon\t5\t16\t.\t-\t.\tgene_id "gB"; transcript_id "tB1"; gene_name "Bgene";
chr1\tsrc\tCDS\t1\t4\t.\t+\t.\tgene_id "gA"; transcript_id "tA1";
"""
GFF3 = (
    "##gff-version 3\n"
    "chr1\tsrc\tgene\t1\t40\t.\t+\t.\tID=g1;Name=GeneOne\n"
    "chr1\tsrc\tmRNA\t1\t40\t.\t+\t.\tID=t1;Parent=g1;Name=TxOne\n"
    "chr1\tsrc\texon\t1\t12\t.\t+\t.\tParent=t1\n"
    "chr1\tsrc\texon\t10\t30\t.\t+\t.\tParent=t1\n"
    "chr1\tsrc\tncRNA\t1\t20\t.\t+\t.\tID=t2;Parent=g1\n"
    "chr1\tsrc\texon\t1\t20\t.\t+\t.\tParent=t2\n"
    "chr2\tsrc\tgene\t2\t30\t.\t-\t.\tID=g2\n"
    "chr2\tsrc\tmRNA\t2\t30\t.\t-\t.\tID=t3;Parent=g2\n"
    "chr2\tsrc\texon\t2\t9\t.\t-\t.\tParent=t3\n"
    "chr2\tsrc\texon\t15\t30\t.\t-\t.\tParent=t3\n"
)


def _inputs(d):
    """Write every case's inputs into `d`."""
    (d / "genome.fa").write_text(
        "".join(f">{name} extra\n{seq}\n" for name, seq in GENOME.items()))
    (d / "anno.gtf").write_text(GTF)
    (d / "anno.gff3").write_text(GFF3)
    (d / "t.fa").write_text(">t1\n" + "ACGT" * 10 + "\n>t2\nACGTACGT\n"
                            ">t3 desc\nTTGCANNACGTTGCAGGCA\n")
    (d / "nopolya.txt").write_text("t2\n")
    (d / "alleles.fa").write_text(
        ">a1\nACGTACGTAC\n>a2\nACGTACGAAC\n>b1\nTTTTCCCC\n")
    (d / "alleles.map").write_text("gX tX a1\ngX tX a2\ngY tY b1\n")


def _case_args(case, d):
    if case == "golden":
        return ["--transcript-to-gene-map", os.path.join(GOLD, "map.txt"),
                os.path.join(GOLD, "tx.fa"), "ref", "-q"]
    if case == "gtf_minus_strand":
        return ["--gtf", str(d / "anno.gtf"), str(d / "genome.fa"), "ref",
                "-q"]
    if case == "polyA_subset":
        return ["--polyA", "--polyA-length", "7", "--no-polyA-subset",
                str(d / "nopolya.txt"), str(d / "t.fa"), "ref", "-q"]
    if case == "allele":
        return ["--allele-to-gene-map", str(d / "alleles.map"),
                str(d / "alleles.fa"), "ref", "-q"]
    if case == "gff3":
        return ["--gff3", str(d / "anno.gff3"), "--gff3-RNA-patterns",
                "mRNA", str(d / "genome.fa"), "ref", "-q"]
    raise ValueError(case)


def _files(d):
    return {p.name: p.read_bytes() for p in sorted(d.iterdir())}


@pytest.mark.parametrize("case", ["golden", "gtf_minus_strand",
                                  "polyA_subset", "allele", "gff3"])
def test_prepare_reference_matches_jax(case, tmp_path, monkeypatch):
    inp, jax_dir, port_dir = (tmp_path / "in", tmp_path / "jax",
                              tmp_path / "port")
    for p in (inp, jax_dir, port_dir):
        p.mkdir()
    _inputs(inp)
    args = _case_args(case, inp)
    monkeypatch.chdir(jax_dir)
    assert jax_prepare(args) == 0
    monkeypatch.chdir(port_dir)
    assert port_main(["prepare-reference"] + args) == 0
    want, got = _files(jax_dir), _files(port_dir)
    assert {"ref.seq", "ref.ti", "ref.grp", "ref.transcripts.fa",
            "ref.idx.fa", "ref.n2g.idx.fa"} <= set(got)
    assert sorted(got) == sorted(want)
    for name in want:
        assert got[name] == want[name], name
    if case == "golden":
        for name in ("ref.seq", "ref.ti", "ref.grp", "ref.transcripts.fa"):
            with open(os.path.join(GOLD, name), "rb") as f:
                assert got[name] == f.read(), name
    if case == "gtf_minus_strand":
        assert got["ref.chrlist"] == b"chr1\t44\nchr2\t32\n"
        # tB1 (minus strand) is the reverse complement of chr2:5-16
        assert b">tB1\nTTTTGGGGCCCC\n" in got["ref.transcripts.fa"]
    if case == "allele":
        assert {"ref.gt", "ref.ta"} <= set(got)


def test_gff3_to_gtf_matches_jax(tmp_path):
    (tmp_path / "in.gff3").write_text(GFF3)
    for rna, genes in (("mRNA", False), ("mRNA,ncRNA", False),
                       ("mRNA", True)):
        a, b = tmp_path / "jax.gtf", tmp_path / "port.gtf"
        n_jax = jax_gff3_to_gtf(str(tmp_path / "in.gff3"), str(a),
                                rna_patterns=rna, genes_as_transcripts=genes)
        n_port = port_gff3_to_gtf(str(tmp_path / "in.gff3"), str(b),
                                  rna_patterns=rna,
                                  genes_as_transcripts=genes)
        assert n_port == n_jax
        assert b.read_bytes() == a.read_bytes()
    assert n_port > 0


# (function, positional args, AlignerConfig fields or keyword args): the
# argument sets of tests/test_aligners.py
ALIGNER_CASES = [
    ("bowtie_command", ("ref", "smp", "smp.temp/smp", "r1.fq"),
     dict(n_threads=4)),
    ("bowtie_command", ("ref", "smp", "imd", "a1.fa,a2.fa", "b1.fa"),
     dict(no_qualities=True, phred33=False, phred64=True, probF=1.0,
          bowtie_path="/tools/bt", fragment_length_min=5,
          fragment_length_max=800, bowtie_chunkmbs=256)),
    ("bowtie2_command", ("ref", "smp", "imd", "r1.fq"),
     dict(aligner="bowtie2")),
    ("bowtie2_command", ("ref", "smp", "imd", "m1.fq", "m2.fq"),
     dict(aligner="bowtie2", probF=0.0,
          bowtie2_sensitivity_level="very_sensitive")),
    ("star_command", ("refs/ref", "smp", "smp.temp/smp", "r1.fq", "r2.fq"),
     dict(aligner="star", n_threads=8)),
    ("star_command", ("ref", "smp", "imd", "r1.fq.gz"),
     dict(aligner="star", star_gzipped_read_file=True)),
    ("hisat2_hca_command", ("ref", "out/smp", "imd", "r1.fq"),
     dict(aligner="hisat2-hca")),
    ("build_alignment_command", ("r", "s", "i", "m"),
     dict(aligner="star")),
    ("build_alignment_command", ("r", "s", "i", "m", "m2"),
     dict(aligner="bowtie", phred33=False, solexa=True, probF=0.0)),
    ("bowtie_build_command", ("", "ref"), None),
    ("bowtie2_build_command", ("", "ref"), dict(n_threads=4)),
    ("hisat2_build_command", ("/h2", "ref"), dict(quiet=True)),
    ("star_genome_generate_command",
     ("", "refs/ref", ["g.fa"], "a.gtf"), None),
    ("star_genome_generate_command",
     ("/s", "ref", ["g1.fa", "g2.fa"], "a.gtf", 75, 6), None),
]


@pytest.mark.parametrize("name,args,kw", ALIGNER_CASES)
def test_aligner_commands_match_jax(name, args, kw):
    def build(mod):
        fn = getattr(mod, name)
        if name.endswith("_build_command") or name.startswith(
                "star_genome"):
            return fn(*args, **(kw or {}))
        return fn(mod.AlignerConfig(**kw), *args)

    got, want = build(port_aligners), build(jax_aligners)
    assert isinstance(got, str) and got == want


def test_aligner_dispatch_refuses_unknown():
    with pytest.raises(ValueError):
        port_aligners.build_alignment_command(
            port_aligners.AlignerConfig(aligner="nope"), "r", "s", "i", "m")


def test_cli_lists_commands_and_index_build_needs_binary(
        tmp_path, monkeypatch, capsys):
    assert port_main(["--help"]) == 0
    listed = capsys.readouterr().out.split()
    assert {"calculate-expression", "prepare-reference",
            "simulate-reads"} <= set(listed)
    # an index build whose aligner is not on PATH raises, after the
    # reference files are written
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(FileNotFoundError, match="bowtie2-build"):
        port_main(["prepare-reference", "--bowtie2",
                   "--transcript-to-gene-map", os.path.join(GOLD, "map.txt"),
                   os.path.join(GOLD, "tx.fa"), "ref", "-q"])
    assert (tmp_path / "ref.idx.fa").exists()
