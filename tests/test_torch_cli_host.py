"""The port's host commands (data matrix, EBSeq, FDR control, ngvector,
reference utilities, plots) against the JAX package's: each command runs
through both CLIs (`python -m rsem_tpu` and `python -m rsem_tpu_torch`
entry points, in process) on the inputs of the JAX tests
(tests/test_diffexp.py, tests/test_ebseq_math.py, tests/test_bam.py,
tests/test_refprep.py, tests/test_plots.py), and every file it writes is
compared byte for byte, with what it prints. The PDFs are the exception:
the same page count, non-empty."""

import contextlib
import io
import os
import shutil

import numpy as np
import pytest

from rsem_tpu.__main__ import main as jax_cli
from rsem_tpu_torch.__main__ import main as port_cli

from test_diffexp import _simulate_counts


def _matrix(path, X, names=None):
    """tests/test_diffexp.py's TestRunner._matrix."""
    names = names or [f"g{i}" for i in range(len(X))]
    with open(path, "w") as f:
        f.write("\t" + "\t".join(f'"s{j}"' for j in range(X.shape[1]))
                + "\n")
        for n, row in zip(names, X):
            f.write(f'"{n}"\t' + "\t".join(f"{v:.2f}" for v in row) + "\n")


def _ebseq_math_counts():
    """tests/test_ebseq_math.py's NB data with 60 planted DE rows."""
    rng = np.random.default_rng(0)
    G = 400
    q_true = rng.beta(2.0, 6.0, size=G)
    r_true = rng.integers(5, 40, size=G).astype(float)
    fold = np.where(np.arange(G) < 60, 4.0, 1.0)
    X1 = rng.negative_binomial(r_true[:, None], q_true[:, None], size=(G, 4))
    q2 = q_true / (fold * (1 - q_true) + q_true)
    X2 = rng.negative_binomial(r_true[:, None], q2[:, None], size=(G, 4))
    data = np.concatenate([X1, X2], axis=1).astype(float)
    data[data.sum(axis=1) == 0, 0] = 1.0
    return data


def _results_files(d):
    for s in ("a", "b"):
        (d / f"{s}.genes.results").write_text(
            "gene_id\ttranscript_id(s)\tlength\teffective_length\t"
            "expected_count\tTPM\tFPKM\n"
            f"g1\tt1\t100\t80\t{10 if s == 'a' else 20}.00\t1.0\t1.0\n"
            f"g2\tt2\t300\t280\t{5 if s == 'a' else 0}.00\t2.0\t2.0\n")
        (d / f"{s}.alleles.results").write_text(
            "allele_id\ttranscript_id\tgene_id\tlength\teffective_length\t"
            "expected_count\tTPM\tFPKM\n"
            f"a1\tt1\tg1\t100\t80\t{3 if s == 'a' else 7}.50\t1.0\t1.0\n")


def _ngvector_inputs(d):
    rng = np.random.default_rng(7)
    shared = "".join(rng.choice(list("ACGT"), size=60))
    with open(d / "tx.fa", "w") as f:
        f.write(">t1\nACGTACGTACGTACGTACGT\n>t2\nACGTACGTACGTACGTACGT\n"
                ">t3\nTTTTGGGGCCCCAAAATTTTGGGG\n>t4\nACGT\n")
        for i in range(5, 41):
            own = "".join(rng.choice(list("ACGT"), size=int(
                rng.integers(20, 200))))
            f.write(f">t{i}\n{own + shared[: i % 3 * 30]}\n")
    rng = np.random.RandomState(4)
    _matrix(d / "iso.txt", _simulate_counts(rng, n_ee=30, n_de=10),
            [f"t{i}" for i in range(1, 41)])


def _ebseq_inputs(d):
    _matrix(d / "mat.txt", _simulate_counts(np.random.RandomState(4),
                                            n_ee=40, n_de=15))
    X = np.random.RandomState(5).poisson(100, size=(30, 9)).astype(float)
    X[20:, 6:] *= 6
    _matrix(d / "multi.txt", X)
    _matrix(d / "math.txt", _ebseq_math_counts())


def _fdr_inputs(d):
    _ebseq_inputs(d)
    with contextlib.redirect_stdout(io.StringIO()):
        assert jax_cli(["run-ebseq", "mat.txt", "4,4", "res.txt"]) == 0


def _trinity_inputs(d):
    (d / "t.fa").write_text(
        ">comp0_c0_seq1 len=100\nACGT\n>comp0_c0_seq2\nACGT\n"
        ">comp1_c0_seq1\n\n>single\nAC\n")
    (d / "in.fna").write_text(
        ">chr1 Primary Assembly\nACGT\n>alt1 ALT_REF\nTTTT\n"
        ">chr2 Primary Assembly\nGG\n")
    (d / "in.gff3").write_text(
        "##gff-version 3\n"
        "chr1\tsrc\tgene\t1\t100\t.\t+\t.\tID=g1;Name=GeneOne\n"
        "chr1\tsrc\tmRNA\t1\t100\t.\t+\t.\tID=t1;Parent=g1;Name=TxOne\n"
        "chr1\tsrc\texon\t1\t40\t.\t+\t.\tParent=t1\n"
        "chr1\tsrc\texon\t35\t100\t.\t+\t.\tParent=t1\n"
        "chr1\tsrc\tncRNA\t1\t50\t.\t+\t.\tID=t2;Parent=g1\n"
        "chr1\tsrc\texon\t1\t50\t.\t+\t.\tParent=t2\n"
        "chr1\tsrc\tgene\t200\t400\t.\t-\t.\tID=g2\n"
        "chr1\tsrc\texon\t200\t400\t.\t-\t.\tParent=g2\n")


# (inputs, argv, files the command writes)
CASES = {
    "generate-data-matrix": (_results_files, [
        "generate-data-matrix", "a.genes.results", "b.genes.results"], []),
    "generate-data-matrix-alleles": (_results_files, [
        "generate-data-matrix", "a.alleles.results", "b.alleles.results"],
        []),
    "extract-transcript-to-gene-map-from-trinity": (_trinity_inputs, [
        "extract-transcript-to-gene-map-from-trinity", "t.fa", "map.txt"],
        ["map.txt"]),
    "refseq-extract-primary-assembly": (_trinity_inputs, [
        "refseq-extract-primary-assembly", "in.fna", "out.fna"],
        ["out.fna"]),
    "gff3-to-gtf": (_trinity_inputs, ["gff3-to-gtf", "in.gff3", "out.gtf"],
                    ["out.gtf"]),
    "gff3-to-gtf-genes": (_trinity_inputs, [
        "gff3-to-gtf", "in.gff3", "g.gtf", "--RNA-patterns", "mRNA,ncRNA",
        "--make-genes-as-transcripts"], ["g.gtf"]),
    "generate-ngvector": (_ngvector_inputs, [
        "generate-ngvector", "tx.fa", "out", "-k", "8", "-q"],
        ["out.ump", "out.ngvec"]),
    "run-ebseq-ngvector": (_ngvector_inputs, None, [
        "res.txt", "res.txt.normalized_data_matrix"]),
    "run-ebseq": (_ebseq_inputs, ["run-ebseq", "mat.txt", "4,4", "res.txt"],
                  ["res.txt", "res.txt.normalized_data_matrix"]),
    "run-ebseq-multi": (_ebseq_inputs, [
        "run-ebseq", "multi.txt", "3,3,3", "m.txt"],
        ["m.txt", "m.txt.pattern", "m.txt.condmeans",
         "m.txt.normalized_data_matrix"]),
    "run-ebseq-math": (_ebseq_inputs, [
        "run-ebseq", "math.txt", "4,4", "x.txt"],
        ["x.txt", "x.txt.normalized_data_matrix"]),
    "control-fdr": (_fdr_inputs, [
        "control-fdr", "res.txt", "0.05", "sel.txt"], ["sel.txt"]),
    "control-fdr-soft": (_fdr_inputs, [
        "control-fdr", "res.txt", "0.05", "soft.txt", "--soft-threshold"],
        ["soft.txt"]),
}


def _run(cli, argv):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = cli(argv)
    return rc, out.getvalue(), err.getvalue()


@pytest.mark.parametrize("case", sorted(CASES))
def test_host_command_matches_jax(case, tmp_path, monkeypatch):
    make, argv, outputs = CASES[case]
    seen = {}
    for side, cli in (("jax", jax_cli), ("port", port_cli)):
        d = tmp_path / side
        d.mkdir()
        monkeypatch.chdir(d)
        make(d)
        if argv is None:  # EBSeq on isoforms with their ngvector
            assert cli(["generate-ngvector", "tx.fa", "ng", "-k", "8",
                        "-q"]) == 0
            argv_ = ["run-ebseq", "iso.txt", "4,4", "res.txt",
                     "--ngvector", "ng.ngvec"]
        else:
            argv_ = argv
        rc, out, err = _run(cli, argv_)
        seen[side] = (rc, out, err.replace("rsem-tpu-torch", "rsem-tpu"),
                      {f: open(f, "rb").read() for f in outputs})
    assert seen["port"] == seen["jax"]
    rc, out, _err, files = seen["port"]
    assert rc == 0 and (out or all(files.values())), case


def test_host_command_refusals_match_jax(tmp_path, monkeypatch):
    """Bad arguments: the same exit codes from both CLIs."""
    monkeypatch.chdir(tmp_path)
    _ebseq_inputs(tmp_path)
    for argv in (["generate-data-matrix"],
                 ["run-ebseq", "mat.txt", "8", "r.txt"],
                 ["control-fdr", "mat.txt", "0.05", "o.txt",
                  "--hard-threshold", "--soft-threshold"],
                 ["no-such-command"]):
        assert _run(port_cli, argv)[0] == _run(jax_cli, argv)[0] != 0, argv


# --------------------------------------------------------------------- #
# plots                                                                  #
# --------------------------------------------------------------------- #
def _pdf_pages(path):
    import re

    data = open(path, "rb").read()
    assert data.startswith(b"%PDF") and len(data) > 1000
    m = re.search(rb"/Count (\d+)", data)
    return int(m.group(1)) if m else 0


@pytest.fixture(scope="module")
def plot_sample(tmp_path_factory):
    """tests/test_plots.py's sample, quantified by the JAX package."""
    pytest.importorskip("matplotlib")
    from rsem_tpu.pipeline.calculate_expression import main as calc_main
    from rsem_tpu.pipeline.prepare_reference import main as prep_main

    from test_em_end_to_end import T1, T2, T3, _make_reads

    d = tmp_path_factory.mktemp("plots")
    with pytest.MonkeyPatch.context() as mp:
        mp.chdir(d)
        (d / "tx.fa").write_text(f">t1\n{T1}\n>t2\n{T2}\n>t3\n{T3}\n")
        (d / "map.txt").write_text("gA t1\ngA t2\ngB t3\n")
        header = ["@HD\tVN:1.0"] + [f"@SQ\tSN:{n}\tLN:{len(q)}" for n, q in
                                    (("t1", T1), ("t2", T2), ("t3", T3))]
        lines = header + _make_reads({"t1": 40, "t2": 80, "t3": 40})
        (d / "aln.sam").write_text("\n".join(lines) + "\n")
        assert prep_main(["--transcript-to-gene-map", "map.txt", "tx.fa",
                          "pref", "-q"]) == 0
        assert calc_main(["--alignments", "aln.sam", "--estimate-rspd",
                          "pref", "psample", "-q"]) == 0
    return d


PLOT_CASES = {
    "plot-model": (["plot-model", "psample", "model.pdf"], "model.pdf", 4,
                   []),
    "plot-transcript-wiggles": (
        ["plot-transcript-wiggles", "psample", "ids.txt", "wig.pdf"],
        "wig.pdf", 1, ["psample.transcript.readdepth"]),
    "plot-transcript-wiggles-genes": (
        ["plot-transcript-wiggles", "psample", "genes.txt", "gwig.pdf",
         "--gene-list", "--show-unique"], "gwig.pdf", 2,
        ["psample.transcript.readdepth",
         "psample.uniq.transcript.readdepth"]),
}


@pytest.mark.parametrize("case", sorted(PLOT_CASES))
def test_plot_command_matches_jax(case, plot_sample, tmp_path, monkeypatch):
    """Both CLIs on one copy each of the JAX package's sample: the same
    page count (and the test_plots.py one), the same read-depth files and
    printed lines."""
    argv, pdf, pages, depth_files = PLOT_CASES[case]
    seen = {}
    for side, cli in (("jax", jax_cli), ("port", port_cli)):
        d = tmp_path / side
        shutil.copytree(plot_sample, d)
        monkeypatch.chdir(d)
        (d / "ids.txt").write_text("t1\nt2\nt3\nbogus\n")
        (d / "genes.txt").write_text("gA\ngB\n")
        rc, out, _err = _run(cli, argv)
        seen[side] = (rc, out, _pdf_pages(pdf),
                      {f: open(f, "rb").read() for f in depth_files})
    assert seen["port"] == seen["jax"]
    assert seen["port"][:1] == (0,) and seen["port"][2] == pages
