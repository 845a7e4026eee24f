"""Golden-file parity of the port's calculate-expression (device="cpu")
against reference RSEM outputs, for the four goldens and at the
tolerances of tests/test_parity.py and tests/test_parity_extra.py."""

import gzip
import os
import shutil

import numpy as np
import pytest
import torch

from rsem_tpu_torch.model.generative import GenerativeModel

GOLD = os.path.join(os.path.dirname(__file__), "goldens")

# sam, golden prefix, extra CLI args, eff-len abs, TPM rel, gene rule
CASES = {
    "aln": ("aln", "golden", [], 0.011, 2e-4, "se"),
    "aln_se0": ("aln_se0", "golden_se0", [
        "--no-qualities", "--fragment-length-mean", "210",
        "--fragment-length-sd", "60"], 0.05, 5e-4, "extra"),
    "aln_pe": ("aln_pe", "golden_pe", ["--paired-end", "--estimate-rspd"],
               0.05, 5e-4, None),
    "aln_pe2": ("aln_pe2", "golden_pe2", ["--paired-end", "--no-qualities"],
                0.05, 5e-4, "extra"),
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain versions run many small ops; in a test run of several
    worker processes torch's intra-op thread pool only adds contention."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _read_table(path):
    rows = [l.rstrip("\n").split("\t") for l in open(path)]
    return {r[0]: r for r in rows[1:]}


@pytest.fixture(scope="module", params=sorted(CASES))
def run(request, tmp_path_factory):
    sam, gold, extra, eff_abs, tpm_rel, gene_rule = CASES[request.param]
    d = tmp_path_factory.mktemp(f"torch_{sam}")
    for f in ("ref.seq", "ref.ti", "ref.grp"):
        shutil.copy(os.path.join(GOLD, f), d)
    with gzip.open(f"{GOLD}/{sam}.sam.gz", "rb") as fi, \
            open(d / "in.sam", "wb") as fo:
        shutil.copyfileobj(fi, fo)
    from rsem_tpu_torch.__main__ import main

    assert main(["calculate-expression", "--alignments", str(d / "in.sam"),
                 str(d / "ref"), str(d / "ours"), "-q", "--device", "cpu"]
                + extra) == 0
    return d, gold, eff_abs, tpm_rel, gene_rule


def test_cnt_identical(run):
    d, gold, *_ = run
    g = open(f"{GOLD}/{gold}.cnt").read().splitlines()
    o = (d / "ours.stat" / "ours.cnt").read_text().splitlines()
    assert o[:3] == g[:3]


def test_isoform_results_match(run):
    d, gold, eff_abs, tpm_rel, _ = run
    ref = _read_table(f"{GOLD}/{gold}.isoforms.results")
    mine = _read_table(str(d / "ours.isoforms.results"))
    assert set(ref) == set(mine)
    max_cnt = max_tpm = 0.0
    for tid, g in ref.items():
        o = mine[tid]
        assert o[1] == g[1] and o[2] == g[2]
        assert float(o[3]) == pytest.approx(float(g[3]), abs=eff_abs)
        max_cnt = max(max_cnt, abs(float(g[4]) - float(o[4])))
        max_tpm = max(max_tpm, abs(float(g[5]) - float(o[5])) / 1e6)
    # float32 device path vs the float64 reference
    assert max_cnt < 1.0, f"count err {max_cnt}"
    assert max_tpm < tpm_rel, f"relative TPM err {max_tpm}"


def test_gene_results_match(run):
    d, gold, _eff, tpm_rel, rule = run
    ref = _read_table(f"{GOLD}/{gold}.genes.results")
    mine = _read_table(str(d / "ours.genes.results"))
    assert set(ref) == set(mine)
    for gid, g in ref.items():
        o = mine[gid]
        assert o[1] == g[1]
        if rule == "se":  # tests/test_parity.py:83-93
            assert float(o[4]) == pytest.approx(float(g[4]), abs=0.5)
            assert float(o[5]) == pytest.approx(float(g[5]), abs=2.0)
        else:  # tests/test_parity_extra.py:61-68
            assert float(o[4]) == pytest.approx(float(g[4]), abs=1.0)
            assert float(o[5]) == pytest.approx(float(g[5]),
                                                abs=tpm_rel * 1e6, rel=0.01)


def test_model_matches(run):
    d, gold, *_ = run
    g = GenerativeModel.read(f"{GOLD}/{gold}.model")
    o = GenerativeModel.read(str(d / "ours.stat" / "ours.model"))
    assert g.spec.model_type == o.spec.model_type
    assert o.gld.lb == g.gld.lb and o.gld.ub == g.gld.ub
    if gold == "golden":  # tests/test_parity.py:173-190
        np.testing.assert_allclose(o.gld.pdf, g.gld.pdf, atol=1e-9)
        np.testing.assert_allclose(o.qd.p_init, g.qd.p_init, atol=1e-9)
        np.testing.assert_allclose(o.qd.p_tran, g.qd.p_tran, atol=1e-9)
        np.testing.assert_allclose(o.pro.p, g.pro.p, atol=2e-3)
        np.testing.assert_allclose(o.npro.p, g.npro.p, atol=2e-3)
        np.testing.assert_allclose(o.mw, g.mw, atol=1e-6)
    elif gold == "golden_se0":  # tests/test_parity_extra.py:88-102
        np.testing.assert_allclose(o.gld.pdf, g.gld.pdf, atol=1e-9)
        np.testing.assert_allclose(o.mld.pdf, g.mld.pdf, atol=1e-9)
        np.testing.assert_allclose(o.pro.p, g.pro.p, atol=3e-3)
        np.testing.assert_allclose(o.npro.p, g.npro.p, atol=2e-3)
        np.testing.assert_allclose(o.mw, g.mw, atol=1e-6)
    elif gold == "golden_pe":  # tests/test_parity.py:157-170
        np.testing.assert_allclose(o.mld.pdf, g.mld.pdf, atol=1e-9)
        np.testing.assert_allclose(o.gld.pdf, g.gld.pdf, atol=2e-4)
        np.testing.assert_allclose(o.rspd.pdf, g.rspd.pdf, atol=2e-3)
        np.testing.assert_allclose(o.pro.p, g.pro.p, atol=3e-3)
    else:  # golden_pe2, tests/test_parity_extra.py:119-129
        np.testing.assert_allclose(o.mld.pdf, g.mld.pdf, atol=1e-9)
        np.testing.assert_allclose(o.gld.pdf, g.gld.pdf, atol=2e-4)
        np.testing.assert_allclose(o.pro.p, g.pro.p, atol=3e-3)
        np.testing.assert_allclose(o.mw, g.mw, atol=1e-6)


def test_transcript_bam_written(run):
    """The posterior-weighted transcript BAM is written by default: one
    record per SAM alignment line, in input order."""
    from rsem_tpu_torch.io.bamio import open_rec_reader

    d, *_ = run
    n_sam = sum(1 for l in open(d / "in.sam") if not l.startswith("@"))
    reader = open_rec_reader(str(d / "ours.transcript.bam"))
    n_bam = sum(1 for _ in reader)
    reader.close()
    assert n_bam == n_sam
