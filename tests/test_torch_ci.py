"""The port's credibility intervals (rsem_tpu_torch.engine.ci,
device="cpu"): interval and CQV columns identical to the JAX package's on
the same samples, run_ci on reference RSEM's own count vectors against its
calcCI output, and --calc-ci through the port's CLI.

The Gamma draws differ from JAX's (torch's generator, not threefry), so the
end-to-end checks are the statistical ones of tests/test_parity_extra.py."""

import gzip
import os
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rsem_tpu.engine.ci import _ci_columns as jax_ci_columns
from rsem_tpu_torch.engine.ci import CIConfig, ci_columns, run_ci

GOLD = os.path.join(os.path.dirname(__file__), "goldens")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain versions run many small ops; in a test run of several
    worker processes torch's intra-op thread pool only adds contention
    (measured: a CLI golden here took 150-250 s under load, 5 s alone)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _read_table(path):
    rows = [l.rstrip("\n").split("\t") for l in open(path)]
    return rows[0], {r[0]: r for r in rows[1:]}


@pytest.mark.parametrize("n", [400, 401, 402, 403])
def test_ci_columns_identical_to_jax(n):
    """Shortest interval and Tukey CQV, for each n mod 4 (the hinge rule
    has three cases), on samples with ties and all-zero columns."""
    rng = np.random.default_rng(n)
    s = rng.gamma(2.0, 50.0, size=(n, 37)).astype(np.float32)
    s[:, 3] = np.round(s[:, 3] / 40.0) * 40.0  # many ties
    s[:, 5] = 0.0
    s[: n // 2, 8] = 0.0
    cover = int(0.95 * n - 1e-8) + 1
    want = [np.asarray(x) for x in jax_ci_columns(jnp.asarray(s), cover)]
    got = [x.numpy() for x in ci_columns(torch.as_tensor(s), cover)]
    for w, g, name in zip(want, got, ("lb", "ub", "cqv")):
        np.testing.assert_array_equal(g, w, err_msg=name)


def test_ci_on_reference_countvectors():
    """run_ci on the count vectors reference calcCI consumed
    (golden.countvectors.gz), at the tolerances of
    tests/test_parity_extra.py:169-186."""
    from rsem_tpu_torch.model.generative import GenerativeModel
    from rsem_tpu_torch.refprep.reference import Reference
    from rsem_tpu_torch.refprep.transcripts import GroupInfo

    cvs = np.loadtxt(gzip.open(f"{GOLD}/golden.countvectors.gz", "rt"),
                     dtype=np.float64)
    refs = Reference.load_seq(f"{GOLD}/ref.seq")
    model = GenerativeModel.read(f"{GOLD}/golden.model", refs=refs)
    gi = GroupInfo.load(f"{GOLD}/ref.grp")
    res = run_ci(cvs, model.calc_eel(), model.mw, gi,
                 CIConfig(confidence=0.95, nspc=50, seed=99), device="cpu")

    ghdr, gold = _read_table(f"{GOLD}/golden_ci.isoforms.results")
    i_lb = ghdr.index("TPM_ci_lower_bound")
    i_ub = ghdr.index("TPM_ci_upper_bound")
    i_cqv = ghdr.index("TPM_coefficient_of_quartile_variation")
    for k, tid in enumerate(gold):  # .ti order = results row order
        g_lb, g_ub = float(gold[tid][i_lb]), float(gold[tid][i_ub])
        width = max(g_ub - g_lb, 1.0)
        assert abs(res.tpm.lb[k + 1] - g_lb) < 0.12 * width + 0.5, tid
        assert abs(res.tpm.ub[k + 1] - g_ub) < 0.12 * width + 0.5, tid
        assert res.tpm.cqv[k + 1] == pytest.approx(
            float(gold[tid][i_cqv]), abs=0.03, rel=0.12), tid
    ghdr, gold_g = _read_table(f"{GOLD}/golden_ci.genes.results")
    j_lb = ghdr.index("TPM_ci_lower_bound")
    j_ub = ghdr.index("TPM_ci_upper_bound")
    for g_i, gid in enumerate(gold_g):
        g_lb, g_ub = float(gold_g[gid][j_lb]), float(gold_g[gid][j_ub])
        width = max(g_ub - g_lb, 1.0)
        assert abs(res.gene_tpm.lb[g_i] - g_lb) < 0.12 * width + 0.5, gid
        assert abs(res.gene_tpm.ub[g_i] - g_ub) < 0.12 * width + 0.5, gid


def test_ci_columns_through_cli(tmp_path):
    """--calc-ci through the port's driver: the reference column layout
    with sane values, as tests/test_parity_extra.py:189-210 checks, and the
    count vectors written with --keep-intermediate-files."""
    for f in ("ref.seq", "ref.ti", "ref.grp"):
        shutil.copy(os.path.join(GOLD, f), tmp_path)
    with gzip.open(f"{GOLD}/aln.sam.gz", "rb") as fi, \
            open(tmp_path / "in.sam", "wb") as fo:
        shutil.copyfileobj(fi, fo)
    from rsem_tpu_torch.__main__ import main

    assert main(["calculate-expression", "--alignments",
                 str(tmp_path / "in.sam"), str(tmp_path / "ref"),
                 str(tmp_path / "ours"), "-q", "--device", "cpu",
                 "--calc-ci", "--seed", "1234", "--gibbs-burnin", "50",
                 "--gibbs-number-of-samples", "320", "--no-bam-output",
                 "--keep-intermediate-files"]) == 0
    ghdr, _ = _read_table(f"{GOLD}/golden_ci.isoforms.results")
    ohdr, mine = _read_table(str(tmp_path / "ours.isoforms.results"))
    assert ohdr == ghdr
    i_lb = ohdr.index("TPM_ci_lower_bound")
    i_ub = ohdr.index("TPM_ci_upper_bound")
    i_pme = ohdr.index("pme_TPM")
    n_pos = 0
    for row in mine.values():
        lb, ub, pme = float(row[i_lb]), float(row[i_ub]), float(row[i_pme])
        assert lb <= ub + 1e-6
        if pme > 1.0:
            n_pos += 1
            assert lb <= pme * 1.25 + 1.0
            assert ub >= pme * 0.75 - 1.0
    assert n_pos > 10
    ghdr, _ = _read_table(f"{GOLD}/golden_ci.genes.results")
    ohdr, _ = _read_table(str(tmp_path / "ours.genes.results"))
    assert ohdr == ghdr
    cv = np.loadtxt(tmp_path / "ours.temp" / "ours.countvectors")
    assert cv.shape == (320, len(mine) + 1)
    n_reads = sum(int(x) for x in open(tmp_path / "ours.stat" / "ours.cnt")
                  .readline().split()[:2])  # N0 + N1
    np.testing.assert_array_equal(cv.sum(1), n_reads)
