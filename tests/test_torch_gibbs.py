"""The port's Gibbs engine (rsem_tpu_torch.engine.gibbs, device="cpu")
against the JAX package's: posterior moments on identical count vectors,
statistical parity of the chains, conservation, determinism, omit and
prior, and the --calc-pme golden of reference RSEM through the port's CLI.

The JAX side runs its XLA blocked sweep (GibbsConfig(kernel="xla")), which
is fast on the CPU, with its one-hot count refresh in blocks of 512 lanes
(the same integer sums as its default 32,768, so the same chains, ~4x
faster here); the tile-sweep replay against the JAX Pallas kernel is in
tests/test_torch_gibbs_sweep.py."""

import functools
import gzip
import os
import shutil

import numpy as np
import pytest
import torch

from rsem_tpu.engine.gibbs import GibbsConfig as JGibbsConfig
from rsem_tpu.engine.gibbs import run_gibbs as jrun_gibbs
from rsem_tpu.ops import pallas_table
from rsem_tpu.refprep.transcripts import GroupInfo as JGroupInfo
from rsem_tpu_torch.engine.gibbs import GibbsConfig, moments, run_gibbs
from rsem_tpu_torch.engine.gibbs import setup_counts
from rsem_tpu_torch.refprep.transcripts import GroupInfo
from rsem_tpu_torch.testing import synthetic_gibbs_hits as _synthetic

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


def _genes(M, size=3):
    """Gene starts over sids 1..M, `size` isoforms per gene."""
    return np.concatenate([np.arange(1, M + 1, size), [M + 1]])


def _eel_mw(M, seed):
    rng = np.random.default_rng(seed)
    eel = rng.uniform(50.0, 500.0, M + 1)
    mw = rng.uniform(0.5, 1.0, M + 1)
    return eel, mw


# one JAX run (XLA blocked sweep, 8 blocks per sweep, one-hot refresh in
# blocks of 512 lanes: ~8 s on the CPU against ~35 s at its default 32,768)
# serves the moments check and the statistical parity check
M_PAR, N_PAR, N0_PAR, NS_PAR = 30, 500, 10, 600
PAR_CFG = dict(burnin=60, nsamples=NS_PAR, n_chains=4)


@pytest.fixture(scope="module")
def parity_case():
    hits, lcp, lnp = _synthetic(N_PAR, M_PAR, seed=3, max_hits=4)
    eel, mw = _eel_mw(M_PAR, 3)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pallas_table, "onehot_scatter", functools.partial(
            pallas_table.onehot_scatter, block=512))
        gx = jrun_gibbs(hits, lcp, lnp, M_PAR, N0_PAR, eel, mw,
                        JGroupInfo(_genes(M_PAR)),
                        JGibbsConfig(seed=6, kernel="xla", n_blocks=8,
                                     **PAR_CFG))
    return hits, lcp, lnp, eel, mw, gx


def test_moments_match_jax_on_identical_countvectors(parity_case):
    """expression_values and the moment sums (pme/pve of counts, pme TPM
    and FPKM, gene count variance) on the JAX chains' own count vectors:
    rtol 1e-5, atol 1e-6 (f32 expression values summed in another order;
    the port sums in f64 where JAX keeps double-float pairs)."""
    _h, _l, _n, eel, mw, gx = parity_case
    cvs = torch.tensor(np.asarray(gx.countvectors), dtype=torch.float32)
    _i, pseudo, totc = setup_counts(GibbsConfig(), M_PAR, N0_PAR, N_PAR,
                                    None, None)
    got = moments(cvs, eel, mw, pseudo, totc, GroupInfo(_genes(M_PAR)))
    for name in ("pme_c", "pve_c", "pme_tpm", "pme_fpkm", "pve_c_genes"):
        np.testing.assert_allclose(getattr(got, name), getattr(gx, name),
                                   rtol=1e-5, atol=1e-6, err_msg=name)
    assert torch.equal(got.countvectors, cvs)


def test_conserved_and_deterministic():
    """Every count vector holds N0 + N1; one seed gives one result. Two
    isoforms have eel = 0 (too short to be expressed): TPM and FPKM 0 there,
    as in the reference (the JAX package's float32 EPSILON test lets eel = 0
    through and its FPKM overflows)."""
    M, N, N0 = 50, 400, 25
    hits, lcp, lnp = _synthetic(N, M, seed=2, max_hits=6)
    eel, mw = np.full(M + 1, 80.0), np.ones(M + 1)
    eel[[2, 7]] = 0.0
    cfg = GibbsConfig(burnin=10, nsamples=40, n_chains=4, seed=7)
    g1 = run_gibbs(hits, lcp, lnp, M, N0, eel, mw, GroupInfo(_genes(M)), cfg,
                   device="cpu")
    cv = g1.countvectors.double().numpy()
    assert cv.shape == (40, M + 1)
    np.testing.assert_allclose(cv.sum(1), N0 + N, rtol=1e-6)
    assert (cv[:, 1:] >= 0).all()
    assert g1.pme_tpm.sum() == pytest.approx(1e6, rel=1e-3)
    assert (g1.pme_tpm[[2, 7]] == 0).all() and (g1.pme_fpkm[[2, 7]] == 0).all()
    assert np.isfinite(g1.pme_fpkm).all()
    g2 = run_gibbs(hits, lcp, lnp, M, N0, eel, mw, GroupInfo(_genes(M)), cfg,
                   device="cpu")
    np.testing.assert_array_equal(g1.pme_c, g2.pme_c)
    assert torch.equal(g1.countvectors, g2.countvectors)


def test_omit_and_prior():
    """As tests/test_pallas_gibbs.py:120-140: an omitted sid stays at -1;
    a strong prior pulls shared reads toward the favoured isoform."""
    M = 40
    hits, lcp, lnp = _synthetic(300, M, seed=4, max_hits=6)
    eel, mw = np.full(M + 2, 80.0), np.ones(M + 2)
    cfg = GibbsConfig(burnin=10, nsamples=40, n_chains=4, seed=5,
                      keep_countvectors=False)
    g = run_gibbs(hits, lcp, lnp, M + 1, 10, eel, mw,
                  GroupInfo(np.arange(1, M + 3)), cfg,
                  omit=np.array([M + 1]), device="cpu")
    assert g.pme_c[M + 1] == -1.0
    assert g.countvectors is None
    shared = int(hits.sid[0])
    prior = np.ones(M + 1)
    prior[0] = 0.0
    prior[shared] = 100.0
    gi = GroupInfo(np.arange(1, M + 2))
    base = run_gibbs(hits, lcp, lnp, M, 10, eel[:M + 1], mw[:M + 1], gi, cfg,
                     device="cpu")
    gp = run_gibbs(hits, lcp, lnp, M, 10, eel[:M + 1], mw[:M + 1], gi, cfg,
                   prior=prior, device="cpu")
    assert gp.pme_c[shared] >= base.pme_c[shared]


def test_statistical_parity_with_jax(parity_case):
    """Both samplers target the same collapsed posterior: posterior mean
    counts agree within combined Monte-Carlo error, at the rule of
    tests/test_pallas_gibbs.py:114-117 (5 se + 0.75)."""
    hits, lcp, lnp, eel, mw, gx = parity_case
    gt = run_gibbs(hits, lcp, lnp, M_PAR, N0_PAR, eel, mw,
                   GroupInfo(_genes(M_PAR)), GibbsConfig(seed=5, **PAR_CFG),
                   device="cpu")
    tau = 16.0
    se = np.sqrt((gt.pve_c + gx.pve_c) * tau / NS_PAR)
    diff = np.abs(gt.pme_c - gx.pme_c)
    assert (diff <= 5.0 * se + 0.75).all(), (diff, se)


def _read_table(path):
    rows = [l.rstrip("\n").split("\t") for l in open(path)]
    return rows[0], {r[0]: r for r in rows[1:]}


def test_pme_golden_through_cli(tmp_path):
    """--calc-pme on the golden SAM against reference RSEM's posterior
    means, at the rule of tests/test_parity.py:109 (< max(2 sd, 1.5))."""
    for f in ("ref.seq", "ref.ti", "ref.grp"):
        shutil.copy(os.path.join(GOLD, f), tmp_path)
    with gzip.open(f"{GOLD}/aln.sam.gz", "rb") as fi, \
            open(tmp_path / "aln.sam", "wb") as fo:
        shutil.copyfileobj(fi, fo)
    from rsem_tpu_torch.__main__ import main

    assert main(["calculate-expression", "--alignments",
                 str(tmp_path / "aln.sam"), str(tmp_path / "ref"),
                 str(tmp_path / "ours"), "-q", "--device", "cpu",
                 "--calc-pme", "--seed", "1234", "--gibbs-burnin", "50",
                 "--gibbs-number-of-samples", "400", "--no-bam-output"]) == 0
    ghdr, gold = _read_table(f"{GOLD}/golden_pme.isoforms.results")
    ohdr, mine = _read_table(str(tmp_path / "ours.isoforms.results"))
    assert ohdr == ghdr
    pme_i = ghdr.index("posterior_mean_count")
    sd_i = ghdr.index("posterior_standard_deviation_of_count")
    for tid, grow in gold.items():
        g_pme, g_sd = float(grow[pme_i]), float(grow[sd_i])
        assert abs(float(mine[tid][pme_i]) - g_pme) < max(2.0 * g_sd, 1.5), \
            tid
    ghdr, gold = _read_table(f"{GOLD}/golden_pme.genes.results")
    ohdr, mine = _read_table(str(tmp_path / "ours.genes.results"))
    assert ohdr == ghdr and set(gold) == set(mine)
