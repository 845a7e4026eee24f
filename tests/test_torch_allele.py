"""Allele-specific quantification in the port (rsem_tpu_torch, device="cpu")
against the JAX package: the transcript-level posterior count variance of
the Gibbs moments, the transcript-level credibility intervals, and the
driver on an allele-specific reference with and without --calc-pme
--calc-ci (.alleles.results, transcript-level .isoforms.results,
.genes.results).

The JAX driver runs its Gibbs stage on one device with its CPU default,
the XLA blocked sweep, which bounds staleness at ~N1/n_blocks reads as the
port's dealt tile layout does (its Pallas tile sweep, which packs the 60
reads of the two tX alleles into one tile, gives a narrower posterior).
That sweep's one-hot count refresh runs here with 512-lane blocks
(`xla_gibbs`): the same integer sums as its default 32,768, several times
faster on the CPU. The 60 shared reads have a flat posterior whose
autocorrelation time is ~28 sweeps, so the runs keep every eighth sweep
(POSTERIOR's --gibbs-sampling-gap): at a gap of 1 the CI upper bound of
tX_a1's TPM moves by ~71,000 (SD) between seeds of one correct sampler,
against a tolerance of ~68,000, and by ~24,000 at a gap of 8."""

import functools
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rsem_tpu.engine.ci import _ci_columns as jax_ci_columns
from rsem_tpu.engine.gibbs import GibbsConfig as JGibbsConfig
from rsem_tpu.engine.gibbs import run_gibbs as jrun_gibbs
from rsem_tpu.pipeline.calculate_expression import main as jax_calc
from rsem_tpu.pipeline.prepare_reference import main as jax_prep
from rsem_tpu.refprep.transcripts import GroupInfo as JGroupInfo
from rsem_tpu_torch.__main__ import main as port_cli
from rsem_tpu_torch.engine.ci import (
    _bounds_chunked,
    group_bounds,
    group_starts,
)
from rsem_tpu_torch.engine.gibbs import GibbsConfig, moments, setup_counts
from rsem_tpu_torch.refprep.transcripts import GroupInfo
from rsem_tpu_torch.testing import synthetic_gibbs_hits

from test_em_end_to_end import T1, T3


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Many small ops in several worker processes: torch's intra-op pool
    only adds contention."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _allele_groups(n_trans, rng):
    """(ta starts, gt starts): transcripts of one or two alleles (one in
    five has one), genes of one to three transcripts."""
    sizes = np.where(rng.random(n_trans) < 0.2, 1, 2)
    ta = np.concatenate([[1], 1 + np.cumsum(sizes)])
    gsizes = []
    left = n_trans
    while left:
        gsizes.append(min(left, int(rng.integers(1, 4))))
        left -= gsizes[-1]
    gt = np.concatenate([[0], np.cumsum(gsizes)])
    return ta, gt


def test_moments_pve_c_trans_matches_jax():
    """moments(ta=...) on the JAX chains' own count vectors gives the JAX
    package's pve_c_trans (f64 sums against its double-float pairs): rtol
    1e-5, atol 1e-6, as pve_c_genes is held."""
    rng = np.random.default_rng(4)
    ta_s, gt_s = _allele_groups(14, rng)
    M = int(ta_s[-1]) - 1
    gene_s = ta_s[gt_s]  # a gene's alleles are its transcripts' alleles
    N, N0 = 300, 7
    hits, lcp, lnp = synthetic_gibbs_hits(N, M, seed=8, max_hits=4)
    eel = rng.uniform(50.0, 500.0, M + 1)
    mw = rng.uniform(0.5, 1.0, M + 1)
    gx = jrun_gibbs(hits, lcp, lnp, M, N0, eel, mw, JGroupInfo(gene_s),
                    JGibbsConfig(seed=2, kernel="xla", n_blocks=4, burnin=20,
                                 nsamples=120, n_chains=4),
                    ta=JGroupInfo(ta_s))
    cvs = torch.tensor(np.asarray(gx.countvectors), dtype=torch.float32)
    _i, pseudo, totc = setup_counts(GibbsConfig(), M, N0, N, None, None)
    got = moments(cvs, eel, mw, pseudo, totc, GroupInfo(gene_s),
                  ta=GroupInfo(ta_s))
    assert got.pve_c_trans.shape == (len(ta_s) - 1,)
    assert (got.pve_c_trans > 0).any()
    for name in ("pve_c_trans", "pve_c_genes", "pve_c", "pme_c"):
        np.testing.assert_allclose(getattr(got, name), getattr(gx, name),
                                   rtol=1e-5, atol=1e-6, err_msg=name)
    plain = moments(cvs, eel, mw, pseudo, totc, GroupInfo(gene_s))
    assert plain.pve_c_trans is None


@pytest.mark.parametrize("n", [400, 403])
def test_transcript_ci_bounds_match_jax(n):
    """group_bounds over the .ta grouping, from identical TPM samples:
    the JAX package's _ci_columns on the segment sums of the allele
    columns (TPM, and FPKM = TPM * 1e3 / l_bar), and a transcript of one
    allele copies its allele's bounds exactly."""
    rng = np.random.default_rng(n)
    ta_s, _gt = _allele_groups(40, rng)
    M = int(ta_s[-1]) - 1
    tpm = rng.gamma(1.5, 40.0, size=(n, M)).astype(np.float32)
    tpm[:, 2] = 0.0
    inv_lbar = (1e3 / rng.uniform(80, 300, n)).astype(np.float32)[:, None]
    cover = int(0.95 * n - 1e-8) + 1
    tpm_t, inv_t = torch.as_tensor(tpm), torch.as_tensor(inv_lbar)
    member = _bounds_chunked(lambda lo, hi: tpm_t[:, lo:hi], M, n, cover)
    member_f = _bounds_chunked(lambda lo, hi: tpm_t[:, lo:hi] * inv_t, M, n,
                               cover)
    ta = GroupInfo(ta_s)
    got_t, got_f = group_bounds(tpm_t, inv_t, ta, member, member_f, cover)
    tids = jnp.asarray(ta.gids_of(np.arange(1, M + 1)))
    single = np.diff(ta_s) == 1
    first = ta_s[:-1] - 1
    for got, mem, cols in ((got_t, member, tpm),
                           (got_f, member_f, tpm * inv_lbar)):
        sums = jax.ops.segment_sum(jnp.asarray(cols).T, tids,
                                   num_segments=ta.m,
                                   indices_are_sorted=True).T
        want = [np.asarray(x) for x in jax_ci_columns(sums, cover)]
        for w, f in zip(want, ("lb", "ub", "cqv")):
            g = getattr(got, f)
            np.testing.assert_array_equal(g[~single], w[~single], err_msg=f)
            np.testing.assert_array_equal(g[single],
                                          getattr(mem, f)[first[single]])


def test_group_starts_checks_contiguity():
    assert list(group_starts(GroupInfo([1, 3, 4]), 3)) == [1, 3, 4]
    for bad, M in (([1, 3, 3, 5], 4), ([1, 3, 4], 4), ([2, 3, 5], 4)):
        with pytest.raises(ValueError, match="contiguous"):
            group_starts(GroupInfo(bad), M)


# ---- the driver on the allele reference of tests/test_pipeline.py ---- #
ALLELES = [("tX_a1", T1), ("tX_a2", T1[:-3]), ("tY_a1", T3)]
POSTERIOR = ["--calc-pme", "--calc-ci", "--seed", "5", "--gibbs-burnin",
             "50", "--gibbs-number-of-samples", "400",
             "--gibbs-sampling-gap", "8",
             "--ci-number-of-samples-per-count-vector", "10"]


def xla_gibbs(run_gibbs):
    """The JAX driver's run_gibbs with the XLA sweep's one-hot count
    refresh (rsem_tpu/ops/pallas_table.py:onehot_scatter) in blocks of
    512 lanes instead of 32,768: its +-1 weights sum to the same small
    integers in any block, so the chains are the same; the default pads
    each block of a few reads to 32,768 lanes on the CPU."""
    pallas_table = sys.modules["rsem_tpu.ops.pallas_table"]
    onehot = pallas_table.onehot_scatter

    def call(*args, **kwargs):
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(pallas_table, "onehot_scatter",
                       functools.partial(onehot, block=512))
            return run_gibbs(*args, **kwargs)
    return call


def _allele_inputs(d):
    (d / "alleles.fa").write_text(
        "".join(f">{n}\n{s}\n" for n, s in ALLELES))
    (d / "amap.txt").write_text("gA tX tX_a1\ngA tX tX_a2\ngB tY tY_a1\n")
    lines = ["@HD\tVN:1.0"] + [f"@SQ\tSN:{n}\tLN:{len(s)}"
                               for n, s in ALLELES]
    rng = np.random.RandomState(42)
    rl, q = 30, "I" * 30
    for rid in range(60):  # multireads shared by both tX alleles
        pos = int(rng.randint(0, len(T1) - 3 - rl + 1))
        frag = T1[pos:pos + rl]
        lines.append(f"r{rid}\t0\ttX_a1\t{pos + 1}\t255\t{rl}M\t*\t0\t0\t"
                     f"{frag}\t{q}")
        lines.append(f"r{rid}\t256\ttX_a2\t{pos + 1}\t255\t{rl}M\t*\t0\t0\t"
                     f"{frag}\t{q}")
    for rid in range(60, 100):
        pos = int(rng.randint(0, len(T3) - rl + 1))
        lines.append(f"r{rid}\t0\ttY_a1\t{pos + 1}\t255\t{rl}M\t*\t0\t0\t"
                     f"{T3[pos:pos + rl]}\t{q}")
    (d / "aln.sam").write_text("\n".join(lines) + "\n")


@pytest.fixture(scope="module")
def allele_runs(tmp_path_factory):
    """JAX and port, each preparing its own allele reference and running
    calculate-expression point-only and with --calc-pme --calc-ci."""
    out = {}
    for side in ("jax", "port"):
        d = tmp_path_factory.mktemp(f"allele_{side}")
        _allele_inputs(d)
        with pytest.MonkeyPatch.context() as mp:
            mp.chdir(d)
            driver = sys.modules["rsem_tpu.pipeline.calculate_expression"]
            mp.setattr(driver, "run_gibbs", xla_gibbs(driver.run_gibbs))
            # one device, as the port, not the test session's 8-device CPU
            # mesh
            mp.setattr(driver, "_production_mesh", lambda n: None)
            prep = ["--allele-to-gene-map", "amap.txt", "alleles.fa", "aref",
                    "-q"]
            if side == "jax":
                assert jax_prep(prep) == 0
            else:
                assert port_cli(["prepare-reference"] + prep) == 0
            assert os.path.exists("aref.ta") and os.path.exists("aref.gt")
            for run, extra in (("point", []), ("post", POSTERIOR)):
                argv = ["--alignments", "aln.sam", "aref", run, "-q",
                        "--no-bam-output"] + extra
                if side == "jax":
                    assert jax_calc(argv) == 0
                else:
                    assert port_cli(["calculate-expression"] + argv
                                    + ["--device", "cpu"]) == 0
        out[side] = d
    return out


def _table(path):
    rows = [l.rstrip("\n").split("\t") for l in open(path)]
    return rows[0], {r[0]: r for r in rows[1:]}


TABLES = ("alleles", "isoforms", "genes")
EM_COLS = {"alleles": ("expected_count", "TPM"),
           "isoforms": ("expected_count", "TPM"),
           "genes": ("expected_count", "TPM")}


@pytest.mark.parametrize("run", ["point", "post"])
@pytest.mark.parametrize("kind", TABLES)
def test_driver_em_columns_match_jax(allele_runs, run, kind):
    """Allele, transcript and gene tables: same rows and headers; expected
    counts within 1.0 and TPM within 2e-4 x 1e6 of the JAX package's (the
    golden tolerances); the allele counts sum to their transcript's and
    gene's."""
    jh, jt = _table(allele_runs["jax"] / f"{run}.{kind}.results")
    ph, pt = _table(allele_runs["port"] / f"{run}.{kind}.results")
    assert ph == jh and list(pt) == list(jt)
    ic, it = jh.index("expected_count"), jh.index("TPM")
    for k, jr in jt.items():
        pr = pt[k]
        assert pr[:ic] == jr[:ic] or kind == "genes", k
        assert abs(float(pr[ic]) - float(jr[ic])) < 1.0, (k, pr, jr)
        assert abs(float(pr[it]) - float(jr[it])) / 1e6 < 2e-4, (k, pr, jr)
    if kind == "alleles":
        _h, iso = _table(allele_runs["port"] / f"{run}.isoforms.results")
        _h, gene = _table(allele_runs["port"] / f"{run}.genes.results")
        by_t, by_g = {}, {}
        for r in pt.values():
            by_t[r[1]] = by_t.get(r[1], 0.0) + float(r[ic])
            by_g[r[2]] = by_g.get(r[2], 0.0) + float(r[ic])
        for t, c in by_t.items():
            assert float(iso[t][4]) == pytest.approx(c, abs=0.02)
        for g, c in by_g.items():
            assert float(gene[g][4]) == pytest.approx(c, abs=0.02)


@pytest.mark.parametrize("kind", TABLES)
def test_driver_pme_columns_match_jax(allele_runs, kind):
    """posterior_mean_count within max(2 sd, 1.5) of the JAX package's (sd:
    its posterior_standard_deviation_of_count), pme_TPM summing to 1e6."""
    jh, jt = _table(allele_runs["jax"] / f"post.{kind}.results")
    _ph, pt = _table(allele_runs["port"] / f"post.{kind}.results")
    i_pme = jh.index("posterior_mean_count")
    i_sd = jh.index("posterior_standard_deviation_of_count")
    i_tpm = jh.index("pme_TPM")
    for k, jr in jt.items():
        lim = max(2.0 * float(jr[i_sd]), 1.5)
        assert abs(float(pt[k][i_pme]) - float(jr[i_pme])) < lim, k
    assert sum(float(r[i_tpm]) for r in pt.values()) == pytest.approx(
        1e6, rel=1e-4)


@pytest.mark.parametrize("kind", TABLES)
def test_driver_ci_columns_match_jax(allele_runs, kind):
    """TPM and FPKM intervals and CQVs at the tolerances of
    tests/test_torch_ci.py (bounds within 0.12 x width + 0.5, CQV abs 0.03
    or rel 0.12); lb <= ub."""
    jh, jt = _table(allele_runs["jax"] / f"post.{kind}.results")
    _ph, pt = _table(allele_runs["port"] / f"post.{kind}.results")
    for unit in ("TPM", "FPKM"):
        i_lb = jh.index(f"{unit}_ci_lower_bound")
        i_ub = jh.index(f"{unit}_ci_upper_bound")
        i_cqv = jh.index(f"{unit}_coefficient_of_quartile_variation")
        for k, jr in jt.items():
            g_lb, g_ub = float(jr[i_lb]), float(jr[i_ub])
            lb, ub = float(pt[k][i_lb]), float(pt[k][i_ub])
            width = max(g_ub - g_lb, 1.0)
            assert lb <= ub
            assert abs(lb - g_lb) < 0.12 * width + 0.5, (unit, k)
            assert abs(ub - g_ub) < 0.12 * width + 0.5, (unit, k)
            assert float(pt[k][i_cqv]) == pytest.approx(
                float(jr[i_cqv]), abs=0.03, rel=0.12), (unit, k)


def test_single_allele_transcript_copies_allele_ci(allele_runs):
    """tY has one allele: its transcript-level CI columns are its allele's,
    digit for digit."""
    ah, at = _table(allele_runs["port"] / "post.alleles.results")
    ih, it = _table(allele_runs["port"] / "post.isoforms.results")
    for col in ("TPM_ci_lower_bound", "TPM_ci_upper_bound",
                "TPM_coefficient_of_quartile_variation", "FPKM_ci_lower_bound",
                "FPKM_ci_upper_bound",
                "FPKM_coefficient_of_quartile_variation"):
        assert it["tY"][ih.index(col)] == at["tY_a1"][ah.index(col)], col
