"""The Gibbs sampler's posterior spread: run_gibbs(device="cpu"), K5's plain
twin on the port's layout, against exact values.

Pairs of isoforms share N_PAIR reads each, with no noise slot. With unit
pseudo-counts the collapsed posterior of a pair's count c on its first
member is exact: summing over the assignments with that count gives
C(n, c) c! (n - c)! r^c = n! r^c, so p(c) is proportional to r^c on 0..n
(uniform for r = 1), r the ratio of the members' conprbs. A tile that holds
many reads of one pair moves them all against the same stale counts and
narrows that posterior: with every read of the input in one tile
(n_blocks = 1) the SD comes out near 0.77 of the exact one, which the
check of the default layout must see. Then a mixed input against an exact
sequential collapsed sweep written here, one read at a time as
Gibbs.cpp:265-353 resamples, vectorised over chains."""

import numpy as np
import pytest
import torch

from rsem_tpu_torch.engine.gibbs import GibbsConfig, run_gibbs, setup_counts
from rsem_tpu_torch.ops import gibbs
from rsem_tpu_torch.refprep.transcripts import GroupInfo
from rsem_tpu_torch.testing import (
    pair_hits,
    pair_posterior,
    pair_tile_max,
    synthetic_gibbs_hits,
)

P, N_PAIR, R = 12, 20, 1.1  # pairs per group, reads per pair, conprb ratio
C, BURNIN, SPC = 32, 60, 120  # chains, burn-in sweeps, samples per chain
SD_TOL = 0.08  # |pooled SD / exact SD - 1|
MEAN_TOL = 0.1  # |pooled mean - exact mean| in exact SDs


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain versions run many small ops; in a test run of several
    worker processes torch's intra-op thread pool only adds contention."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pairs():
    """2P pairs (sids 2p+1, 2p+2): the first P with equal conprbs, the
    other P with the first member R times as likely; no noise slot."""
    return pair_hits([1.0] * P + [R] * P, N_PAIR)


def _run(hits, lcp, lnp, M, n_blocks=32, omit=None, seed=4):
    eel, mw = np.full(M + 1, 1000.0), np.ones(M + 1)
    gi = GroupInfo(np.concatenate([np.arange(1, M + 1, 2), [M + 1]]))
    cfg = GibbsConfig(burnin=BURNIN, nsamples=C * SPC, n_chains=C,
                      seed=seed, n_blocks=n_blocks)
    return run_gibbs(hits, lcp, lnp, M, 0, eel, mw, gi, cfg, omit=omit,
                     device="cpu")


def _spread(res, group):
    """(pooled SD / exact SD, (pooled mean - exact mean) / exact SD) over
    the first members of a group's pairs."""
    first = slice(1 + 2 * P * group, 1 + 2 * P * (group + 1), 2)
    mean, sd = pair_posterior(R if group else 1.0, N_PAIR)
    return (float(np.sqrt(res.pve_c[first].mean())) / sd,
            (float(res.pme_c[first].mean()) - mean) / sd)


@pytest.fixture(scope="module")
def pair_run():
    return _run(*_pairs(), 4 * P)


@pytest.mark.parametrize("group", [0, 1], ids=["equal", "ratio"])
def test_pair_posteriors_match_exact(pair_run, group):
    """Pooled SD within SD_TOL of the exact SD and pooled mean within
    MEAN_TOL exact SDs of the exact mean, for the pairs of equal conprbs
    and those of ratio R."""
    sd_ratio, mean_dev = _spread(pair_run, group)
    assert abs(sd_ratio - 1.0) < SD_TOL, sd_ratio
    assert abs(mean_dev) < MEAN_TOL, mean_dev


def test_one_tile_for_everything_is_seen_as_narrow():
    """n_blocks = 1 at this size puts all reads in one tile: the check
    above has the power to see the narrowing, in both groups."""
    hits, lcp, lnp = _pairs()
    layout = gibbs.build_layout(hits, lcp, lnp, 4 * P, n_blocks=1)
    assert layout.n_tiles == 1
    res = _run(hits, lcp, lnp, 4 * P, n_blocks=1)
    for group in (0, 1):
        assert _spread(res, group)[0] < 1.0 - SD_TOL


def test_default_layout_deals_each_pair_over_tiles():
    hits, lcp, lnp = _pairs()
    layout = gibbs.build_layout(hits, lcp, lnp, 4 * P)
    assert [p.n_tiles for p in layout.parts] == [32]
    assert pair_tile_max(layout) == 1
    assert pair_tile_max(gibbs.build_layout(hits, lcp, lnp, 4 * P,
                                            n_blocks=1)) == N_PAIR


def sequential_sweeps(hits, lcp, lnp, init_counts, pseudo, n_chains, burnin,
                      spc, seed):
    """The exact collapsed sampler: chains of one-read-at-a-time sweeps in
    float64, each read resampled against the live table with its own
    assignment taken out (all its slots of that sid, or noise), as K5's
    weights read, over [noise, slots]; initial draws proportional to the
    conprbs. init_counts, pseudo [M+1]: engine.gibbs.setup_counts's (-1 and
    its pseudo-count at an omitted sid). Returns the count vectors
    [n_chains, spc, M+1] (table minus pseudo, as run_gibbs keeps them)."""
    rng = np.random.default_rng(seed)
    offs = hits.read_offsets
    sid = hits.sid.astype(np.int64)
    cps = np.exp(lcp - np.maximum(
        np.maximum.reduceat(lcp, offs[:-1]), lnp).repeat(np.diff(offs)))
    ncs = np.exp(lnp - np.maximum(np.maximum.reduceat(lcp, offs[:-1]), lnp))
    rows = np.arange(n_chains)
    table = np.repeat((init_counts + pseudo)[None, :], n_chains, 0)
    z = np.empty((n_chains, hits.n_reads), np.int64)  # current sid, 0 noise
    for i in range(hits.n_reads):
        s = sid[offs[i]:offs[i + 1]]
        p = np.concatenate([[ncs[i]], cps[offs[i]:offs[i + 1]]])
        pick = rng.choice(len(p), size=n_chains, p=p / p.sum())
        z[:, i] = np.where(pick > 0, s[np.maximum(pick - 1, 0)], 0)
        np.add.at(table, (rows, z[:, i]), 1.0)
    out = np.empty((n_chains, spc, len(pseudo)))
    for sweep in range(burnin + spc):
        u = rng.random((hits.n_reads, n_chains))
        for i in range(hits.n_reads):
            s = sid[offs[i]:offs[i + 1]]
            cur = z[:, i]
            own = s[None, :] == cur[:, None]
            w = np.maximum(table[:, s] - own, 0.0) * cps[offs[i]:offs[i + 1]]
            w0 = np.maximum(table[:, 0] - (cur == 0), 0.0) * ncs[i]
            cum = np.cumsum(np.concatenate([w0[:, None], w], 1), 1)
            k = (cum < u[i][:, None] * cum[:, -1:]).sum(1)
            new = np.where(k > 0, s[np.maximum(k - 1, 0)], 0)
            table[rows, cur] -= 1.0
            table[rows, new] += 1.0
            z[:, i] = new
        if sweep >= burnin:
            out[:, sweep - burnin] = table - pseudo
    return out


def _chain_stats(cv):
    """Per-chain means and SDs of count vectors [chains, spc, M+1]: their
    averages over chains and the standard errors of those averages."""
    means, sds = cv.mean(1), cv.std(1, ddof=1)
    n = cv.shape[0]
    return ((means.mean(0), means.std(0, ddof=1) / np.sqrt(n)),
            (sds.mean(0), sds.std(0, ddof=1) / np.sqrt(n)))


def test_mixed_input_matches_sequential_sweep():
    """200 reads of 3-6 hits (duplicate sids inside reads) on 12 isoforms,
    a third of them with a noise slot as likely as their hits, isoform 5
    omitted. Per isoform and for noise, the average over chains of each
    chain's mean and of its SD agree with the exact sequential sweep's
    within 5 standard errors of the difference (from the spread over the
    32 chains of each side), plus 0.05 counts."""
    M, N, omit = 12, 200, np.array([5])
    hits, lcp, lnp = synthetic_gibbs_hits(N, M, seed=21, max_hits=6,
                                          min_hits=3)
    lnp[::3] = -20.0
    res = _run(hits, lcp, lnp, M, omit=omit, seed=8)
    port = res.countvectors.numpy().reshape(C, SPC, M + 1).astype(np.float64)
    init_counts, pseudo, _totc = setup_counts(GibbsConfig(), M, 0, N, omit,
                                              None)
    seq = sequential_sweeps(hits, lcp, lnp, init_counts, pseudo, C, BURNIN,
                            SPC, seed=9)
    np.testing.assert_array_equal(port.sum(2), N - 1)  # omitted: -1
    np.testing.assert_array_equal(seq.sum(2), N - 1)
    for (pm, pse), (sm, sse) in zip(_chain_stats(port), _chain_stats(seq)):
        bound = 5.0 * np.sqrt(pse ** 2 + sse ** 2) + 0.05
        assert (np.abs(pm - sm) <= bound).all(), (pm, sm, bound)
