"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Marked `cuda`; each test skips without a CUDA device. On the GPU
machine (which has no JAX, so the JAX conftest is not loaded):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Covers the branches the full-width smoke run does not reach: tables too
large for the shared-memory copy (gather) or needing the opt-in shared
memory (scatter), 256-column rows, empty inputs, reads of up to 200 hits
in the theta round, PreIdx for paired and quality-less reads, and the
Gibbs sweep (K5) at read widths from 1 to 8192 slots, one and eight chains,
on the layout's own table and on one 40 times as large; plus the fused
model loop against the CPU and under sync debug mode "error", run_em,
run_gibbs and run_ci on the card against the CPU and the goldens."""

import numpy as np
import pytest
import torch

from rsem_tpu_torch.convert import model_arrays_to_torch
from rsem_tpu_torch.engine import em
from rsem_tpu_torch.io.hits import HitArrays
from rsem_tpu_torch.ops import conprb, gibbs, table, theta
from rsem_tpu_torch.ops.layout import HitsDevice
from rsem_tpu_torch.testing import (
    relabel_layout,
    synthetic_arrays_fast,
    synthetic_dataset,
    synthetic_gibbs_hits,
)

pytestmark = pytest.mark.cuda
CPU = torch.device("cpu")


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _idx(rng, rows, cols, size, dev):
    return torch.as_tensor(rng.integers(0, size + 1, size=(rows, cols)),
                           dtype=torch.int32, device=dev)


@pytest.mark.parametrize("size,cols", [(1000, 128), (900, 256),
                                       (20000, 128)])
def test_gather_sum(dev, size, cols):
    rng = np.random.default_rng(size)
    idx = _idx(rng, 3000, cols, size, dev)
    vals = torch.as_tensor(rng.normal(-3, 1, size), dtype=torch.float32,
                           device=dev)
    tab = table.padded_table(vals, size)
    n0 = table.gather_sum.launches
    got = table.gather_sum(tab, idx)
    assert table.gather_sum.launches == n0 + 1
    want = table.gather_sum_plain(tab.cpu(), idx.cpu())
    torch.testing.assert_close(got.cpu(), want, rtol=1e-6, atol=1e-6)
    empty = table.gather_sum(tab, idx[:0])
    assert empty.shape == (0,)


@pytest.mark.parametrize("size,cols", [(1000, 128), (900, 256),
                                       (20000, 128)])
def test_scatter_add(dev, size, cols):
    rng = np.random.default_rng(size + 1)
    idx = _idx(rng, 3000, cols, size, dev)
    w = torch.as_tensor(rng.random(3000), dtype=torch.float32, device=dev)
    w[::7] = 0.0
    got = table.scatter_add(idx, w, size)
    want = table.scatter_add_plain(idx.cpu(), w.cpu(), size)
    torch.testing.assert_close(got.cpu(), want, rtol=1e-5, atol=1e-6)


def test_wrappers_check_inputs(dev):
    idx = torch.zeros((4, 128), dtype=torch.int64, device=dev)
    tab = torch.zeros(10, device=dev)
    with pytest.raises(ValueError):
        table.gather_sum(tab, idx)
    with pytest.raises(ValueError):
        table.gather_sum(tab, idx.int()[:, :6])
    with pytest.raises(ValueError):
        table.scatter_add(idx.int(), torch.zeros(4, device=dev,
                                                 dtype=torch.float64), 9)


def _ragged_hits(N, M, seed):
    rng = np.random.default_rng(seed)
    nh = np.minimum(rng.geometric(0.25, size=N) + (rng.random(N) < 0.03)
                    * rng.integers(30, 200, size=N), 200).astype(np.int64)
    H = int(nh.sum())
    offsets = np.zeros(N + 1, dtype=np.int64)
    np.cumsum(nh, out=offsets[1:])
    hits = HitArrays(
        rid=np.repeat(np.arange(N, dtype=np.int32), nh),
        sid=rng.integers(1, M + 1, size=H).astype(np.int32),
        dir=np.zeros(H, dtype=np.int8), pos=np.zeros(H, dtype=np.int32),
        insert_len=None, read_offsets=offsets)
    lcp = np.log(rng.random(H) * 0.9 + 0.1) - 20.0
    lcp[::31] = -np.inf
    lnp = np.log(rng.random(N) * 0.5 + 0.01) - 25.0
    lnp[::97] = -np.inf
    return hits, torch.as_tensor(lcp), torch.as_tensor(lnp)


def _data(hits, lcp, lnp, M, device):
    return theta.scale_conprbs(HitsDevice.from_arrays(hits, device),
                               lcp.to(device), lnp.to(device), M, 5.0)


@pytest.mark.parametrize("segment", [1, 16])
def test_theta_round_and_loop(dev, monkeypatch, segment):
    """K1's fused round on the card against its plain version (counts and
    theta to rtol 1e-5: the f32 denominators are summed in another order;
    the stop count within 2 entries, which the last bit of theta_new can
    move across the threshold), twice in a row from one state (the
    kernels leave their scratch reset), then the segmented loop on the
    card against the CPU loop: the same stop round."""
    M = 3000
    hits, lcp, lnp = _ragged_hits(5000, M, seed=3)
    d_gpu, d_cpu = _data(hits, lcp, lnp, M, dev), _data(hits, lcp, lnp, M,
                                                        CPU)
    th = torch.as_tensor(np.random.default_rng(1).dirichlet(np.ones(M + 1)),
                         dtype=torch.float32)
    state = theta.round_state(d_gpu, 2, dev)
    state.ring[0] = th.to(dev)
    n0 = theta.theta_round.launches
    theta.theta_round(state, d_gpu, 2)
    assert theta.theta_round.launches == n0 + 2
    t1, c1, n1 = theta.theta_round_plain(th, d_cpu)
    t2, c2, n2 = theta.theta_round_plain(state.ring[1].cpu(), d_cpu)
    torch.testing.assert_close(state.ring[1].cpu(), t1, rtol=1e-5, atol=1e-9)
    torch.testing.assert_close(state.ring[2].cpu(), t2, rtol=1e-5, atol=1e-9)
    torch.testing.assert_close(state.counts.cpu(), c2, rtol=1e-5, atol=1e-6)
    assert abs(int(state.tot[0]) - int(n1)) <= 2
    assert abs(int(state.tot[1]) - int(n2)) <= 2
    assert not bool(state.contrib.any()) and float(state.acc[0]) == 0.0
    torch.testing.assert_close(theta.counts(th.to(dev), d_gpu).cpu(), c1,
                               rtol=1e-5, atol=1e-6)
    monkeypatch.setattr(theta, "SEGMENT", segment)
    t_g, r_g = theta.run_theta_loop(th.to(dev), d_gpu, max_round=300)
    t_c, r_c = theta.run_theta_loop(th, d_cpu, max_round=300)
    assert r_g == r_c
    torch.testing.assert_close(t_g.cpu(), t_c, rtol=1e-4, atol=1e-9)


def test_theta_round_checks_inputs(dev):
    from rsem_tpu_torch.ops import _build

    M = 50
    hits, lcp, lnp = _ragged_hits(300, M, seed=4)
    data = _data(hits, lcp, lnp, M, dev)
    state = theta.round_state(data, 2, dev)
    with pytest.raises(ValueError):
        theta.theta_round(state, data, 3)  # a ring row short
    with pytest.raises(ValueError):
        theta.theta_round(state._replace(ring=state.ring.double()), data)
    with pytest.raises(ValueError):
        theta.theta_round(state._replace(acc=state.acc.cpu()), data)
    with pytest.raises(ValueError):
        theta.theta_round(state, data._replace(rid=data.rid.long()))
    # a launch the C entry refuses (no round) raises
    with pytest.raises(RuntimeError, match="theta_round"):
        _build.check(_build.lib().rsem_theta_rounds(
            data.sid.data_ptr(), data.rid.data_ptr(), data.cps.data_ptr(),
            data.ncs.data_ptr(), data.read_offsets.data_ptr(),
            data.ncs.shape[0], M + 1, 0.0, state.ring.data_ptr(),
            state.counts.data_ptr(), state.tot.data_ptr(),
            state.contrib.data_ptr(), state.acc.data_ptr(), 0,
            _build.stream_of(state.ring)), "theta_round")


@pytest.mark.parametrize("read_len", [50, 150])
@pytest.mark.parametrize("has_qual", [True, False])
@pytest.mark.parametrize("paired", [False, True])
def test_preidx_matches_plain(dev, paired, has_qual, read_len):
    ref, bundle, _spec, model = synthetic_arrays_fast(
        n_reads=2000, M=40, read_len=read_len, tx_len=5 * read_len,
        paired=paired, has_qual=has_qual, mean_extra_hits=1.3, seed=9)
    g = em.upload(ref, bundle, paired, dev)
    c = em.upload(ref, bundle, paired, CPU)
    kcfg = em.kernel_config(model, bundle, int(g[1].codes.shape[1]))
    pg = conprb.precompute_profile_indices_fused(kcfg, *g)
    pc = conprb.precompute_profile_indices_fused(kcfg, *c)
    assert torch.equal(pg.flat1.cpu(), pc.flat1)
    if paired:
        assert torch.equal(pg.flat2.cpu(), pc.flat2)
    # and the conprbs built on them
    dm_g = model_arrays_to_torch(model.device_arrays(), dev)
    dm_c = model_arrays_to_torch(model.device_arrays(), CPU)
    lg = conprb.compute_log_conprb(kcfg, *g, dm_g, pg)
    lc = conprb.compute_log_conprb(kcfg, *c, dm_c, pc)
    torch.testing.assert_close(lg.cpu(), lc, rtol=1e-6, atol=1e-5)


@pytest.mark.parametrize("skew", [0, 1])
@pytest.mark.parametrize("has_qual", [True, False])
@pytest.mark.parametrize("read_len", [36, 50, 100, 150, 250])
def test_preidx_read_lengths(dev, read_len, has_qual, skew):
    """K4 bit-identical to its plain version for both mates at read rows
    4-aligned (36, 100) and 2-aligned (50, 150, 250), 128 and 256
    columns, with the read arrays' base 4-aligned or 1 byte off (skew),
    and a hit count that is not a multiple of a warp's 32 rows."""
    ref, bundle, _spec, model = synthetic_arrays_fast(
        n_reads=1001, M=30, read_len=read_len, tx_len=4 * read_len,
        paired=True, has_qual=has_qual, mean_extra_hits=1.3,
        seed=read_len)
    refd, m1, m2, hd = em.upload(ref, bundle, True, dev)
    assert hd.n_hits % 32 != 0
    kcfg = em.kernel_config(model, bundle, int(m1.codes.shape[1]))

    def skewed(t):
        if t is None or not skew:
            return t
        buf = torch.zeros(t.numel() + skew, dtype=t.dtype, device=dev)
        out = buf[skew:].view(t.shape)
        out.copy_(t)
        return out

    for mate, mate2 in ((m1, False), (m2, True)):
        mate = mate._replace(codes=skewed(mate.codes),
                             quals=skewed(mate.quals))
        n0 = conprb.preidx_flat.launches
        got = conprb.preidx_flat(kcfg, refd, mate, hd, mate2)
        assert conprb.preidx_flat.launches == n0 + 1
        cpu = [x.cpu() if x is not None else None for x in mate]
        want = conprb.preidx_flat_plain(
            kcfg, type(refd)(*[x.cpu() for x in refd]), type(mate)(*cpu),
            type(hd)(*[x.cpu() if x is not None else None for x in hd]),
            mate2)
        assert got.shape == (hd.n_hits, conprb.pre_cols(read_len))
        assert torch.equal(got.cpu(), want)


def test_preidx_refused_launch_raises(dev):
    from rsem_tpu_torch.ops import _build

    ref, bundle, _spec, model = synthetic_arrays_fast(
        n_reads=50, M=5, read_len=36, tx_len=200, has_qual=True, seed=1)
    refd, m1, _m2, hd = em.upload(ref, bundle, False, dev)
    out = torch.empty((hd.n_hits, 130), dtype=torch.int32, device=dev)
    with pytest.raises(RuntimeError, match="preidx"):  # cols % 4 != 0
        _build.check(_build.lib().rsem_preidx(
            refd.codes.data_ptr(), refd.codes.numel(),
            refd.offsets.data_ptr(), refd.tot_len.data_ptr(),
            m1.codes.data_ptr(), m1.quals.data_ptr(), m1.lens.data_ptr(), 36,
            hd.rid.data_ptr(), hd.sid.data_ptr(), hd.pos.data_ptr(),
            hd.dir.data_ptr(), None, hd.n_hits, 130, 7, out.data_ptr(),
            _build.stream_of(out)), "preidx")


@pytest.mark.parametrize("paired", [False, True])
def test_run_em_cuda_matches_cpu(dev, paired):
    import copy

    ref, bundle, _spec, model = synthetic_dataset(
        n_reads=3000, M=80, read_len=36, tx_len=400, paired=paired,
        has_qual=True, mean_extra_hits=1.5, seed=11)
    g = em.run_em(copy.deepcopy(model), ref, bundle, device=dev)
    c = em.run_em(copy.deepcopy(model), ref, bundle, device="cpu")
    assert g.rounds == c.rounds
    np.testing.assert_allclose(g.counts, c.counts, rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(g.tpm, c.tpm, rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(g.frac_hit, c.frac_hit, rtol=1e-4, atol=1e-6)


def _model_loop_inputs(paired, device):
    """(kcfg, loop data, round-0 tables, theta0) of the fused model loop
    for a synthetic paired est-RSPD or single-end dataset on `device`."""
    from rsem_tpu_torch.ops import model_loop

    ref, bundle, _spec, model = synthetic_dataset(
        n_reads=3000, M=80, read_len=36, tx_len=400, paired=paired,
        has_qual=True, mean_extra_hits=1.5, seed=11, est_rspd=paired)
    refd, m1, m2, hd = em.upload(ref, bundle, paired, device)
    kcfg = em.kernel_config(model, bundle, int(m1.codes.shape[1]))
    pre = conprb.precompute_profile_indices_fused(kcfg, refd, m1, m2, hd)
    dm = model_arrays_to_torch(model.device_arrays(), device)
    data = model_loop.build_model_loop_data(
        kcfg, refd, m1, m2, hd, pre, dm, model.npro.c, bundle.cnt.N0,
        float(model.spec.probF))
    theta0 = torch.as_tensor(np.random.default_rng(2).dirichlet(
        np.ones(ref.M + 1)), dtype=torch.float32).to(device)
    return (kcfg, data, model_loop.tables_from_model(kcfg, dm), theta0,
            hd.n_reads, ref.M)


@pytest.mark.parametrize("paired", [False, True])
def test_model_loop_cuda_matches_cpu(dev, paired):
    """10 fused model rounds on the card against the CPU: theta and the
    sufficient statistics to rtol 1e-5 (K3 and index_add_ sum with f64
    atomics, in another order than the CPU; exp/log round differently),
    with K2 and K3 launched every round."""
    from rsem_tpu_torch.ops import model_loop

    k, d, t, th, n, M = _model_loop_inputs(paired, dev)
    n2, n3 = table.gather_sum.launches, table.scatter_add.launches
    theta_g, suff_g = model_loop.run_model_loop(k, d, t, th, 10, n, M)
    per_round = 4 if paired else 2  # profile and noise, per mate
    assert table.gather_sum.launches - n2 == 10 * per_round
    assert table.scatter_add.launches - n3 == 10 * per_round
    k, d, t, th, n, M = _model_loop_inputs(paired, CPU)
    theta_c, suff_c = model_loop.run_model_loop(k, d, t, th, 10, n, M)
    torch.testing.assert_close(theta_g.cpu(), theta_c, rtol=1e-5, atol=1e-9)
    assert set(suff_g) == set(suff_c)
    for key, v in suff_c.items():
        torch.testing.assert_close(suff_g[key].cpu(), v, rtol=1e-5,
                                   atol=1e-5 * float(v.abs().max()),
                                   msg=key)


def test_model_loop_makes_no_host_sync(dev):
    """The fused loop only enqueues work: 10 paired est-RSPD rounds under
    torch.cuda.set_sync_debug_mode("error") raise on no host sync."""
    from rsem_tpu_torch.ops import model_loop

    args = _model_loop_inputs(True, dev)
    torch.cuda.synchronize()
    mode = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        theta, suff = model_loop.run_model_loop(*args[:4], 10, *args[4:])
    finally:
        torch.cuda.set_sync_debug_mode(mode)
    assert bool(torch.isfinite(theta).all())
    assert abs(float(theta.double().sum()) - 1.0) < 1e-5
    assert set(suff) == {"pro", "npro", "gld", "rspd"}


@pytest.mark.parametrize("table", ["M", "relabelled"])
@pytest.mark.parametrize("n_chains", [1, 8])
@pytest.mark.parametrize("K", [1, 4, 32, 64, 256, 1024, 8192])
def test_gibbs_sweep_matches_plain(dev, K, n_chains, table):
    """K5 against sweep_part_plain on the card and on the CPU, exact, over
    two sweeps: several tiles per part, window and full-table parts (K=1,
    M=5000), fractional pseudo-counts, an omitted sid, and reads whose noise
    slot competes with their hits. table: the layout's own T = M+1, or the
    sids relabelled s -> 40 s in a table of T = 40 M + 1 (200,001 at
    K=1). One delta scratch serves all the card's sweeps and ends zero."""
    lo = K // 2 + 1 if K > 1 else 1
    N = {1: 20000, 4: 5000, 32: 800, 64: 400, 256: 100, 1024: 24,
         8192: 3}[K]
    M = 5000 if K == 1 else 300
    hits, lcp, lnp = synthetic_gibbs_hits(N, M, seed=K, max_hits=K,
                                          min_hits=lo)
    lnp[::3] = -20.0
    layout = gibbs.build_layout(hits, lcp, lnp, M)
    assert {p.K for p in layout.parts} == {K}
    base = torch.full((M + 1,), 0.1)
    base[17] = -0.9  # omitted
    base[0] += 5.0
    assigns, tab = gibbs.init_chains(layout, base, n_chains, seed=3)
    if table == "relabelled":
        layout, tab = relabel_layout(layout, tab, factor=40)
    lay_g = layout.to(dev)
    a_g = [a.to(dev) for a in assigns]
    a_p = [a.to(dev) for a in assigns]
    t_g, t_p = tab.to(dev), tab.to(dev)
    scratch = gibbs.delta_scratch(t_g)
    n0 = gibbs.sweep_part.launches
    for sweep in range(2):
        for pi, part in enumerate(layout.parts):
            sp = gibbs.part_seed(11, pi)
            gibbs.sweep_part(a_g[pi], t_g, lay_g.parts[pi], sp, sweep,
                             scratch)
            gibbs.sweep_part_plain(a_p[pi], t_p, lay_g.parts[pi], sp, sweep)
            gibbs.sweep_part(assigns[pi], tab, part, sp, sweep)
    torch.cuda.synchronize()
    assert gibbs.sweep_part.launches == n0 + 2 * len(layout.parts)
    for g, p, c in zip(a_g, a_p, assigns):
        assert torch.equal(g.cpu(), p.cpu()) and torch.equal(g.cpu(), c)
    assert torch.equal(t_g.cpu(), t_p.cpu()) and torch.equal(t_g.cpu(), tab)
    assert sum(int((a >= 0).sum()) for a in assigns) > 0
    assert not bool(scratch.any())


def test_gibbs_sweep_checks_inputs(dev):
    hits, lcp, lnp = synthetic_gibbs_hits(50, 20, seed=0, max_hits=2)
    layout = gibbs.build_layout(hits, lcp, lnp, 20, device=dev)
    part = layout.parts[0]
    a = torch.zeros((2, part.n_reads), dtype=torch.int32, device=dev)
    t = torch.ones((2, 21), device=dev)
    with pytest.raises(ValueError):
        gibbs.sweep_part(a.long(), t, part, 1, 0)
    with pytest.raises(ValueError):
        gibbs.sweep_part(a[:, :-1].contiguous(), t, part, 1, 0)
    with pytest.raises(ValueError):
        gibbs.sweep_part(a, t.cpu(), part, 1, 0)
    with pytest.raises(ValueError, match="scratch"):
        gibbs.sweep_part(a, t, part, 1, 0, gibbs.delta_scratch(t)[:, :-1])
    # a launch the kernel refuses (read count not the part's) raises
    from rsem_tpu_torch.ops import _build

    s = gibbs.delta_scratch(t)
    with pytest.raises(RuntimeError, match="gibbs_sweep"):
        _build.check(_build.lib().rsem_gibbs_sweep(
            part.sid.data_ptr(), part.cps.data_ptr(), part.ncs.data_ptr(),
            a.data_ptr(), t.data_ptr(), s.data_ptr(), part.n_tiles,
            part.K.bit_length() - 1, 2, part.n_reads - 1, 21, 1, 0,
            _build.stream_of(t)), "gibbs_sweep")


def test_run_gibbs_cuda_matches_cpu(dev):
    """One seed, one initial state (drawn on the host): identical count
    vectors from the kernel and from the plain version."""
    from rsem_tpu_torch.engine.gibbs import GibbsConfig, run_gibbs
    from rsem_tpu_torch.refprep.transcripts import GroupInfo

    M = 200
    hits, lcp, lnp = synthetic_gibbs_hits(3000, M, seed=5, max_hits=20)
    eel, mw = np.full(M + 1, 150.0), np.ones(M + 1)
    gi = GroupInfo(np.concatenate([np.arange(1, M + 1, 4), [M + 1]]))
    cfg = GibbsConfig(burnin=20, nsamples=80, n_chains=8, seed=3)
    g = run_gibbs(hits, lcp, lnp, M, 30, eel, mw, gi, cfg, device=dev)
    c = run_gibbs(hits, lcp, lnp, M, 30, eel, mw, gi, cfg, device="cpu")
    assert torch.equal(g.countvectors.cpu(), c.countvectors)
    np.testing.assert_allclose(g.pme_c, c.pme_c, rtol=1e-12)
    np.testing.assert_allclose(g.pme_tpm, c.pme_tpm, rtol=1e-5)


def test_run_ci_cuda_on_reference_countvectors(dev):
    """run_ci on the card, on reference calcCI's count vectors, at the
    tolerances of tests/test_parity_extra.py:169-186."""
    import gzip
    import os

    from rsem_tpu_torch.engine.ci import CIConfig, run_ci
    from rsem_tpu_torch.model.generative import GenerativeModel
    from rsem_tpu_torch.refprep.reference import Reference
    from rsem_tpu_torch.refprep.transcripts import GroupInfo

    gold = os.path.join(os.path.dirname(__file__), "goldens")
    cvs = np.loadtxt(gzip.open(f"{gold}/golden.countvectors.gz", "rt"))
    refs = Reference.load_seq(f"{gold}/ref.seq")
    model = GenerativeModel.read(f"{gold}/golden.model", refs=refs)
    gi = GroupInfo.load(f"{gold}/ref.grp")
    res = run_ci(cvs, model.calc_eel(), model.mw, gi,
                 CIConfig(confidence=0.95, nspc=50, seed=99), device=dev)
    rows = [l.rstrip("\n").split("\t")
            for l in open(f"{gold}/golden_ci.isoforms.results")]
    hdr = rows[0]
    i_lb, i_ub = hdr.index("TPM_ci_lower_bound"), hdr.index(
        "TPM_ci_upper_bound")
    i_cqv = hdr.index("TPM_coefficient_of_quartile_variation")
    for k, r in enumerate(rows[1:]):
        g_lb, g_ub = float(r[i_lb]), float(r[i_ub])
        width = max(g_ub - g_lb, 1.0)
        assert abs(res.tpm.lb[k + 1] - g_lb) < 0.12 * width + 0.5, r[0]
        assert abs(res.tpm.ub[k + 1] - g_ub) < 0.12 * width + 0.5, r[0]
        assert res.tpm.cqv[k + 1] == pytest.approx(float(r[i_cqv]),
                                                   abs=0.03, rel=0.12)
