"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Marked `cuda`; each test skips without a CUDA device. On the GPU
machine (which has no JAX, so the JAX conftest is not loaded):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Covers the branches the full-width smoke run does not reach: tables too
large for the shared-memory copy (gather) or needing the opt-in shared
memory (scatter), 256-column rows, empty inputs, reads of up to 200 hits
in the theta round, PreIdx for paired and quality-less reads, and the
Gibbs sweep (K5) at read widths from 1 to 8192 slots, one and eight chains,
on the layout's own table and on one 40 times as large, and on layouts
dealt over mostly empty tiles (the posterior-spread test's input); the
Gibbs set-up on the card (layout and initial state) against the CPU's; plus
the fused
model loop against the CPU and under sync debug mode "error", its E-step
statistics kernel against the plain version at the cells and the bulk
cell's sizes (and once a round in run_em), run_em,
run_gibbs and run_ci on the card against the CPU and the goldens (with an
allele grouping too), and
windowed PreIdx: K4 over a window's views, K3 into one accumulator across
windows, and run_em windowed against unwindowed; the read simulator on
the card (counts of a 1M-read draw against theta, same seed same bytes);
and the read-sharded pieces: K1 split into its partial and finish around
the sum over ranks, K5 keyed on a rank's first chain (chain0), and run_em
with an NCCL group of one against no group; the layout's device cache (the
same device buffers on a repeat upload, new ones after an edit) and the
streamed theta loop over pinned host chunks against the resident loop.
The device cache is cleared after every test."""

import numpy as np
import pytest
import torch

from rsem_tpu_torch.convert import model_arrays_to_torch
from rsem_tpu_torch.engine import em
from rsem_tpu_torch.io.hits import HitArrays
from rsem_tpu_torch.ops import conprb, gibbs, table, theta
from rsem_tpu_torch.ops.layout import HitsDevice, clear_device_cache
from rsem_tpu_torch.parallel.fast_sharded import build_theta_chunks
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
    yield torch.device("cuda")
    clear_device_cache()


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


def test_scatter_add_into_accumulator(dev):
    """The windowed passes add each window's scatter into one f64 table."""
    rng = np.random.default_rng(5)
    idx = _idx(rng, 3000, 128, 1000, dev)
    w = torch.as_tensor(rng.random(3000), dtype=torch.float32, device=dev)
    acc = torch.zeros(1000, dtype=torch.float64, device=dev)
    n0 = table.scatter_add.launches
    for a, b in ((0, 1100), (1100, 1101), (1101, 3000)):
        assert table.scatter_add(idx[a:b], w[a:b], 1000, acc) is acc
    assert table.scatter_add.launches == n0 + 3
    want = table.scatter_add_plain(idx.cpu(), w.cpu(), 1000)
    torch.testing.assert_close(acc.float().cpu(), want, rtol=1e-5,
                               atol=1e-6)


def _k3_inputs(kind, rows, cols, size, weights, dev, seed=0):
    """Index rows and weights where K3's lanes contend most or oddly:
    every entry on one slot, uniform slots of a small or large table, rows
    of sentinels only (the table size and values far above it)."""
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    if kind == "one_slot":
        idx = torch.full((rows, cols), min(3, size - 1), dtype=torch.int32,
                         device=dev)
    elif kind == "sentinels":
        idx = torch.full((rows, cols), size, dtype=torch.int32, device=dev)
        idx[:, 1::2] = 2**31 - 1
    else:
        idx = torch.randint(0, size + 1, (rows, cols), generator=g,
                            dtype=torch.int32, device=dev)
    w = torch.rand(rows, generator=g, device=dev)
    if weights == "zero":
        w.zero_()
    elif weights == "seventh":
        w[::7] = 0.0
    return idx, w


@pytest.mark.parametrize("kind,rows,cols,size,weights", [
    ("one_slot", 4096, 128, 1000, "rand"),
    ("one_slot", 4096, 256, 5, "seventh"),
    ("uniform", 3000, 128, 5, "rand"),
    ("uniform", 3000, 256, 25, "seventh"),
    ("sentinels", 2000, 128, 1000, "rand"),
    ("uniform", 3000, 128, 1000, "zero"),
    ("uniform", 1, 128, 1000, "rand"),
    ("uniform", 31, 256, 1000, "seventh"),
    ("uniform", 2**20 + 3, 128, 500, "seventh"),
    ("uniform", 3000, 128, 12288, "rand"),
    ("uniform", 3000, 256, 58112, "seventh"),
])
def test_scatter_add_contention(dev, kind, rows, cols, size, weights):
    """K3 against its plain version (on the card, in f64) where slots
    collide or the table is at the edges of the shared-memory sizes: 48 KB
    (12,288 slots) and the 227 KB limit (58,112)."""
    idx, w = _k3_inputs(kind, rows, cols, size, weights, dev)
    n0 = table.scatter_add.launches
    got = table.scatter_add(idx, w, size)
    assert table.scatter_add.launches == n0 + 1
    want = table.scatter_add_plain(idx, w, size)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
    if weights == "zero" or kind == "sentinels":
        assert not bool(got.any())


def test_scatter_add_refuses_table_over_shared_memory(dev):
    idx, w = _k3_inputs("uniform", 64, 128, 58113, "rand", dev)
    n0 = table.scatter_add.launches
    with pytest.raises(RuntimeError):
        table.scatter_add(idx, w, 58113)
    assert table.scatter_add.launches == n0


@pytest.mark.parametrize("cols", [128, 256])
def test_scatter_add_windows_into_accumulator(dev, cols):
    """Three windows of composed-like rows (few slots, many repeats) add
    into one f64 table, as the windowed passes do."""
    idx, w = _k3_inputs("uniform", 5000, cols, 1000, "seventh", dev, seed=3)
    idx = torch.where(idx < 1000, idx % 37 * 25, idx)  # 37 slots in use
    acc = torch.zeros(1000, dtype=torch.float64, device=dev)
    for a, b in ((0, 1700), (1700, 1703), (1703, 5000)):
        assert table.scatter_add(idx[a:b], w[a:b], 1000, acc) is acc
    want = table.scatter_add_plain(idx, w, 1000)
    torch.testing.assert_close(acc.float(), want, rtol=1e-5, atol=1e-6)


def test_scatter_add_allocates_nothing(dev):
    """A launch into a caller's accumulator allocates no device memory."""
    idx, w = _k3_inputs("uniform", 20000, 128, 1000, "seventh", dev)
    acc = torch.zeros(1000, dtype=torch.float64, device=dev)
    table.scatter_add(idx, w, 1000, acc)  # builds the kernels
    torch.cuda.synchronize()
    before = torch.cuda.memory_stats(dev)["allocation.all.allocated"]
    for _ in range(3):
        table.scatter_add(idx, w, 1000, acc)
    after = torch.cuda.memory_stats(dev)["allocation.all.allocated"]
    assert after == before


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


@pytest.mark.parametrize("paired", [False, True])
def test_preidx_of_a_window_view(dev, paired):
    """K4 over a window's hits (1-D views that start mid-array) equals
    those rows of the whole build, bit for bit."""
    ref, bundle, _spec, model = synthetic_dataset(
        n_reads=2000, M=50, read_len=50, tx_len=400, paired=paired,
        has_qual=True, mean_extra_hits=1.5, seed=3)
    refd, m1, m2, hd = em.upload(ref, bundle, paired, dev)
    kcfg = em.kernel_config(model, bundle, int(m1.codes.shape[1]))
    whole = conprb.precompute_profile_indices_fused(kcfg, refd, m1, m2, hd)
    off = bundle.hits.read_offsets
    w = conprb.Window(701, 1403, int(off[701]), int(off[1403]))
    n0 = conprb.preidx_flat.launches
    part = conprb.window_preidx(kcfg, refd, m1, m2, hd, w)
    assert conprb.preidx_flat.launches == n0 + (2 if paired else 1)
    assert torch.equal(part.flat1, whole.flat1[w.h0:w.h1])
    assert torch.equal(part.nflat1, whole.nflat1[w.r0:w.r1])
    if paired:
        assert torch.equal(part.flat2, whole.flat2[w.h0:w.h1])
        assert torch.equal(part.nflat2, whole.nflat2[w.r0:w.r1])


@pytest.mark.parametrize("paired", [False, True])
def test_run_em_windowed_cuda_matches_unwindowed(dev, paired):
    """On the card, PreIdx cut into >= 3 windows against the unwindowed
    per-round path: same rounds; theta, counts, frac_hit and the refit
    profiles within rtol 1e-5."""
    import copy

    ref, bundle, _spec, model = synthetic_dataset(
        n_reads=3000, M=80, read_len=36, tx_len=400, paired=paired,
        has_qual=True, mean_extra_hits=1.5, seed=11)
    kcfg = em.kernel_config(model, bundle, 36)
    budget = conprb.preidx_bytes(kcfg, bundle.hits.n_hits,
                                 bundle.hits.n_reads) // 3
    w = em.run_em(copy.deepcopy(model), ref, bundle,
                  em.EMConfig(preidx_budget=budget), device=dev)
    u = em.run_em(copy.deepcopy(model), ref, bundle,
                  em.EMConfig(fused_model=False), device=dev)
    assert w.windows >= 3 and u.windows == 1
    assert w.rounds == u.rounds
    for name in ("theta_raw", "counts", "frac_hit"):
        np.testing.assert_allclose(getattr(w, name), getattr(u, name),
                                   rtol=1e-5, atol=1e-9, err_msg=name)
    np.testing.assert_allclose(w.model.pro.p, u.model.pro.p, rtol=1e-5,
                               atol=1e-12)
    np.testing.assert_allclose(w.model.npro.p, u.model.npro.p, rtol=1e-5,
                               atol=1e-12)


def test_default_budget_on_cuda(dev):
    """The default budget is the free device memory less the headroom, in
    PreIdx bytes; a workload far under it runs in one window."""
    import copy

    ref, bundle, _spec, model = synthetic_dataset(
        n_reads=500, M=20, read_len=36, tx_len=300, seed=2)
    kcfg = em.kernel_config(model, bundle, 36)
    budget = em.preidx_budget(em.EMConfig(), kcfg, dev,
                              bundle.hits.n_hits)
    free, _total = torch.cuda.mem_get_info(dev)
    assert 0 < budget < free
    res = em.run_em(copy.deepcopy(model), ref, bundle, device=dev)
    assert res.windows == 1 and 0 < res.preidx_budget < free


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


def test_model_loop_k3_allocates_nothing(dev, monkeypatch):
    """Every K3 launch of the fused loop (paired: both mates' profile and
    noise rows, each round) adds into the loop's own f64 accumulators and
    allocates no device memory."""
    from rsem_tpu_torch.ops import model_loop

    args = _model_loop_inputs(True, dev)
    grown, accs = [], set()
    scatter = model_loop.scatter_add

    def counted(idx, w, size, acc=None):
        torch.cuda.synchronize()
        before = torch.cuda.memory_stats(dev)["allocation.all.allocated"]
        out = scatter(idx, w, size, acc)
        grown.append(torch.cuda.memory_stats(dev)["allocation.all.allocated"]
                     - before)
        accs.add(None if acc is None else acc.data_ptr())
        return out

    monkeypatch.setattr(model_loop, "scatter_add", counted)
    model_loop.run_model_loop(*args[:4], 3, *args[4:])
    assert grown == [0] * 12
    assert None not in accs and len(accs) == 2


@pytest.mark.parametrize("paired", [True, False])
@pytest.mark.parametrize("n_reads", [900_000, 13_500_000])
def test_estep_stats_matches_plain(dev, n_reads, paired):
    """The fused loop's E-step statistics kernel against its plain version
    on the card, at the cells cell's size (0.9M aligned pairs, ~2.4M hits)
    and a bulk sample's (13.5M, ~36M hits), M = 73,599, paired with
    est-RSPD and single-end: frac and frac_noise within float32 rtol 1e-6
    (the weights are the same bits; the f64 denominators are summed in
    another order); the kernel's f64 counts and histograms within rtol
    1e-12 of the same sums over its own fractions on the CPU (atomic
    order), and within 1e-6 of the plain version's."""
    from rsem_tpu_torch.ops import model_loop
    from rsem_tpu_torch.testing import synthetic_estep_inputs
    from rsem_tpu_torch.utils import timing

    M = 73_599
    cfg, data, lp, lnp, th = synthetic_estep_inputs(n_reads, M, paired,
                                                    paired, 5, dev)
    H = data.sid.shape[0]
    sizes = [M + 1, cfg.gld_ub - cfg.gld_lb if paired else 0,
             cfg.B if paired else 0]

    def run(fn):
        red = torch.zeros(sum(sizes), dtype=torch.float64, device=dev)
        frac = torch.empty(H, dtype=torch.float32, device=dev)
        frac_noise = torch.empty(n_reads, dtype=torch.float32, device=dev)
        fn(cfg, data, lp, lnp, th, *red.split(sizes), frac, frac_noise)
        return [frac.cpu(), frac_noise.cpu(), *red.cpu().split(sizes)]

    n, c = model_loop.estep_stats.launches, timing.counters().get(
        "model_estep_launches", 0)
    got = run(model_loop.estep_stats)
    assert model_loop.estep_stats.launches == n + 1
    assert timing.counters()["model_estep_launches"] == c + 1
    want = run(model_loop.estep_stats_plain)
    for what, g, w in zip(["frac", "frac_noise"], got, want):
        torch.testing.assert_close(g, w, rtol=1e-6, atol=0, msg=what)
    frac, frac_noise = got[:2]
    own = [torch.zeros(n, dtype=torch.float64) for n in sizes]
    own[0].index_add_(0, data.sid.cpu().long(), frac.double())
    own[0][0] += frac_noise.double().sum()
    if paired:
        own[1].index_add_(0, data.ins_idx.cpu().long(), frac.double())
        own[2].index_add_(0, data.rs_b0.cpu().long(),
                          (frac * data.rs_w0.cpu()).double())
        own[2].index_add_(0, data.rs_b1.cpu().long(),
                          (frac * data.rs_w1.cpu()).double())
    for what, g, o, w in zip(["counts", "gld", "rspd"], got[2:], own,
                             want[2:]):
        torch.testing.assert_close(g, o, rtol=1e-12, atol=0, msg=what)
        torch.testing.assert_close(g, w, rtol=1e-6, atol=0, msg=what)


def test_run_em_launches_estep_once_a_model_round(dev):
    """A fused run_em on the card launches the E-step statistics kernel
    once per model-update round: model_estep_launches rises by exactly
    10."""
    import copy

    from rsem_tpu_torch.utils import timing

    ref, bundle, _spec, model = synthetic_dataset(
        n_reads=3000, M=80, read_len=36, tx_len=400, paired=True,
        has_qual=True, mean_extra_hits=1.5, seed=11, est_rspd=True)
    before = timing.counters().get("model_estep_launches", 0)
    res = em.run_em(copy.deepcopy(model), ref, bundle, device=dev)
    assert res.rounds > 10
    assert timing.counters()["model_estep_launches"] - before == 10


@pytest.mark.parametrize("table", ["M", "relabelled"])
@pytest.mark.parametrize("n_chains", [1, 8])
@pytest.mark.parametrize("K", [1, 4, 32, 64, 256, 1024, 8192])
def test_gibbs_sweep_matches_plain(dev, K, n_chains, table):
    """K5 against sweep_part_plain on the card and on the CPU, exact, over
    two sweeps: several tiles per part, each with padding at its end,
    fractional pseudo-counts, an omitted sid, and reads whose noise slot
    competes with their hits. table: the layout's own T = M+1, or the
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
            part.K.bit_length() - 1, 2, part.n_reads - 1, 21, 1, 0, 0,
            _build.stream_of(t)), "gibbs_sweep")


def _gibbs_setup_inputs():
    """Widths 1-32 with noise slots, a fifth of the alignments dropped and
    reads with no kept slot; and pairs of isoforms (the spread test's)."""
    from rsem_tpu_torch.testing import pair_hits

    hits, lcp, lnp = synthetic_gibbs_hits(20_000, 400, seed=12, max_hits=24)
    lcp = lcp.copy()
    lcp[::5] = -np.inf
    for r in range(0, 20_000, 101):
        lcp[hits.read_offsets[r]:hits.read_offsets[r + 1]] = -np.inf
    lnp = lnp.copy()
    lnp[::3] = -21.0
    return {"mixed": (hits, lcp, lnp, 400),
            "pairs": pair_hits([1.0] * 200 + [1.1] * 200, 30) + (800,)}


@pytest.mark.parametrize("case", ["mixed", "pairs"])
def test_gibbs_layout_cuda_matches_cpu(dev, case):
    """build_layout on the card (from the cached upload of the hits) equals
    the CPU's: parts, widths, tile counts, fills and sids exactly, the
    scaled conprbs within one f32 ulp (f64 exp on either device)."""
    hits, lcp, lnp, M = _gibbs_setup_inputs()[case]
    g = gibbs.build_layout(hits, lcp, lnp, M, device=dev)
    c = gibbs.build_layout(hits, lcp, lnp, M, device="cpu")
    assert (g.n_reads, g.n_noise_fixed) == (c.n_reads, c.n_noise_fixed)
    assert [(p.K, p.n_tiles) for p in g.parts] == [
        (p.K, p.n_tiles) for p in c.parts]
    for p, q in zip(g.parts, c.parts):
        assert p.sid.is_cuda and np.array_equal(p.fill, q.fill)
        assert torch.equal(p.sid.cpu(), q.sid)
        for x, y in ((p.cps.cpu(), q.cps), (p.ncs.cpu(), q.ncs)):
            ulp = torch.as_tensor(np.spacing(np.maximum(
                x.abs().numpy(), y.abs().numpy())))
            assert bool(((x - y).abs() <= ulp).all())


@pytest.mark.parametrize("chains", [None, slice(3, 7)])
def test_gibbs_init_cuda_matches_cpu(dev, chains):
    """init_chains on the card equals the CPU's on the same layout, bit for
    bit: assignments and tables, all 8 chains or a rank's slice."""
    hits, lcp, lnp, M = _gibbs_setup_inputs()["mixed"]
    layout = gibbs.build_layout(hits, lcp, lnp, M, device=dev)
    base = torch.full((M + 1,), 0.5)
    base[0] += 40.0
    a_g, t_g = gibbs.init_chains(layout, base.to(dev), 8, seed=9,
                                 chains=chains)
    a_c, t_c = gibbs.init_chains(layout.to(CPU), base, 8, seed=9,
                                 chains=chains)
    assert t_g.is_cuda and torch.equal(t_g.cpu(), t_c)
    for x, y in zip(a_g, a_c):
        assert x.is_cuda and torch.equal(x.cpu(), y)
    assert sum(int((a >= 0).sum()) for a in a_c) > 0


def test_run_gibbs_cuda_matches_cpu(dev):
    """One seed, one initial state (each device builds the layout and
    draws the state from the counter hash): identical count vectors from
    the kernel and from the plain version."""
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


def test_run_gibbs_spread_input_cuda_matches_cpu(dev):
    """tests/test_torch_gibbs_spread.py's pairs (12 of equal conprbs, 12 of
    ratio 1.1, 20 reads each) at its run's configuration: a layout of 32
    mostly empty tiles (n_blocks = 32), one read of a pair per tile; K5
    on the card gives the CPU's count vectors exactly, one launch per
    sweep."""
    from rsem_tpu_torch.engine.gibbs import GibbsConfig, run_gibbs
    from rsem_tpu_torch.refprep.transcripts import GroupInfo
    from rsem_tpu_torch.testing import pair_hits, pair_tile_max

    M = 48
    hits, lcp, lnp = pair_hits([1.0] * 12 + [1.1] * 12, 20)
    layout = gibbs.build_layout(hits, lcp, lnp, M, device=dev)
    assert layout.n_tiles == 32 and pair_tile_max(layout) == 1
    eel, mw = np.full(M + 1, 1000.0), np.ones(M + 1)
    gi = GroupInfo(np.concatenate([np.arange(1, M + 1, 2), [M + 1]]))
    cfg = GibbsConfig(burnin=60, nsamples=32 * 120, n_chains=32, seed=4)
    n0 = gibbs.sweep_part.launches
    g = run_gibbs(hits, lcp, lnp, M, 0, eel, mw, gi, cfg, device=dev)
    torch.cuda.synchronize()
    assert gibbs.sweep_part.launches - n0 == 60 + 120
    c = run_gibbs(hits, lcp, lnp, M, 0, eel, mw, gi, cfg, device="cpu")
    assert torch.equal(g.countvectors.cpu(), c.countvectors)
    np.testing.assert_allclose(g.pve_c, c.pve_c, rtol=1e-12)


def test_gibbs_sweep_dealt_few_reads_matches_plain(dev):
    """A few hundred reads of 3-6 hits (widths 4 and 8) with noise slots,
    dealt over their share of n_blocks = 32 tiles (most slots padding, in
    every tile): K5 launches once per part and sweep and stays identical
    to the plain version, which skips the padding."""
    M = 12
    hits, lcp, lnp = synthetic_gibbs_hits(200, M, seed=21, max_hits=6,
                                          min_hits=3)
    lnp[::3] = -20.0
    layout = gibbs.build_layout(hits, lcp, lnp, M, n_blocks=32)
    assert [p.K for p in layout.parts] == [4, 8]
    assert sum(p.n_tiles for p in layout.parts) >= 32
    assert all(p.fill.max() < p.reads_per_tile for p in layout.parts)
    base = torch.ones(M + 1)
    base[5] = 0.0  # omitted
    assigns, tab = gibbs.init_chains(layout, base, 8, seed=2)
    lay_g = layout.to(dev)
    a_g = [a.to(dev) for a in assigns]
    t_g = tab.to(dev)
    scratch = gibbs.delta_scratch(t_g)
    n0 = gibbs.sweep_part.launches
    for sweep in range(3):
        for pi, part in enumerate(layout.parts):
            sp = gibbs.part_seed(6, pi)
            gibbs.sweep_part(a_g[pi], t_g, lay_g.parts[pi], sp, sweep,
                             scratch)
            gibbs.sweep_part(assigns[pi], tab, part, sp, sweep)
    torch.cuda.synchronize()
    assert gibbs.sweep_part.launches == n0 + 3 * len(layout.parts)
    for g, c in zip(a_g, assigns):
        assert torch.equal(g.cpu(), c)
    assert torch.equal(t_g.cpu(), tab)
    assert not bool(scratch.any())


def _allele_groups(M):
    """(gene starts, transcript -> allele starts) over sids 1..M: alleles in
    pairs, every fifth transcript with one; genes of two transcripts."""
    sizes = np.resize([2, 2, 2, 2, 1], M)
    ta = np.concatenate([[1], 1 + np.cumsum(sizes)])
    ta = np.append(ta[ta < M + 1], M + 1)
    return np.append(ta[:-1][::2], M + 1), ta


def test_run_gibbs_allele_cuda_matches_cpu(dev):
    """run_gibbs with an allele grouping: K5 replays the CPU chains exactly
    (identical count vectors), pve_c_trans within rtol 1e-5 of the CPU's."""
    from rsem_tpu_torch.engine.gibbs import GibbsConfig, run_gibbs
    from rsem_tpu_torch.refprep.transcripts import GroupInfo

    M = 240
    gene_s, ta_s = _allele_groups(M)
    hits, lcp, lnp = synthetic_gibbs_hits(4000, M, seed=9, max_hits=12)
    eel, mw = np.full(M + 1, 150.0), np.ones(M + 1)
    cfg = GibbsConfig(burnin=20, nsamples=80, n_chains=8, seed=4)
    args = (hits, lcp, lnp, M, 25, eel, mw, GroupInfo(gene_s), cfg)
    g = run_gibbs(*args, device=dev, ta=GroupInfo(ta_s))
    c = run_gibbs(*args, device="cpu", ta=GroupInfo(ta_s))
    assert torch.equal(g.countvectors.cpu(), c.countvectors)
    assert g.pve_c_trans.shape == (len(ta_s) - 1,)
    np.testing.assert_allclose(g.pve_c_trans, c.pve_c_trans, rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(g.pve_c_genes, c.pve_c_genes, rtol=1e-5,
                               atol=1e-6)


def test_run_ci_allele_cuda_matches_cpu(dev):
    """run_ci with an allele grouping on the card: transcript intervals
    beside the CPU's from the same count vectors (the Gamma draws of two
    devices differ: bounds within 0.12 x width + 0.5 and lb <= ub), and a
    transcript of one allele copies its allele's bounds exactly."""
    from rsem_tpu_torch.engine.ci import CIConfig, run_ci
    from rsem_tpu_torch.refprep.transcripts import GroupInfo

    M = 240
    gene_s, ta_s = _allele_groups(M)
    rng = np.random.default_rng(6)
    cvs = rng.poisson(rng.gamma(1.0, 30.0, M + 1), size=(64, M + 1)).astype(
        np.float32)
    eel, mw = rng.uniform(100, 400, M + 1), np.ones(M + 1)
    cfg = CIConfig(nspc=50, seed=3)
    ta = GroupInfo(ta_s)
    g = run_ci(cvs, eel, mw, GroupInfo(gene_s), cfg, device=dev, ta=ta)
    c = run_ci(cvs, eel, mw, GroupInfo(gene_s), cfg, device="cpu", ta=ta)
    single = np.diff(ta_s) == 1
    first = ta_s[:-1] - 1
    for got, want, member in ((g.iso_tpm, c.iso_tpm, g.tpm),
                              (g.iso_fpkm, c.iso_fpkm, g.fpkm)):
        assert (got.lb <= got.ub).all()
        width = np.maximum(want.ub - want.lb, 1.0)
        assert (np.abs(got.lb - want.lb) < 0.12 * width + 0.5).all()
        assert (np.abs(got.ub - want.ub) < 0.12 * width + 0.5).all()
        for f in ("lb", "ub", "cqv"):
            np.testing.assert_array_equal(
                getattr(got, f)[single], getattr(member, f)[1:][
                    first[single]])


def test_ci_group_sums_on_card_equal_cpu(dev):
    """CI's group sums on the card: the same bits as on the CPU, where
    each group's members are added one after another from 0, at skewed
    group sizes and whole or cut at a group boundary."""
    from rsem_tpu_torch.engine.ci import _segment_sums

    rng = np.random.default_rng(9)
    sizes = np.minimum(rng.zipf(1.6, 3000), 300)
    rows = torch.as_tensor(rng.gamma(0.3, 1e3, (int(sizes.sum()), 257)),
                           dtype=torch.float32)
    want = _segment_sums(rows, sizes)
    assert torch.equal(_segment_sums(rows.to(dev), sizes).cpu(), want)
    lo = int(sizes[:1234].sum())
    assert torch.equal(_segment_sums(rows[lo:].to(dev), sizes[1234:]).cpu(),
                       want[1234:])


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


def _golden_sim_inputs(model_file):
    import os

    from rsem_tpu_torch.model.generative import GenerativeModel
    from rsem_tpu_torch.refprep.reference import Reference

    gold = os.path.join(os.path.dirname(__file__), "goldens")
    refs = Reference.load_seq(f"{gold}/ref.seq")
    model = GenerativeModel.read(f"{gold}/{model_file}", refs=refs)
    rows = [l.rstrip("\n").split("\t")
            for l in open(f"{gold}/golden.isoforms.results")]
    tpm = np.zeros(refs.M + 1)
    tpm[1:] = [float(r[rows[0].index("TPM")]) for r in rows[1:]]
    return refs, model, tpm


def test_simulate_counts_follow_theta_on_card(dev, tmp_path):
    """1M reads drawn on the card from the golden single-end model: the
    transcript counts against n * theta (6 sd + 3 each, chi-square p >
    1e-6), four FASTQ lines per read."""
    from rsem_tpu_torch.engine import simulate as sim
    from rsem_tpu_torch.testing import counts_vs_theta

    refs, model, tpm = _golden_sim_inputs("golden.model")
    n = 1_000_000
    res = sim.simulate_reads(model, refs, tpm, 0.05, n, str(tmp_path / "s"),
                             seed=13, device=dev)
    assert res.counts.sum() == n and res.counts.shape == (refs.M + 1,)
    worst, p = counts_vs_theta(res.counts, sim.sim_theta(model, tpm, 0.05),
                               n)
    assert worst <= 1.0 and p > 1e-6, (worst, p)
    buf = np.fromfile(tmp_path / "s.fq", dtype=np.uint8)
    assert int((buf == 10).sum()) == 4 * n


def test_simulate_same_seed_same_bytes_on_card(dev, tmp_path):
    from rsem_tpu_torch.engine import simulate as sim

    refs, model, tpm = _golden_sim_inputs("golden_pe.model")

    def run(tag, seed):
        sim.simulate_reads(model, refs, tpm, 0.05, 50_000,
                           str(tmp_path / tag), seed=seed, chunk=20_000,
                           device=dev)
        return [(tmp_path / f"{tag}_{m}.fq").read_bytes() for m in (1, 2)]

    a, b, c = run("a", 5), run("b", 5), run("c", 6)
    assert a == b and a != c


def test_theta_split_matches_plain(dev):
    """K1 split for the read-sharded loop: its partial kernel on two read
    slices adds into one summed buffer (as the ranks' all_reduce would),
    then its finish, against the plain versions on the CPU (rtol 1e-5,
    stop count within 2); the finish leaves the buffer zero."""
    from rsem_tpu_torch.parallel.fast_sharded import partition_reads_by_hits

    rng = np.random.default_rng(21)
    N, M = 20_000, 500
    nh = rng.integers(0, 7, N)
    offs = np.concatenate([[0], np.cumsum(nh)])
    H = int(offs[-1])
    sid = rng.integers(1, M + 1, H)
    cps = rng.random(H)
    ncs = rng.random(N) * 0.1
    th = torch.as_tensor(rng.dirichlet(np.ones(M + 1)), dtype=torch.float32)

    def data_of(lo, hi, device):
        h0, h1 = int(offs[lo]), int(offs[hi])
        t = lambda x, dt: torch.as_tensor(x, dtype=dt).to(device)  # noqa
        return theta.ThetaData(
            t(sid[h0:h1], torch.int32),
            t(np.repeat(np.arange(hi - lo), nh[lo:hi]), torch.int32),
            t(cps[h0:h1], torch.float32), t(ncs[lo:hi], torch.float32),
            t(offs[lo:hi + 1] - h0, torch.int64), M, 4.0)

    cuts = partition_reads_by_hits(offs, 2)
    slices = list(zip(cuts[:-1], cuts[1:]))
    state = theta.round_state(data_of(0, N, dev), 1, dev)
    state.ring[0] = th.to(dev)
    red = torch.zeros(M + 2, dtype=torch.float64)
    n0 = theta.theta_partial.launches
    for lo, hi in slices:
        theta.theta_partial(state, data_of(lo, hi, dev), 0)
        red += theta.theta_partial_plain(th, data_of(lo, hi, CPU))
    torch.testing.assert_close(state.reduced.cpu(), red, rtol=1e-5,
                               atol=1e-9)
    theta.theta_finish(state, data_of(0, N, dev), 0)
    assert theta.theta_partial.launches == n0 + 2
    t_p, c_p, n_p = theta.theta_finish_plain(th, red, 4.0)
    torch.testing.assert_close(state.ring[1].cpu(), t_p, rtol=1e-5,
                               atol=1e-9)
    torch.testing.assert_close(state.counts.cpu(), c_p, rtol=1e-5, atol=1e-6)
    assert abs(int(state.tot[0]) - int(n_p)) <= 2
    assert not bool(state.reduced.any())


@pytest.mark.parametrize("chain0", [4, 5])
def test_gibbs_sweep_chain0_matches_plain(dev, chain0):
    """K5 on chains chain0.. of 8 (a rank's share): identical to the plain
    sweep with the same chain0, and to those chains of the 8-chain run."""
    hits, lcp, lnp = synthetic_gibbs_hits(20_000, 300, seed=chain0,
                                          max_hits=9)
    layout = gibbs.build_layout(hits, lcp, lnp, 300, device=dev)
    base = torch.ones(301)
    mine = slice(chain0, min(chain0 + 3, 8))
    a8, t8 = gibbs.init_chains(layout, base, 8, seed=2, device=dev)
    a_k, t_k = gibbs.init_chains(layout, base, 8, seed=2, device=dev,
                                 chains=mine)
    a_p, t_p = [a.cpu() for a in a_k], t_k.cpu()
    for s in range(3):
        for pi, part in enumerate(layout.parts):
            sp = gibbs.part_seed(9, pi)
            gibbs.sweep_part(a8[pi], t8, part, sp, s)
            gibbs.sweep_part(a_k[pi], t_k, part, sp, s, chain0=chain0)
            gibbs.sweep_part_plain(a_p[pi], t_p, part.to(CPU), sp, s,
                                   chain0)
    assert torch.equal(t_k.cpu(), t_p)
    assert torch.equal(t_k, t8[mine])
    for x, y, z in zip(a_k, a_p, a8):
        assert torch.equal(x.cpu(), y)
        assert torch.equal(x, z[mine])


def test_run_em_nccl_world_one_matches_no_group(dev):
    """run_em with an NCCL group of one (the read-sharded path: K1 split
    around the all_reduce) against run_em without a group: counts, TPM and
    frac_hit within rtol 1e-5, rounds within 2."""
    import copy
    import socket

    from rsem_tpu_torch.parallel import distributed

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    d1 = distributed.init_group(dev, f"tcp://127.0.0.1:{port}", 1, 0)
    try:
        assert d1.backend == "nccl"
        ref, bundle, _spec, model = synthetic_dataset(
            n_reads=3000, M=80, read_len=36, tx_len=400, paired=False,
            has_qual=True, mean_extra_hits=1.5, seed=11)
        n0 = theta.theta_partial.launches
        g = em.run_em(copy.deepcopy(model), ref, bundle, device=dev, dist=d1)
        assert theta.theta_partial.launches > n0
        c = em.run_em(copy.deepcopy(model), ref, bundle, device=dev)
        assert abs(g.rounds - c.rounds) <= 2
        np.testing.assert_allclose(g.counts, c.counts, rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(g.tpm, c.tpm, rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(g.frac_hit, c.frac_hit, rtol=1e-5,
                                   atol=1e-7)
    finally:
        torch.distributed.destroy_process_group()


def test_cached_upload_keeps_device_buffers(dev):
    """A repeat upload of the same host objects returns the same device
    buffers; an in-place edit of a sampled element gives new ones holding
    the edit; clear_device_cache() drops them."""
    from rsem_tpu_torch.ops.layout import device_cache_bytes

    ref, bundle, _spec, _model = synthetic_dataset(
        n_reads=500, M=20, read_len=36, tx_len=300, seed=2)
    a = em.upload(ref, bundle, False, dev)
    b = em.upload(ref, bundle, False, dev)
    for x, y in zip(a, b):
        if x is not None:
            for t, u in zip(x, y):
                if isinstance(t, torch.Tensor):
                    assert t.data_ptr() == u.data_ptr()
    assert device_cache_bytes() > 0
    bundle.hits.pos[0] += 1
    c = em.upload(ref, bundle, False, dev)
    assert c[3].pos.data_ptr() != a[3].pos.data_ptr()
    assert int(c[3].pos[0]) == int(bundle.hits.pos[0])
    assert c[0].codes.data_ptr() == a[0].codes.data_ptr()  # ref unchanged
    clear_device_cache()
    assert device_cache_bytes() == 0


def test_streamed_loop_matches_resident_on_card(dev):
    """The streamed loop over 3 pinned chunks (two device buffers fed on a
    side stream) against the resident loop on the whole CSR, both at 25
    rounds: theta within rtol 1e-5 (K1's f64 atomics), 25 x 3 partial
    launches; the last round's counts as the CPU's streamed loop gives
    them (rtol 1e-5)."""
    M = 3000
    hits, lcp, lnp = _ragged_hits(5000, M, seed=3)
    chunks, _b, _hb = build_theta_chunks(hits, lcp.numpy(), lnp.numpy(), M,
                                         5.0, 3, device=dev)
    assert all(c.sid.is_pinned() and c.cps.is_pinned() for c in chunks)
    th0 = torch.full((M + 1,), 1.0 / (M + 1), device=dev)
    n0 = theta.theta_partial.launches
    th_s, c_s, r_s = theta.run_theta_loop_streamed(
        th0, chunks, M, 5.0, min_round=25, max_round=25, device=dev)
    assert theta.theta_partial.launches == n0 + 25 * 3
    th_r, r_r = theta.run_theta_loop(th0, _data(hits, lcp, lnp, M, dev),
                                     min_round=25, max_round=25)
    assert r_s == r_r == 25
    torch.testing.assert_close(th_s, th_r, rtol=1e-5, atol=1e-9)
    cpu, _b, _hb = build_theta_chunks(hits, lcp.numpy(), lnp.numpy(), M,
                                      5.0, 3, device="cpu")
    _t, c_cpu, _r = theta.run_theta_loop_streamed(
        th0.cpu(), cpu, M, 5.0, min_round=25, max_round=25, device="cpu")
    torch.testing.assert_close(c_s.cpu(), c_cpu, rtol=1e-5, atol=1e-6)


def test_streamed_loop_refuses_unpinned_chunks(dev):
    M = 300
    hits, lcp, lnp = _ragged_hits(500, M, seed=4)
    chunks, _b, _hb = build_theta_chunks(hits, lcp.numpy(), lnp.numpy(), M,
                                         5.0, 2, device="cpu")
    with pytest.raises(ValueError, match="pinned"):
        theta.run_theta_loop_streamed(torch.full((M + 1,), 1.0 / (M + 1)),
                                      chunks, M, 5.0, device=dev)
