"""The port's kernels (their plain PyTorch versions, which the CPU runs)
against the TPU package's Pallas kernels in interpret mode and their XLA
formulations, on the same numpy inputs.

K2 gather_sum / K3 scatter_add  vs rsem_tpu.ops.pallas_table
K1 theta_round (+ loop, final fractions) vs rsem_tpu.ops.pallas_round /
   rsem_tpu.ops.fast_estep
K4 preidx_flat vs rsem_tpu.ops.conprb.precompute_profile_indices_fused
   (bit-identical)
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rsem_tpu.io.hits import HitArrays
from rsem_tpu.ops import pallas_table as pt
from rsem_tpu.ops.fast_estep import (
    build_fast_data,
    fast_final_fracs,
    fast_theta_round,
    run_fast_em_loop,
)
from rsem_tpu.ops.pallas_round import build_pallas_data, pallas_theta_round
from rsem_tpu.testing import synthetic_arrays_fast
from rsem_tpu_torch.convert import (
    bundle_from_arrays,
    host_state,
    model_from_arrays,
    reference_from_arrays,
)
from rsem_tpu_torch.engine import em as tem
from rsem_tpu_torch.ops import conprb as tconprb
from rsem_tpu_torch.ops import table as ttable
from rsem_tpu_torch.ops import theta as ttheta
from rsem_tpu_torch.ops.layout import HitsDevice as THits
from rsem_tpu_torch.ops.layout import KernelConfig as TKernelConfig

CPU = torch.device("cpu")


# ------------------------------------------------------------------ #
# K2 / K3: table gather-sum and scatter-add                           #
# ------------------------------------------------------------------ #
@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain versions run many small ops; in a test run of several
    worker processes torch's intra-op thread pool only adds contention."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _table_case(size, X, seed):
    rng = np.random.default_rng(seed)
    flat = rng.integers(0, size + 1, size=(X, 128)).astype(np.int32)
    vals = rng.normal(-3.0, 1.0, size).astype(np.float32)
    w = rng.random(X, dtype=np.float32)
    t_pad = pt.table_rows_padded(size)
    jtab = np.zeros(t_pad * 128, dtype=np.float32)
    jtab[:size] = vals
    return flat, vals, w, jnp.asarray(jtab).reshape(t_pad, 128)


@pytest.mark.parametrize("size,X,seed", [(900, 64, 7), (2500, 40, 3)])
def test_gather_sum_matches_pallas(size, X, seed):
    flat, vals, _w, jtab = _table_case(size, X, seed)
    want = np.asarray(pt.gather_sum(jtab, jnp.asarray(flat),
                                    interpret=True))
    got = ttable.gather_sum(
        ttable.padded_table(torch.as_tensor(vals), size),
        torch.as_tensor(flat)).numpy()
    # f32 sums of 128 terms in different orders (the port sums in f64)
    np.testing.assert_allclose(got, want, rtol=2e-6, atol=1e-4)


@pytest.mark.parametrize("size,X,seed", [(900, 64, 7), (2500, 40, 3)])
def test_scatter_add_matches_pallas(size, X, seed):
    flat, _vals, w, _jtab = _table_case(size, X, seed)
    want = np.asarray(pt.scatter_add(jnp.asarray(flat), jnp.asarray(w), size,
                                     interpret=True))[:size]
    got = ttable.scatter_add(torch.as_tensor(flat), torch.as_tensor(w),
                             size).numpy()
    # the Pallas kernel keeps ~16 mantissa bits per product (bf16 split)
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=1e-5)


@pytest.fixture(scope="module")
def composed_indices():
    """The profile PreIdx and noise indices of a quality-bearing workload
    (~500 and ~200 rows), whose slots collide within a row as they do on
    the main path (the random cases above spread them uniformly), with
    weights (one row in 7 zero) and the Pallas kernel's counts. One
    interpret-mode call scatters both into one table, the noise slots
    after the profile's, because each call costs seconds here."""
    ref, bundle, _spec, model = synthetic_arrays_fast(
        n_reads=200, M=40, read_len=100, tx_len=600, has_qual=True, seed=4)
    t_ref = reference_from_arrays(host_state(ref))
    t_bundle = bundle_from_arrays(host_state(bundle))
    t_model = model_from_arrays(host_state(model), refs=t_ref)
    refd, m1, _m2, hd = tem.upload(t_ref, t_bundle, False, CPU)
    kcfg = TKernelConfig.from_model(t_model, 100)
    pro, npro = kcfg.pro_keys(), kcfg.npro_keys()
    flat = tconprb.preidx_flat(kcfg, refd, m1, hd).numpy()
    nflat = tconprb.noise_flat(kcfg, m1).numpy()
    rng = np.random.default_rng(11)
    w = rng.random(flat.shape[0] + nflat.shape[0], dtype=np.float32)
    w[::7] = 0.0
    both = np.concatenate([np.where(flat < pro, flat, pro + npro),
                           nflat + pro]).astype(np.int32)
    want = np.asarray(pt.scatter_add(jnp.asarray(both), jnp.asarray(w),
                                     pro + npro, interpret=True))
    cut = flat.shape[0]
    return {"profile": (flat, pro, w[:cut], want[:pro]),
            "noise": (nflat, npro, w[cut:], want[pro:pro + npro])}


@pytest.mark.parametrize("which", ["profile", "noise"])
def test_scatter_add_composed_matches_pallas(composed_indices, which):
    flat, size, w, want = composed_indices[which]
    rows = flat.shape[0]
    # slots repeat inside rows: fewer distinct slots than valid lanes
    distinct = sum(len(np.unique(r[r < size])) for r in flat)
    assert distinct < 0.9 * int((flat < size).sum())
    flat = torch.as_tensor(flat)
    got = ttable.scatter_add(flat, torch.as_tensor(w), size).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=1e-5)
    acc = torch.zeros(size, dtype=torch.float64)
    for a, b in ((0, rows // 3), (rows // 3, rows)):
        ttable.scatter_add(flat[a:b], torch.as_tensor(w[a:b]), size, acc)
    np.testing.assert_allclose(acc.numpy(), want, rtol=2e-5, atol=1e-5)


def test_wide_rows_sum_whole():
    """Rows of 256 columns (150 bp reads) are summed whole, which equals
    the TPU path's [H*2, 128] reshape followed by a pairwise sum."""
    flat, vals, w, jtab = _table_case(700, 64, 5)
    wide = flat.reshape(32, 256)
    want = np.asarray(pt.gather_sum(jtab, jnp.asarray(flat),
                                    interpret=True)).reshape(32, 2).sum(1)
    got = ttable.gather_sum(ttable.padded_table(torch.as_tensor(vals), 700),
                            torch.as_tensor(wide)).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-6, atol=1e-4)
    want_s = np.asarray(pt.scatter_add(
        jnp.asarray(flat), jnp.asarray(np.repeat(w[:32], 2)), 700,
        interpret=True))[:700]
    got_s = ttable.scatter_add(torch.as_tensor(wide),
                               torch.as_tensor(w[:32]), 700).numpy()
    np.testing.assert_allclose(got_s, want_s, rtol=2e-5, atol=1e-5)


# ------------------------------------------------------------------ #
# K1: theta round                                                     #
# ------------------------------------------------------------------ #
def _synthetic_hits(N, M, max_hits=200, seed=0):
    """Ragged hits per read (1..200) with noise reads and -inf noise
    conprbs, as tests/test_pallas_round.py builds them."""
    rng = np.random.default_rng(seed)
    nh = np.minimum(
        rng.geometric(0.25, size=N) + (rng.random(N) < 0.02) * rng.integers(
            100, max_hits, size=N),
        max_hits,
    ).astype(np.int64)
    H = int(nh.sum())
    offsets = np.zeros(N + 1, dtype=np.int64)
    np.cumsum(nh, out=offsets[1:])
    hits = HitArrays(
        rid=np.repeat(np.arange(N, dtype=np.int32), nh),
        sid=rng.integers(1, M + 1, size=H).astype(np.int32),
        dir=np.zeros(H, dtype=np.int8), pos=np.zeros(H, dtype=np.int32),
        insert_len=None, read_offsets=offsets,
    )
    lcp = np.log(rng.random(H) * 0.9 + 0.1) - 20.0
    lnp = np.log(rng.random(N) * 0.5 + 0.01) - 25.0
    lnp[::97] = -np.inf
    return hits, lcp, lnp


def _theta_data(hits, lcp, lnp, M, n0):
    return ttheta.scale_conprbs(
        THits.from_arrays(hits, CPU), torch.as_tensor(lcp),
        torch.as_tensor(lnp), M, n0)


@pytest.mark.parametrize("seed", [0, 3])
def test_theta_round_matches_pallas_and_xla(seed):
    M, n0 = 300, 17.0
    hits, lcp, lnp = _synthetic_hits(700, M, seed=seed)
    theta = np.random.default_rng(seed + 1).dirichlet(np.ones(M + 1)).astype(
        np.float32)
    t_x, c_x = fast_theta_round(jnp.asarray(theta),
                                build_fast_data(hits, lcp, lnp, M, n0))
    t_p, c_p = pallas_theta_round(jnp.asarray(theta),
                                  build_pallas_data(hits, lcp, lnp, M, n0),
                                  interpret=True)
    t_new, c_new, _n = ttheta.theta_round_plain(
        torch.as_tensor(theta), _theta_data(hits, lcp, lnp, M, n0))
    # f32 rounds on the TPU side vs f64 sums here
    for c_ref, t_ref in ((c_x, t_x), (c_p, t_p)):
        np.testing.assert_allclose(c_new.numpy(), np.asarray(c_ref),
                                   rtol=2e-5, atol=1e-4)
        np.testing.assert_allclose(t_new.numpy(), np.asarray(t_ref),
                                   rtol=1e-4, atol=1e-9)


def test_theta_loop_matches_xla_loop():
    M = 150
    hits, lcp, lnp = _synthetic_hits(400, M, seed=5)
    theta0 = np.full(M + 1, 1.0 / (M + 1), dtype=np.float32)
    t_ref, _c, r_ref, _ = run_fast_em_loop(
        jnp.asarray(theta0), build_fast_data(hits, lcp, lnp, M, 3.0),
        max_round=40)
    t_new, r_new = ttheta.run_theta_loop(
        torch.as_tensor(theta0), _theta_data(hits, lcp, lnp, M, 3.0),
        max_round=40)
    assert r_new == int(r_ref)
    np.testing.assert_allclose(t_new.numpy(), np.asarray(t_ref), rtol=5e-4,
                               atol=1e-8)


@pytest.mark.parametrize("seed,N,M", [(1, 300, 40), (2, 200, 20)])
def test_theta_loop_stops_where_xla_loop_stops(seed, N, M):
    """Run to the reference's stop rule (hundreds of rounds here): the
    port must stop at exactly the same round."""
    hits, lcp, lnp = _synthetic_hits(N, M, seed=seed)
    theta0 = np.full(M + 1, 1.0 / (M + 1), dtype=np.float32)
    t_ref, _c, r_ref, _ = run_fast_em_loop(
        jnp.asarray(theta0), build_fast_data(hits, lcp, lnp, M, 3.0),
        max_round=10_000)
    t_new, r_new = ttheta.run_theta_loop(
        torch.as_tensor(theta0), _theta_data(hits, lcp, lnp, M, 3.0),
        max_round=10_000)
    assert 20 < r_new < 10_000
    assert r_new == int(r_ref)
    np.testing.assert_allclose(t_new.numpy(), np.asarray(t_ref), rtol=5e-4,
                               atol=1e-8)


def test_final_fracs_and_counts_match_xla():
    M = 120
    hits, lcp, lnp = _synthetic_hits(300, M, seed=9)
    theta = np.random.default_rng(2).dirichlet(np.ones(M + 1)).astype(
        np.float32)
    fdata = build_fast_data(hits, lcp, lnp, M, 0.0)
    f_ref, fn_ref = fast_final_fracs(jnp.asarray(theta), fdata)
    data = _theta_data(hits, lcp, lnp, M, 0.0)
    f_new, fn_new = ttheta.final_fracs(torch.as_tensor(theta), data)
    np.testing.assert_allclose(f_new.numpy(), np.asarray(f_ref)[:hits.n_hits],
                               rtol=2e-5, atol=1e-7)
    np.testing.assert_allclose(fn_new.numpy(), np.asarray(fn_ref), rtol=2e-5,
                               atol=1e-7)
    # counts at a fixed theta conserve the read mass
    c = ttheta.counts(torch.as_tensor(theta), data).numpy()
    assert c.sum() == pytest.approx(hits.n_reads, rel=1e-6)


# ------------------------------------------------------------------ #
# K4: PreIdx build, bit-identical                                     #
# ------------------------------------------------------------------ #
def _jax_layout(ref, bundle, paired):
    from rsem_tpu.ops import HitsDevice, ReadsDevice, RefDevice

    refd = RefDevice.from_reference(ref)
    if paired:
        m1 = ReadsDevice.from_arrays(bundle.reads.mate1)
        m2 = ReadsDevice.from_arrays(bundle.reads.mate2)
    else:
        m1, m2 = ReadsDevice.from_arrays(bundle.reads), None
    return refd, m1, m2, HitsDevice.from_arrays(bundle.hits)


@pytest.mark.parametrize("read_len", [50, 150])
@pytest.mark.parametrize("has_qual", [True, False])
@pytest.mark.parametrize("paired", [False, True])
def test_preidx_bit_identical(paired, has_qual, read_len):
    from rsem_tpu.ops import KernelConfig
    from rsem_tpu.ops.conprb import precompute_profile_indices_fused

    ref, bundle, _spec, model = synthetic_arrays_fast(
        n_reads=200, M=30, read_len=read_len, tx_len=5 * read_len,
        paired=paired, has_qual=has_qual, mean_extra_hits=1.3, seed=9,
    )
    refd, m1, m2, hd = _jax_layout(ref, bundle, paired)
    L = m1.codes.shape[1]
    want = precompute_profile_indices_fused(
        KernelConfig.from_model(model, L), refd, m1, m2, hd)

    t_ref = reference_from_arrays(host_state(ref))
    t_bundle = bundle_from_arrays(host_state(bundle))
    t_model = model_from_arrays(host_state(model), refs=t_ref)
    trefd, tm1, tm2, thd = tem.upload(t_ref, t_bundle, paired, CPU)
    got = tconprb.precompute_profile_indices_fused(
        TKernelConfig.from_model(t_model, L), trefd, tm1, tm2, thd)

    H, N = bundle.hits.n_hits, bundle.hits.n_reads
    np.testing.assert_array_equal(got.flat1.numpy(),
                                  np.asarray(want.flat1)[:H])
    np.testing.assert_array_equal(got.nflat1.numpy(),
                                  np.asarray(want.nflat1)[:N])
    if paired:
        np.testing.assert_array_equal(got.flat2.numpy(),
                                      np.asarray(want.flat2)[:H])
        np.testing.assert_array_equal(got.nflat2.numpy(),
                                      np.asarray(want.nflat2)[:N])
