"""The port's fused model loop (rsem_tpu_torch/ops/model_loop.py) and the
device EM that takes it by default, against the JAX package's fused loop
(rsem_tpu/ops/model_loop.py, reached through its _run_em_device with
RSEM_TPU_FUSED_MODEL unset), on the CPU, at the sizes of
tests/test_torch_em.py, for single-end with and without quals and
paired-end with quals and est-RSPD.

The JAX single-device engine is called directly (as
tests/test_model_loop.py does): the 8 virtual CPU devices of conftest.py
would otherwise route run_em to its sharded path. The JAX side runs once
per configuration (module-scoped fixture).

One difference is by design: the JAX loop sums the noise terms through a
static per-read key histogram and bf16-split matmuls, which round each
term to 2^-17 relative; the port gathers and scatters them over the noise
indices (K2/K3). The noise statistics therefore get their own tolerance."""

import copy
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rsem_tpu.engine.em import EMConfig, _run_em_device
from rsem_tpu.ops import model_loop as jml
from rsem_tpu.ops.conprb import CHUNK, _ceil_to
from rsem_tpu.ops.conprb import precompute_profile_indices_fused as jpre
from rsem_tpu.ops.layout import HitsDevice, KernelConfig, ReadsDevice
from rsem_tpu.ops.layout import RefDevice
from rsem_tpu.testing import synthetic_dataset
from rsem_tpu_torch import convert
from rsem_tpu_torch.engine import em as tem
from rsem_tpu_torch.ops import model_loop as tml
from rsem_tpu_torch.ops.conprb import precompute_profile_indices_fused
from rsem_tpu_torch.ops.layout import KernelConfig as TKernelConfig

CPU = torch.device("cpu")
CONFIGS = {
    "se_qual": dict(paired=False, has_qual=True),
    "se_noqual": dict(paired=False, has_qual=False),
    "pe_qual_rspd": dict(paired=True, has_qual=True, est_rspd=True),
}
FIXED, CONVERGED = (15, 15), (20, 10_000)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain versions run many small ops; in a test run of several
    worker processes torch's intra-op thread pool only adds contention."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_loop_inputs(ref, bundle, model):
    """The JAX device engine's set-up of the fused loop (its
    _run_em_device up to jit_build_model_loop_data)."""
    spec = model.spec
    refd = RefDevice.from_reference(ref)
    if spec.paired:
        m1 = ReadsDevice.from_arrays(bundle.reads.mate1)
        m2 = ReadsDevice.from_arrays(bundle.reads.mate2)
        quals = [bundle.reads.mate1.quals, bundle.reads.mate2.quals]
    else:
        m1, m2 = ReadsDevice.from_arrays(bundle.reads), None
        quals = [bundle.reads.quals]
    hd = HitsDevice.from_arrays(
        bundle.hits, max(_ceil_to(bundle.hits.n_hits, CHUNK), CHUNK))
    qmax = max(int(np.max(q)) for q in quals) if spec.has_qual else None
    kcfg = KernelConfig.from_model(model, m1.codes.shape[1], qmax=qmax)
    dm = {k: jnp.asarray(v, dtype=jnp.float32)
          for k, v in model.device_arrays().items()}
    pre = jpre(kcfg, refd, m1, m2, hd)
    mdata = jml.jit_build_model_loop_data(
        kcfg, refd, m1, m2, hd, pre, dm,
        jnp.asarray(bundle.hits.read_offsets, dtype=jnp.int32),
        jnp.asarray(np.asarray(model.npro.c).reshape(-1), dtype=jnp.float32),
        jnp.asarray(float(bundle.cnt.N0), dtype=jnp.float32),
        float(spec.probF))
    return kcfg, dm, mdata


@pytest.fixture(scope="module", params=list(CONFIGS))
def case(request):
    """JAX side of one configuration: its fused loop's data and one round,
    and its fused run_em with fixed rounds and to convergence."""
    os.environ.pop("RSEM_TPU_FUSED_MODEL", None)  # the JAX default: fused
    ref, bundle, _spec, model0 = synthetic_dataset(
        n_reads=1500, M=60, read_len=36, tx_len=400, mean_extra_hits=1.2,
        seed=7, **CONFIGS[request.param])
    kcfg, dm, mdata = _jax_loop_inputs(ref, bundle, model0)
    theta0 = np.random.default_rng(2).dirichlet(np.ones(ref.M + 1))
    one = jml.jit_model_loop(kcfg, mdata, jml.tables_from_model(kcfg, dm),
                             jnp.asarray(theta0, dtype=jnp.float32), 1,
                             bundle.hits.n_reads, ref.M)
    runs = {r: _run_em_device(copy.deepcopy(model0), ref, bundle,
                              EMConfig(backend="device", min_round=r[0],
                                       max_round=r[1]),
                              need_posteriors=False)
            for r in (FIXED, CONVERGED)}
    t_ref = convert.reference_from_arrays(convert.host_state(ref))
    return dict(
        name=request.param, H=bundle.hits.n_hits, N1=bundle.cnt.N1,
        mdata=mdata, theta0=theta0,
        one=(np.asarray(one[0]), {k: np.asarray(v) for k, v in
                                  one[1].items()}),
        runs=runs, t_ref=t_ref,
        t_bundle=convert.bundle_from_arrays(convert.host_state(bundle)),
        t_model=convert.model_from_arrays(convert.host_state(model0), t_ref))


def _port_loop_inputs(c):
    t_ref, t_bundle, t_model = c["t_ref"], c["t_bundle"], c["t_model"]
    spec = t_model.spec
    refd, m1, m2, hd = tem.upload(t_ref, t_bundle, spec.paired, CPU)
    kcfg = tem.kernel_config(t_model, t_bundle, int(m1.codes.shape[1]))
    pre = precompute_profile_indices_fused(kcfg, refd, m1, m2, hd)
    dm = convert.model_arrays_to_torch(t_model.device_arrays(), CPU)
    mdata = tml.build_model_loop_data(kcfg, refd, m1, m2, hd, pre, dm,
                                      t_model.npro.c, t_bundle.cnt.N0,
                                      float(spec.probF))
    return kcfg, dm, mdata


def test_fused_supported_matches_jax():
    """The gate on the 8 cases of tests/test_model_loop.py:79-101."""
    jcfg = KernelConfig(
        paired=False, has_qual=True, est_rspd=True, use_mld=False, B=20,
        seed_len=25, gld_lb=0, gld_ub=1000, mld_lb=0, mld_ub=1,
        max_read_len=36, pro_len=100)
    tcfg = TKernelConfig(**jcfg._asdict())
    cases = [
        ({}, False, None), ({}, False, 400), ({}, True, None),
        ({}, False, 10), ({"use_mld": True}, False, None),
        ({"use_mld": True, "paired": True}, False, None),
        ({"est_rspd": False, "paired": True}, True, None),
        ({"est_rspd": False}, True, None),
    ]
    got = [tml.fused_supported(tcfg._replace(**kw), polya, fl)
           for kw, polya, fl in cases]
    want = [jml.fused_supported(jcfg._replace(**kw), polya, fl)
            for kw, polya, fl in cases]
    assert got == want == [True, True, False, False, False, True, False,
                           True]


def test_loop_data_matches_jax(case):
    """Every leaf the two loops share, on the first H entries of the JAX
    package's padded arrays: identical -inf positions, floats to rtol 1e-5
    and atol 1e-4 (as tests/test_torch_conprb.py holds the conprbs:
    the est-RSPD bin weights and lp_static without its round-0 RSPD factor
    are differences of near-equal float32 values, which XLA and PyTorch
    round in another order, ~2e-5 and ~7e-5 here), integer and mask
    leaves equal."""
    _k, _d, got = _port_loop_inputs(case)
    want, H = case["mdata"], case["H"]
    n = int(got.s0.shape[0])
    names = ["lp_static", "log_mw_h", "lnp_static", "s0", "s0_hit"]
    names += [f for f in got._fields if f.startswith(("gld_", "ins_",
                                                      "rs_"))
              and getattr(got, f) is not None]
    if case["name"] == "pe_qual_rspd":
        assert "gld_num_idx" in names and "rs_b1" in names
    for f in names:
        g = getattr(got, f).numpy()
        w = np.asarray(getattr(want, f))[: n if f in ("lnp_static", "s0")
                                         else H]
        if g.dtype.kind in "biu":
            np.testing.assert_array_equal(g, w, err_msg=f)
            continue
        fin = np.isfinite(w)
        np.testing.assert_array_equal(np.isfinite(g), fin, err_msg=f)
        np.testing.assert_allclose(g[fin], w[fin], rtol=1e-5, atol=1e-4,
                                   err_msg=f)


def test_one_round_matches_jax(case):
    """One round from the same tables and theta: theta to rtol 2e-4, the
    sufficient statistics to 1e-3 of their largest entry (or of one read's
    weight, where all are below it: the noise statistics of reads that
    align are ~1e-37 here, which the JAX side flushes to 0); the noise
    statistics to 2e-3 (the JAX side's bf16 split, module docstring)."""
    kcfg, dm, mdata = _port_loop_inputs(case)
    M = case["t_ref"].M
    theta, suff = tml.run_model_loop(
        kcfg, mdata, tml.tables_from_model(kcfg, dm),
        torch.as_tensor(case["theta0"], dtype=torch.float32), 1,
        int(mdata.s0.shape[0]), M)
    w_theta, w_suff = case["one"]
    np.testing.assert_allclose(theta.numpy(), w_theta, rtol=2e-4, atol=1e-9)
    assert set(suff) == set(w_suff)
    for k, v in suff.items():
        w = w_suff[k]
        tol = 2e-3 if k == "npro" else 1e-3
        np.testing.assert_allclose(v.numpy(), w, rtol=tol,
                                   atol=tol * max(np.abs(w).max(), 1.0),
                                   err_msg=k)


def _port_run(case, rounds):
    return tem.run_em(copy.deepcopy(case["t_model"]), case["t_ref"],
                      case["t_bundle"],
                      tem.EMConfig(min_round=rounds[0], max_round=rounds[1]),
                      need_posteriors=False, device="cpu")


def test_fixed_rounds_theta(case):
    """10 fused model rounds + 5 theta rounds on both sides."""
    got, want = _port_run(case, FIXED), case["runs"][FIXED]
    assert got.rounds == want.rounds == 15
    np.testing.assert_allclose(got.theta_raw, want.theta_raw, rtol=1e-3,
                               atol=1e-8)


def test_converged_run(case):
    """Default stop rule: the same stopping round, counts and TPM, and
    the refit model tables."""
    got, want = _port_run(case, CONVERGED), case["runs"][CONVERGED]
    assert got.rounds == want.rounds
    np.testing.assert_allclose(got.counts, want.counts, rtol=1e-3, atol=1e-2)
    np.testing.assert_allclose(got.tpm, want.tpm, rtol=1e-3, atol=1e-2)
    gm, wm = got.model, want.model
    np.testing.assert_allclose(gm.pro.p, wm.pro.p, rtol=1e-3, atol=1e-7)
    np.testing.assert_allclose(gm.npro.p, wm.npro.p, rtol=1e-3, atol=1e-7)
    if gm.spec.paired:
        np.testing.assert_allclose(gm.gld.pdf, wm.gld.pdf, rtol=1e-3,
                                   atol=1e-9)
    if gm.spec.est_rspd:
        np.testing.assert_allclose(gm.rspd.pdf, wm.rspd.pdf, rtol=1e-3,
                                   atol=1e-9)


def test_rspd_term_zero_where_den_not_positive():
    """The RSPD term is zeroed where its denominator is not > 0, as the
    JAX loop does (rsem_tpu/ops/model_loop.py:360). RSEM zeroes it below
    EPSILON = 1e-300 (RSPD.h:74); in float32 the two rules pick the same
    entries, since no positive float32 lies below 1e-300. Entries (den =
    cdf[i_e] + (v_e - i_e) * pdf[i_e + 1], num likewise at fpos+1 minus
    at fpos): den 0, den 0.25, den -0.5, ok false, and den = 1e-30 with
    num twice that (term log 2)."""
    pdf = np.array([0, 1e-30, 0.5, 0.5, 0, 0], dtype=np.float32)
    cdf = np.array([0, 0, 0, 0.5, 1, 0], dtype=np.float32)
    i_f = np.array([1, 1, 1, 1, 0], dtype=np.int32)
    v_f = np.array([1, 1, 1, 1, 0], dtype=np.float32)
    i_f1 = np.array([2, 2, 2, 2, 0], dtype=np.int32)
    v_f1 = np.array([2.5, 2.5, 2.5, 2.5, 2.0], dtype=np.float32)
    i_e = np.array([1, 2, 2, 2, 0], dtype=np.int32)
    v_e = np.array([1.0, 2.5, 1.0, 2.5, 1.0], dtype=np.float32)
    ok = np.array([True, True, True, False, True])
    args = (i_f, v_f, i_f1, v_f1, i_e, v_e, ok)
    got = tml._rspd_log_term(
        torch.as_tensor(pdf), torch.as_tensor(cdf),
        *(torch.as_tensor(a).long() if a.dtype == np.int32
          else torch.as_tensor(a) for a in args)).numpy()
    want = np.asarray(jml._rspd_log_term(jnp.asarray(pdf), jnp.asarray(cdf),
                                         *(jnp.asarray(a) for a in args)))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got, [-np.inf, 0.0, -np.inf, -np.inf,
                                     np.log(2.0)], rtol=1e-5, atol=1e-5)


def test_polya_takes_per_round_path(monkeypatch):
    """A paired model with poly(A) is outside fused_supported: run_em
    takes the per-round path and never calls run_model_loop; the same
    data without poly(A) calls it once, and fused_model=False never."""
    import dataclasses

    from rsem_tpu_torch.testing import synthetic_dataset as t_synth

    ref, bundle, spec, model = t_synth(n_reads=200, M=10, read_len=30,
                                       tx_len=200, paired=True, seed=3)
    calls = []
    real = tml.run_model_loop
    monkeypatch.setattr(tml, "run_model_loop",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    polya = copy.deepcopy(model)
    polya.spec = dataclasses.replace(spec, has_polya=True)
    polya.calc_mw()
    for m, cfg, n in ((polya, tem.EMConfig(), 0), (model, tem.EMConfig(), 1),
                      (model, tem.EMConfig(fused_model=False), 1)):
        res = tem.run_em(copy.deepcopy(m), ref, bundle, cfg,
                         need_posteriors=False, device="cpu")
        assert len(calls) == n
        assert res.rounds >= 20 and np.isfinite(res.counts).all()


def _former_estep(cfg, data, lp, lnp, theta, M):
    """The fused loop's E-step statistics as its rounds computed them
    inline before the E-step statistics kernel took them over (int64
    indices, s0 gathered per hit once)."""
    rid, sid = data.rid.long(), data.sid.long()
    s0_hit = data.s0[rid]
    ltheta = tml._safe_log(theta)
    w = torch.exp((lp + ltheta[sid] - s0_hit).clamp(max=tml.MAX_DRIFT))
    w0 = torch.exp((lnp + ltheta[0] - data.s0).clamp(max=tml.MAX_DRIFT))
    denom = torch.empty(data.s0.shape[0], dtype=torch.float64)
    denom.zero_().index_add_(0, rid, w.double())
    d = denom + w0
    inv = torch.where(d > 0, 1.0 / torch.where(d > 0, d, 1.0),
                      0.0).to(torch.float32)
    frac = w * inv[rid]
    frac_noise = w0 * inv
    sizes = [M + 1, cfg.gld_ub - cfg.gld_lb if cfg.paired else 0,
             cfg.B if cfg.est_rspd else 0]
    counts, gld, rspd = torch.zeros(sum(sizes), dtype=torch.float64).split(
        sizes)
    counts.index_add_(0, sid, frac.double())
    counts[0] += frac_noise.sum(dtype=torch.float64)
    if cfg.paired:
        gld.index_add_(0, data.ins_idx.long(), frac.double())
    if cfg.est_rspd:
        rspd.index_add_(0, data.rs_b0.long(), (frac * data.rs_w0).double())
        rspd.index_add_(0, data.rs_b1.long(), (frac * data.rs_w1).double())
    return frac, frac_noise, counts, gld, rspd


ESTEP_CASES = {
    "se": dict(paired=False, est_rspd=False),
    "pe_rspd": dict(paired=True, est_rspd=True),
    "dead_read": dict(paired=True, est_rspd=True, dead=3),
    "long_read": dict(paired=False, est_rspd=True, long=5),
    "no_noise": dict(paired=True, est_rspd=False, noise=False),
}


@pytest.mark.parametrize("name", list(ESTEP_CASES))
def test_estep_stats_plain_matches_former_inline(name):
    """The E-step statistics' plain version (what the CPU runs) equals the
    loop's former inline arithmetic bit for bit: single-end without
    est-RSPD; paired with est-RSPD; a read whose hits and noise term are
    all -inf (denominator 0: inv 0, no fraction); a read of 200 hits; a
    sample without noise mass. Each read's fractions and its noise
    fraction sum to 1 where its denominator is not 0."""
    c = ESTEP_CASES[name]
    rng = np.random.default_rng(len(name))
    N, M, B, span = 40, 25, 20, 30
    nh = rng.integers(1, 5, size=N)
    if "long" in c:
        nh[c["long"]] = 200
    off = np.concatenate([[0], np.cumsum(nh)])
    H = int(off[-1])
    rid = torch.as_tensor(np.repeat(np.arange(N), nh), dtype=torch.int32)
    lp = torch.as_tensor(rng.normal(-30.0, 4.0, H), dtype=torch.float32)
    lp[torch.as_tensor(rng.random(H) < 0.1)] = float("-inf")
    lnp = torch.as_tensor(rng.normal(-34.0, 3.0, N), dtype=torch.float32)
    if not c.get("noise", True):
        lnp[:] = float("-inf")
    if "dead" in c:
        r = c["dead"]
        lp[off[r]:off[r + 1]] = float("-inf")
        lnp[r] = float("-inf")
    s0 = torch.full((N,), float("-inf")).scatter_reduce_(
        0, rid.long(), lp, "amax", include_self=True)
    s0 = torch.maximum(s0, lnp)
    s0 = torch.where(torch.isfinite(s0), s0, 0.0)
    theta = torch.as_tensor(rng.dirichlet(np.ones(M + 1)),
                            dtype=torch.float32)
    theta[7] = 0.0  # log theta -inf
    cfg = TKernelConfig(
        paired=c["paired"], has_qual=True, est_rspd=c["est_rspd"],
        use_mld=c["paired"], B=B, seed_len=25, gld_lb=0, gld_ub=span,
        mld_lb=0, mld_ub=1, max_read_len=36, pro_len=100)
    b0 = rng.integers(0, B, H)
    kw = {}
    if cfg.paired:
        kw["ins_idx"] = torch.as_tensor(rng.integers(0, span, H),
                                        dtype=torch.int32)
    if cfg.est_rspd:
        kw.update(
            rs_b0=torch.as_tensor(b0, dtype=torch.int32),
            rs_w0=torch.as_tensor(rng.random(H), dtype=torch.float32),
            rs_b1=torch.as_tensor(np.minimum(b0 + 1, B - 1),
                                  dtype=torch.int32),
            rs_w1=torch.as_tensor(np.where(rng.random(H) < 0.3,
                                           rng.random(H), 0.0),
                                  dtype=torch.float32))
    data = tml.ModelLoopData(
        lp_static=None, log_mw_h=None, lnp_static=None,
        sid=torch.as_tensor(rng.integers(1, M + 1, H), dtype=torch.int32),
        rid=rid, read_offsets=torch.as_tensor(off), s0=s0, pre=None,
        npro_c=None, n0=None, **kw)

    sizes = [M + 1, span if cfg.paired else 0, B if cfg.est_rspd else 0]
    counts, gld, rspd = torch.zeros(sum(sizes), dtype=torch.float64).split(
        sizes)
    frac, frac_noise = torch.empty(H), torch.empty(N)
    tml.estep_stats(cfg, data, lp, lnp, theta, counts, gld, rspd, frac,
                    frac_noise)
    want = _former_estep(cfg, data, lp, lnp, theta, M)
    for what, g, w in zip(("frac", "frac_noise", "counts", "gld", "rspd"),
                          (frac, frac_noise, counts, gld, rspd), want):
        assert torch.equal(g, w), what

    per_read = torch.zeros(N, dtype=torch.float64).index_add_(
        0, rid.long(), frac.double()) + frac_noise.double()
    # a read's denominator is 0 where no term of it is finite
    hit_ok = torch.isfinite(lp) & (theta[data.sid.long()] > 0)
    live = torch.isfinite(lnp) | torch.zeros(N, dtype=torch.bool).index_add_(
        0, rid, hit_ok)
    if "dead" in c:
        r = c["dead"]
        assert not live[r] and per_read[r] == 0
        assert not frac[off[r]:off[r + 1]].any()
    assert torch.equal(per_read == 0, ~live)
    torch.testing.assert_close(per_read[live],
                               torch.ones(int(live.sum()),
                                          dtype=torch.float64),
                               rtol=0, atol=1e-6)
    if not c.get("noise", True):
        assert not frac_noise.any() and counts[0] == 0
    assert float(counts.sum()) == pytest.approx(float(live.sum()), abs=1e-5)
