"""conprbs and sufficient statistics of the port against the JAX package,
on the same synthetic data (rsem_tpu.testing.synthetic_arrays_fast) carried
across with rsem_tpu_torch.convert, for single/paired x qual/no-qual.

Both sides use PreIdx (frozen profile-table indices). Paired cases also
turn on est-RSPD in the kernel config, so the RSPD lookups and the RSPD
sufficient statistic are covered."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rsem_tpu.ops import (
    HitsDevice,
    KernelConfig,
    ReadsDevice,
    RefDevice,
    compute_log_conprb,
    compute_log_noise_conprb,
)
from rsem_tpu.ops.conprb import precompute_profile_indices_fused
from rsem_tpu.ops.estep import estep_fracs, suffstats
from rsem_tpu.testing import synthetic_arrays_fast
from rsem_tpu_torch import convert
from rsem_tpu_torch.engine import em as tem
from rsem_tpu_torch.ops import conprb as tconprb
from rsem_tpu_torch.ops import estep as testep
from rsem_tpu_torch.ops.layout import KernelConfig as TKernelConfig

CPU = torch.device("cpu")
CASES = [(False, True), (False, False), (True, True), (True, False)]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain versions run many small ops; in a test run of several
    worker processes torch's intra-op thread pool only adds contention."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def cases():
    """Each configuration's two sides and JAX conprbs, built once per
    module (_both) and shared by its four tests."""
    return {}


def _both(cases, paired, has_qual):
    if (paired, has_qual) not in cases:
        cases[paired, has_qual] = _build_both(paired, has_qual)
    return cases[paired, has_qual]


def _build_both(paired, has_qual):
    """(bundle, spec, JAX side, port side, JAX log conprb, JAX log noise
    conprb)."""
    ref, bundle, spec, model = synthetic_arrays_fast(
        n_reads=400, M=60, read_len=36, tx_len=400, paired=paired,
        has_qual=has_qual, mean_extra_hits=1.0, seed=3,
    )
    # JAX side
    refd = RefDevice.from_reference(ref)
    if paired:
        m1 = ReadsDevice.from_arrays(bundle.reads.mate1)
        m2 = ReadsDevice.from_arrays(bundle.reads.mate2)
    else:
        m1, m2 = ReadsDevice.from_arrays(bundle.reads), None
    hd = HitsDevice.from_arrays(bundle.hits)
    L = m1.codes.shape[1]
    kcfg = KernelConfig.from_model(model, L)._replace(est_rspd=paired)
    dm = {k: jnp.asarray(v, dtype=jnp.float32)
          for k, v in model.device_arrays().items()}
    pre = precompute_profile_indices_fused(kcfg, refd, m1, m2, hd)
    jax_side = (kcfg, refd, m1, m2, hd, dm, pre)
    # port side, carried across as plain numpy state
    t_ref = convert.reference_from_arrays(convert.host_state(ref))
    t_bundle = convert.bundle_from_arrays(convert.host_state(bundle))
    t_model = convert.model_from_arrays(convert.host_state(model), t_ref)
    trefd, tm1, tm2, thd = tem.upload(t_ref, t_bundle, paired, CPU)
    tkcfg = TKernelConfig.from_model(t_model, L)._replace(est_rspd=paired)
    tdm = convert.model_arrays_to_torch(t_model.device_arrays(), CPU)
    tpre = tconprb.precompute_profile_indices_fused(tkcfg, trefd, tm1, tm2,
                                                    thd)
    torch_side = (tkcfg, trefd, tm1, tm2, thd, tdm, tpre)
    lcp = compute_log_conprb(kcfg, refd, m1, m2, hd, dm, pre=pre)
    lnp = compute_log_noise_conprb(kcfg, m1, m2, dm, pre=pre)
    return bundle, spec, jax_side, torch_side, lcp, lnp


def _assert_logp(got, want):
    want = np.asarray(want)
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want))
    fin = np.isfinite(want)
    # float32 sums of ~36-72 per-position log-probs taken in another order
    # (the TPU package's CPU gather also rescales by 1/8 and re-adds)
    np.testing.assert_allclose(got[fin], want[fin], rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("paired,has_qual", CASES)
def test_log_conprb_matches(cases, paired, has_qual):
    bundle, _spec, _jax, (tk, tr, ta, tb, th, tdm, tpre), want, _lnp = \
        _both(cases, paired, has_qual)
    got = tconprb.compute_log_conprb(tk, tr, ta, tb, th, tdm, tpre)
    _assert_logp(got.numpy(), np.asarray(want)[: bundle.hits.n_hits])


@pytest.mark.parametrize("paired,has_qual", CASES)
def test_log_noise_conprb_matches(cases, paired, has_qual):
    bundle, _spec, _jax, (tk, _tr, ta, tb, _th, tdm, tpre), _lcp, want = \
        _both(cases, paired, has_qual)
    got = tconprb.compute_log_noise_conprb(tk, ta, tb, tdm, tpre)
    _assert_logp(got.numpy(), np.asarray(want)[: bundle.hits.n_reads])


@pytest.mark.parametrize("paired,has_qual", CASES)
def test_suffstats_match(cases, paired, has_qual):
    bundle, spec, (k, r, a, b, h, dm, pre), (tk, tr, ta, tb, th, tdm,
                                             tpre), lcp, lnp = _both(
        cases, paired, has_qual)
    # one E-step on the JAX side gives the posteriors both sides scatter
    n_reads, M = bundle.hits.n_reads, int(r.full_len.shape[0]) - 1
    lt = jnp.full((M + 1,), -np.log(M + 1), jnp.float32)
    out = estep_fracs(lt, h.sid, h.rid, lcp, lnp, n_reads, M)
    want = suffstats(k, r, a, b, h, out.frac_hit, out.frac_noise, dm,
                     float(spec.probF), pre=pre)
    fh = torch.tensor(np.asarray(out.frac_hit)[: bundle.hits.n_hits])
    fn = torch.tensor(np.asarray(out.frac_noise)[:n_reads])
    got = testep.suffstats(tk, tr, ta, tb, th, fh, fn, float(spec.probF),
                           tpre)
    assert set(got) == set(want)
    for key in want:
        # the TPU package scatters with f32 one-hot products; the port's
        # plain scatter sums in f64
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   rtol=2e-5, atol=1e-4, err_msg=key)


@pytest.mark.parametrize("paired,has_qual", CASES)
def test_estep_fracs_match(cases, paired, has_qual):
    bundle, _spec, (_k, r, _a, _b, h, _dm, _pre), (_tk, _tr, _ta, _tb, th,
                                                   _tdm, _tpre), lcp, lnp = \
        _both(cases, paired, has_qual)
    n_reads, M = bundle.hits.n_reads, int(r.full_len.shape[0]) - 1
    H = bundle.hits.n_hits
    rng = np.random.default_rng(4)
    lt = np.log(rng.dirichlet(np.ones(M + 1))).astype(np.float32)
    want = estep_fracs(jnp.asarray(lt), h.sid, h.rid, lcp, lnp, n_reads, M)
    got = testep.estep_fracs(
        torch.tensor(lt), th.sid.long(), th.rid.long(),
        torch.tensor(np.asarray(lcp)[:H]),
        torch.tensor(np.asarray(lnp)[:n_reads]), n_reads, M)
    np.testing.assert_allclose(got.frac_hit.numpy(),
                               np.asarray(want.frac_hit)[:H], rtol=1e-5,
                               atol=1e-7)
    np.testing.assert_allclose(got.frac_noise.numpy(),
                               np.asarray(want.frac_noise), rtol=1e-5,
                               atol=1e-7)
    np.testing.assert_allclose(got.counts.numpy(), np.asarray(want.counts),
                               rtol=1e-5, atol=1e-5)
