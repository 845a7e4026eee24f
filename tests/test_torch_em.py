"""The port's run_em(device="cpu") against the JAX package's device EM on
the same synthetic dataset, model rounds on the per-round path on both
sides: EMConfig(fused_model=False) here, RSEM_TPU_FUSED_MODEL=0 there (the
fused loop, both sides' default, is held in tests/test_torch_model_loop.py).

The JAX single-device engine is called directly (as tests/test_model_loop.py
does): the 8 virtual CPU devices of conftest.py would otherwise route
run_em to its sharded path. Its theta loop still shards over those
devices, which computes the same round."""

import copy

import numpy as np
import pytest
import torch

from rsem_tpu.engine.em import EMConfig, _run_em_device
from rsem_tpu.testing import synthetic_dataset
from rsem_tpu_torch import convert
from rsem_tpu_torch.engine import em as tem


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain versions run many small ops; in a test run of several
    worker processes torch's intra-op thread pool only adds contention."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _run_both(monkeypatch, paired, min_round, max_round):
    ref, bundle, _spec, model0 = synthetic_dataset(
        n_reads=1500, M=60, read_len=36, tx_len=400, paired=paired,
        has_qual=True, mean_extra_hits=1.2, seed=7,
    )
    t_ref = convert.reference_from_arrays(convert.host_state(ref))
    t_bundle = convert.bundle_from_arrays(convert.host_state(bundle))
    t_model = convert.model_from_arrays(convert.host_state(model0), t_ref)
    monkeypatch.setenv("RSEM_TPU_FUSED_MODEL", "0")
    want = _run_em_device(
        copy.deepcopy(model0), ref, bundle,
        EMConfig(backend="device", min_round=min_round, max_round=max_round),
        need_posteriors=True)
    got = tem.run_em(
        t_model, t_ref, t_bundle,
        tem.EMConfig(min_round=min_round, max_round=max_round,
                     fused_model=False),
        need_posteriors=True, device="cpu")
    return want, got


@pytest.mark.parametrize("paired", [False, True])
def test_fixed_rounds_theta(monkeypatch, paired):
    """10 model rounds + 5 theta rounds on both sides: the same round count
    by construction, so theta is compared tightly (f32 device rounds on
    the JAX side, f64 sums here)."""
    want, got = _run_both(monkeypatch, paired, 15, 15)
    assert got.rounds == want.rounds == 15
    np.testing.assert_allclose(got.theta_raw, want.theta_raw, rtol=2e-4,
                               atol=1e-8)
    np.testing.assert_allclose(got.frac_hit, want.frac_hit, rtol=5e-4,
                               atol=1e-6)
    np.testing.assert_allclose(got.frac_noise, want.frac_noise, rtol=5e-4,
                               atol=1e-6)


@pytest.mark.parametrize("paired", [False, True])
def test_converged_run(monkeypatch, paired):
    """Default stop rule: same stopping round, counts, TPM and refit
    model."""
    want, got = _run_both(monkeypatch, paired, 20, 10_000)
    assert got.rounds == want.rounds
    np.testing.assert_allclose(got.counts, want.counts, rtol=1e-3,
                               atol=1e-2)
    np.testing.assert_allclose(got.tpm, want.tpm, rtol=1e-3, atol=1e-2)
    np.testing.assert_allclose(got.counts.sum(), want.counts.sum(),
                               rtol=1e-6)
    gm, wm = got.model, want.model
    np.testing.assert_allclose(gm.pro.p, wm.pro.p, rtol=1e-4, atol=1e-7)
    np.testing.assert_allclose(gm.npro.p, wm.npro.p, rtol=1e-4, atol=1e-7)
    np.testing.assert_allclose(gm.mw, wm.mw, rtol=1e-9)
    if paired:
        np.testing.assert_allclose(gm.gld.pdf, wm.gld.pdf, rtol=1e-4,
                                   atol=1e-9)
