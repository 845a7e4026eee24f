"""The port's C++ host sidecar (rsem_tpu_torch/native) and the hybrid and
native EM backends, against the JAX package's (rsem_tpu/native,
rsem_tpu.engine.em._run_em_hybrid), on the CPU, for single-end with and
without quals and paired-end with quals and est-RSPD.

The sidecars compile the same arithmetic, so at one thread count their
outputs are equal bit for bit. The native backends run the same host
loops (counts to rtol 1e-12); the hybrid backends differ in their theta
loop (the JAX package's sharded float32 loop against the port's, with
float64 sums)."""

import copy
import time

import numpy as np
import pytest
import torch

from rsem_tpu import native as jnative
from rsem_tpu.engine.em import EMConfig, _run_em_hybrid
from rsem_tpu.testing import synthetic_dataset
from rsem_tpu_torch import convert
from rsem_tpu_torch import native as tnative
from rsem_tpu_torch.engine import em as tem

CONFIGS = {
    "se_qual": dict(paired=False, has_qual=True),
    "se_noqual": dict(paired=False, has_qual=False),
    "pe_qual_rspd": dict(paired=True, has_qual=True, est_rspd=True),
}
THREADS = 3


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain versions run many small ops; in a test run of several
    worker processes torch's intra-op thread pool only adds contention."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def libs():
    """Both sidecars, built once for the module. The JAX package rebuilds
    its library beside its source when a checkout leaves it older than the
    source, and another test worker may be half way through that build
    when this one loads it: then its loader gives up for the process, so
    ask it again after a pause."""
    for _ in range(5):
        if jnative.get_lib() is not None:
            break
        jnative._tried = False
        time.sleep(2.0)
    assert jnative.get_lib() is not None
    return tnative.lib()


@pytest.fixture(scope="module", params=list(CONFIGS))
def case(request, libs):
    ref, bundle, _spec, model = synthetic_dataset(
        n_reads=1500, M=60, read_len=36, tx_len=400, mean_extra_hits=1.2,
        seed=7, **CONFIGS[request.param])
    t_ref = convert.reference_from_arrays(convert.host_state(ref))
    return dict(
        ref=ref, bundle=bundle, model=model, t_ref=t_ref,
        t_bundle=convert.bundle_from_arrays(convert.host_state(bundle)),
        t_model=convert.model_from_arrays(convert.host_state(model), t_ref))


def test_sidecar_bit_equal(case):
    """native_conprb, native_em_count_step and native_suffstats of the port
    equal the JAX package's bit for bit at the same thread count."""
    ref, bundle, model = case["ref"], case["bundle"], case["model"]
    t_ref, t_bundle, t_model = case["t_ref"], case["t_bundle"], case["t_model"]
    M = ref.M
    want = jnative.native_conprb(bundle.hits, bundle.reads, ref, model,
                                 n_threads=THREADS)
    got = tnative.native_conprb(t_bundle.hits, t_bundle.reads, t_ref, t_model,
                                n_threads=THREADS)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert np.isfinite(got[0]).all() and (got[0] > 0).any()
    theta = np.random.default_rng(1).dirichlet(np.ones(M + 1))
    want = jnative.native_em_count_step(bundle.hits, *want, theta, M,
                                        n_threads=THREADS)
    got = tnative.native_em_count_step(t_bundle.hits, *got, theta, M,
                                       n_threads=THREADS)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    fh, fn = (x.astype(np.float32) for x in got[:2])
    want = jnative.native_suffstats(bundle.hits, fh, fn, bundle.reads, ref,
                                    model, n_threads=THREADS)
    got = tnative.native_suffstats(t_bundle.hits, fh, fn, t_bundle.reads,
                                   t_ref, t_model, n_threads=THREADS)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("backend", ["native", "hybrid"])
def test_backend_matches_jax(case, backend):
    """run_em(backend=...) on the CPU against the JAX package's
    _run_em_hybrid (theta_backend "native" for the native backend): the
    same stopping round; counts to rtol 1e-12 (native) or rtol 1e-3, atol
    1e-2 (hybrid); counts sum to N1 + N0."""
    want = _run_em_hybrid(
        copy.deepcopy(case["model"]), case["ref"], case["bundle"],
        EMConfig(backend=backend,
                 theta_backend="native" if backend == "native" else "device"),
        need_posteriors=False)
    got = tem.run_em(copy.deepcopy(case["t_model"]), case["t_ref"],
                     case["t_bundle"], tem.EMConfig(backend=backend),
                     need_posteriors=True, device="cpu")
    assert got.rounds == want.rounds
    if backend == "native":
        np.testing.assert_allclose(got.counts, want.counts, rtol=1e-12)
    else:
        np.testing.assert_allclose(got.counts, want.counts, rtol=1e-3,
                                   atol=1e-2)
    cnt = case["bundle"].cnt
    np.testing.assert_allclose(got.counts.sum(), cnt.N1 + cnt.N0, rtol=1e-9)
    assert got.frac_hit.shape == (cnt.n_hits,)


def test_build_goes_to_build_dir_and_needs_gxx(libs, tmp_path, monkeypatch):
    """The library lies under rsem_tpu_torch/_build/, keyed by a hash of
    the source; nothing is written beside the source. Without g++ an
    explicit hybrid or native backend raises."""
    path = tnative.library_path()
    assert path.exists() and path.parent.parent == tnative.BUILD_ROOT
    assert sorted(p.name for p in tnative.SRC.parent.iterdir()
                  if not p.name.startswith("__pycache__")) == [
        "__init__.py", "bamparse.cpp", "bamparse.py", "suffstats.cpp"]
    ref, bundle, _spec, model = synthetic_dataset(
        n_reads=50, M=5, read_len=30, tx_len=200, seed=1)
    t_ref = convert.reference_from_arrays(convert.host_state(ref))
    t_bundle = convert.bundle_from_arrays(convert.host_state(bundle))
    t_model = convert.model_from_arrays(convert.host_state(model), t_ref)
    monkeypatch.setattr(tnative, "_lib", None)
    monkeypatch.setattr(tnative, "BUILD_ROOT", tmp_path)
    monkeypatch.setattr(tnative.shutil, "which", lambda _name: None)
    for backend in ("hybrid", "native"):
        with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
            tem.run_em(copy.deepcopy(t_model), t_ref, t_bundle,
                       tem.EMConfig(backend=backend), device="cpu")
    assert not any(tmp_path.iterdir())
