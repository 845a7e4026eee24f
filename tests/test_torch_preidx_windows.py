"""Windowed PreIdx (rsem_tpu_torch/ops/conprb.py plan_windows, the window
loop of engine/em.py) on the CPU: the window plan; the windowed E-step of
a window that starts mid-array; run_em with a PreIdx budget that forces
>= 3 windows against the port's unwindowed per-round run on the SE and PE
goldens and a small synthetic set (same rounds; theta, counts, frac_hit
and the refit pro.p / npro.p within rtol 1e-5); and against the JAX
package with RSEM_TPU_PREIDX_BUDGET=0 (its path without PreIdx) at the
tolerances of tests/test_torch_em.py::test_fixed_rounds_theta."""

import copy
import gzip
import os
import shutil

import numpy as np
import pytest
import torch

from rsem_tpu.engine.em import EMConfig as JEMConfig
from rsem_tpu.engine.em import _run_em_device
from rsem_tpu.io.sam import parse_alignments as jparse
from rsem_tpu.model.generative import GenerativeModel as JModel
from rsem_tpu.model.spec import ModelSpec as JSpec
from rsem_tpu.refprep.reference import Reference as JReference
from rsem_tpu_torch.engine import em
from rsem_tpu_torch.io.sam import parse_alignments
from rsem_tpu_torch.model.generative import GenerativeModel
from rsem_tpu_torch.model.spec import ModelSpec
from rsem_tpu_torch.ops import conprb, estep, model_loop
from rsem_tpu_torch.ops.layout import HitsDevice, KernelConfig
from rsem_tpu_torch.refprep.reference import Reference
from rsem_tpu_torch.refprep.transcripts import Transcripts
from rsem_tpu_torch.testing import synthetic_dataset

GOLD = os.path.join(os.path.dirname(__file__), "goldens")
CPU = torch.device("cpu")
# sam, read type, extra ModelSpec arguments (calculate-expression's flags)
GOLDENS = {
    "aln": ("aln", 1, {}),
    "aln_pe": ("aln_pe", 3, {"est_rspd": True}),
    "aln_se0": ("aln_se0", 0, {"mean": 210.0, "sd": 60.0}),
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain versions run many small ops; in a test run of several
    worker processes torch's intra-op thread pool only adds contention."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _spec_args(read_type, has_polya, extra):
    """calculate-expression's ModelSpec at its defaults."""
    args = dict(model_type=read_type, est_rspd=False, B=20, minL=1,
                maxL=1000, mate_minL=1, mate_maxL=1000, mean=-1.0, sd=0.0,
                probF=0.5, seed_len=25, has_polya=has_polya)
    args.update(extra)
    return args


def _golden(name, tmp_path_factory, jax_side=False):
    """(ref, bundle, initialised model) of a golden SAM, from the port's
    modules or, with jax_side, from the JAX package's."""
    sam, read_type, extra = GOLDENS[name]
    d = tmp_path_factory.mktemp(f"win_{sam}")
    with gzip.open(f"{GOLD}/{sam}.sam.gz", "rb") as fi, \
            open(d / "in.sam", "wb") as fo:
        shutil.copyfileobj(fi, fo)
    names = [""] + [t.transcript_id for t in
                    Transcripts.read_ti(f"{GOLD}/ref.ti").transcripts]
    R, parse, Spec, Model = ((JReference, jparse, JSpec, JModel) if jax_side
                             else (Reference, parse_alignments, ModelSpec,
                                   GenerativeModel))
    ref = R.load_seq(f"{GOLD}/ref.seq")
    bundle = parse(str(d / "in.sam"), names, read_type, ref.has_polya, 25)
    model = Model(Spec(**_spec_args(read_type, ref.has_polya, extra)), ref)
    model.estimate_from_stats(bundle.stats)
    return ref, bundle, model


def _kcfg(bundle, model):
    if model.spec.paired:
        L = max(bundle.reads.mate1.codes.shape[1],
                bundle.reads.mate2.codes.shape[1])
    else:
        L = bundle.reads.codes.shape[1]
    return em.kernel_config(model, bundle, L)


def _budget(bundle, model, parts):
    """A PreIdx budget that cuts the run into >= `parts` windows."""
    kcfg = _kcfg(bundle, model)
    return conprb.preidx_bytes(kcfg, bundle.hits.n_hits,
                               bundle.hits.n_reads) // parts


# --------------------------------------------------------------------- #
# the window plan                                                        #
# --------------------------------------------------------------------- #
def _cfg(paired=False, L=36):
    return KernelConfig(paired=paired, has_qual=True, est_rspd=False,
                        use_mld=False, B=20, seed_len=25, gld_lb=0,
                        gld_ub=1000, mld_lb=0, mld_ub=1, max_read_len=L,
                        pro_len=100)


def _offsets(nh):
    return np.concatenate([[0], np.cumsum(nh)]).astype(np.int64)


def _check_plan(windows, off, row, budget):
    """Windows tile the reads in order, cut at read boundaries, with the
    hit ranges of the CSR; each is under the budget unless it is one
    read."""
    assert windows[0].r0 == 0 and windows[-1].r1 == len(off) - 1
    for a, b in zip(windows, windows[1:]):
        assert a.r1 == b.r0
    for w in windows:
        assert w.r1 > w.r0
        assert (w.h0, w.h1) == (off[w.r0], off[w.r1])
        size = (w.h1 - w.h0 + w.r1 - w.r0) * row
        assert size <= budget or w.r1 - w.r0 == 1


@pytest.mark.parametrize("paired", [False, True])
@pytest.mark.parametrize("parts", [2, 3, 7, 50])
def test_plan_cuts_at_read_boundaries_under_budget(paired, parts):
    cfg = _cfg(paired)
    off = _offsets(np.random.default_rng(parts).integers(1, 9, size=400))
    row = conprb.preidx_row_bytes(cfg)
    total = conprb.preidx_bytes(cfg, int(off[-1]), len(off) - 1)
    budget = total // parts
    windows = conprb.plan_windows(cfg, off, budget)
    assert len(windows) >= parts
    _check_plan(windows, off, row, budget)


def test_plan_oversized_read_gets_its_own_window():
    cfg = _cfg()
    off = _offsets([1, 2, 60, 1, 3, 1])
    row = conprb.preidx_row_bytes(cfg)
    budget = 10 * row
    windows = conprb.plan_windows(cfg, off, budget)
    _check_plan(windows, off, row, budget)
    assert conprb.Window(2, 3, 3, 63) in windows
    # a zero budget: one window per read, never an error
    zero = conprb.plan_windows(cfg, off, 0)
    assert [(w.r0, w.r1) for w in zero] == [(i, i + 1) for i in range(6)]


def test_plan_one_window_without_a_budget_on_cpu():
    cfg = _cfg()
    off = _offsets([3, 1, 2])
    assert em.preidx_budget(em.EMConfig(), cfg, CPU, 6) is None
    assert conprb.plan_windows(cfg, off, None) == [conprb.Window(0, 3, 0, 6)]
    total = conprb.preidx_bytes(cfg, 6, 3)
    assert conprb.plan_windows(cfg, off, total) == [
        conprb.Window(0, 3, 0, 6)]
    assert em.preidx_budget(em.EMConfig(preidx_budget=123), cfg, CPU,
                            6) == 123


def test_window_views_are_contiguous_and_keep_global_rids():
    """K4 takes a window's hits as 1-D views (no copy): they must pass its
    contiguity test and keep the global read ids."""
    off = _offsets([2, 1, 3, 2])
    H = int(off[-1])
    rid = np.repeat(np.arange(4), np.diff(off)).astype(np.int32)
    hd = HitsDevice(rid=torch.as_tensor(rid),
                    sid=torch.arange(1, H + 1, dtype=torch.int32),
                    dir=torch.zeros(H, dtype=torch.int32),
                    pos=torch.arange(H, dtype=torch.int32),
                    insert_len=torch.ones(H, dtype=torch.int32),
                    read_offsets=torch.as_tensor(off))
    w = conprb.Window(1, 3, 2, 6)
    hw = conprb.hits_window(hd, w)
    for t in (hw.rid, hw.sid, hw.dir, hw.pos, hw.insert_len):
        assert t.is_contiguous()
        assert t.data_ptr() == t._base.data_ptr() + 2 * 4
    assert hw.rid.tolist() == [1, 2, 2, 2]
    assert hw.n_reads == 2 and hw.n_hits == 4


def test_noise_indices_in_chunks(monkeypatch):
    """The noise-index build, a few reads at a time, equals one step over
    all reads (ragged lengths, with and without quals)."""
    from rsem_tpu_torch.ops.layout import ReadsDevice

    rng = np.random.default_rng(6)
    N, L = 23, 36
    mate = ReadsDevice(
        codes=torch.as_tensor(rng.integers(0, 5, (N, L)), dtype=torch.uint8),
        lens=torch.as_tensor(rng.integers(20, L + 1, N), dtype=torch.int32),
        quals=torch.as_tensor(rng.integers(2, 41, (N, L)),
                              dtype=torch.uint8),
        lq=torch.zeros(N, dtype=torch.bool))
    for has_qual in (True, False):
        cfg = _cfg()._replace(has_qual=has_qual,
                              npro_key_size=205 if has_qual else 0)
        whole = conprb.noise_flat(cfg, mate)
        monkeypatch.setattr(conprb, "NOISE_CHUNK", 5)
        assert torch.equal(conprb.noise_flat(cfg, mate), whole)
        monkeypatch.undo()
        j = torch.arange(whole.shape[1])[None, :]
        assert bool((whole[j.expand_as(whole) >= mate.lens[:, None]]
                     == cfg.npro_keys()).all())


def test_estep_window_mid_array_matches_full_estep():
    """A window that starts mid-array: its rids are rebased to its first
    read; its fractions are the full E-step's slices and its counts the
    window's share."""
    rng = np.random.default_rng(4)
    nh = rng.integers(1, 5, size=60)
    off = _offsets(nh)
    H, N, M = int(off[-1]), 60, 12
    rid = torch.as_tensor(np.repeat(np.arange(N), nh).astype(np.int32))
    sid = torch.as_tensor(rng.integers(1, M + 1, size=H).astype(np.int32))
    hd = HitsDevice(rid=rid, sid=sid, dir=torch.zeros_like(sid),
                    pos=torch.zeros_like(sid), insert_len=None,
                    read_offsets=torch.as_tensor(off))
    lcp = torch.as_tensor(rng.normal(-5.0, 2.0, H), dtype=torch.float32)
    lcp[::7] = float("-inf")
    lnp = torch.as_tensor(rng.normal(-6.0, 2.0, N), dtype=torch.float32)
    log_theta = torch.log(torch.as_tensor(
        rng.dirichlet(np.ones(M + 1)), dtype=torch.float32))
    full = estep.estep_fracs(log_theta, sid.long(), rid.long(), lcp, lnp, N,
                             M)
    w = conprb.Window(17, 41, int(off[17]), int(off[41]))
    out = estep.estep_window(log_theta, conprb.hits_window(hd, w), w,
                             lcp[w.h0:w.h1], lnp[w.r0:w.r1], M)
    torch.testing.assert_close(out.frac_hit, full.frac_hit[w.h0:w.h1],
                               rtol=0, atol=0)
    torch.testing.assert_close(out.frac_noise, full.frac_noise[w.r0:w.r1],
                               rtol=0, atol=0)
    want = torch.zeros(M + 1).index_add_(0, sid[w.h0:w.h1].long(),
                                         full.frac_hit[w.h0:w.h1])
    want[0] += full.frac_noise[w.r0:w.r1].sum()
    torch.testing.assert_close(out.counts, want, rtol=1e-6, atol=1e-6)


# --------------------------------------------------------------------- #
# run_em windowed against unwindowed                                     #
# --------------------------------------------------------------------- #
@pytest.fixture(scope="module", params=["aln", "aln_pe", "synthetic"])
def runs(request, tmp_path_factory):
    """The port's unwindowed per-round run and its run with PreIdx cut into
    >= 3 windows (the fused loop made to raise, so the run shows it was
    not taken), both with posteriors."""
    if request.param == "synthetic":
        ref, bundle, _spec, model0 = synthetic_dataset(
            n_reads=1500, M=60, read_len=36, tx_len=400, paired=True,
            has_qual=True, mean_extra_hits=1.2, seed=7)
    else:
        ref, bundle, model0 = _golden(request.param, tmp_path_factory)
    whole = em.run_em(copy.deepcopy(model0), ref, bundle,
                      em.EMConfig(fused_model=False), need_posteriors=True,
                      device=CPU)

    def refuse(*_a, **_k):
        raise AssertionError("the fused loop ran on a windowed PreIdx")

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(model_loop, "run_model_loop", refuse)
        windowed = em.run_em(
            copy.deepcopy(model0), ref, bundle,
            em.EMConfig(preidx_budget=_budget(bundle, model0, 3)),
            need_posteriors=True, device=CPU)
    return whole, windowed


def test_windowed_run_matches_unwindowed(runs):
    whole, windowed = runs
    assert whole.windows == 1 and windowed.windows >= 3
    assert windowed.rounds == whole.rounds
    for name in ("theta_raw", "counts", "frac_hit"):
        np.testing.assert_allclose(getattr(windowed, name),
                                   getattr(whole, name), rtol=1e-5,
                                   atol=1e-12, err_msg=name)
    np.testing.assert_allclose(windowed.model.pro.p, whole.model.pro.p,
                               rtol=1e-5, atol=1e-12)
    np.testing.assert_allclose(windowed.model.npro.p, whole.model.npro.p,
                               rtol=1e-5, atol=1e-12)


def test_windowed_posterior_outputs_match(runs):
    """need_posteriors: the final conprbs (written window by window) and
    the final fractions."""
    whole, windowed = runs
    for name in ("log_conprb", "log_ncp"):
        a, b = getattr(windowed, name), getattr(whole, name)
        assert a.shape == b.shape
        np.testing.assert_array_equal(np.isfinite(a), np.isfinite(b))
        fin = np.isfinite(b)
        np.testing.assert_allclose(a[fin], b[fin], rtol=1e-5, atol=1e-5,
                                   err_msg=name)
    np.testing.assert_allclose(windowed.frac_noise, whole.frac_noise,
                               rtol=1e-5, atol=1e-12)


def test_fused_default_takes_a_whole_preidx():
    """Without a budget on the CPU there is one window and the default EM
    takes the fused loop."""
    ref, bundle, _spec, model0 = synthetic_dataset(
        n_reads=300, M=20, read_len=36, tx_len=300, has_qual=True, seed=3)
    calls = []
    loop = model_loop.run_model_loop

    def counted(*a, **k):
        calls.append(1)
        return loop(*a, **k)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(model_loop, "run_model_loop", counted)
        res = em.run_em(copy.deepcopy(model0), ref, bundle, em.EMConfig(),
                        need_posteriors=False, device=CPU)
    assert res.windows == 1 and calls == [1]


def test_windowed_matches_jax_without_preidx(monkeypatch, tmp_path_factory):
    """The JAX package's path without PreIdx (RSEM_TPU_PREIDX_BUDGET=0: the
    reference walk in every round) against the port's windowed run, on
    the smallest golden, 10 model rounds + 5 theta rounds on both sides,
    at the tolerances of tests/test_torch_em.py::test_fixed_rounds_theta."""
    monkeypatch.setenv("RSEM_TPU_PREIDX_BUDGET", "0")
    jref, jbundle, jmodel = _golden("aln_se0", tmp_path_factory,
                                    jax_side=True)
    want = _run_em_device(jmodel, jref, jbundle,
                          JEMConfig(backend="device", min_round=15,
                                    max_round=15), need_posteriors=True)
    ref, bundle, model = _golden("aln_se0", tmp_path_factory)
    got = em.run_em(model, ref, bundle,
                    em.EMConfig(min_round=15, max_round=15,
                                preidx_budget=_budget(bundle, model, 3)),
                    need_posteriors=True, device=CPU)
    assert got.windows >= 3
    assert got.rounds == want.rounds == 15
    np.testing.assert_allclose(got.theta_raw, want.theta_raw, rtol=2e-4,
                               atol=1e-8)
    np.testing.assert_allclose(got.frac_hit, want.frac_hit, rtol=5e-4,
                               atol=1e-6)
    np.testing.assert_allclose(got.frac_noise, want.frac_noise, rtol=5e-4,
                               atol=1e-6)
