"""The port's segmented theta loop (K1 rounds enqueued SEGMENT at a time,
one host read of the stop counts per segment) against the JAX package's
on-device while_loop (rsem_tpu.ops.fast_estep.run_fast_em_loop), on the
CPU, where each round is K1's plain version: same stop round, same theta
(the tolerance of tests/test_torch_kernels.py), for segment lengths 1, 4
and 16 and at the edges of the rule."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rsem_tpu.io.hits import HitArrays
from rsem_tpu.ops.fast_estep import build_fast_data, run_fast_em_loop
from rsem_tpu_torch.constants import STOP_CRITERIA, THETA_CUT
from rsem_tpu_torch.ops import theta as ttheta
from rsem_tpu_torch.ops.layout import HitsDevice

CPU = torch.device("cpu")
N, M, N0 = 200, 20, 3.0


@functools.lru_cache(maxsize=None)
@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain versions run many small ops; in a test run of several
    worker processes torch's intra-op thread pool only adds contention."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _case():
    rng = np.random.default_rng(2)
    nh = np.minimum(rng.geometric(0.25, size=N) + (rng.random(N) < 0.02)
                    * rng.integers(100, 200, size=N), 200).astype(np.int64)
    H = int(nh.sum())
    offsets = np.zeros(N + 1, dtype=np.int64)
    np.cumsum(nh, out=offsets[1:])
    hits = HitArrays(
        rid=np.repeat(np.arange(N, dtype=np.int32), nh),
        sid=rng.integers(1, M + 1, size=H).astype(np.int32),
        dir=np.zeros(H, dtype=np.int8), pos=np.zeros(H, dtype=np.int32),
        insert_len=None, read_offsets=offsets)
    lcp = np.log(rng.random(H) * 0.9 + 0.1) - 20.0
    lnp = np.log(rng.random(N) * 0.5 + 0.01) - 25.0
    lnp[::97] = -np.inf
    return hits, lcp, lnp


def _data():
    hits, lcp, lnp = _case()
    return ttheta.scale_conprbs(HitsDevice.from_arrays(hits, CPU),
                                torch.as_tensor(lcp), torch.as_tensor(lnp),
                                M, N0)


def _theta0():
    return np.full(M + 1, 1.0 / (M + 1), dtype=np.float32)


@functools.lru_cache(maxsize=None)
def _jax_loop(min_round, max_round, start_round):
    hits, lcp, lnp = _case()
    t, _c, r, _n = run_fast_em_loop(
        jnp.asarray(_theta0()), build_fast_data(hits, lcp, lnp, M, N0),
        min_round=min_round, max_round=max_round, start_round=start_round)
    return np.asarray(t), int(r)


def _port_loop(monkeypatch, segment, **kw):
    monkeypatch.setattr(ttheta, "SEGMENT", segment)
    t, r = ttheta.run_theta_loop(torch.as_tensor(_theta0()), _data(), **kw)
    return t.numpy(), r


def _natural_stop():
    return _jax_loop(20, 10_000, 0)[1]


def test_fused_plain_round_equals_step_and_stop_count():
    """The fused plain round = the separate M-step and stop test the loop
    ran before it was fused, bit for bit."""
    data = _data()
    theta = torch.as_tensor(np.random.default_rng(4).dirichlet(
        np.ones(M + 1)).astype(np.float32))
    t_new, c, n = ttheta.theta_round_plain(theta, data)
    # the unfused round: E-step sums, then counts, M-step and stop test
    _w, w0, inv = ttheta._weights(theta, data)
    contrib = torch.zeros(M + 1, dtype=torch.float64).index_add_(
        0, data.sid.long(), (data.cps * inv[data.rid]).double())
    want_c = contrib * theta.double()
    want_c[0] = (w0 * inv).double().sum() + N0
    want_t = (want_c / want_c.sum()).to(torch.float32)
    mask = theta >= THETA_CUT
    rel = (want_t - theta).abs() / torch.where(mask, theta,
                                                torch.ones_like(theta))
    want_n = int((torch.where(mask, rel, torch.zeros_like(rel))
                  >= STOP_CRITERIA).sum())
    assert torch.equal(c, want_c) and torch.equal(t_new, want_t)
    assert n.dtype == torch.int32 and int(n) == want_n > 0
    # the wrapper on CPU tensors runs it, one round per ring row
    state = ttheta.round_state(data, 2, CPU)
    state.ring[0] = theta
    ttheta.theta_round(state, data, 2)
    assert torch.equal(state.ring[1], want_t)
    t2, c2, n2 = ttheta.theta_round_plain(want_t, data)
    assert torch.equal(state.ring[2], t2) and torch.equal(state.counts, c2)
    assert state.tot.tolist() == [want_n, int(n2)]
    with pytest.raises(ValueError):
        ttheta.theta_round(state, data, 3)


@pytest.mark.parametrize("segment", [1, 4, 16])
def test_segmented_loop_stops_where_jax_loop_stops(monkeypatch, segment):
    t_ref, r_ref = _jax_loop(20, 10_000, 0)
    t, r = _port_loop(monkeypatch, segment)
    assert 20 < r < 10_000
    assert r == r_ref
    np.testing.assert_allclose(t, t_ref, rtol=5e-4, atol=1e-8)


@pytest.mark.parametrize("case", ["min_round_at_stop", "min_round_after_stop",
                                  "max_round_cuts", "start_round",
                                  "start_past_max"])
def test_segmented_loop_edges(monkeypatch, case):
    """A stop exactly at min_round (converged there, or earlier and held
    until it), max_round ending the loop between segment boundaries of
    the unclamped schedule, the EM's start_round = 10, and a start at or
    past both limits (no round)."""
    stop = _natural_stop()
    kw = {"min_round_at_stop": dict(min_round=stop, max_round=10_000,
                                    start_round=0),
          "min_round_after_stop": dict(min_round=stop + 7, max_round=10_000,
                                       start_round=0),
          "max_round_cuts": dict(min_round=5, max_round=37, start_round=0),
          "start_round": dict(min_round=20, max_round=10_000,
                              start_round=10),
          "start_past_max": dict(min_round=20, max_round=30,
                                 start_round=30)}[case]
    t_ref, r_ref = _jax_loop(kw["min_round"], kw["max_round"],
                             kw["start_round"])
    for segment in (4, 16):
        t, r = _port_loop(monkeypatch, segment, **kw)
        assert r == r_ref, segment
        np.testing.assert_allclose(t, t_ref, rtol=5e-4, atol=1e-8)
    if case == "min_round_after_stop":
        assert r == stop + 7
    if case == "max_round_cuts":
        assert r == 37
    if case == "start_past_max":
        assert r == 30 and np.array_equal(t, _theta0())


@pytest.mark.parametrize("rounds,min_round,max_round,segment,want", [
    (0, 20, 10_000, 16, 16), (16, 20, 10_000, 16, 4),
    (20, 20, 10_000, 16, 16), (10, 20, 10_000, 16, 10),
    (36, 5, 37, 16, 1), (0, 500, 500, 16, 16), (496, 500, 500, 16, 4),
    (0, 20, 10_000, 1, 1)])
def test_segment_schedule(rounds, min_round, max_round, segment, want):
    assert ttheta._segment_length(rounds, min_round, max_round,
                                  segment) == want


def test_first_stop_rule():
    # rounds 11..14 done; the rule needs >= min_round and a zero count
    assert ttheta._first_stop(10, [3, 0, 0, 2], 12, 100) == 1
    assert ttheta._first_stop(10, [0, 0, 0, 0], 14, 100) == 3
    assert ttheta._first_stop(10, [5, 5, 5, 5], 12, 100) == -1
    assert ttheta._first_stop(10, [5, 5, 5, 5], 12, 13) == 2
