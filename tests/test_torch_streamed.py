"""The port's streamed theta loop (ops/theta.run_theta_loop_streamed over
the host chunks of parallel/fast_sharded.build_theta_chunks) on the CPU,
where each chunk's partial is K1's plain version: the chunk bounds of the
JAX package's build_fast_data_chunks, its run_fast_em_loop_streamed at the
tolerances of its own test (tests/test_scale.py:168-170: rounds equal,
theta rtol 5e-4 atol 1e-9, count sum rtol 1e-5), and the port's resident
run_theta_loop (rounds equal, theta rtol 1e-6); the bytes of a chunk, and
the edges of the loop."""

import functools

import numpy as np
import pytest
import torch

from rsem_tpu.io.hits import HitArrays as JHitArrays
from rsem_tpu.ops.fast_estep import run_fast_em_loop_streamed
from rsem_tpu.parallel.fast_sharded import build_fast_data_chunks
from rsem_tpu_torch.io.hits import HitArrays
from rsem_tpu_torch.ops import theta as ttheta
from rsem_tpu_torch.ops.layout import HitsDevice
from rsem_tpu_torch.parallel.fast_sharded import build_theta_chunks

CPU = torch.device("cpu")
N, M, N0 = 3000, 300, 7.0


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain versions run many small ops; in a test run of several
    worker processes torch's intra-op thread pool only adds contention."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _arrays(nh, seed):
    """(sid, rid, offsets, lcp, lnp) of reads with nh hits each, drawn as
    tests/test_scale.py:146-148 draws its conprbs."""
    rng = np.random.default_rng(seed)
    nh = np.asarray(nh, dtype=np.int64)
    H = int(nh.sum())
    offsets = np.zeros(len(nh) + 1, dtype=np.int64)
    np.cumsum(nh, out=offsets[1:])
    rid = np.repeat(np.arange(len(nh), dtype=np.int32), nh)
    sid = rng.integers(1, M + 1, size=H).astype(np.int32)
    lcp = rng.normal(-20, 3, H)
    lnp = rng.normal(-25, 3, len(nh))
    return sid, rid, offsets, lcp, lnp


def _hits(cls, sid, rid, offsets):
    H = len(sid)
    return cls(rid=rid, sid=sid, dir=np.zeros(H, dtype=np.int8),
               pos=np.zeros(H, dtype=np.int32), insert_len=None,
               read_offsets=offsets)


@functools.lru_cache(maxsize=None)
def _case(trailing_empty: bool = False):
    """N reads, skewed hits per read (geometric with a rare tail to 200),
    one read in 50 without a hit (none at the end unless asked: the JAX
    builder refuses a chunk that ends in one)."""
    rng = np.random.default_rng(11)
    nh = np.minimum(rng.geometric(0.35, size=N) + (rng.random(N) < 0.01)
                    * rng.integers(60, 200, size=N), 200)
    nh[rng.random(N) < 0.02] = 0
    nh[-1] = 0 if trailing_empty else max(nh[-1], 1)
    return _arrays(nh, seed=12)


def _theta0():
    return np.full(M + 1, 1.0 / (M + 1))


def _resident(sid, rid, offsets, lcp, lnp, **loop):
    data = ttheta.scale_conprbs(
        HitsDevice.from_arrays(_hits(HitArrays, sid, rid, offsets), CPU),
        torch.as_tensor(lcp), torch.as_tensor(lnp), M, N0)
    th, r = ttheta.run_theta_loop(torch.as_tensor(_theta0()), data, **loop)
    return th.numpy(), r


def _streamed(arrays, n_chunks, **loop):
    sid, rid, offsets, lcp, lnp = arrays
    chunks, _b, _hb = build_theta_chunks(
        _hits(HitArrays, sid, rid, offsets), lcp, lnp, M, N0, n_chunks,
        device="cpu")
    th, c, r = ttheta.run_theta_loop_streamed(_theta0(), chunks, M, N0,
                                              device="cpu", **loop)
    return th.numpy(), c.numpy(), r


@pytest.mark.parametrize("n_chunks", [1, 2, 3, 4, 5])
@pytest.mark.parametrize("shape", ["skewed", "more chunks than reads"])
def test_chunk_bounds_match_jax(n_chunks, shape):
    """Read and hit bounds equal the JAX builder's; each chunk holds its
    reads' hits with rid local to it, offsets from 0, and cps / ncs as the
    port's f64 host scaling gives them over the whole dataset."""
    if shape == "skewed":
        sid, rid, offsets, lcp, lnp = _case()
    else:
        sid, rid, offsets, lcp, lnp = _arrays([2, 0, 3], seed=3)
    jchunks, jb, jhb = build_fast_data_chunks(
        _hits(JHitArrays, sid, rid, offsets), lcp, lnp, M, N0, n_chunks)
    chunks, b, hb = build_theta_chunks(
        _hits(HitArrays, sid, rid, offsets), lcp, lnp, M, N0, n_chunks,
        device="cpu")
    assert len(chunks) == len(jchunks) == n_chunks
    np.testing.assert_array_equal(b, jb)
    np.testing.assert_array_equal(hb, jhb)
    whole, _b, _hb = build_theta_chunks(
        _hits(HitArrays, sid, rid, offsets), lcp, lnp, M, N0, 1,
        device="cpu")
    for c, lo, hi, hlo, hhi in zip(chunks, b[:-1], b[1:], hb[:-1], hb[1:]):
        assert c.sid.dtype == c.rid.dtype == torch.int32
        assert c.cps.dtype == c.ncs.dtype == torch.float32
        assert c.read_offsets.dtype == torch.int64
        assert not c.sid.is_pinned()
        np.testing.assert_array_equal(c.sid, sid[hlo:hhi])
        np.testing.assert_array_equal(c.rid, rid[hlo:hhi] - lo)
        np.testing.assert_array_equal(c.read_offsets,
                                      offsets[lo:hi + 1] - hlo)
        np.testing.assert_array_equal(c.cps, whole[0].cps[hlo:hhi])
        np.testing.assert_array_equal(c.ncs, whole[0].ncs[lo:hi])
        assert (c.M, c.n0) == (M, N0)


def test_streamed_matches_jax():
    """Against the JAX streamed loop on 4 chunks (M-step on the host in f64
    there, on the device's f64 into an f32 theta here) at max_round =
    25."""
    n_chunks = 4
    sid, rid, offsets, lcp, lnp = _case()
    jchunks, _b, _hb = build_fast_data_chunks(
        _hits(JHitArrays, sid, rid, offsets), lcp, lnp, M, N0, n_chunks)
    th_j, c_j, r_j = run_fast_em_loop_streamed(_theta0(), jchunks, M, N0,
                                               max_round=25)
    th, c, r = _streamed(_case(), n_chunks, max_round=25)
    assert r == r_j == 25
    np.testing.assert_allclose(th, th_j, rtol=5e-4, atol=1e-9)
    np.testing.assert_allclose(c.sum(), c_j.sum(), rtol=1e-5)
    assert c.dtype == np.float64 and c.shape == (M + 1,)


@pytest.mark.parametrize("rule,n_chunks,trailing_empty", [
    ("fixed", n, t) for n in (1, 3, 5) for t in (False, True)] + [
    ("convergent", 3, False), ("convergent", 5, True)])
def test_streamed_matches_resident(rule, n_chunks, trailing_empty):
    """Against the port's resident loop on the whole CSR: the same rounds,
    theta within rtol 1e-6 (the chunks' f64 partial sums add in another
    order); the counts are the stop round's: they sum to N + n0 (a read
    with no hit is noise; each read's weights are f32) and normalise to
    theta."""
    loop = dict(min_round=25, max_round=25) if rule == "fixed" else {}
    arrays = _case(trailing_empty)
    th_r, r_r = _resident(*arrays, **loop)
    th, c, r = _streamed(arrays, n_chunks, **loop)
    assert r == r_r
    if rule == "convergent":
        assert 25 < r < 10_000
    np.testing.assert_allclose(th, th_r, rtol=1e-6, atol=1e-12)
    assert c.sum() == pytest.approx(N + N0, rel=1e-6)
    np.testing.assert_allclose(c / c.sum(), th, rtol=1e-6, atol=1e-12)


def _nbytes(chunk) -> int:
    return sum(t.numel() * t.element_size()
               for t in chunk if isinstance(t, torch.Tensor))


def test_chunk_bytes_bounded():
    """With 4 chunks the largest holds < 0.55 of the whole data's bytes
    (the JAX test's bound, tests/test_scale.py:159-161); all four add up
    to the whole but for the three extra offsets."""
    sid, rid, offsets, lcp, lnp = _case()
    hits = _hits(HitArrays, sid, rid, offsets)
    chunks, _b, _hb = build_theta_chunks(hits, lcp, lnp, M, N0, 4,
                                         device="cpu")
    whole, _b, _hb = build_theta_chunks(hits, lcp, lnp, M, N0, 1,
                                        device="cpu")
    assert max(_nbytes(c) for c in chunks) < 0.55 * _nbytes(whole[0])
    assert sum(_nbytes(c) for c in chunks) == _nbytes(whole[0]) + 3 * 8


def test_streamed_edges():
    """start_round >= max_round runs nothing (theta0 back, zero counts);
    start_round counts toward max_round; progress sees every round with
    its stop count, the last one the stop; a chunk of another M and no
    read at all refuse."""
    arrays = _case()
    sid, rid, offsets, lcp, lnp = arrays
    chunks, _b, _hb = build_theta_chunks(
        _hits(HitArrays, sid, rid, offsets), lcp, lnp, M, N0, 3,
        device="cpu")
    th, c, r = ttheta.run_theta_loop_streamed(
        _theta0(), chunks, M, N0, min_round=20, max_round=20,
        start_round=20, device="cpu")
    assert r == 20 and not c.any()
    np.testing.assert_array_equal(th.numpy(), _theta0().astype(np.float32))

    seen = []
    th, c, r = ttheta.run_theta_loop_streamed(
        _theta0(), chunks, M, N0, min_round=5, max_round=30, start_round=22,
        device="cpu", progress=lambda i, tot: seen.append((i, tot)))
    assert r == 30
    assert [i for i, _t in seen] == list(range(23, 31))
    th_r, r_r = _resident(*arrays, min_round=5, max_round=30,
                          start_round=22)
    assert r_r == 30
    np.testing.assert_allclose(th.numpy(), th_r, rtol=1e-6, atol=1e-12)

    seen.clear()
    _th, _c, r = ttheta.run_theta_loop_streamed(
        _theta0(), chunks, M, N0, device="cpu",
        progress=lambda i, tot: seen.append((i, tot)))
    assert [i for i, _t in seen] == list(range(1, r + 1))
    assert seen[-1][1] == 0 and all(t > 0 for _i, t in seen[19:-1])

    with pytest.raises(ValueError, match="M"):
        ttheta.run_theta_loop_streamed(_theta0(), chunks, M + 1, N0,
                                       device="cpu")
    with pytest.raises(ValueError, match="no chunk"):
        ttheta.run_theta_loop_streamed(_theta0(), [], M, N0, device="cpu")


def test_streamed_runs_on_cuda_unless_asked():
    """With no device given both the builder and the loop ask for CUDA
    (pinned chunks, the card's buffers) and raise without it."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    sid, rid, offsets, lcp, lnp = _arrays([1, 2, 1], seed=1)
    hits = _hits(HitArrays, sid, rid, offsets)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build_theta_chunks(hits, lcp, lnp, M, N0, 2)
    chunks, _b, _hb = build_theta_chunks(hits, lcp, lnp, M, N0, 2,
                                         device="cpu")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ttheta.run_theta_loop_streamed(_theta0(), chunks, M, N0)
