"""The port's Gibbs tile sweep (K5's plain version, on the CPU) against the
JAX package's Pallas sweep in interpret mode.

From one chain state, carried across by
rsem_tpu_torch.convert.gibbs_state_from_jax, both sides must give identical
assignments and count tables: the port keeps the TPU layout's tiles and
parts, its counter-hash uniforms and its reduction order. Interpret-mode
sweeps are slow on the CPU (seconds per part), so these cases use two
chains, at most 300 reads and three sweeps in all."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rsem_tpu.io.hits import HitArrays
from rsem_tpu.ops import pallas_gibbs as pg
from rsem_tpu_torch.convert import gibbs_state_from_jax
from rsem_tpu_torch.ops import gibbs as tg
from rsem_tpu_torch.testing import synthetic_gibbs_hits as _synthetic

C = 2


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain versions run many small ops; in a test run of several
    worker processes torch's intra-op thread pool only adds contention."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _s32(x):
    return x - (1 << 32) if x >= (1 << 31) else x


def _layouts_equal(jd, td):
    parts, _a, _t = gibbs_state_from_jax(
        jd.parts, [np.zeros((1,) + p.sid_t.shape, np.float32)
                   for p in jd.parts],
        np.zeros((1, jd.t_pad, 128), np.float32), jd.M)
    assert [(p.K, p.n_tiles, p.n_real) for p in parts] == [
        (p.K, p.n_tiles, p.n_real) for p in td.parts]
    for a, b in zip(parts, td.parts):
        assert torch.equal(a.sid, b.sid)
        assert torch.equal(a.cps, b.cps)
        assert torch.equal(a.ncs, b.ncs)
    assert (td.n_reads, td.n_noise_fixed) == (jd.n_reads, jd.n_noise_fixed)


def _replay(hits, lcp, lnp, M, n_sweeps, seed, pseudo=1.0, omit=()):
    """JAX init -> n_sweeps on both sides; returns the number of reads whose
    assignment differs and the max table difference after each sweep.
    `omit`: sids whose table entry starts at -1 + pseudo (omitted)."""
    jd = pg.build_pallas_gibbs_data(hits, lcp, lnp, M)
    td = tg.build_layout(hits, lcp, lnp, M)
    _layouts_equal(jd, td)
    base = np.zeros(jd.t_pad * 128, np.float32)
    base[: M + 1] = pseudo
    base[list(omit)] -= 1.0
    base[0] += 7 + jd.n_noise_fixed
    keys = jax.random.split(jax.random.PRNGKey(seed), C)
    zohs, tables = pg.init_chains_jit(keys, jd, jnp.asarray(base), C)
    _p, assigns, table = gibbs_state_from_jax(jd.parts, zohs, tables, M)
    seeds = [tg.part_seed(seed, pi) for pi in range(len(td.parts))]
    out = []
    for sweep in range(n_sweeps):
        new = []
        for pi, part in enumerate(jd.parts):
            z, tables = pg.sweep_part(
                zohs[pi], tables, part,
                jnp.asarray([_s32(seeds[pi]), sweep], jnp.int32),
                interpret=True)
            new.append(z)
        zohs = tuple(new)
        for part, a, sp in zip(td.parts, assigns, seeds):
            tg.sweep_part(a, table, part, sp, sweep)
        _p, ja, jt = gibbs_state_from_jax(jd.parts, zohs, tables, M)
        n_diff = sum(int((x != y).any(0).sum()) for x, y in zip(ja, assigns))
        out.append((n_diff, float((jt - table).abs().max())))
        # conservation: every chain's table holds N0 + N1 + sum(pseudo)
        want = 7 + hits.n_reads + pseudo * (M + 1) - len(omit)
        np.testing.assert_allclose(table.double().sum(1).numpy(), want,
                                   rtol=1e-6)
    return out


def test_layout_matches_jax():
    """(a) same parts, tiles and slot contents as the JAX layout, for
    narrow reads (widths 1-8) and reads of up to 180 alignments."""
    for N, M, mh in ((300, 40, 6), (80, 300, 180)):
        hits, lcp, lnp = _synthetic(N, M, seed=1, max_hits=mh)
        lcp[::13] = -np.inf  # dropped alignments
        _layouts_equal(pg.build_pallas_gibbs_data(hits, lcp, lnp, M),
                       tg.build_layout(hits, lcp, lnp, M))


def test_two_sweeps_replay_jax_exactly():
    """(b) from the JAX init state, two sweeps of every part: identical
    assignments and tables after each. A quarter of the reads have a noise
    slot as likely as their hits, and one sid is omitted."""
    hits, lcp, lnp = _synthetic(300, 40, seed=1, max_hits=6)
    lnp[::4] = -20.0
    assert _replay(hits, lcp, lnp, 40, 2, seed=7, omit=(3,)) == [
        (0, 0.0), (0, 0.0)]


def test_wide_reads_replay_jax_exactly():
    """(c) reads of 129-180 alignments (width 256: the cross-row prefix and
    shared-memory reductions of the kernel), one sweep, fractional pseudo
    counts in the table."""
    hits, lcp, lnp = _synthetic(40, 300, seed=8, max_hits=180, min_hits=129)
    assert _replay(hits, lcp, lnp, 300, 1, seed=9, pseudo=0.1) == [(0, 0.0)]


def test_counter_hash_matches_jax_bit_for_bit():
    """(d) mix32 and the per-read uniform equal JAX's _mix32 stream."""
    rng = np.random.default_rng(0)
    keys = np.concatenate([
        rng.integers(-(1 << 31), 1 << 31, size=20000, dtype=np.int64),
        [0, 1, -1, (1 << 31) - 1, -(1 << 31)]]).astype(np.int32)
    want = np.asarray(pg._mix32(jnp.asarray(keys))).view(np.uint32)
    got = tg.mix32(torch.as_tensor(keys.view(np.uint32).astype(np.int64)))
    np.testing.assert_array_equal(got.numpy().astype(np.uint32), want)
    for k in keys[:50]:
        assert tg.mix32_int(int(k) & 0xFFFFFFFF) == int(
            np.asarray(pg._mix32(jnp.int32(k))).view(np.uint32))
    # the kernel's uniform of every read of a tile (pallas_gibbs.py:446-460)
    for seed_part, sweep, tile, K in ((12345, 0, 0, 1), (0xDEADBEEF, 7, 3, 4),
                                      (2**31 + 5, 250, 41, 256)):
        h = pg._mix32(jnp.int32(_s32(seed_part))
                      + jnp.int32(sweep) * jnp.int32(-1640531527)
                      + jnp.int32(tile) * jnp.int32(0x7F4A7C15))
        rows = np.arange(C * 64, dtype=np.int32)[:, None]
        lanes = np.arange(128, dtype=np.int32)[None, :]
        k1 = h + jnp.asarray(rows * 128 + lanes)
        u = np.asarray((jax.lax.shift_right_logical(
            pg._mix32(pg._mix32(k1)), jnp.int32(7)) & 0xFFFFFF).astype(
                jnp.float32) * (1.0 / (1 << 24))).reshape(C, -1)
        got = tg.read_uniforms(seed_part, sweep, tile, C, K)
        np.testing.assert_array_equal(got.numpy(), u[:, ::K])


def test_layout_refuses_reads_wider_than_a_tile():
    many = 9000
    hits = HitArrays(rid=np.zeros(many, np.int32),
                     sid=np.ones(many, np.int32),
                     dir=np.zeros(many, np.int8),
                     pos=np.zeros(many, np.int32), insert_len=None,
                     read_offsets=np.array([0, many], np.int64))
    with pytest.raises(ValueError, match="fit a Gibbs tile"):
        tg.build_layout(hits, np.zeros(many), np.zeros(1), 10)
