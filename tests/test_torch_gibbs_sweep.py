"""The port's Gibbs tile sweep (K5's plain version, on the CPU) against the
JAX package's Pallas sweep in interpret mode, and the port's own layout.

From one chain state on the JAX layout's tiles and parts, carried across
by rsem_tpu_torch.convert.gibbs_state_from_jax, both sides must give
identical assignments and count tables: the port keeps the TPU kernel's
tile geometry, counter-hash uniforms and reduction order. The port's
build_layout deals reads over tiles on purpose (ops/gibbs.py), so its
layout holds the JAX layout's reads in another order; that is checked
apart. Interpret-mode sweeps are slow on the CPU (seconds per part), so
these cases use two chains, at most 300 reads and three sweeps in all."""

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


def _reads(part):
    """{(sid row, cps row, ncs)} multiset of a part's filled reads; the
    sid of a slot without weight reads 0 (the JAX layout pads with a sid
    in the tile's row window, the port with 0)."""
    rows = part.filled_reads()
    cps = part.cps.view(-1, part.K)[rows].numpy()
    sid = np.where(cps > 0, part.sid.view(-1, part.K)[rows].numpy(), 0)
    ncs = part.ncs[rows].numpy()
    return sorted(zip(map(tuple, sid.tolist()), map(tuple, cps.tolist()),
                      ncs.tolist()))


def _check_layout(hits, lcp, lnp, M, td, n_blocks):
    """Every kept alignment placed once, with its sid and scaled conprb, in
    its read's row; tile fills differ by <= 1 with padding at each tile's
    end; each bucket's tile count follows tiles_for; no tile holds more
    than ceil(n_set / n_tiles) reads of one kept-sid multiset."""
    cps, ncs = tg.scale_conprbs(hits, lcp, lnp)
    keep = np.isfinite(lcp)
    offs = hits.read_offsets
    want, sets = {}, {}
    for i in range(hits.n_reads):
        k = keep[offs[i]:offs[i + 1]]
        if k.any():
            row = (tuple(hits.sid[offs[i]:offs[i + 1]][k].tolist()),
                   tuple(cps[offs[i]:offs[i + 1]][k].tolist()))
            want.setdefault(len(row[0]), []).append(row + (float(ncs[i]),))
            key = tuple(sorted(row[0]))
            sets[key] = sets.get(key, 0) + 1
    assert td.n_reads == sum(map(len, want.values()))
    got = {}
    for part in td.parts:
        K, rpt = part.K, part.reads_per_tile
        assert part.n_tiles == tg.tiles_for(part.n_real, K, td.n_reads,
                                            n_blocks)
        assert part.fill.max() - part.fill.min() <= 1
        cps_t = part.cps.view(part.n_tiles, rpt, K)
        ncs_t = part.ncs.view(part.n_tiles, rpt)
        for t, f in enumerate(part.fill):
            assert not bool(cps_t[t, f:].any() or ncs_t[t, f:].any())
            placed = {}
            for sid_r, cps_r, nc in _reads_of_tile(part, t):
                n = sum(x != 0 for x in sid_r)  # padding slots: sid 0
                row = (tuple(sid_r[:n]), tuple(cps_r[:n]), nc)
                key = tuple(sorted(row[0]))
                placed[key] = placed.get(key, 0) + 1
                got.setdefault(n, []).append(row)
            for key, n in placed.items():
                assert n <= -(-sets[key] // part.n_tiles), key
    widths = {}
    for w, rows in want.items():  # bucket width: next power of two
        widths.setdefault(1 << (w - 1).bit_length(), []).extend(rows)
    assert sorted(want) == sorted(got) and all(
        sorted(want[w]) == sorted(got[w]) for w in want)
    assert sorted(widths) == [p.K for p in td.parts]


def _reads_of_tile(part, t):
    f, K = int(part.fill[t]), part.K
    s0, r0 = t * tg.TILE_SLOTS, t * part.reads_per_tile
    sid = part.sid[s0:s0 + f * K].view(f, K).tolist()
    cps = part.cps[s0:s0 + f * K].view(f, K).tolist()
    return zip(sid, cps, part.ncs[r0:r0 + f].tolist())


def _replay(hits, lcp, lnp, M, n_sweeps, seed, pseudo=1.0, omit=()):
    """JAX init -> n_sweeps on both sides, on the JAX layout's parts;
    returns the number of reads whose assignment differs and the max table
    difference after each sweep. `omit`: sids whose table entry starts at
    -1 + pseudo (omitted)."""
    jd = pg.build_pallas_gibbs_data(hits, lcp, lnp, M)
    base = np.zeros(jd.t_pad * 128, np.float32)
    base[: M + 1] = pseudo
    base[list(omit)] -= 1.0
    base[0] += 7 + jd.n_noise_fixed
    keys = jax.random.split(jax.random.PRNGKey(seed), C)
    zohs, tables = pg.init_chains_jit(keys, jd, jnp.asarray(base), C)
    parts, assigns, table = gibbs_state_from_jax(jd.parts, zohs, tables, M)
    seeds = [tg.part_seed(seed, pi) for pi in range(len(parts))]
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
        for part, a, sp in zip(parts, assigns, seeds):
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
    """(a) the port's layout holds the JAX layout's reads, buckets and
    placed/noise counts, dealt over its tiles: narrow reads (widths 1-8)
    and reads of up to 180 alignments, with the default n_blocks and
    with n_blocks = 1 (no more tiles than the reads fill)."""
    for N, M, mh in ((300, 40, 6), (80, 300, 180)):
        hits, lcp, lnp = _synthetic(N, M, seed=1, max_hits=mh)
        lcp[::13] = -np.inf  # dropped alignments
        jd = pg.build_pallas_gibbs_data(hits, lcp, lnp, M)
        jparts, _a, _t = gibbs_state_from_jax(
            jd.parts, [np.zeros((1,) + p.sid_t.shape, np.float32)
                       for p in jd.parts],
            np.zeros((1, jd.t_pad, 128), np.float32), M)
        for n_blocks in (32, 1):
            td = tg.build_layout(hits, lcp, lnp, M, n_blocks=n_blocks)
            assert (td.n_reads, td.n_noise_fixed) == (jd.n_reads,
                                                      jd.n_noise_fixed)
            assert sorted(r for p in jparts for r in _reads(p)) == sorted(
                r for p in td.parts for r in _reads(p))
            _check_layout(hits, lcp, lnp, M, td, n_blocks)
            if n_blocks == 1:
                assert all(p.n_tiles == -(-p.n_real // p.reads_per_tile)
                           for p in td.parts)


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
