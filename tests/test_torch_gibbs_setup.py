"""The Gibbs set-up in torch (`build_layout`, `init_chains`), on the CPU.

`build_layout` sorts and deals the reads with torch ops wherever the hits
lie; here it is held against `numpy_layout`, the host numpy build the port
used before (kept in this file as the reference): the same parts, widths,
tile counts, fills, sids and read order exactly, the scaled conprbs within
one f32 ulp (the f64 `exp` of torch and of numpy may differ in the last
bit). `init_chains` draws each read's initial slot by CDF inversion from
K5's counter hash: its pick frequencies against the conprb weights (a
chi-square test), its tables against a recount, its padding reads, a
rank's slice of the chains, and its picks against K5's own selection
(one plain sweep from an empty state at the init's sweep key)."""

import functools
import types

import numpy as np
import pytest
import torch
from scipy.stats import chi2

from rsem_tpu_torch.io.hits import HitArrays
from rsem_tpu_torch.ops import gibbs
from rsem_tpu_torch.testing import pair_hits, synthetic_gibbs_hits


# ------------------------------------------------------------------ #
# the reference: the host numpy layout build                         #
# ------------------------------------------------------------------ #
def _per_read(ufunc, values, offs, empty):
    out = np.full(len(offs) - 1, empty, dtype=values.dtype)
    full = np.diff(offs) > 0
    if full.any():
        out[full] = ufunc.reduceat(values, offs[:-1][full])
    return out


def _mix64(x):
    """splitmix64's finaliser on uint64 (wrap-around arithmetic)."""
    x = x.astype(np.uint64)
    x = (x ^ (x >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
    x = (x ^ (x >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    return x ^ (x >> np.uint64(31))


def numpy_layout(hits, log_conprb, log_ncp, n_blocks=32):
    """[(K, n_tiles, fill, sid [n_tiles * 8192], cps, ncs)] per part and
    (placed reads, reads with no kept slot), as numpy arrays."""
    N = hits.n_reads
    offs = hits.read_offsets.astype(np.int64)
    sid = hits.sid.astype(np.int64)
    cps, ncs = gibbs.scale_conprbs(hits, log_conprb, log_ncp)
    keep = np.isfinite(np.asarray(log_conprb, dtype=np.float64))
    n_slots = _per_read(np.add, keep.astype(np.int64), offs, 0)
    included = n_slots > 0
    n_placed = int(included.sum())
    s_min = _per_read(np.minimum, np.where(keep, sid, np.iinfo(np.int64).max),
                      offs, 0)
    s_hash = _per_read(np.add, np.where(keep, _mix64(sid), np.uint64(0)),
                       offs, np.uint64(0))
    key = (s_min.astype(np.uint64) << np.uint64(32)) | (
        s_hash >> np.uint64(32))
    sizes = [1]
    mx = int(n_slots.max()) if included.any() else 1
    while sizes[-1] < mx:
        sizes.append(sizes[-1] * 2)
    bucket_of = np.searchsorted(np.asarray(sizes), n_slots)
    keep_pos = np.flatnonzero(keep)
    kept_offs = np.concatenate([[0], np.cumsum(n_slots)])
    parts = []
    for bi, K in enumerate(sizes):
        rsel = np.flatnonzero(included & (bucket_of == bi))
        if len(rsel) == 0:
            continue
        rsel = rsel[np.argsort(key[rsel], kind="stable")]
        n_k = len(rsel)
        rpt = gibbs.TILE_SLOTS // K
        n_tiles = gibbs.tiles_for(n_k, K, n_placed, n_blocks)
        j = np.arange(n_k)
        row = (j % n_tiles) * rpt + j // n_tiles
        nh_sel = n_slots[rsel]
        tot = int(nh_sel.sum())
        cols = np.arange(tot) - np.repeat(np.cumsum(nh_sel) - nh_sel, nh_sel)
        rows_idx = np.repeat(row, nh_sel)
        src = keep_pos[np.repeat(kept_offs[rsel], nh_sel) + cols]
        sid_m = np.zeros((n_tiles * rpt, K), dtype=np.int32)
        cps_m = np.zeros((n_tiles * rpt, K), dtype=np.float32)
        ncs_m = np.zeros(n_tiles * rpt, dtype=np.float32)
        sid_m[rows_idx, cols] = sid[src]
        cps_m[rows_idx, cols] = cps[src]
        ncs_m[row] = ncs[rsel]
        parts.append((K, n_tiles, np.bincount(j % n_tiles, minlength=n_tiles),
                      sid_m.reshape(-1), cps_m.reshape(-1), ncs_m))
    return parts, (n_placed, int(N - n_placed))


def _within_one_ulp(got, want):
    got, want = got.numpy(), np.asarray(want)
    ulp = np.spacing(np.maximum(np.abs(got), np.abs(want)))
    return bool((np.abs(got - want) <= ulp).all())


def assert_layout_equal(layout, hits, lcp, lnp, n_blocks=32):
    parts, (n_placed, n_fixed) = numpy_layout(hits, lcp, lnp, n_blocks)
    assert (layout.n_reads, layout.n_noise_fixed) == (n_placed, n_fixed)
    assert [(p.K, p.n_tiles) for p in layout.parts] == [
        (K, n) for K, n, *_ in parts]
    for p, (K, n_tiles, fill, sid, cps, ncs) in zip(layout.parts, parts):
        np.testing.assert_array_equal(p.fill, fill)
        assert p.fill.dtype == np.int64
        np.testing.assert_array_equal(p.sid.numpy(), sid)
        assert _within_one_ulp(p.cps, cps) and _within_one_ulp(p.ncs, ncs)
        assert p.sid.dtype == torch.int32 and p.cps.dtype == torch.float32


@functools.lru_cache(maxsize=None)
def _mixed():
    """Widths 1-64, duplicate sids in a read, noise slots, a fifth of the
    alignments dropped, reads with no kept slot and reads with no hit
    (cached: callers do not write to the arrays)."""
    hits, lcp, lnp = synthetic_gibbs_hits(3000, 150, seed=3, max_hits=40)
    lcp = lcp.copy()
    lcp[::5] = -np.inf
    offs = hits.read_offsets
    for r in range(0, 3000, 97):  # no kept slot
        lcp[offs[r]:offs[r + 1]] = -np.inf
    lnp = lnp.copy()
    lnp[::4] = -np.inf
    # reads without hits between the others: offsets repeat
    nh = np.diff(offs)
    nh = np.insert(nh, np.arange(0, 3000, 250), 0)
    offs2 = np.concatenate([[0], np.cumsum(nh)])
    lnp2 = np.insert(lnp, np.arange(0, 3000, 250), -3.0)
    hits2 = HitArrays(rid=np.repeat(np.arange(len(nh), dtype=np.int32), nh),
                      sid=hits.sid, dir=hits.dir, pos=hits.pos,
                      insert_len=None, read_offsets=offs2.astype(np.int64))
    return hits2, lcp, lnp2


CASES = {
    "pairs": lambda: pair_hits([1.0] * 12 + [1.1] * 12, 20),
    "mixed": _mixed,
    "wide": lambda: synthetic_gibbs_hits(40, 30, seed=8, max_hits=600,
                                         min_hits=300),
}


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("n_blocks", [1, 32])
def test_layout_equals_numpy_build(case, n_blocks):
    hits, lcp, lnp = CASES[case]()
    layout = gibbs.build_layout(hits, lcp, lnp, 300, n_blocks=n_blocks)
    assert_layout_equal(layout, hits, lcp, lnp, n_blocks)


def test_layout_from_tensors_and_views():
    """The same layout from device-style inputs (a HitsDevice and f64
    tensors) and from a view of sid and read_offsets alone (the .ofg
    restart's `gibbs_inputs_from_ofg`)."""
    from rsem_tpu_torch.ops.layout import HitsDevice

    hits, lcp, lnp = _mixed()
    want = gibbs.build_layout(hits, lcp, lnp, 150)
    hd = HitsDevice.from_arrays(hits, torch.device("cpu"))
    view = types.SimpleNamespace(sid=hits.sid, read_offsets=hits.read_offsets,
                                 n_reads=hits.n_reads, n_hits=hits.n_hits)
    for got in (gibbs.build_layout(hd, torch.as_tensor(lcp),
                                   torch.as_tensor(lnp), 150),
                gibbs.build_layout(view, lcp, lnp, 150)):
        for p, q in zip(got.parts, want.parts):
            assert (p.K, p.n_tiles) == (q.K, q.n_tiles)
            assert torch.equal(p.sid, q.sid) and torch.equal(p.cps, q.cps)
            assert torch.equal(p.ncs, q.ncs)


def test_mix64_equals_uint64_splitmix():
    x = np.concatenate([[0, 1, 2**31 - 1, 2**32 - 1],
                        np.random.default_rng(1).integers(0, 2**32, 5000)])
    hi, lo = gibbs.mix64(torch.as_tensor(x, dtype=torch.int64))
    got = (hi.numpy().astype(np.uint64) << np.uint64(32)) | lo.numpy().astype(
        np.uint64)
    np.testing.assert_array_equal(got, _mix64(x))


# ------------------------------------------------------------------ #
# init_chains                                                        #
# ------------------------------------------------------------------ #
def _weighted_reads(n_per=400):
    """Three kinds of read, n_per each: conprbs 1 : 2 : 4 over three sids
    with a noise slot of weight 0.5; 1 : 3 with no noise slot; one hit of
    weight 1 against noise of weight 1. Returns (hits, lcp, lnp, weights
    of each kind over [noise, slots])."""
    kinds = [([1, 2, 3], [1.0, 2.0, 4.0], 0.5), ([4, 5], [1.0, 3.0], 0.0),
             ([6], [1.0], 1.0)]
    per_read, lcp, lnp = [], [], []
    for sids, w, w0 in kinds:
        for _ in range(n_per):
            per_read.append([(s, 0) for s in sids])
            lcp += list(np.log(w))
            lnp.append(np.log(w0) if w0 else -np.inf)
    hits = HitArrays.from_lists(per_read, paired=False)
    weights = [np.array([w0] + w) / (w0 + sum(w)) for _s, w, w0 in kinds]
    return hits, np.array(lcp), np.array(lnp), weights


def test_init_picks_follow_the_conprbs():
    """Chi-square of the picks pooled over 64 chains, per kind of read,
    against the conprb weights; seed 5, each statistic under the 0.999
    quantile of its chi-square law (3 kinds: a false alarm ~0.3%)."""
    hits, lcp, lnp, weights = _weighted_reads()
    layout = gibbs.build_layout(hits, lcp, lnp, 6)
    assigns, tab = gibbs.init_chains(layout, torch.ones(7), 64, seed=5)
    for part, a in zip(layout.parts, assigns):
        rows = part.filled_reads()
        sid = part.sid.view(-1, part.K)[rows].long()
        pick = a[:, rows].long()  # [C, n]
        first = sid[:, 0]
        for kind, w in enumerate(weights):
            mine = first == {0: 1, 1: 4, 2: 6}[kind]
            if not bool(mine.any()):
                continue
            got = np.bincount((pick[:, mine] + 1).reshape(-1).numpy(),
                              minlength=len(w))
            assert len(got) == len(w)
            want = w * got.sum()
            on = want > 0
            assert got[~on].sum() == 0  # a zero-weight slot is never drawn
            stat = float(((got[on] - want[on]) ** 2 / want[on]).sum())
            assert stat < chi2.ppf(0.999, on.sum() - 1), (kind, got, want)


def test_init_tables_recount_the_assignments():
    hits, lcp, lnp = _mixed()
    M = 150
    layout = gibbs.build_layout(hits, lcp, lnp, M)
    base = torch.full((M + 1,), 0.5)
    base[9] = -1.0  # omitted
    base[0] += 7.0
    assigns, tab = gibbs.init_chains(layout, base, 5, seed=2)
    want = base[None].double().repeat(5, 1)
    for part, a in zip(layout.parts, assigns):
        filled = torch.zeros(part.n_reads, dtype=torch.bool)
        filled[part.filled_reads()] = True
        assert bool((a[:, ~filled] == -1).all())  # padding
        sid = part.sid.view(-1, part.K).long()
        on = a >= 0
        for c in range(5):
            s = sid[on[c]].gather(1, a[c, on[c]].long()[:, None])[:, 0]
            want[c].index_add_(0, s, torch.ones(len(s), dtype=torch.float64))
            want[c, 0] += part.n_real - int(on[c].sum())
    assert torch.equal(tab, want.float())
    # every read placed has a positive slot here, so noise gets the rest
    assert float(tab.sum(1).min()) == float(
        base.sum() + layout.n_reads)


def test_init_slice_draws_only_its_chains(monkeypatch):
    hits, lcp, lnp = synthetic_gibbs_hits(1500, 80, seed=9, max_hits=5)
    layout = gibbs.build_layout(hits, lcp, lnp, 80)
    base = torch.ones(81)
    drawn = []
    key_uniforms = gibbs.key_uniforms
    monkeypatch.setattr(gibbs, "key_uniforms", lambda k: (
        drawn.append(k.numel()), key_uniforms(k))[1])
    a8, t8 = gibbs.init_chains(layout, base, 8, seed=2)
    full = sum(drawn)
    drawn.clear()
    a4, t4 = gibbs.init_chains(layout, base, 8, seed=2, chains=slice(4, 8))
    assert sum(drawn) * 2 == full
    assert torch.equal(t4, t8[4:])
    for x, y in zip(a4, a8):
        assert torch.equal(x, y[4:])


def test_init_is_k5s_pick_from_an_empty_state():
    """On a one-tile layout, one plain K5 sweep at the init's sweep key from
    every read on noise, with counts of 1 on every hit and 2 on noise (so
    K5's count factors are all 1 once a read's own count is out), picks
    what init_chains picks, read for read and chain for chain."""
    hits, lcp, lnp = synthetic_gibbs_hits(300, 40, seed=4, max_hits=4,
                                          min_hits=3)
    lnp[::2] = -1.0
    layout = gibbs.build_layout(hits, lcp, lnp, 40, n_blocks=1)
    assert [(p.K, p.n_tiles) for p in layout.parts] == [(4, 1)]
    part = layout.parts[0]
    C, seed = 6, 11
    assigns, _tab = gibbs.init_chains(layout, torch.zeros(41), C, seed=seed)
    a = torch.full((C, part.n_reads), -1, dtype=torch.int32)
    table = torch.ones((C, 41))
    table[:, 0] = 2.0
    gibbs.sweep_part_plain(a, table, part, gibbs.part_seed(seed, 0),
                           gibbs.INIT_SWEEP)
    assert torch.equal(a, assigns[0])
    assert bool((a >= 0).any()) and bool((a[:, :part.n_real] == -1).any())
