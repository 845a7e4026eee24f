"""Collapsed-Gibbs tile sweep (K5): layout, counter-hash uniforms, sweep.

Counterpart of rsem_tpu/ops/pallas_gibbs.py. The reference's sampler
(Gibbs.cpp:265-353) resamples one read at a time against live counts. Here
reads are packed into tiles of TILE_SLOTS = 64 x 128 alignment slots
(bucket width K: 8192/K reads per tile), and each tile is one block of the
blocked collapse: every read of the tile samples against the counts as they
stood at the start of the tile (its own assignment subtracted exactly),
then the tile's +-1 count deltas are applied. Tiles run in order; chains
are independent.

The layout differs from the JAX Pallas sweep's on purpose. That one sorts
a bucket's reads by their smallest table row and fills tiles front to back,
so every read of an ambiguous split of up to thousands of reads (isoforms,
alleles, paralogs) lands in one tile and moves against the same stale
counts, which narrows the posterior. Here each bucket is one part whose
reads are sorted so that reads sharing a kept-sid set sit together, then
dealt round-robin over the part's tiles: a run of L such reads puts at most
ceil(L / n_tiles) into any tile. A bucket of n_b of the N1 placed reads
gets max(ceil(n_b / reads per tile), min(n_b, ceil(n_blocks n_b / N1)))
tiles, so that, as in the JAX package's XLA blocked sweep
(rsem_tpu/engine/gibbs.py:548-581), a read samples against counts at most
~N1 / n_blocks reads stale. Tile fills differ by at most one read; the
padding reads (conprbs 0, noise coefficient 0, slot sids 0) sit at each
tile's end and never move.

What is kept from the TPU kernel: the power-of-two bucket widths, the
tile geometry, the counter hash keyed on (part seed, sweep, tile, chain,
read) and the per-tile arithmetic in its reduction order, so the plain
sweep still replays the JAX Pallas sweep bit for bit on a layout carried
over from it (convert.gibbs_state_from_jax).

The set-up runs where the chains will: `build_layout` sorts and deals the
reads with torch ops on the EM's device copy of the hits, and
`init_chains` draws the initial state from the same counter hash (a sweep
key no run reaches) with K5's own selection arithmetic, so the CPU and the
card start from one state bit for bit and a rank draws only its chains.

State of a part: `assign` [C, n_reads] int32, the slot index of each read's
current alignment (-1 = noise), and one count table [C, M+1] f32 holding
counts + pseudo-counts (index 0 = noise) shared by all parts. `sweep_part`
updates both IN PLACE (the JAX kernel returns new arrays).

`sweep_part` runs the CUDA kernel (csrc/gibbs_sweep.cu) on CUDA tensors
and `sweep_part_plain` on CPU tensors. Both use the same float32 arithmetic
in the same order (no fused multiply-add), so they agree bit for bit; the
plain version skips each tile's padding reads, which the kernel samples
without effect. The kernel keeps the count table in device memory at any T
and sums a tile's deltas per sid in an int32 scratch (`delta_scratch`)
that the caller allocates once and passes to every sweep.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..io.hits import HitArrays
from . import _build
from .layout import HitsDevice
from .theta import scale_conprbs as scale_device

TILE_ROWS = 64
LANES = 128
TILE_SLOTS = TILE_ROWS * LANES  # slots per tile
MASK32 = 0xFFFFFFFF
GOLDEN = 0x9E3779B9  # sweep multiplier of the counter hash
TILE_MUL = 0x7F4A7C15  # tile multiplier of the counter hash
UNIFORM_BATCH = 1 << 22  # uniforms the plain sweep draws per batch of tiles
INIT_SWEEP = MASK32  # init_chains' sweep key: a run's sweeps never reach it


# ------------------------------------------------------------------ #
# layout                                                             #
# ------------------------------------------------------------------ #
@dataclass
class GibbsPart:
    """One bucket part's tiles: `n_tiles` tiles of TILE_SLOTS slots, read r
    of tile t at slots [t*TILE_SLOTS + r*K, ... + K). Tile t holds its
    fill[t] reads first; the rest of it is padding (cps 0, ncs 0)."""

    sid: torch.Tensor  # [n_tiles * TILE_SLOTS] int32
    cps: torch.Tensor  # [n_tiles * TILE_SLOTS] f32 scaled conprb (padding 0)
    ncs: torch.Tensor  # [n_tiles * reads_per_tile] f32 noise coefficient
    K: int  # slots per read (power of two, <= TILE_SLOTS)
    n_tiles: int
    fill: np.ndarray  # [n_tiles] int64 reads at the front of each tile

    @property
    def reads_per_tile(self) -> int:
        return TILE_SLOTS // self.K

    @property
    def n_real(self) -> int:
        """Reads of the part (the others are padding)."""
        return int(self.fill.sum())

    def filled_reads(self) -> torch.Tensor:
        """Indices (int64, on the part's device) of the filled reads among
        the part's n_reads, tile by tile; computed there from the fills."""
        dev = self.sid.device
        fill = torch.as_tensor(self.fill, dtype=torch.int64).to(dev)
        t = torch.repeat_interleave(torch.arange(self.n_tiles, device=dev),
                                    fill, output_size=self.n_real)
        first = torch.cumsum(fill, 0) - fill
        return (t * self.reads_per_tile
                + torch.arange(self.n_real, device=dev) - first[t])

    @property
    def n_reads(self) -> int:
        return self.n_tiles * self.reads_per_tile

    def to(self, device) -> "GibbsPart":
        return GibbsPart(self.sid.to(device), self.cps.to(device),
                         self.ncs.to(device), self.K, self.n_tiles,
                         self.fill)


@dataclass
class GibbsLayout:
    parts: List[GibbsPart]
    M: int
    n_reads: int  # reads placed in tiles (>= 1 kept hit)
    n_noise_fixed: int  # reads with no kept hit: noise for good

    @property
    def n_tiles(self) -> int:
        return sum(p.n_tiles for p in self.parts)

    @property
    def n_slots(self) -> int:
        """Slots of the placed reads (reads x bucket width)."""
        return sum(p.n_real * p.K for p in self.parts)

    def to(self, device) -> "GibbsLayout":
        return GibbsLayout([p.to(device) for p in self.parts], self.M,
                           self.n_reads, self.n_noise_fixed)


def scale_conprbs(hits, log_conprb: np.ndarray, log_ncp: np.ndarray):
    """Per-read max-logit scaling of the frozen conprbs (f64, then f32):
    (cps [H], ncs [N]), as the JAX package's pallas_round.scale_conprbs."""
    N = hits.n_reads
    offs = hits.read_offsets.astype(np.int64)
    nh = np.diff(offs)
    log_conprb = np.asarray(log_conprb, dtype=np.float64)
    log_ncp = np.asarray(log_ncp, dtype=np.float64)
    # over the reads with hits only: reduceat would read a neighbour at an
    # empty read, and refuses the start H of one at the end
    read_max = np.full(N, -np.inf)
    full = nh > 0
    if full.any():
        read_max[full] = np.maximum.reduceat(log_conprb, offs[:-1][full])
    read_max = np.maximum(read_max, log_ncp)
    safe_max = np.where(np.isfinite(read_max), read_max, 0.0)
    with np.errstate(invalid="ignore", over="ignore"):
        cps = np.exp(log_conprb - np.repeat(safe_max, nh)).astype(np.float32)
        ncs = np.exp(log_ncp - safe_max).astype(np.float32)
    cps[~np.isfinite(log_conprb)] = 0.0
    ncs[~np.isfinite(log_ncp)] = 0.0
    return cps, ncs


def _mul64(hi: torch.Tensor, lo: torch.Tensor, m: int):
    """(hi, lo) * m mod 2^64 on the 32-bit halves of a uint64 (int64
    tensors < 2^32 each), without an int64 product over 2^62: lo * m's low
    half and carry from 16-bit pieces, the cross terms through _mul32."""
    b1, b0 = (m >> 16) & 0xFFFF, m & 0xFFFF
    a1, a0 = lo >> 16, lo & 0xFFFF
    low = ((a1 * b0 + a0 * b1) << 16) + a0 * b0  # < 2^50
    carry = a1 * b1 + (low >> 32)
    return ((carry + _mul32(lo, m >> 32) + _mul32(hi, m & MASK32)) & MASK32,
            low & MASK32)


def _xor_shr64(hi: torch.Tensor, lo: torch.Tensor, s: int):
    """(hi, lo) ^ ((hi, lo) >> s), logical, for 0 < s < 32."""
    return hi ^ (hi >> s), lo ^ (((lo >> s) | (hi << (32 - s))) & MASK32)


def mix64(x: torch.Tensor):
    """splitmix64's finaliser of int64 x in [0, 2^32) as uint64 arithmetic,
    returned as its (high, low) 32-bit halves."""
    hi, lo = _xor_shr64(torch.zeros_like(x), x, 30)
    hi, lo = _mul64(hi, lo, 0xBF58476D1CE4E5B9)
    hi, lo = _xor_shr64(hi, lo, 27)
    hi, lo = _mul64(hi, lo, 0x94D049BB133111EB)
    return _xor_shr64(hi, lo, 31)


def tiles_for(n_b: int, K: int, n_placed: int, n_blocks: int) -> int:
    """Tiles of a bucket of n_b reads of width K among n_placed reads: as
    many as its reads fill, and at least its share of n_blocks (ceil'd, at
    most one a read), so that no read samples against counts more than
    ~n_placed / n_blocks reads stale."""
    return max(-(-n_b // (TILE_SLOTS // K)),
               min(n_b, -(-(n_blocks * n_b) // max(n_placed, 1))))


def _hits_on(hits, device) -> HitsDevice:
    """`hits` on `device`: a HitsDevice as it is, an io.HitArrays through
    the EM's cached upload (HitsDevice.from_arrays), or a view with only
    sid and read_offsets (io/ofg.gibbs_inputs_from_ofg) uploaded with its
    read ids made on the device."""
    if isinstance(hits, HitsDevice):
        return hits
    if isinstance(hits, HitArrays):
        return HitsDevice.from_arrays(hits, device)
    offs = torch.as_tensor(np.asarray(hits.read_offsets)).to(
        device, torch.int64)
    H, N = int(len(hits.sid)), len(offs) - 1
    rid = torch.repeat_interleave(
        torch.arange(N, dtype=torch.int32, device=device), offs.diff(),
        output_size=H)
    return HitsDevice(rid=rid, sid=torch.as_tensor(np.asarray(hits.sid)).to(
        device, torch.int32), dir=None, pos=None, insert_len=None,
        read_offsets=offs)


def build_layout(hits, log_conprb, log_ncp, M: int, device=None,
                 n_blocks: int = 32) -> GibbsLayout:
    """The layout from the frozen conprbs (the .ofg content,
    EM.cpp:435-457 / Gibbs.cpp:101-137), built with torch ops on `device`
    (default: the CPU, or where a HitsDevice `hits` lies), from the EM's
    cached upload of the hits. One part per bucket width; reads sorted by
    (smallest kept sid, a hash of the kept-sid multiset) and dealt
    round-robin over the part's `tiles_for` tiles. Only per-bucket sizes
    come back to the host. log_conprb [H] / log_ncp [N]: host arrays or
    tensors (f64 on the device, as the EM's scaling)."""
    if n_blocks < 1:
        raise ValueError(f"n_blocks must be >= 1, not {n_blocks}")
    if isinstance(hits, HitsDevice):
        device = hits.sid.device
    hd = _hits_on(hits, torch.device("cpu" if device is None else device))
    dev = hd.sid.device
    N, H = hd.n_reads, int(hd.sid.shape[0])
    f64 = dict(dtype=torch.float64, device=dev)
    i64 = dict(dtype=torch.int64, device=dev)
    lcp = torch.as_tensor(log_conprb, **f64)
    scaled = scale_device(hd, lcp, torch.as_tensor(log_ncp, **f64), M, 0.0)
    cps, ncs = scaled.cps, scaled.ncs
    rid, sid = hd.rid.long(), hd.sid.long()
    keep = torch.isfinite(lcp)
    n_slots = torch.zeros(N, **i64).index_add_(0, rid, keep.long())
    included = n_slots > 0
    # sort key: a read's smallest kept sid, then the high 32 bits of an
    # order-free hash (the uint64 sum of splitmix64 of its kept sids);
    # reads of one multiset share it, so the sort puts them next to each
    # other (and a gene's reads near each other). Integer sums: exact in
    # any order. sids < 2^31 are exact in f64, whose amin every device has
    s_min = torch.full((N,), float("inf"), **f64).scatter_reduce_(
        0, rid, torch.where(keep, sid.double(), float("inf")), "amin")
    s_min = torch.where(included, s_min, 0.0).long()
    m_hi, m_lo = mix64(sid)
    zero = torch.zeros((), **i64)
    h_hi = torch.zeros(N, **i64).index_add_(0, rid, torch.where(keep, m_hi,
                                                                zero))
    h_lo = torch.zeros(N, **i64).index_add_(0, rid, torch.where(keep, m_lo,
                                                                zero))
    key = (s_min << 32) | ((h_hi + (h_lo >> 32)) & MASK32)

    # bucket b < WIDE holds the reads of 2^(b-1) < kept slots <= 2^b, WIDE
    # those wider than a tile, WIDE + 1 those with no kept slot. Their
    # read and slot counts are the one read back to the host.
    WIDE = TILE_SLOTS.bit_length()
    sizes = 2 ** torch.arange(WIDE, **i64)
    bucket = torch.where(included, torch.searchsorted(sizes, n_slots),
                         WIDE + 1)
    per = torch.zeros((2, WIDE + 2), **i64)
    per[0].index_add_(0, bucket, torch.ones_like(bucket))
    per[1].index_add_(0, bucket, n_slots)
    n_of, slots_of = per.tolist()
    if n_of[WIDE]:
        raise ValueError(f"a read has {int(n_slots.max())} kept alignments; "
                         f"at most {TILE_SLOTS} fit a Gibbs tile")
    n_placed = N - n_of[WIDE + 1]
    # reads by bucket, then key, then read index (two stable sorts)
    order = torch.sort(key, stable=True).indices
    order = order[torch.sort(bucket[order], stable=True).indices]
    # the kept hits in hit order: keep_pos[kept_start[r] + i] is read r's
    # i-th kept hit (dropped hits scatter to one spare slot)
    n_kept = sum(slots_of[:WIDE])
    keep_pos = torch.zeros(n_kept + 1, **i64).scatter_(
        0, torch.where(keep, torch.cumsum(keep, 0) - 1, n_kept),
        torch.arange(H, **i64))
    kept_start = torch.cumsum(n_slots, 0) - n_slots

    parts: List[GibbsPart] = []
    start = 0
    for bi in range(WIDE):
        n_k, tot = n_of[bi], slots_of[bi]
        if n_k == 0:
            continue
        K = 1 << bi
        rsel = order[start:start + n_k]
        start += n_k
        rpt = TILE_SLOTS // K
        n_tiles = tiles_for(n_k, K, n_placed, n_blocks)
        # read j of the order: tile j mod n_tiles, (j div n_tiles)-th in it
        j = torch.arange(n_k, **i64)
        row = (j % n_tiles) * rpt + j // n_tiles
        nh_sel = n_slots[rsel]
        first = torch.repeat_interleave(torch.cumsum(nh_sel, 0) - nh_sel,
                                        nh_sel, output_size=tot)
        cols = torch.arange(tot, **i64) - first
        rows_idx = torch.repeat_interleave(row, nh_sel, output_size=tot)
        src = keep_pos[torch.repeat_interleave(
            kept_start[rsel], nh_sel, output_size=tot) + cols]
        sid_m = torch.zeros((n_tiles * rpt, K), dtype=torch.int32,
                            device=dev)
        cps_m = torch.zeros((n_tiles * rpt, K), dtype=torch.float32,
                            device=dev)
        ncs_m = torch.zeros(n_tiles * rpt, dtype=torch.float32, device=dev)
        sid_m[rows_idx, cols] = hd.sid[src]
        cps_m[rows_idx, cols] = cps[src]
        ncs_m[row] = ncs[rsel]
        fill = np.full(n_tiles, n_k // n_tiles, dtype=np.int64)
        fill[:n_k % n_tiles] += 1
        parts.append(GibbsPart(sid=sid_m.view(-1), cps=cps_m.view(-1),
                               ncs=ncs_m, K=K, n_tiles=n_tiles, fill=fill))
    return GibbsLayout(parts, M, n_placed, N - n_placed)


# ------------------------------------------------------------------ #
# counter-hash uniforms (pallas_gibbs.py:287-297, 440-460)           #
# ------------------------------------------------------------------ #
def _mul32(h: torch.Tensor, m: int) -> torch.Tensor:
    """(h * m) mod 2^32 for int64 h < 2^32, without leaving int64."""
    return (h * (m & 0xFFFF) + (((h * (m >> 16)) & 0xFFFF) << 16)) & MASK32


def mix32(h: torch.Tensor) -> torch.Tensor:
    """murmur3 fmix32 on int64 tensors holding uint32 values."""
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul32(h, 0xC2B2AE35)
    return h ^ (h >> 16)


def part_seed(seed: int, part_index: int) -> int:
    """uint32 seed of part `part_index` (engine/gibbs.py:354-361)."""
    return (int(seed) * 2654435761 + (part_index + 1) * 40503) & MASK32


def tile_hashes(seed_part: int, sweep: int, tiles: torch.Tensor
                ) -> torch.Tensor:
    """The hash h of (part seed, sweep, tile) for each tile index of the
    int64 tensor `tiles` (values < 2^31)."""
    base = (seed_part + sweep * GOLDEN) & MASK32
    return mix32((base + tiles * TILE_MUL) & MASK32)


def key_uniforms(k: torch.Tensor) -> torch.Tensor:
    """f32 uniforms in [0, 1) (24 random bits) of the int64 counter keys
    k, taken mod 2^32."""
    bits = (mix32(mix32(k & MASK32)) >> 7) & 0xFFFFFF
    return bits.to(torch.float32) * (1.0 / (1 << 24))


def tile_uniforms(seed_part: int, sweep: int, tiles: range, C: int, K: int,
                  n: int, device=None, chain0: int = 0) -> torch.Tensor:
    """[len(tiles), C, n] f32: the uniform (24 random bits) of each of the
    first n reads of every tile in `tiles`, keyed h + (c*64 + row)*128 +
    lane at the read's first slot, h the hash of (part seed, sweep, tile),
    c = chain0 + the local chain index (the global chain of a rank that
    holds chains from chain0 on)."""
    h = tile_hashes(seed_part, sweep, torch.arange(
        tiles.start, tiles.stop, tiles.step, dtype=torch.int64,
        device=device))
    c = torch.arange(chain0, chain0 + C, dtype=torch.int64, device=device)
    r = torch.arange(n, dtype=torch.int64, device=device)
    return key_uniforms(h[:, None, None] + c[None, :, None] * TILE_SLOTS
                        + r[None, None, :] * K)


def read_uniforms(seed_part: int, sweep: int, tile: int, C: int, K: int,
                  device=None, chain0: int = 0) -> torch.Tensor:
    """[C, TILE_SLOTS // K] f32: tile_uniforms of every read of one tile."""
    return tile_uniforms(seed_part, sweep, range(tile, tile + 1), C, K,
                         TILE_SLOTS // K, device, chain0)[0]


# ------------------------------------------------------------------ #
# group reductions in the TPU kernel's order (pallas_gibbs.py:313-368)
# ------------------------------------------------------------------ #
def _group_sum(w: torch.Tensor) -> torch.Tensor:
    """XOR-butterfly sum over the last axis (K slots): x + x[j ^ s] for
    s = 1, 2, ..., K/2 — the pairwise tree of the TPU's lane-then-row
    butterfly. Every slot ends with the same value."""
    K = w.shape[-1]
    j = torch.arange(K, device=w.device)
    s = 1
    while s < K:
        w = w + w.index_select(-1, j ^ s)
        s *= 2
    return w


def _hillis_steele(x: torch.Tensor, width: int) -> torch.Tensor:
    """Inclusive Hillis-Steele prefix over the last axis of length width."""
    j = torch.arange(width, device=x.device)
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    s = 1
    while s < width:
        sh = x.index_select(-1, (j - s).clamp(min=0))
        x = x + torch.where(j >= s, sh, zero)
        s *= 2
    return x


def _group_prefix(w: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix over the last axis (K slots) in the TPU order:
    Hillis-Steele within each 128-slot row, then (K > 128) a Hillis-Steele
    over the row totals, added back as (acc - row total)."""
    K = w.shape[-1]
    if K <= LANES:
        return _hillis_steele(w, K)
    shape = w.shape
    x = _hillis_steele(w.reshape(*shape[:-1], K // LANES, LANES), LANES)
    rt = x[..., LANES - 1:]  # [..., rows, 1]
    acc = _hillis_steele(rt.transpose(-1, -2), K // LANES).transpose(-1, -2)
    return (x + (acc - rt)).reshape(shape)


# ------------------------------------------------------------------ #
# the sweep                                                          #
# ------------------------------------------------------------------ #
def _check_state(assign: torch.Tensor, table: torch.Tensor,
                 part: GibbsPart, scratch: Optional[torch.Tensor]) -> None:
    if assign.dtype != torch.int32 or assign.dim() != 2 or \
            not assign.is_contiguous():
        raise ValueError("assign must be a contiguous [C, n_reads] int32")
    if assign.shape[1] != part.n_reads:
        raise ValueError(f"assign has {assign.shape[1]} reads, the part "
                         f"{part.n_reads}")
    if table.dtype != torch.float32 or table.dim() != 2 or \
            not table.is_contiguous() or table.shape[0] != assign.shape[0]:
        raise ValueError("table must be a contiguous [C, M+1] float32")
    if scratch is not None and (
            scratch.dtype != torch.int32 or scratch.shape != table.shape or
            not scratch.is_contiguous()):
        raise ValueError("scratch must be a contiguous int32 of the table's "
                         "shape")
    for t in (table, part.sid, part.cps, part.ncs, scratch):
        if t is not None and t.device != assign.device:
            raise ValueError("assign, table, scratch and the part must share "
                             "a device")


def sweep_part_plain(assign: torch.Tensor, table: torch.Tensor,
                     part: GibbsPart, seed_part: int, sweep: int,
                     chain0: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of K5: vectorised over the filled reads of a
    tile and the chains, looping over tiles. A padding read (cps 0, ncs 0,
    assignment -1) never moves and adds no delta, so skipping it changes no
    bit of what the kernel computes. Updates assign and table in place."""
    C = assign.shape[0]
    K, rpt = part.K, part.reads_per_tile
    dev = table.device
    j = torch.arange(K, device=dev)
    minus1 = torch.full((), -1, dtype=torch.int64, device=dev)
    n_u = int(part.fill.max()) if part.n_tiles else 0
    chunk = max(1, UNIFORM_BATCH // max(C * n_u, 1))  # tiles per batch
    for t in range(part.n_tiles):
        if t % chunk == 0:
            us = tile_uniforms(seed_part, sweep, range(
                t, min(t + chunk, part.n_tiles)), C, K, n_u, dev, chain0)
        f = int(part.fill[t])
        if f == 0:
            continue
        s0, r0 = t * TILE_SLOTS, t * rpt
        sid = part.sid[s0:s0 + f * K].long().view(f, K)
        cps = part.cps[s0:s0 + f * K].view(f, K)
        ncs = part.ncs[r0:r0 + f]
        a = assign[:, r0:r0 + f].long()  # [C, f]
        has = a >= 0
        sid_c = sid.expand(C, f, K)
        cur = sid_c.gather(2, a.clamp(min=0)[..., None])[..., 0]
        own = ((sid_c == cur[..., None]) & has[..., None]).to(torch.float32)
        cg = table.gather(1, sid.reshape(1, -1).expand(C, -1)).view(C, f, K)
        w = (cg - own).clamp_min(0.0) * cps
        own0 = 1.0 - has.to(torch.float32)
        w0 = (table[:, :1] - own0).clamp_min(0.0) * ncs  # [C, f]
        tot = _group_sum(w)[..., 0]
        pre = _group_prefix(w)
        u = us[t % chunk, :, :f]
        target = u * (tot + w0)
        pick_noise = target < w0
        t2 = target - w0
        lastv = torch.where(w > 0, j, minus1).amax(-1)
        chosen = torch.where(pre > t2[..., None], j, lastv[..., None]).amin(
            -1)
        new = torch.where(~pick_noise & (chosen >= 0), chosen, minus1)
        # the tile's deltas: summed per sid first (integers, exact), then
        # one add per table entry, as the TPU's one-hot contraction does
        moved = new != a
        net = torch.zeros(table.shape, dtype=torch.int64, device=dev)
        old_on = moved & has
        new_on = moved & (new >= 0)
        net.scatter_add_(1, cur, -old_on.long())
        net.scatter_add_(1, sid_c.gather(2, new.clamp(min=0)[..., None])[
            ..., 0], new_on.long())
        table += net.to(torch.float32)
        dn = new_on.long().sum(1) - old_on.long().sum(1)
        table[:, 0] -= dn.to(torch.float32)
        assign[:, r0:r0 + f] = new.to(torch.int32)
    return assign, table


def delta_scratch(table: torch.Tensor) -> torch.Tensor:
    """The zeroed int32 scratch in which K5 sums a tile's deltas per sid,
    of the table's shape and device. The kernel leaves it zero, so one
    scratch serves every sweep of that table in stream order; run_chains
    allocates one per run."""
    return torch.zeros(table.shape, dtype=torch.int32, device=table.device)


def sweep_part(assign: torch.Tensor, table: torch.Tensor, part: GibbsPart,
               seed_part: int, sweep: int,
               scratch: Optional[torch.Tensor] = None, chain0: int = 0
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One sweep over a part's tiles for every chain (K5), IN PLACE.

    assign: [C, part.n_reads] int32 slot of each read (-1 = noise);
    table: [C, M+1] f32 counts + pseudo-counts (index 0 = noise);
    seed_part: uint32 part seed; sweep: global sweep index; scratch:
    delta_scratch(table), reused across sweeps (None: one for this call);
    chain0: the global index of chain 0 (the uniforms' chain key: a rank
    holding chains 4-7 of 8 passes 4 and draws as they would in one run).
    The plain version, which needs no scratch, runs on CPU tensors."""
    _check_state(assign, table, part, scratch)
    if chain0 < 0:
        raise ValueError(f"chain0 must be >= 0, not {chain0}")
    if assign.device.type == "cpu":
        return sweep_part_plain(assign, table, part, seed_part, sweep,
                                chain0)
    if assign.device.type != "cuda":
        raise ValueError(f"unsupported device {assign.device}")
    for name, t in (("sid", part.sid), ("cps", part.cps), ("ncs", part.ncs),
                    ("assign", assign)):
        if t.data_ptr() % 16:
            raise ValueError(f"K5 needs a 16-byte-aligned {name}")
    if scratch is None:
        scratch = delta_scratch(table)
    C, T = table.shape
    _build.check(_build.lib().rsem_gibbs_sweep(
        part.sid.data_ptr(), part.cps.data_ptr(), part.ncs.data_ptr(),
        assign.data_ptr(), table.data_ptr(), scratch.data_ptr(),
        part.n_tiles, part.K.bit_length() - 1, C, assign.shape[1], T,
        seed_part & MASK32, sweep & MASK32, chain0 & MASK32,
        _build.stream_of(table)),
        "gibbs_sweep")
    sweep_part.launches += 1
    return assign, table


sweep_part.launches = 0


# ------------------------------------------------------------------ #
# chain initialisation (pallas_gibbs.py:568-632)                     #
# ------------------------------------------------------------------ #
def init_chains(layout: GibbsLayout, table_base: torch.Tensor,
                n_chains: int, seed: int, device=None,
                chains: Optional[slice] = None
                ) -> Tuple[List[torch.Tensor], torch.Tensor]:
    """Initial assignments z ~ conprb by CDF inversion over [noise, slots]
    (Gibbs.cpp:281-291) for every filled read (padding reads stay -1), plus
    the chains' count tables, computed on the layout's device.

    Each read's uniform is K5's counter hash keyed on (part seed, sweep
    INIT_SWEEP, tile, global chain, read), and its slot is K5's pick with
    the count factor taken out (w = cps, w0 = ncs; the same group sums,
    prefix, noise and last-positive rules), all in f32 in a fixed order
    with separate ops, so the CPU and the card start from the same state
    bit for bit. A read with no positive weight stays on noise (-1) and is
    not counted; the other reads off a hit count on entry 0.
    table_base: [M+1] f32 = init counts + pseudo, with [0] += N0 +
    n_noise_fixed. Returns (assign per part [C, n_reads] int32, tables
    [C, M+1] f32), on `device` (default: the layout's); with `chains`, only
    those chains of n_chains are drawn, as they would be in a whole run."""
    idx = range(n_chains)[chains if chains is not None else slice(None)]
    dev = (layout.parts[0].sid.device if layout.parts
           else torch.device("cpu" if device is None else device))
    C = len(idx)
    counts = torch.zeros((C, table_base.shape[0]), dtype=torch.int64,
                         device=dev)
    assigns = []
    for pi, part in enumerate(layout.parts):
        K = part.K
        rows = part.filled_reads()
        sid = part.sid.view(-1, K)[rows].long()
        w = part.cps.view(-1, K)[rows]
        w0 = part.ncs[rows]
        j = torch.arange(K, device=dev)
        den = _group_sum(w)[:, 0] + w0
        pre = _group_prefix(w)
        lastv = torch.where(w > 0, j, -1).amax(-1, keepdim=True)
        n_valid = ((w0 > 0) | (w > 0).any(1)).sum()
        key = (tile_hashes(part_seed(seed, pi), INIT_SWEEP,
                           rows // part.reads_per_tile)
               + (rows % part.reads_per_tile) * K)
        full = torch.full((C, part.n_reads), -1, dtype=torch.int32,
                          device=dev)
        for ci, c in enumerate(idx):
            target = key_uniforms(key + c * TILE_SLOTS) * den
            t2 = target - w0
            chosen = torch.where(pre > t2[:, None], j, lastv).amin(-1)
            new = torch.where((target >= w0) & (chosen >= 0), chosen, -1)
            full[ci, rows] = new.to(torch.int32)
            on = new >= 0
            counts[ci].index_add_(0, sid.gather(1, new.clamp(min=0)[:, None])
                                  [:, 0], on.long())
            counts[ci, 0] += n_valid - on.sum()
        assigns.append(full)
    tables = table_base.to(dev)[None, :] + counts.to(torch.float32)
    if device is not None:
        assigns = [a.to(device) for a in assigns]
        tables = tables.to(device)
    return assigns, tables
