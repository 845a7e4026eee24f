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

from . import _build

TILE_ROWS = 64
LANES = 128
TILE_SLOTS = TILE_ROWS * LANES  # slots per tile
MASK32 = 0xFFFFFFFF
GOLDEN = 0x9E3779B9  # sweep multiplier of the counter hash
TILE_MUL = 0x7F4A7C15  # tile multiplier of the counter hash
UNIFORM_BATCH = 1 << 22  # uniforms the plain sweep draws per batch of tiles


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

    def filled_reads(self) -> np.ndarray:
        """Indices of the filled reads among the part's n_reads, tile by
        tile."""
        starts = np.repeat(np.arange(self.n_tiles) * self.reads_per_tile,
                           self.fill)
        first = np.repeat(np.cumsum(self.fill) - self.fill, self.fill)
        return starts + np.arange(self.n_real) - first

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


def _per_read(ufunc, values: np.ndarray, offs: np.ndarray, empty):
    """ufunc reduced over each read's hits; `empty` for reads without any
    (reduceat would read a neighbour there, and refuses a start of H)."""
    out = np.full(len(offs) - 1, empty, dtype=values.dtype)
    full = np.diff(offs) > 0
    if full.any():
        out[full] = ufunc.reduceat(values, offs[:-1][full])
    return out


def _mix64(x: np.ndarray) -> np.ndarray:
    """splitmix64's finaliser on uint64 (wrap-around arithmetic)."""
    x = x.astype(np.uint64)
    x = (x ^ (x >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
    x = (x ^ (x >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    return x ^ (x >> np.uint64(31))


def tiles_for(n_b: int, K: int, n_placed: int, n_blocks: int) -> int:
    """Tiles of a bucket of n_b reads of width K among n_placed reads: as
    many as its reads fill, and at least its share of n_blocks (ceil'd, at
    most one a read), so that no read samples against counts more than
    ~n_placed / n_blocks reads stale."""
    return max(-(-n_b // (TILE_SLOTS // K)),
               min(n_b, -(-(n_blocks * n_b) // max(n_placed, 1))))


def build_layout(hits, log_conprb: np.ndarray, log_ncp: np.ndarray,
                 M: int, device=None, n_blocks: int = 32) -> GibbsLayout:
    """Host-side layout from the frozen conprbs (the .ofg content,
    EM.cpp:435-457 / Gibbs.cpp:101-137); tensors end on `device`. One part
    per bucket width; reads sorted by (smallest kept sid, a hash of the
    kept-sid multiset) and dealt round-robin over the part's `tiles_for`
    tiles."""
    if n_blocks < 1:
        raise ValueError(f"n_blocks must be >= 1, not {n_blocks}")
    N = hits.n_reads
    offs = hits.read_offsets.astype(np.int64)
    sid = hits.sid.astype(np.int64)
    cps, ncs = scale_conprbs(hits, log_conprb, log_ncp)
    keep = np.isfinite(np.asarray(log_conprb, dtype=np.float64))
    n_slots = _per_read(np.add, keep.astype(np.int64), offs, 0)
    included = n_slots > 0
    n_placed = int(included.sum())
    # sort key: a read's smallest kept sid, then 32 bits of an order-free
    # hash of its kept-sid multiset; reads of one multiset share it, so
    # the sort puts them next to each other (and a gene's reads near each
    # other)
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
    if sizes[-1] > TILE_SLOTS:
        raise ValueError(f"a read has {mx} kept alignments; at most "
                         f"{TILE_SLOTS} fit a Gibbs tile")
    bucket_of = np.searchsorted(np.asarray(sizes), n_slots)
    keep_pos = np.flatnonzero(keep)
    kept_offs = np.concatenate([[0], np.cumsum(n_slots)])

    parts: List[GibbsPart] = []
    for bi, K in enumerate(sizes):
        rsel = np.flatnonzero(included & (bucket_of == bi))
        if len(rsel) == 0:
            continue
        rsel = rsel[np.argsort(key[rsel], kind="stable")]
        n_k = len(rsel)
        rpt = TILE_SLOTS // K
        n_tiles = tiles_for(n_k, K, n_placed, n_blocks)
        # read j of the order: tile j mod n_tiles, (j div n_tiles)-th in it
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
        parts.append(GibbsPart(
            sid=torch.as_tensor(sid_m.reshape(-1)).to(device),
            cps=torch.as_tensor(cps_m.reshape(-1)).to(device),
            ncs=torch.as_tensor(ncs_m).to(device), K=K, n_tiles=n_tiles,
            fill=np.bincount(j % n_tiles, minlength=n_tiles)))
    return GibbsLayout(parts, M, n_placed, int(N - n_placed))


# ------------------------------------------------------------------ #
# counter-hash uniforms (pallas_gibbs.py:287-297, 440-460)           #
# ------------------------------------------------------------------ #
def mix32_int(h: int) -> int:
    """murmur3 fmix32 on a Python int (mod 2^32, logical shifts)."""
    h &= MASK32
    h ^= h >> 16
    h = (h * 0x85EBCA6B) & MASK32
    h ^= h >> 13
    h = (h * 0xC2B2AE35) & MASK32
    h ^= h >> 16
    return h


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


def tile_uniforms(seed_part: int, sweep: int, tiles: range, C: int, K: int,
                  n: int, device=None, chain0: int = 0) -> torch.Tensor:
    """[len(tiles), C, n] f32: the uniform (24 random bits) of each of the
    first n reads of every tile in `tiles`, keyed h + (c*64 + row)*128 +
    lane at the read's first slot, h the hash of (part seed, sweep, tile),
    c = chain0 + the local chain index (the global chain of a rank that
    holds chains from chain0 on)."""
    h = torch.tensor([mix32_int(seed_part + sweep * GOLDEN + t * TILE_MUL)
                      for t in tiles], dtype=torch.int64, device=device)
    c = torch.arange(chain0, chain0 + C, dtype=torch.int64, device=device)
    r = torch.arange(n, dtype=torch.int64, device=device)
    k = (h[:, None, None] + c[None, :, None] * TILE_SLOTS
         + r[None, None, :] * K) & MASK32
    bits = (mix32(mix32(k)) >> 7) & 0xFFFFFF
    return bits.to(torch.float32) * (1.0 / (1 << 24))


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
    """Initial assignments z ~ conprb (Gibbs.cpp:281-291), a Gumbel-max pick
    over [noise, slots] per filled read (padding reads stay -1), plus the
    chains' count tables.

    The draws come from a CPU torch.Generator seeded with `seed`, so the
    initial state is the same whichever device the chains then run on.
    table_base: [M+1] f32 = init counts + pseudo, with [0] += N0 +
    n_noise_fixed. Returns (assign per part [C, n_reads] int32, tables
    [C, M+1] f32), both on `device`; with `chains`, only those chains'
    rows (all C are drawn all the same, so a rank's slice starts where the
    whole run's chains would)."""
    chains = slice(None) if chains is None else chains
    C = n_chains
    gen = torch.Generator().manual_seed(int(seed))
    counts = torch.zeros((C, table_base.shape[0]), dtype=torch.float64)
    assigns = []
    for part in layout.parts:
        K = part.K
        rows = torch.as_tensor(part.filled_reads())
        n = len(rows)
        cps = part.cps.cpu().view(-1, K)[rows]
        ncs = part.ncs.cpu()[rows]
        logits = torch.cat([ncs[:, None], cps], 1).log()  # 0 -> -inf
        valid = torch.isfinite(logits).any(1)
        u = torch.rand((C, n, K + 1), generator=gen).clamp_min(1e-30)
        pick = (logits - (-u.log()).log()).argmax(2)  # [C, n]
        a = torch.where(valid & (pick > 0), pick - 1,
                        torch.full_like(pick, -1))
        full = torch.full((C, part.n_reads), -1, dtype=torch.int32)
        full[:, rows] = a.to(torch.int32)
        assigns.append(full[chains].contiguous().to(device))
        on = a >= 0
        sids = part.sid.cpu().long().view(-1, K)[rows].expand(C, n, K).gather(
            2, a.clamp(min=0)[..., None])[..., 0]
        counts.scatter_add_(1, sids, on.double())
        counts[:, 0] += float(valid.sum()) - on.sum(1).double()
    tables = table_base.cpu()[None, :] + counts.to(torch.float32)
    return assigns, tables[chains].contiguous().to(device)
