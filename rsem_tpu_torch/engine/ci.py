"""Credibility intervals via Gamma resampling (reference: calcCI.cpp).

Counterpart of rsem_tpu/engine/ci.py.

Phase I (calcCI.cpp:93-164): for each Gibbs count vector, draw nSpC theta
vectors theta_j ~ Gamma(count_j + pseudo, 1)/mw_j, normalise, convert to
TPM and the per-sample mean effective length l_bar. The Gamma draws come
from `torch._standard_gamma` with an explicit generator on the device.

Phase II (calcCI.cpp:218-284): per transcript, the shortest interval over
the sorted nCV*nSpC TPM samples covering ceil(confidence * n) points, plus
the coefficient of quartile variation from Tukey's hinges; FPKM samples are
1e3 / l_bar * TPM; gene intervals use summed sample vectors, and
single-isoform genes copy their isoform's interval (calcCI.cpp:350-357).
With an allele-specific reference (`ta`) the same holds one level down:
transcript intervals from the summed allele samples, and a transcript of
one allele copies its allele's interval.

The [n, M] TPM sample matrix stays on the device (4.0 GB at the defaults,
1000 x 50 samples of M = 20,000); the sort runs in chunks of transcript
columns, and a block of genes (or transcripts) sums its members'
contiguous columns, each group's members added one after another in
column order (segment_reduce). Each chunk of CV_CHUNK count vectors
draws from its own generator, seeded from (seed, the chunk's first row).

Several devices (`dist`, a parallel.distributed process group; the JAX
package's mesh branch, engine/ci.py:151-153,175-180 there): phase I splits
the count vectors by whole chunks over the ranks, phase II the transcript
columns into blocks cut at gene boundaries (and allele-group boundaries
with `ta`), so a group's sums stay on one rank; the samples move by one
all-to-all, and the bounds are gathered on every rank. A chunk's draws
and a column's sort do not depend on the split, so every world size gives
the same bits.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional, Tuple

import numpy as np
import torch
import torch.distributed

from ..constants import EPSILON
from ..parallel.distributed import Dist, gather_rows
from ..utils.device import DeviceLike, resolve_device

CV_CHUNK = 50  # count vectors sampled per chunk (~200 MB of draws at M=20k)
GROUP_BLOCK_BYTES = 1 << 30  # member samples copied at once for group sums


@dataclass
class CIConfig:
    confidence: float = 0.95
    nspc: int = 50  # theta samples per count vector
    pseudo_count: float = 1.0
    seed: int = 0


@dataclass
class CIBounds:
    lb: np.ndarray
    ub: np.ndarray
    cqv: np.ndarray


@dataclass
class CIResult:
    tpm: CIBounds  # [M+1] (index 0 zero)
    fpkm: CIBounds
    gene_tpm: CIBounds  # [m]
    gene_fpkm: CIBounds
    iso_tpm: Optional[CIBounds] = None  # [ta.m], allele mode only
    iso_fpkm: Optional[CIBounds] = None


def sample_tpm_chunk(gen: torch.Generator, cvecs: torch.Tensor,
                     pseudo: float, inv_mw: torch.Tensor, eel: torch.Tensor,
                     eel_ok: torch.Tensor, usable: torch.Tensor, nspc: int):
    """cvecs: [B, M+1] f32 -> (tpm [B*nspc, M], l_bar [B*nspc]); eel_ok:
    [M] eel[1:] >= EPSILON, tested in float64."""
    B, M1 = cvecs.shape
    alpha = (cvecs[:, None, :] + pseudo).clamp_min(1e-6).expand(B, nspc, M1)
    g = torch._standard_gamma(alpha.contiguous(), generator=gen)
    theta = torch.where(usable, g * inv_mw, torch.zeros_like(g))
    theta = theta / theta.sum(2, keepdim=True)
    e = eel[1:]
    tpm = torch.where(eel_ok, theta[:, :, 1:] / e.clamp_min(1e-30),
                      torch.zeros_like(theta[:, :, 1:]))
    tpm = tpm / tpm.sum(2, keepdim=True)
    l_bar = (tpm * e).sum(2)
    tpm = tpm * 1e6
    return tpm.reshape(B * nspc, M1 - 1), l_bar.reshape(B * nspc)


def ci_columns(samples: torch.Tensor, cover: int):
    """Per column of [n, T] samples: the shortest window of `cover` sorted
    points (calcCI.cpp:218-258) and the CQV from Tukey's hinges
    (calcCI.cpp:261-283). Returns (lb, ub, cqv), each [T]."""
    s = torch.sort(samples, dim=0).values
    n = s.shape[0]
    width = s[cover - 1:] - s[:n - cover + 1]
    p = torch.argmin(width, dim=0)
    lb = s.gather(0, p[None])[0]
    ub = s.gather(0, (p + cover - 1)[None])[0]
    q, r = divmod(n, 4)
    if r == 0:
        Q1 = (s[q - 1] + s[q]) / 2.0
        Q3 = (s[3 * q - 1] + s[3 * q]) / 2.0
    elif r == 3:
        Q1 = (s[q] + s[q + 1]) / 2.0
        Q3 = (s[3 * q + 1] + s[3 * q + 2]) / 2.0
    else:
        Q1 = s[q]
        Q3 = s[3 * q]
    cqv = torch.where(Q3 - Q1 > 0.0, (Q3 - Q1) / (Q3 + Q1),
                      torch.zeros_like(Q1))
    return lb, ub, cqv


def _bounds_chunked(get_chunk: Callable[[int, int], torch.Tensor], T: int,
                    n: int, cover: int) -> CIBounds:
    """ci_columns over T columns, `TCH` at a time (the sort's workspace
    stays ~1 GB whatever M is)."""
    tch = max(128, min(4096, (1 << 28) // max(n * 4, 1)))
    lbs, ubs, cqvs = [], [], []
    for lo in range(0, T, tch):
        lb, ub, cqv = ci_columns(get_chunk(lo, min(T, lo + tch)), cover)
        lbs.append(lb.cpu())
        ubs.append(ub.cpu())
        cqvs.append(cqv.cpu())
    cat = lambda xs: (torch.cat(xs).double().numpy() if xs  # noqa: E731
                      else np.zeros(0))
    return CIBounds(cat(lbs), cat(ubs), cat(cqvs))


def group_starts(groups, M: int) -> np.ndarray:
    """The starts of a GroupInfo over sids 1..M, checked: the chunked
    segment sums need every group a non-empty contiguous run of columns."""
    starts = np.asarray(groups.starts, dtype=np.int64)
    if starts[0] != 1 or starts[-1] != M + 1 or (np.diff(starts) < 1).any():
        raise ValueError(f"groups do not tile sids 1..{M} in contiguous, "
                         "non-empty runs")
    return starts


def _segment_sums(rows: torch.Tensor, sizes: np.ndarray) -> torch.Tensor:
    """Sums of the consecutive runs of rows of rows [w, n], sizes[g] rows
    each: [len(sizes), n]. segment_reduce over a leading axis gives each
    output one thread that adds its run's rows to 0 one after another, on
    the card as on the CPU, so every device and every cut of the runs
    gives the same bits (an index_add_ on the card adds in the order its
    atomics land)."""
    return torch.segment_reduce(rows, "sum", axis=0, lengths=torch.as_tensor(
        sizes, dtype=torch.int64, device=rows.device))


def group_bounds(tpm: torch.Tensor, inv_lbar: torch.Tensor, groups,
                 member: CIBounds, member_fpkm: CIBounds, cover: int,
                 c0: int = 0, M: Optional[int] = None):
    """TPM and FPKM intervals of the groups' summed sample columns (genes
    over isoforms, transcripts over alleles); a group of one member copies
    its member's interval exactly (calcCI.cpp:350-357). tpm: [n, w], the
    sample columns c0..c0+w of M (default w) transcripts, cut at group
    boundaries, and member/member_fpkm their intervals; the groups whose
    members lie there get theirs. The members are summed a block of whole
    groups at a time, each block's columns (times inv_lbar for FPKM)
    copied to rows first: GROUP_BLOCK_BYTES of them, or one group."""
    n, w = tpm.shape
    starts = group_starts(groups, w if M is None else M) - 1  # 0-based
    g0, g1 = np.searchsorted(starts, [c0, c0 + w])
    if starts[g0] != c0 or starts[g1] != c0 + w:
        raise ValueError(f"columns {c0}..{c0 + w} cut a group")
    local = starts[g0:g1 + 1] - c0
    cap = GROUP_BLOCK_BYTES // max(4 * n, 1)  # member columns a block

    def bounds(scale) -> CIBounds:
        parts, b0 = [], 0
        while b0 < g1 - g0:
            b1 = max(b0 + 1, int(np.searchsorted(local, local[b0] + cap,
                                                 "right")) - 1)
            cols = tpm[:, local[b0]:local[b1]].T
            rows = torch.empty(cols.shape, dtype=tpm.dtype,
                               device=tpm.device)
            if scale is None:
                rows.copy_(cols)
            else:
                torch.mul(cols, scale.T, out=rows)
            sums = _segment_sums(rows, np.diff(local[b0:b1 + 1]))
            del rows
            parts.append(_bounds_chunked(lambda lo, hi: sums[lo:hi].T,
                                         b1 - b0, n, cover))
            del sums
            b0 = b1
        return CIBounds(*(np.concatenate([getattr(p, f) for p in parts]
                                         + [np.zeros(0)])
                          for f in ("lb", "ub", "cqv")))

    g_tpm = bounds(None)
    g_fpkm = bounds(inv_lbar)
    single = np.diff(local) == 1
    first = local[:-1][single]  # member index in the block
    for b_group, b_member in ((g_tpm, member), (g_fpkm, member_fpkm)):
        for f in ("lb", "ub", "cqv"):
            getattr(b_group, f)[single] = getattr(b_member, f)[first]
    return g_tpm, g_fpkm


def chunk_seed(seed: int, lo: int) -> int:
    """Seed of the Gamma draws of the count-vector chunk that starts at row
    lo: keyed on (seed, lo), so a chunk draws the same numbers whichever
    rank samples it and however many ranks there are."""
    ss = np.random.SeedSequence([int(seed), int(lo)])
    return int(ss.generate_state(1, np.uint64)[0] >> np.uint64(1))


def row_cuts(nCV: int, world: int) -> np.ndarray:
    """[world+1] count-vector rows of each rank in phase I: whole chunks of
    CV_CHUNK, as evenly as they go."""
    n_chunks = -(-nCV // CV_CHUNK)
    cuts = (np.arange(world + 1) * n_chunks) // world * CV_CHUNK
    return np.minimum(cuts, nCV)


def column_cuts(M: int, world: int, groupings) -> np.ndarray:
    """[world+1] transcript-column cuts of each rank in phase II, as even
    as the boundaries of every grouping (genes; allele groups) allow, so
    that a group's sums stay on one rank."""
    allowed = np.arange(M + 1)
    for g in groupings:
        allowed = np.intersect1d(allowed, group_starts(g, M) - 1)
    targets = (np.arange(world + 1) * M) // world
    return allowed[np.searchsorted(allowed, targets)]


def _gather_bounds(bounds: Tuple[CIBounds, ...], sizes, dist: Dist
                   ) -> Tuple[CIBounds, ...]:
    """Every rank's CIBounds of one level (its `sizes[rank]` entries),
    concatenated in rank order, on every rank."""
    local = torch.as_tensor(np.stack(
        [getattr(b, f) for b in bounds for f in ("lb", "ub", "cqv")], 1))
    full = gather_rows(local.to(dist.device), sizes, dist).cpu().numpy()
    return tuple(CIBounds(*(full[:, 3 * i + j] for j in range(3)))
                 for i in range(len(bounds)))


def run_ci(
    countvectors,  # [nCV, M+1] (Gibbs retained samples; tensor or array)
    eel: np.ndarray,
    mw: np.ndarray,
    gi,
    cfg: CIConfig,
    device: DeviceLike = None,
    ta=None,
    dist: Optional[Dist] = None,
) -> CIResult:
    """gi: gene GroupInfo; ta: transcript -> allele GroupInfo of an
    allele-specific reference (adds iso_tpm / iso_fpkm, the transcript
    intervals). Runs on CUDA unless device="cpu" is given. dist: the
    process group (every rank passes all count vectors and runs on
    dist.device): phase I splits the count vectors by whole chunks, phase
    II the transcript columns at gene (and allele-group) boundaries, the
    samples move by one all-to-all, and every rank returns all bounds,
    the same as one process would."""
    dev = dist.device if dist is not None else resolve_device(device)
    cvs = torch.as_tensor(countvectors).to(device=dev, dtype=torch.float32)
    nCV, M1 = cvs.shape
    M = M1 - 1
    n = nCV * cfg.nspc
    cover = int(cfg.confidence * n - 1e-8) + 1
    # EPSILON tests in float64 on the host, as the reference's (the JAX
    # package's float32 tests let eel = 0 or mw = 0 through)
    eel = np.asarray(eel, dtype=np.float64)
    mw = np.asarray(mw, dtype=np.float64)
    eel_ok = torch.as_tensor(eel[1:] >= EPSILON, device=dev)
    mw_ok = torch.as_tensor(mw >= EPSILON, device=dev)
    eel_d = torch.as_tensor(eel, dtype=torch.float32, device=dev)
    mw_d = torch.as_tensor(mw, dtype=torch.float32, device=dev)
    usable = torch.cat([
        torch.ones(1, dtype=torch.bool, device=dev),
        (cvs[0, 1:] >= 0) & eel_ok & mw_ok[1:]])
    inv_mw = torch.where(mw_ok, 1.0 / mw_d.clamp_min(1e-30),
                         torch.zeros_like(mw_d))
    world, rank = (dist.world, dist.rank) if dist is not None else (1, 0)
    groupings = [gi] + ([ta] if ta is not None else [])

    # ---- Phase I: this rank's rows of the TPM sample matrix [n, M] ----
    rows = row_cuts(nCV, world)
    r0, r1 = int(rows[rank]), int(rows[rank + 1])
    tpm = torch.empty(((r1 - r0) * cfg.nspc, M), dtype=torch.float32,
                      device=dev)
    l_bar = torch.empty((r1 - r0) * cfg.nspc, dtype=torch.float32,
                        device=dev)
    for lo in range(r0, r1, CV_CHUNK):
        hi = min(r1, lo + CV_CHUNK)
        gen = torch.Generator(device=dev).manual_seed(chunk_seed(cfg.seed,
                                                                 lo))
        t, lb = sample_tpm_chunk(gen, cvs[lo:hi], cfg.pseudo_count, inv_mw,
                                 eel_d, eel_ok, usable, cfg.nspc)
        tpm[(lo - r0) * cfg.nspc:(hi - r0) * cfg.nspc] = t
        l_bar[(lo - r0) * cfg.nspc:(hi - r0) * cfg.nspc] = lb
        del t, lb

    # ---- all samples of this rank's transcript columns ----
    cols = column_cuts(M, world, groupings)
    c0, c1 = int(cols[rank]), int(cols[rank + 1])
    if dist is not None:
        n_rows = np.diff(rows) * cfg.nspc
        width = np.diff(cols)
        send = torch.cat([tpm[:, cols[q]:cols[q + 1]].reshape(-1)
                          for q in range(world)])
        del tpm
        block = torch.empty(n * (c1 - c0), dtype=torch.float32, device=dev)
        torch.distributed.all_to_all_single(
            block, send, (n_rows * (c1 - c0)).tolist(),
            (width * (r1 - r0) * cfg.nspc).tolist(), group=dist.group)
        del send
        tpm = block.view(n, c1 - c0)
        l_bar = gather_rows(l_bar, n_rows.tolist(), dist)
    inv_lbar = (1e3 / l_bar)[:, None]

    # ---- Phase II on those columns ----
    iso_tpm = _bounds_chunked(lambda lo, hi: tpm[:, lo:hi], c1 - c0, n,
                              cover)
    iso_fpkm = _bounds_chunked(lambda lo, hi: tpm[:, lo:hi] * inv_lbar,
                               c1 - c0, n, cover)
    gene_tpm, gene_fpkm = group_bounds(tpm, inv_lbar, gi, iso_tpm, iso_fpkm,
                                       cover, c0, M)
    trans = (None, None) if ta is None else group_bounds(
        tpm, inv_lbar, ta, iso_tpm, iso_fpkm, cover, c0, M)
    if dist is not None:
        def sizes(g):
            return np.diff(np.searchsorted(group_starts(g, M) - 1,
                                           cols)).tolist()

        iso_tpm, iso_fpkm = _gather_bounds((iso_tpm, iso_fpkm),
                                           np.diff(cols).tolist(), dist)
        gene_tpm, gene_fpkm = _gather_bounds((gene_tpm, gene_fpkm),
                                             sizes(gi), dist)
        if ta is not None:
            trans = _gather_bounds(trans, sizes(ta), dist)

    def with_zero(b: CIBounds) -> CIBounds:
        z = np.zeros(1)
        return CIBounds(np.concatenate([z, b.lb]), np.concatenate([z, b.ub]),
                        np.concatenate([z, b.cqv]))

    return CIResult(tpm=with_zero(iso_tpm), fpkm=with_zero(iso_fpkm),
                    gene_tpm=gene_tpm, gene_fpkm=gene_fpkm,
                    iso_tpm=trans[0], iso_fpkm=trans[1])
