"""Collapsed Gibbs sampler over read assignments (reference: Gibbs.cpp).

Counterpart of rsem_tpu/engine/gibbs.py, tile-sweep path
(`_run_gibbs_pallas` there, :287-455). The reference runs independent
chains, each a sequential sweep over all reads per round
(Gibbs.cpp:265-353). Here every chain sweeps the reads tile by tile (kernel
K5, ops/gibbs.py): each tile is one block of the blocked collapse, its
reads sampling against the counts as they stood at the tile's start with
their own assignment subtracted exactly.

Flow, all on the run's device: layout build from the frozen conprbs and
the EM's cached upload of the hits; counts set-up with omit and prior
(`setup_counts`); chain init, keyed on K5's counter hash (the CPU and the
card draw the same initial state); burn-in plus retained sweeps,
every sweep one K5 launch per part, each retained count vector kept on the
device ([C, samples_per_chain, M+1] f32); then the posterior moments,
summed in float64 on the device. With an allele-specific reference
(`ta`, the transcript -> allele grouping) the moments add the
transcript-level count variance `pve_c_trans`, summed as the gene one is.

Several devices (`dist`, a parallel.distributed process group; the JAX
package's mesh branch, engine/gibbs.py:651-660 there): where the chains
tile the ranks, each rank builds the layout from all hits, draws the
initial state of its own chains only (`init_chains(chains=)`, keyed on
the global chain), runs K5 on them with its first chain's global index
(`chain0`, the uniforms' chain key, so every chain draws what it would in
one process),
and the ranks gather the retained count vectors; the moments then run on
every rank. Otherwise every rank runs all the chains.

The layout deals each bucket's reads over its tiles (ops/gibbs.py) so that
no tile holds a whole ambiguous split; `GibbsConfig.n_blocks` keeps the JAX
package's meaning, the XLA blocked sweep's staleness bound: a read samples
against counts at most ~N1 / n_blocks reads stale. Not ported: the XLA
sweep itself, whose bound the tile layout now keeps, and the TPU
watchdog's `sweep_segment`.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import numpy as np
import torch

from ..constants import EPSILON
from ..ops.gibbs import (
    GibbsLayout,
    build_layout,
    delta_scratch,
    init_chains,
    part_seed,
    sweep_part,
)
from ..parallel.distributed import Dist, gather_rows
from ..utils.device import DeviceLike, fetch64, resolve_device


@dataclass
class GibbsConfig:
    burnin: int = 200
    nsamples: int = 1000
    gap: int = 1
    n_chains: int = 8
    # within-sweep count-refresh budget: a bucket's reads are dealt over at
    # least its share of n_blocks tiles, so any read samples against
    # counts at most ~N1/n_blocks reads stale (rsem_tpu's meaning)
    n_blocks: int = 32
    pseudo_count: float = 1.0
    seed: int = 0
    keep_countvectors: bool = True


@dataclass
class GibbsResult:
    pme_c: np.ndarray  # [M+1] posterior mean counts
    pve_c: np.ndarray  # [M+1] posterior count variance
    pme_tpm: np.ndarray
    pme_fpkm: np.ndarray
    pve_c_genes: np.ndarray  # [m]
    # [nsamples, M+1] f32 on the device (CI consumes it there); None unless
    # keep_countvectors
    countvectors: Optional[torch.Tensor]
    pve_c_trans: Optional[np.ndarray] = None  # [ta.m], allele mode only


def setup_counts(cfg: GibbsConfig, M: int, N0: int, N1: int,
                 omit: Optional[np.ndarray], prior: Optional[np.ndarray]):
    """init_counts / pseudo / totc (Gibbs.cpp:152-194 load_omit_info +
    load_prior_info)."""
    init_counts = np.zeros(M + 1)
    if omit is not None and len(omit):
        init_counts[np.asarray(omit, dtype=np.int64)] = -1
    if prior is not None:
        pseudo = np.asarray(prior, dtype=np.float64).copy()
        pseudo[init_counts < 0] = 0.0
        totc = 1.0 + pseudo[1:][init_counts[1:] >= 0].sum() + N0 + N1
    else:
        pseudo = np.full(M + 1, cfg.pseudo_count)
        totc = (M + 1 - (init_counts < 0).sum()) * cfg.pseudo_count + N0 + N1
    return init_counts, pseudo, totc


def expression_values(counts: torch.Tensor, eel: np.ndarray, mw: np.ndarray,
                      pseudo: np.ndarray, totc: float):
    """theta -> polish -> (tpm, fpkm), each [S, M+1] f32 with column 0 zero,
    for count vectors [S, M+1] f32 (Gibbs.cpp:317-323).

    The EPSILON tests run in float64 on the host, as the reference's do: an
    isoform with eel = 0 gets TPM and FPKM 0. (The JAX package compares in
    float32, where 1e-300 rounds to 0, so eel = 0 passes and its FPKM
    overflows to inf/NaN.)"""
    dev = counts.device
    f32 = dict(dtype=torch.float32, device=dev)
    ok = torch.as_tensor(eel[1:] >= EPSILON, device=dev)
    bad = torch.as_tensor((mw[1:] < EPSILON) | (eel[1:] < EPSILON),
                          device=dev)
    eel_d = torch.as_tensor(eel[1:], **f32)
    mw_d = torch.as_tensor(mw[1:], **f32)
    theta = torch.where(counts < 0, torch.zeros_like(counts),
                        (counts + torch.as_tensor(pseudo, **f32)) / totc)
    t = theta.clone()
    t[:, 1:] = torch.where(bad, torch.zeros_like(theta[:, 1:]),
                           theta[:, 1:] / torch.where(
                               bad, torch.ones_like(mw_d), mw_d))
    t = t / t.sum(1, keepdim=True)
    frac = torch.where(ok, t[:, 1:], torch.zeros_like(t[:, 1:]))
    frac = frac / frac.sum(1, keepdim=True).clamp_min(EPSILON)
    fpkm = torch.where(ok, frac * 1e9 / eel_d.clamp_min(1e-30),
                       torch.zeros_like(frac))
    tpm = fpkm / fpkm.sum(1, keepdim=True).clamp_min(EPSILON) * 1e6
    z = torch.zeros((counts.shape[0], 1), dtype=tpm.dtype,
                    device=tpm.device)
    return torch.cat([z, tpm], 1), torch.cat([z, fpkm], 1)


def _group_count_var(c64: torch.Tensor, groups, pme_c: np.ndarray
                     ) -> np.ndarray:
    """Posterior variance of each group's summed count (genes, or the
    transcripts of an allele reference): the f64 count vectors [S, M+1]
    summed over the group's members, (sum^2 - S pme^2) / (S - 1) clipped at
    0."""
    S, M1 = c64.shape
    members = np.arange(1, M1)
    ids = torch.as_tensor(groups.gids_of(members), dtype=torch.int64,
                          device=c64.device)
    gsum = torch.zeros((S, groups.m), dtype=torch.float64, device=c64.device)
    gsum.index_add_(1, ids, c64[:, 1:])
    sum_g2 = fetch64((gsum * gsum).sum(0))
    pme_g = np.bincount(groups.gids_of(members), weights=pme_c[1:],
                        minlength=groups.m)
    var = (sum_g2 - S * pme_g ** 2) / (S - 1)
    var[var < 0] = 0.0
    return var


def moments(cvs: torch.Tensor, eel: np.ndarray, mw: np.ndarray,
            pseudo: np.ndarray, totc: float, gi,
            keep_countvectors: bool = True, ta=None) -> GibbsResult:
    """Posterior summaries from the retained count vectors [S, M+1] f32
    (Gibbs.cpp:355-423 release()); sums in float64 on cvs' device. ta:
    transcript -> allele GroupInfo of an allele-specific reference."""
    S = cvs.shape[0]
    c64 = cvs.double()
    sum_c = c64.sum(0)
    sum_c2 = (c64 * c64).sum(0)
    pme_c = fetch64(sum_c) / S
    pve_c = (fetch64(sum_c2) - S * pme_c ** 2) / (S - 1)
    pve_c[pve_c < 0] = 0.0
    pve_c_genes = _group_count_var(c64, gi, pme_c)
    pve_c_trans = None if ta is None else _group_count_var(c64, ta, pme_c)
    del c64
    tpm, fpkm = expression_values(cvs, np.asarray(eel, dtype=np.float64),
                                  np.asarray(mw, dtype=np.float64), pseudo,
                                  totc)
    sum_tpm = tpm.double().sum(0)
    sum_fpkm = fpkm.double().sum(0)
    del tpm, fpkm
    return GibbsResult(
        pme_c=pme_c, pve_c=pve_c, pme_tpm=fetch64(sum_tpm) / S,
        pme_fpkm=fetch64(sum_fpkm) / S, pve_c_genes=pve_c_genes,
        countvectors=cvs if keep_countvectors else None,
        pve_c_trans=pve_c_trans)


def retained_index(sweep: int, cfg: GibbsConfig) -> Optional[int]:
    """Row of `sweep` among the retained samples of its chain, or None."""
    if sweep < cfg.burnin or (sweep - cfg.burnin) % cfg.gap:
        return None
    return (sweep - cfg.burnin) // cfg.gap


def run_chains(layout: GibbsLayout, assigns: List[torch.Tensor],
               table: torch.Tensor, pseudo: torch.Tensor, cfg: GibbsConfig,
               chain0: int = 0) -> torch.Tensor:
    """All sweeps from a given chain state (updated in place) of C of the
    cfg.n_chains chains, chain0 the global index of the first. Returns the
    retained count vectors [C, samples_per_chain, M+1] f32 (counts =
    table - pseudo)."""
    C = table.shape[0]
    spc = cfg.nsamples // cfg.n_chains
    total = cfg.burnin + 1 + (spc - 1) * cfg.gap
    seeds = [part_seed(cfg.seed, pi) for pi in range(len(layout.parts))]
    cvs = torch.zeros((C, spc, layout.M + 1), dtype=torch.float32,
                      device=table.device)
    scratch = delta_scratch(table)
    for s in range(total):
        for part, a, sp in zip(layout.parts, assigns, seeds):
            sweep_part(a, table, part, sp, s, scratch, chain0)
        k = retained_index(s, cfg)
        if k is not None:
            cvs[:, k] = table - pseudo
    return cvs


def run_gibbs(
    hits,
    log_conprb: np.ndarray,
    log_ncp: np.ndarray,
    M: int,
    N0: int,
    eel: np.ndarray,
    mw: np.ndarray,
    gi,
    cfg: GibbsConfig,
    omit: Optional[np.ndarray] = None,
    prior: Optional[np.ndarray] = None,
    device: DeviceLike = None,
    ta=None,
    dist: Optional[Dist] = None,
) -> GibbsResult:
    """hits: io.HitArrays; log_conprb/log_ncp: final-model conprbs from EM
    (the .ofg content); gi: gene GroupInfo; prior: [M+1] per-isoform
    pseudo-counts (pRSEM's --prior); ta: transcript -> allele GroupInfo of
    an allele-specific reference (adds pve_c_trans). Runs on CUDA unless
    device="cpu"; the layout and the chains' initial state are built on
    that device, the state from a counter hash, so both devices start from
    one state. dist: the process group; its ranks
    (on dist.device) split the chains when n_chains is a multiple of the
    ranks, and every rank returns the same result."""
    dev = dist.device if dist is not None else resolve_device(device)
    C = cfg.n_chains
    if cfg.nsamples % C:
        raise ValueError(f"nsamples ({cfg.nsamples}) must be divisible by "
                         f"n_chains ({C})")
    init_counts, pseudo, totc = setup_counts(cfg, M, N0, hits.n_reads,
                                             omit, prior)
    pseudo_d = torch.as_tensor(pseudo, dtype=torch.float32, device=dev)
    layout = build_layout(hits, log_conprb, log_ncp, M, device=dev,
                          n_blocks=cfg.n_blocks)
    table_base = torch.as_tensor(init_counts + pseudo, dtype=torch.float32,
                                 device=dev)
    table_base[0] += N0 + layout.n_noise_fixed
    split = dist is not None and C % dist.world == 0
    per = C // dist.world if split else C
    chain0 = dist.rank * per if split else 0
    assigns, table = init_chains(layout, table_base, C, cfg.seed, dev,
                                 chains=slice(chain0, chain0 + per))
    cvs = run_chains(layout, assigns, table, pseudo_d, cfg, chain0)
    if split:
        cvs = gather_rows(cvs, [per] * dist.world, dist)
    return moments(cvs.reshape(-1, M + 1), eel, mw, pseudo, totc, gi,
                   cfg.keep_countvectors, ta=ta)
