"""E-step of the model-update rounds and the model's sufficient statistics.

Counterpart of rsem_tpu/ops/estep.py. Responsibilities are a numerically
stable per-read softmax of log(theta[sid]) + log(conprb), with the noise
isoform as one extra slot per read (EM.cpp:199-244); the segment max and
sum over each read's hits are `scatter_reduce_`/`index_add_` over the
sorted read ids. The sufficient statistics (SingleModel::update,
PairedEndQModel::update) scatter the posteriors into the model tables: the
profile and noise-profile tables through the PreIdx scatter-add (K3), the
fragment-length and RSPD histograms with plain tensor ops.

Where PreIdx is built one window of reads at a time (ops/conprb.py
`plan_windows`), the E-step runs per window (`estep_window`: a read's hits
all lie in its window and theta is fixed for the round), and so do the
profile and noise-profile scatters (`table_stats`, which adds each
window's counts into one float64 total); the expected counts and the
per-hit histograms run once over the round's whole posteriors.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import torch

from .conprb import (
    LOG_EPS,
    NEG_INF,
    PreIdx,
    Window,
)
from .layout import HitsDevice, KernelConfig, ReadsDevice, RefDevice
from .table import scatter_add

ORIVALVE = 0.1  # constants.ORIVALVE: strand threshold of the RSPD update


class EStepOut(NamedTuple):
    frac_hit: torch.Tensor  # [H] posterior responsibility per hit
    frac_noise: torch.Tensor  # [N] noise responsibility per read
    counts: torch.Tensor  # [M+1] expected counts (without +N0)


def estep_fracs(log_theta: torch.Tensor, sid: torch.Tensor,
                rid: torch.Tensor, log_conprb: torch.Tensor,
                log_ncp: torch.Tensor, n_reads: int, M: int) -> EStepOut:
    """sid/rid: [H] int64 (rid sorted); all float work in float32."""
    lw = log_theta[sid] + log_conprb
    lw0 = log_theta[0] + log_ncp
    # reference zeroes absolute weights below EPSILON (EM.cpp:213-222)
    lw = torch.where(lw < LOG_EPS, NEG_INF, lw)
    lw0 = torch.where(lw0 < LOG_EPS, NEG_INF, lw0)

    seg_max = torch.full((n_reads,), NEG_INF, dtype=lw.dtype,
                         device=lw.device)
    seg_max.scatter_reduce_(0, rid, lw, "amax", include_self=True)
    m = torch.maximum(seg_max, lw0)
    m_safe = torch.where(m > NEG_INF, m, 0.0)
    e_h = torch.where(lw > NEG_INF, torch.exp(lw - m_safe[rid]), 0.0)
    e_0 = torch.where(lw0 > NEG_INF, torch.exp(lw0 - m_safe), 0.0)
    denom = torch.zeros_like(e_0).index_add_(0, rid, e_h) + e_0
    denom_safe = torch.where(denom > 0, denom, 1.0)
    frac_hit = e_h / denom_safe[rid]
    frac_noise = e_0 / denom_safe

    return EStepOut(frac_hit, frac_noise,
                    expected_counts(frac_hit, frac_noise, sid, M))


def expected_counts(frac_hit: torch.Tensor, frac_noise: torch.Tensor,
                    sid: torch.Tensor, M: int) -> torch.Tensor:
    """[M+1] expected counts (without +N0): frac_hit summed by sid, the
    noise fractions into slot 0."""
    counts = torch.zeros(M + 1, dtype=frac_hit.dtype, device=frac_hit.device)
    counts.index_add_(0, sid, frac_hit)
    counts[0] += frac_noise.sum()
    return counts


def estep_window(log_theta: torch.Tensor, hits: HitsDevice, w: Window,
                 log_conprb: torch.Tensor, log_ncp: torch.Tensor,
                 M: int) -> EStepOut:
    """The E-step of one window: `hits` are the window's hits (global
    rids, ops/conprb.hits_window), log_conprb [h1-h0] and log_ncp [r1-r0]
    its conprbs. The read ids are rebased to the window's first read, so
    frac_noise is [r1-r0] and counts sum over the window only."""
    return estep_fracs(log_theta, hits.sid.long(), hits.rid.long() - w.r0,
                       log_conprb, log_ncp, w.r1 - w.r0, M)


def table_stats(cfg: KernelConfig, pre: PreIdx, frac_hit: torch.Tensor,
                frac_noise: torch.Tensor,
                acc: Optional[Dict[str, torch.Tensor]] = None
                ) -> Dict[str, torch.Tensor]:
    """The profile and noise-profile counts (K3 over PreIdx) as float64
    {"pro": [pro_keys], "npro": [npro_keys]}, added into `acc` (the counts
    of the round's earlier windows) when given. Over one window of a
    windowed PreIdx, `pre` and the posteriors are the window's."""
    if acc is None:
        dev = frac_hit.device
        acc = {"pro": torch.zeros(cfg.pro_keys(), dtype=torch.float64,
                                  device=dev),
               "npro": torch.zeros(cfg.npro_keys(), dtype=torch.float64,
                                   device=dev)}
    w = frac_hit.to(torch.float32).contiguous()
    wn = frac_noise.to(torch.float32).contiguous()
    for idx, weights, key in ((pre.flat1, w, "pro"), (pre.flat2, w, "pro"),
                              (pre.nflat1, wn, "npro"),
                              (pre.nflat2, wn, "npro")):
        if idx is not None:
            scatter_add(idx, weights, acc[key].shape[0], acc[key])
    return acc


def suffstats(cfg: KernelConfig, ref: RefDevice, m1: ReadsDevice,
              m2: Optional[ReadsDevice], hits: HitsDevice,
              frac_hit: torch.Tensor, frac_noise: torch.Tensor,
              probF: float, pre: Optional[PreIdx] = None,
              tables: Optional[Dict[str, torch.Tensor]] = None
              ) -> Dict[str, torch.Tensor]:
    """Posterior-weighted count tensors for this round's model refresh.

    The profile and noise tables come from `tables` (table_stats, summed
    over the windows of a windowed PreIdx) or else from the whole PreIdx
    `pre`; the fragment-length and RSPD histograms from all hits."""
    if tables is None:
        tables = table_stats(cfg, pre, frac_hit, frac_noise)
    out: Dict[str, torch.Tensor] = {}
    pro_size = cfg.pro_len * 25
    pc = tables["pro"].to(torch.float32)
    # slots beyond the effective key window are unreachable: zero-pad
    pc = torch.nn.functional.pad(pc, (0, pro_size - pc.shape[0]))
    out["pro"] = pc.reshape(cfg.pro_len, 5, 5)

    npro_size = 500 if cfg.has_qual else 5
    nc = tables["npro"].to(torch.float32)
    nc = torch.nn.functional.pad(nc, (0, npro_size - nc.shape[0]))
    out["npro"] = nc.reshape(100, 5) if cfg.has_qual else nc

    if cfg.paired:
        gspan = cfg.gld_ub - cfg.gld_lb
        ins_idx = (hits.insert_len - cfg.gld_lb - 1).clamp(0, gspan - 1)
        out["gld"] = torch.zeros(gspan, dtype=torch.float32,
                                 device=frac_hit.device).index_add_(
            0, ins_idx.long(), frac_hit.to(torch.float32))

    if cfg.est_rspd:
        out["rspd"] = _rspd_stats(cfg, ref, m1, hits, frac_hit, probF)
    return out


def _rspd_stats(cfg, ref, m1, hits, frac_hit, probF):
    """RSPD bin masses with the single-dominant-strand rule
    (SingleModel.h:167-199; PairedEndQModel.h:165-170)."""
    B = cfg.B
    sid = hits.sid.long()
    fl = ref.full_len[sid]
    tl = ref.tot_len[sid]
    dirs, pos = hits.dir, hits.pos
    if cfg.paired:
        fpos = torch.where(dirs == 1, tl - pos - hits.insert_len, pos)
        use = fpos < fl
    else:
        l1 = m1.lens[hits.rid.long()]
        if probF >= ORIVALVE:
            fpos = pos
            use = (dirs == 0) & (fpos < fl)
        else:
            fpos = tl - pos - l1
            use = (dirs == 1) & (fpos < fl)
    frac = torch.where(use, frac_hit, 0.0)
    full = fl.clamp(min=1).to(torch.float32)
    lo = fpos.to(torch.float32) / full
    hi = (fpos.to(torch.float32) + 1.0) / full
    edges = torch.arange(B + 1, dtype=torch.float32, device=full.device) / B
    seg = torch.minimum(hi[:, None], edges[None, 1:]) - torch.maximum(
        lo[:, None], edges[None, :-1])
    seg = seg.clamp(min=0.0) * full[:, None]
    return (seg * frac[:, None]).sum(0)
