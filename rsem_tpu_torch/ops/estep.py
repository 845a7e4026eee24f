"""E-step of the model-update rounds and the model's sufficient statistics.

Counterpart of rsem_tpu/ops/estep.py. Responsibilities are a numerically
stable per-read softmax of log(theta[sid]) + log(conprb), with the noise
isoform as one extra slot per read (EM.cpp:199-244); the segment max and
sum over each read's hits are `scatter_reduce_`/`index_add_` over the
sorted read ids. The sufficient statistics (SingleModel::update,
PairedEndQModel::update) scatter the posteriors into the model tables: the
profile and noise-profile tables through the PreIdx scatter-add (K3), the
fragment-length and RSPD histograms with plain tensor ops.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import torch

from .conprb import (
    LOG_EPS,
    NEG_INF,
    PreIdx,
    _where,
    noise_scatter_pre,
    profile_scatter_pre,
)
from .layout import HitsDevice, KernelConfig, ReadsDevice, RefDevice

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
    lw = _where(lw < LOG_EPS, NEG_INF, lw)
    lw0 = _where(lw0 < LOG_EPS, NEG_INF, lw0)

    seg_max = torch.full((n_reads,), NEG_INF, dtype=lw.dtype,
                         device=lw.device)
    seg_max.scatter_reduce_(0, rid, lw, "amax", include_self=True)
    m = torch.maximum(seg_max, lw0)
    m_safe = _where(m > NEG_INF, m, 0.0)
    e_h = _where(lw > NEG_INF, torch.exp(lw - m_safe[rid]), 0.0)
    e_0 = _where(lw0 > NEG_INF, torch.exp(lw0 - m_safe), 0.0)
    denom = torch.zeros_like(e_0).index_add_(0, rid, e_h) + e_0
    denom_safe = _where(denom > 0, denom, 1.0)
    frac_hit = e_h / denom_safe[rid]
    frac_noise = e_0 / denom_safe

    counts = torch.zeros(M + 1, dtype=frac_hit.dtype, device=frac_hit.device)
    counts.index_add_(0, sid, frac_hit)
    counts[0] += frac_noise.sum()
    return EStepOut(frac_hit, frac_noise, counts)


def suffstats(cfg: KernelConfig, ref: RefDevice, m1: ReadsDevice,
              m2: Optional[ReadsDevice], hits: HitsDevice,
              frac_hit: torch.Tensor, frac_noise: torch.Tensor,
              probF: float, pre: PreIdx) -> Dict[str, torch.Tensor]:
    """Posterior-weighted count tensors for this round's model refresh."""
    out: Dict[str, torch.Tensor] = {}
    pro_size = cfg.pro_len * 25
    pc = profile_scatter_pre(cfg, pre, frac_hit)
    # slots beyond the effective key window are unreachable: zero-pad
    pc = torch.nn.functional.pad(pc, (0, pro_size - pc.shape[0]))
    out["pro"] = pc.reshape(cfg.pro_len, 5, 5)

    npro_size = 500 if cfg.has_qual else 5
    nc = noise_scatter_pre(cfg, pre.nflat1, frac_noise)
    if cfg.paired:
        nc = nc + noise_scatter_pre(cfg, pre.nflat2, frac_noise)
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
    frac = _where(use, frac_hit, 0.0)
    full = fl.clamp(min=1).to(torch.float32)
    lo = fpos.to(torch.float32) / full
    hi = (fpos.to(torch.float32) + 1.0) / full
    edges = torch.arange(B + 1, dtype=torch.float32, device=full.device) / B
    seg = torch.minimum(hi[:, None], edges[None, 1:]) - torch.maximum(
        lo[:, None], edges[None, :-1])
    seg = seg.clamp(min=0.0) * full[:, None]
    return (seg * frac[:, None]).sum(0)
