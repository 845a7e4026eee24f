"""The fused model-update rounds, all on the device.

Counterpart of rsem_tpu/ops/model_loop.py. The reference runs 10
model-update EM rounds (EM.cpp:307-310): each recomputes every hit's conprb
under the current model (SingleModel.h:95-146), runs the E-step
(EM.cpp:199-244), scatters posterior-weighted sufficient statistics into
the model tables (SingleModel.h:163-209) and renormalises them (EM.cpp:
400-404). The per-round path of engine/em.py does that with two host reads,
a float64 host refit and a model upload per round. Here the rounds are one
stream of device work with no host read between them:

  * the conprb splits once into a STATIC per-hit part (orientation, mate
    lengths, fixed RSPD, masking: compute_log_conprb(static_only=True))
    and the ROUND-VARYING part: the profile term (K2 over PreIdx), paired
    the fragment-length term from two small-table lookups, est-RSPD the
    RSPD term from frozen evalCDF indices;
  * the E-step runs scale-free in linear f32: each read's max logit is
    frozen once from the round-0 conprbs (s0; model drift across update
    rounds is a few nats, clamped at MAX_DRIFT), so no round needs a
    per-read max;
  * the E-step statistics kernel (csrc/model_estep.cu, `estep_stats`)
    takes the round's log conprbs to the fractions in one pass over the
    reads: the per-read denominators (float64 sums over each read's CSR
    range), the expected counts and the fragment-length and RSPD
    histograms; K3 then scatters the fractions into the profile and noise
    statistics over PreIdx;
  * the table finishes (normalise, cumsum) run in f32 on the device; the
    host refits the float64 model once, from the last round's statistics
    (engine/em.py).

What changed from the TPU package, where it was there only for the TPU:
the noise terms go through K2/K3 over the noise indices (nflat1/nflat2)
in place of a static per-read key histogram with bf16-split MXU matmuls
(which round each term to 2^-17 relative); `onehot_scatter` and
`seg_sum_sorted` (a double-float prefix sum) are the E-step statistics
kernel's float64 sums, `gather_rows` indexing. Reads and hits carry no
padding rows.
With a process group (`dist`, the read-sharded EM of engine/em.py) each
rank runs the loop on its own reads and one all_reduce per round sums the
expected counts and the float64 statistic accumulators, where the JAX
package's `axis_name` branch psums; n0 is added once, after the sum.

Scope: model variants whose masking weights and fixed terms stay fixed
across the update rounds (`fused_supported`); elsewhere engine/em.py keeps
the per-round path.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..parallel.distributed import Dist, all_reduce_
from ..utils.device import to_device
from ..utils.timing import count
from . import _build
from .conprb import (
    LOG_EPS,
    NEG_INF,
    PreIdx,
    compute_log_conprb,
    compute_log_noise_conprb,
    log_lendist_pdf,
)
from .estep import ORIVALVE
from .layout import HitsDevice, KernelConfig, ReadsDevice, RefDevice
from .table import gather_sum, scatter_add

# w = exp(lw - s0) clamp: the round-0 per-read max keeps lw - s0 <= ~0
# plus a few nats of model drift; 80 caps runaway values below f32
# overflow while leaving all realistic ratios exact
MAX_DRIFT = 80.0


def fused_supported(cfg: KernelConfig, has_polya: bool,
                    min_full_len: Optional[int] = None) -> bool:
    """The fused loop needs mw to stay fixed across rounds and every
    round-varying conprb term to be expressible from frozen per-hit
    indices. Without poly(A), mw is identically 1 (PairedEndQModel.h:
    302-307, SingleModel.h:462-524 integrate only masked positions), so
    poly(A) with paired reads or est-RSPD is the real gate. est-RSPD rides
    frozen indices, except the single-end user-mld remarginalised update
    (SingleModel.h:178-199) and reads on transcripts shorter than B bins
    (a position can then span more than 2 bins)."""
    if has_polya and (cfg.paired or cfg.est_rspd):
        return False
    if cfg.est_rspd:
        if cfg.use_mld and not cfg.paired:
            return False
        if min_full_len is not None and min_full_len < cfg.B:
            return False
    return True


class ModelLoopData(NamedTuple):
    """Round-invariant device tensors of the fused loop."""

    lp_static: torch.Tensor  # [H] f32 fixed terms (-inf masks)
    log_mw_h: torch.Tensor  # [H] f32 log mw[sid]
    lnp_static: torch.Tensor  # [N] f32 noise length terms (-inf on lq)
    sid: torch.Tensor  # [H] int32, the layout's
    rid: torch.Tensor  # [H] int32, sorted, the layout's
    read_offsets: torch.Tensor  # [N+1] int64, the layout's
    s0: torch.Tensor  # [N] f32 frozen per-read max logit (round 0)
    pre: PreIdx  # profile and noise indices (K2/K3)
    npro_c: torch.Tensor  # [npro_keys] f32 fixed N0 noise counts
    n0: torch.Tensor  # f64 scalar
    # paired only (None on single-end)
    gld_num_idx: Optional[torch.Tensor] = None  # [H] int64
    gld_den_idx: Optional[torch.Tensor] = None  # [H] int64
    gld_valid: Optional[torch.Tensor] = None  # [H] bool
    ins_idx: Optional[torch.Tensor] = None  # [H] int32 (gld statistic slot)
    # est-RSPD only: frozen evalCDF indices and interpolants at fpos,
    # fpos+1 and effL (RSPD.h:63-75), and the 2-bin spread of the
    # statistic (RSPD.h:43-59, use-masked weights)
    rs_if: Optional[torch.Tensor] = None  # [H] int64
    rs_vf: Optional[torch.Tensor] = None  # [H] f32
    rs_if1: Optional[torch.Tensor] = None
    rs_vf1: Optional[torch.Tensor] = None
    rs_ie: Optional[torch.Tensor] = None
    rs_ve: Optional[torch.Tensor] = None
    rs_ok: Optional[torch.Tensor] = None  # [H] bool
    rs_b0: Optional[torch.Tensor] = None  # [H] int32 (0-based bin)
    rs_w0: Optional[torch.Tensor] = None  # [H] f32
    rs_b1: Optional[torch.Tensor] = None
    rs_w1: Optional[torch.Tensor] = None

    @property
    def s0_hit(self) -> torch.Tensor:
        """[H] f32 s0 per hit, the JAX package's leaf (the loop reads s0
        once a read)."""
        return self.s0[self.rid]


def _safe_log(x: torch.Tensor) -> torch.Tensor:
    """log x, -inf where x <= 0 (scalars stay scalars: no host copy)."""
    return torch.where(x > 0, torch.log(torch.where(x > 0, x, 1.0)), NEG_INF)


def _rspd_log_term(pdf, cdf, i_f, v_f, i_f1, v_f1, i_e, v_e, ok):
    """log RSPD::getAdjustedProb from frozen evalCDF indices; pdf/cdf are
    the [B+2] linear tables. The term is zeroed where the denominator is
    not > 0, as the TPU package does; RSEM zeroes it below EPSILON = 1e-300
    (RSPD.h:74), which in float32 picks the same entries, since no
    positive float32 lies below 1e-300."""

    def ev(i, v):
        return cdf[i] + (v - i.to(torch.float32)) * pdf[i + 1]

    num = ev(i_f1, v_f1) - ev(i_f, v_f)
    den = ev(i_e, v_e)
    r = torch.where(ok & (den > 0), num / torch.where(den > 0, den, 1.0),
                    0.0)
    return _safe_log(r)


def build_model_loop_data(
    cfg: KernelConfig,
    ref: RefDevice,
    m1: ReadsDevice,
    m2: Optional[ReadsDevice],
    hits: HitsDevice,
    pre: PreIdx,
    model: Dict[str, torch.Tensor],
    npro_c,
    n0,
    probF: float = 0.5,
) -> ModelLoopData:
    """Freeze every round-invariant term. `model` is the round-0 device
    model: its fixed distributions feed lp_static, its full conprbs the
    frozen per-read scale s0. npro_c: the fixed N0 noise counts (any
    shape; flattened to the key window)."""
    dev = hits.rid.device
    rid, sid = hits.rid.long(), hits.sid.long()
    lp_static, log_mw_h = compute_log_conprb(cfg, ref, m1, m2, hits, model,
                                             pre, static_only=True)

    def len_term(lens):
        if cfg.paired or cfg.use_mld:
            return log_lendist_pdf(model["log_mld_pdf"], cfg.mld_lb,
                                   cfg.mld_ub, lens)
        return log_lendist_pdf(model["log_gld_pdf"], cfg.gld_lb, cfg.gld_ub,
                               lens)

    lnp = len_term(m1.lens)
    if cfg.paired:
        lnp = lnp + len_term(m2.lens)
        lq = (m1.lq & m2.lq) | (m1.lens < cfg.seed_len) | (
            m2.lens < cfg.seed_len)
    else:
        lq = m1.lq
    lnp_static = torch.where(lq, NEG_INF, lnp)

    # frozen per-read scale from the ROUND-0 full conprbs: theta <= 1 only
    # lowers logits, and profile/gld drift across update rounds is a few
    # nats, so exp(lw - s0) stays in f32 range for the whole loop
    lcp0 = compute_log_conprb(cfg, ref, m1, m2, hits, model, pre)
    lnp0 = compute_log_noise_conprb(cfg, m1, m2, model, pre)
    s0 = torch.full_like(lnp0, NEG_INF).scatter_reduce_(
        0, rid, lcp0, "amax", include_self=True)
    s0 = torch.maximum(s0, lnp0)
    s0 = torch.where(torch.isfinite(s0), s0, 0.0)

    kw = {}
    if cfg.paired:
        span = cfg.gld_ub - cfg.gld_lb
        tl = ref.tot_len[sid]
        ins = hits.insert_len
        kw["gld_valid"] = (ins > cfg.gld_lb) & (ins <= cfg.gld_ub) & (
            tl > cfg.gld_lb)
        kw["gld_num_idx"] = (ins - cfg.gld_lb).clamp(0, span).long()
        kw["gld_den_idx"] = (tl.clamp(max=cfg.gld_ub) - cfg.gld_lb).clamp(
            0, span).long()
        kw["ins_idx"] = (ins - cfg.gld_lb - 1).clamp(0, span - 1).int()

    if cfg.est_rspd:
        B = cfg.B
        fl = ref.full_len[sid]
        tl = ref.tot_len[sid]
        pos, dirs = hits.pos, hits.dir
        l1h = m1.lens[rid]
        span_len = hits.insert_len if cfg.paired else l1h
        fpos = torch.where(dirs == 1, tl - pos - span_len, pos)
        effL = torch.minimum(fl, tl - span_len + 1)
        fls = fl.clamp(min=1)
        flf = fls.to(torch.float32)
        ok = (fpos >= 0) & (fpos < fl) & (effL >= 1)

        def clip(x, lo, hi):
            return torch.minimum(x.clamp(min=lo), hi)

        def iv(x):
            return (torch.div(x * B, fls, rounding_mode="floor").long(),
                    x.to(torch.float32) * B / flf)

        kw["rs_if"], kw["rs_vf"] = iv(clip(fpos, 0, fls - 1))
        kw["rs_if1"], kw["rs_vf1"] = iv(clip(fpos, 0, fls - 1) + 1)
        kw["rs_ie"], kw["rs_ve"] = iv(clip(effL, 1, fls))
        kw["rs_ok"] = ok
        if cfg.paired:
            fpos_s = fpos
            use = fpos_s < fl
        elif probF >= ORIVALVE:
            fpos_s = pos
            use = (dirs == 0) & (pos < fl)
        else:
            fpos_s = tl - pos - l1h
            use = (dirs == 1) & (fpos_s < fl)
        fpos_s = clip(fpos_s, 0, fls - 1)
        lo_e = fpos_s.to(torch.float32) / flf
        hi_e = (fpos_s.to(torch.float32) + 1.0) / flf
        b0 = torch.div(fpos_s * B, fls, rounding_mode="floor").clamp(0, B - 1)
        b1 = (b0 + 1).clamp(max=B - 1)

        def weight(b):
            lo = torch.maximum(lo_e, b.to(torch.float32) / B)
            hi = torch.minimum(hi_e, (b + 1).to(torch.float32) / B)
            return (hi - lo).clamp(min=0.0) * flf

        kw["rs_b0"] = b0.int()
        kw["rs_w0"] = torch.where(use, weight(b0), 0.0)
        kw["rs_b1"] = b1.int()
        kw["rs_w1"] = torch.where(use & (b1 > b0), weight(b1), 0.0)
        # lp_static carries the ROUND-0 RSPD factor; strip it so the loop
        # can add the live one
        r0 = _rspd_log_term(
            model["rspd_pdf"].to(torch.float32),
            model["rspd_cdf"].to(torch.float32),
            kw["rs_if"], kw["rs_vf"], kw["rs_if1"], kw["rs_vf1"],
            kw["rs_ie"], kw["rs_ve"], ok)
        lp_static = torch.where(
            torch.isfinite(lp_static),
            lp_static - torch.where(torch.isfinite(r0), r0, 0.0), NEG_INF)

    npro_c = np.asarray(npro_c, dtype=np.float32).reshape(-1)
    return ModelLoopData(
        lp_static=lp_static, log_mw_h=log_mw_h, lnp_static=lnp_static,
        sid=hits.sid, rid=hits.rid, read_offsets=hits.read_offsets, s0=s0,
        pre=pre,
        npro_c=to_device(npro_c[: cfg.npro_keys()], dev),
        n0=to_device(np.array(float(n0)), dev), **kw)


def tables_from_model(cfg: KernelConfig, model: Dict[str, torch.Tensor]
                      ) -> Dict[str, torch.Tensor]:
    """Round-0 loop tables (compact key windows) from the device model."""
    t = {
        "log_pro": model["log_pro"].reshape(-1).to(torch.float32)[
            : cfg.pro_keys()],
        "log_npro": model["log_npro"].reshape(-1).to(torch.float32)[
            : cfg.npro_keys()],
    }
    if cfg.paired:
        t["log_gld_pdf"] = model["log_gld_pdf"].to(torch.float32)
        t["log_gld_cdf"] = model["log_gld_cdf"].to(torch.float32)
    if cfg.est_rspd:
        t["rspd_pdf"] = model["rspd_pdf"].to(torch.float32)
        t["rspd_cdf"] = model["rspd_cdf"].to(torch.float32)
    return t


def _zero_first(x: torch.Tensor) -> torch.Tensor:
    return torch.cat([x.new_zeros(1), x])


def _finish_rspd(counts, pdf_prev, cdf_prev):
    """Linear [B+2] pdf/cdf from B bin masses (RSPD::finish; empty input
    keeps the previous tables)."""
    s = counts.sum()
    pdf1 = torch.where(s > 0, counts / torch.where(s > 0, s, 1.0), 0.0)
    z = pdf1.new_zeros(1)
    pdf = torch.cat([z, pdf1, z])
    cdf = torch.cat([z, torch.cumsum(pdf1, 0), z])
    return torch.where(s > 0, pdf, pdf_prev), torch.where(s > 0, cdf, cdf_prev)


def _finish_profile(pro_counts: torch.Tensor) -> torch.Tensor:
    """log of the Profile/QProfile finish: rows normalised, empty rows 0
    (host twin: model/profile.py finish_from_counts)."""
    pc = pro_counts.reshape(-1, 5)
    s = pc.sum(1, keepdim=True)
    p = torch.where(s > 0, pc / torch.where(s > 0, s, 1.0), 0.0)
    return _safe_log(p).reshape(-1)


def _finish_npro(cfg: KernelConfig, npro_counts, npro_c, log_prev):
    """log of the Noise(Q)Profile finish: posterior counts + the fixed N0
    counts, normalised per quality row with quals, globally without. Empty
    input keeps the previous table (NoiseProfile.h:78-89)."""
    tot = npro_counts + npro_c
    if cfg.has_qual:
        t2 = tot.reshape(-1, 5)
        s = t2.sum(1, keepdim=True)
        p = torch.where(s > 0, t2 / torch.where(s > 0, s, 1.0), 0.0)
        return _safe_log(p).reshape(-1)
    s = tot.sum()
    logp = _safe_log(torch.where(s > 0, tot / torch.where(s > 0, s, 1.0),
                                 0.0))
    return torch.where(s > 0, logp, log_prev)


def _finish_gld(gld_counts) -> Tuple[torch.Tensor, torch.Tensor]:
    """log pdf/cdf over the frozen (lb, ub] window from posterior-weighted
    insert-length masses (PairedEndQModel.h:161-178 + the LenDist
    finish)."""
    s = gld_counts.sum()
    pdf1 = torch.where(s > 0, gld_counts / torch.where(s > 0, s, 1.0), 0.0)
    return _safe_log(_zero_first(pdf1)), _safe_log(
        _zero_first(torch.cumsum(pdf1, 0)))


def estep_stats_plain(cfg: KernelConfig, data: ModelLoopData,
                      lp: torch.Tensor, lnp: torch.Tensor,
                      theta: torch.Tensor, counts: torch.Tensor,
                      gld: torch.Tensor, rspd: torch.Tensor,
                      frac: torch.Tensor, frac_noise: torch.Tensor) -> None:
    """Plain PyTorch version of the E-step statistics kernel: one round's
    E-step (EM.cpp:199-244), scale-free in linear f32, from the round's
    log conprbs lp [H] and lnp [N]. Writes frac [H] and frac_noise [N]
    (f32) and adds the expected counts into counts (f64 [M+1]; slot 0 gets
    no hit, sid >= 1, and the noise sum), paired the fragment-length
    statistic into gld (f64 [gld span]), est-RSPD the read-start one into
    rspd (f64 [B])."""
    rid, sid = data.rid.long(), data.sid.long()
    ltheta = _safe_log(theta)
    w = torch.exp((lp + ltheta[sid] - data.s0[rid]).clamp(max=MAX_DRIFT))
    w0 = torch.exp((lnp + ltheta[0] - data.s0).clamp(max=MAX_DRIFT))
    denom = torch.zeros_like(data.s0, dtype=torch.float64).index_add_(
        0, rid, w.double())
    d = denom + w0
    inv = torch.where(d > 0, 1.0 / torch.where(d > 0, d, 1.0),
                      0.0).to(torch.float32)
    torch.mul(w, inv[rid], out=frac)
    torch.mul(w0, inv, out=frac_noise)
    counts.index_add_(0, sid, frac.double())
    counts[0] += frac_noise.sum(dtype=torch.float64)
    if cfg.paired:
        gld.index_add_(0, data.ins_idx, frac.double())
    if cfg.est_rspd:
        rspd.index_add_(0, data.rs_b0, (frac * data.rs_w0).double())
        rspd.index_add_(0, data.rs_b1, (frac * data.rs_w1).double())


def _check_estep(cfg: KernelConfig, data: ModelLoopData, lp, lnp, theta,
                 counts, gld, rspd, frac, frac_noise) -> None:
    dev = lp.device
    H, N = data.sid.shape[0], data.s0.shape[0]
    want = [(lp, torch.float32, H), (frac, torch.float32, H),
            (data.sid, torch.int32, H), (data.rid, torch.int32, H),
            (lnp, torch.float32, N), (frac_noise, torch.float32, N),
            (data.s0, torch.float32, N),
            (data.read_offsets, torch.int64, N + 1),
            (theta, torch.float32, theta.shape[0]),
            (counts, torch.float64, theta.shape[0])]
    if cfg.paired:
        want += [(data.ins_idx, torch.int32, H),
                 (gld, torch.float64, cfg.gld_ub - cfg.gld_lb)]
    if cfg.est_rspd:
        want += [(data.rs_b0, torch.int32, H), (data.rs_w0, torch.float32, H),
                 (data.rs_b1, torch.int32, H), (data.rs_w1, torch.float32, H),
                 (rspd, torch.float64, cfg.B)]
    for t, dtype, n in want:
        if t.dtype != dtype or t.shape != (n,) or not t.is_contiguous() \
                or t.device != dev:
            raise ValueError(
                f"estep_stats: expected a contiguous {dtype} [{n}] tensor on "
                f"{dev}, got {t.dtype} {tuple(t.shape)} on {t.device}")


def estep_stats(cfg: KernelConfig, data: ModelLoopData, lp: torch.Tensor,
                lnp: torch.Tensor, theta: torch.Tensor, counts: torch.Tensor,
                gld: torch.Tensor, rspd: torch.Tensor, frac: torch.Tensor,
                frac_noise: torch.Tensor) -> None:
    """One round's E-step statistics, as estep_stats_plain describes them:
    CPU tensors take the plain version; CUDA tensors launch the kernel
    (csrc/model_estep.cu) on the current stream, which allocates nothing and
    does not synchronise, and count the launch (`launches` and the
    `model_estep_launches` counter of utils/timing). The kernel adds the
    f64 sums with atomics, in another order than the plain version; the
    f32 values are the same. More than 27,648 histogram slots (the gld
    span plus 8 * B) are refused on CUDA."""
    dev = lp.device
    if dev.type == "cpu":
        estep_stats_plain(cfg, data, lp, lnp, theta, counts, gld, rspd, frac,
                          frac_noise)
        return
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    _check_estep(cfg, data, lp, lnp, theta, counts, gld, rspd, frac,
                 frac_noise)

    def ptr(t):
        return None if t is None else t.data_ptr()

    n_gld = cfg.gld_ub - cfg.gld_lb if cfg.paired else 0
    n_rspd = cfg.B if cfg.est_rspd else 0
    _build.check(_build.lib().rsem_estep_stats(
        lp.data_ptr(), lnp.data_ptr(), theta.data_ptr(), data.s0.data_ptr(),
        data.sid.data_ptr(), data.rid.data_ptr(), data.read_offsets.data_ptr(),
        data.s0.shape[0], ptr(data.ins_idx), n_gld, ptr(data.rs_b0),
        ptr(data.rs_w0), ptr(data.rs_b1), ptr(data.rs_w1), n_rspd, MAX_DRIFT,
        int(cfg.paired), int(cfg.est_rspd), frac.data_ptr(),
        frac_noise.data_ptr(), counts.data_ptr(), gld.data_ptr(),
        rspd.data_ptr(), _build.stream_of(lp)), "estep_stats")
    estep_stats.launches += 1
    count("model_estep_launches")


estep_stats.launches = 0


def run_model_loop(cfg: KernelConfig, data: ModelLoopData,
                   tables0: Dict[str, torch.Tensor], theta0: torch.Tensor,
                   n_rounds: int, n_reads: int, M: int,
                   dist: Optional[Dist] = None):
    """n_rounds fused model-update EM rounds; returns (theta f32 [M+1],
    suff) where suff holds the LAST round's raw sufficient statistics in
    the full reference shapes (the host refits the float64 model from
    them, engine/em.py). With `dist`, `data` holds this rank's reads and
    the counts and statistics are summed over the ranks every round
    (one all_reduce); theta and suff are then the same on every rank.

    The rounds only enqueue device work: no host read, no branch on a
    tensor's value, and the buffers the rounds reuse are allocated once."""
    if n_rounds < 1:
        raise ValueError("run_model_loop needs at least one round")
    dev = data.sid.device
    pre = data.pre
    pro_keys, npro_keys = cfg.pro_keys(), cfg.npro_keys()
    gspan = cfg.gld_ub - cfg.gld_lb
    # K2 tables with their zero sentinel slot, refilled each round
    pro_tab = torch.zeros(pro_keys + 1, dtype=torch.float32, device=dev)
    npro_tab = torch.zeros(npro_keys + 1, dtype=torch.float32, device=dev)
    frac = torch.empty(data.sid.shape[0], dtype=torch.float32, device=dev)
    frac_noise = torch.empty(n_reads, dtype=torch.float32, device=dev)
    # the round's f64 sums, one buffer (one all_reduce with `dist`):
    # counts, then K3's profile and noise tables (both mates added, read
    # once a round as f32), the fragment-length and RSPD histograms
    sizes = [M + 1, pro_keys, npro_keys, gspan if cfg.paired else 0,
             cfg.B if cfg.est_rspd else 0]
    red = torch.empty(sum(sizes), dtype=torch.float64, device=dev)
    counts, pro_acc, npro_acc, gld_acc, rspd_acc = red.split(sizes)
    pro_cnt = torch.empty(pro_keys, dtype=torch.float32, device=dev)
    npro_cnt = torch.empty(npro_keys, dtype=torch.float32, device=dev)

    theta = theta0.to(device=dev, dtype=torch.float32).contiguous()
    t, suff = tables0, {}
    for _ in range(n_rounds):
        pro_tab[:pro_keys] = t["log_pro"]
        npro_tab[:npro_keys] = t["log_npro"]
        lp = data.lp_static + gather_sum(pro_tab, pre.flat1)
        lnp = gather_sum(npro_tab, pre.nflat1)
        if cfg.paired:
            lp = lp + gather_sum(pro_tab, pre.flat2)
            lnp = lnp + gather_sum(npro_tab, pre.nflat2)
            num = t["log_gld_pdf"][data.gld_num_idx]
            den = t["log_gld_cdf"][data.gld_den_idx]
            lp = lp + torch.where(
                data.gld_valid & (num > NEG_INF) & (den > NEG_INF),
                num - den, NEG_INF)
        if cfg.est_rspd:
            lp = lp + _rspd_log_term(
                t["rspd_pdf"], t["rspd_cdf"], data.rs_if, data.rs_vf,
                data.rs_if1, data.rs_vf1, data.rs_ie, data.rs_ve, data.rs_ok)
        # reference op order: EPSILON cutoff on the full product, then /mw
        lp = torch.where(lp < LOG_EPS, NEG_INF, lp)
        lp = torch.where(data.log_mw_h > NEG_INF, lp - data.log_mw_h, NEG_INF)
        lnp = data.lnp_static + lnp
        lnp = torch.where(lnp < LOG_EPS, NEG_INF, lnp)

        # E-step and its statistics; the profile and noise ones are K3's.
        # Summed over the ranks with `dist`
        red.zero_()
        estep_stats(cfg, data, lp, lnp, theta, counts, gld_acc, rspd_acc,
                    frac, frac_noise)
        scatter_add(pre.flat1, frac, pro_keys, pro_acc)
        scatter_add(pre.nflat1, frac_noise, npro_keys, npro_acc)
        if cfg.paired:
            scatter_add(pre.flat2, frac, pro_keys, pro_acc)
            scatter_add(pre.nflat2, frac_noise, npro_keys, npro_acc)
        if dist is not None:
            all_reduce_(red, dist)
        counts[0] += data.n0
        theta = (counts / counts.sum()).to(torch.float32)

        # the on-device finish
        suff["pro"] = pro_cnt.copy_(pro_acc)
        suff["npro"] = npro_cnt.copy_(npro_acc)
        if cfg.paired:
            suff["gld"] = gld_acc.to(torch.float32)
        if cfg.est_rspd:
            suff["rspd"] = rspd_acc.to(torch.float32)
        t_new = {"log_pro": _finish_profile(suff["pro"]),
                 "log_npro": _finish_npro(cfg, suff["npro"], data.npro_c,
                                          t["log_npro"])}
        if cfg.paired:
            t_new["log_gld_pdf"], t_new["log_gld_cdf"] = _finish_gld(
                suff["gld"])
        if cfg.est_rspd:
            t_new["rspd_pdf"], t_new["rspd_cdf"] = _finish_rspd(
                suff["rspd"], t["rspd_pdf"], t["rspd_cdf"])
        t = t_new

    # expand the compact key windows to the full reference shapes
    pro_full = cfg.pro_len * 25
    npro_full = 500 if cfg.has_qual else 5
    pro = torch.nn.functional.pad(suff["pro"], (0, pro_full - pro_keys))
    npro = torch.nn.functional.pad(suff["npro"], (0, npro_full - npro_keys))
    out = {"pro": pro.reshape(cfg.pro_len, 5, 5),
           "npro": npro.reshape(-1, 5) if cfg.has_qual else npro}
    if cfg.paired:
        out["gld"] = suff["gld"]
    if cfg.est_rspd:
        out["rspd"] = suff["rspd"]
    return theta, out
