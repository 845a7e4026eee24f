"""Per-hit alignment log-likelihood (conprb) and the PreIdx build (K4).

Counterpart of rsem_tpu/ops/conprb.py. The reference computes conprb per
(read, hit) in nested C++ loops (SingleModel.h:95-146,
PairedEndQModel.h:94-138). Here every hit is an element of flat tensor
work in log space (float32 log-probabilities stay exact far below the
linear-float32 underflow point, so the reference's EPSILON=1e-300 cutoffs
become a -690.776 logit cutoff).

The port always goes through PreIdx, the round-invariant per-(hit,
position) profile-table indices (kernel K4, csrc/preidx.cu); every conprb
and sufficient-statistic pass then reduces to a table gather-sum (K2) or
scatter-add (K3) over those indices (ops/table.py). Where the whole PreIdx
fits its byte budget it is built once per run. Where it does not, the
reads are cut into windows (`plan_windows`: contiguous read ranges at read
boundaries and their contiguous hit ranges, each window's PreIdx under the
budget) and each pass builds one window's PreIdx at a time
(`window_preidx`) and frees it before the next. This takes the place of
the TPU package's path without PreIdx (`_profile_logprob`, the reference
walk in every round), which has no counterpart here.
"""

from __future__ import annotations

import math
from typing import Dict, List, NamedTuple, Optional

import numpy as np
import torch

from . import _build
from .layout import HitsDevice, KernelConfig, ReadsDevice, RefDevice
from .table import gather_sum, padded_table

NEG_INF = float("-inf")
LOG_EPS = math.log(1e-300)  # reference EPSILON cutoff, in logits
PRE_COLS = 128  # minimum PreIdx position-axis width
PLAIN_CHUNK = 1 << 18  # hits per step of the plain PreIdx build
MLD_CHUNK = 1 << 16  # hits per step of the fragment-length marginalisation
NOISE_CHUNK = 1 << 18  # reads per step of the noise-index build


def _ceil_to(x: int, m: int) -> int:
    return -(-x // m) * m


def pre_cols(max_read_len: int) -> int:
    """PreIdx position-axis width: the smallest 128 multiple covering the
    read length (128 for <=128bp, 256 for 150bp Illumina, ...)."""
    return max(PRE_COLS, _ceil_to(max_read_len, 128))


def preidx_row_bytes(cfg: KernelConfig) -> int:
    """PreIdx bytes per hit and per read (all mates)."""
    mates = 2 if cfg.paired else 1
    return pre_cols(cfg.max_read_len) * 4 * mates


def preidx_bytes(cfg: KernelConfig, n_hits: int, n_reads: int) -> int:
    """Device footprint of PreIdx."""
    return (n_hits + n_reads) * preidx_row_bytes(cfg)


class Window(NamedTuple):
    """Reads [r0, r1) and their hits [h0, h1) (the CSR order by read)."""

    r0: int
    r1: int
    h0: int
    h1: int


def plan_windows(cfg: KernelConfig, read_offsets: np.ndarray,
                 budget: Optional[int]) -> List[Window]:
    """Cut the reads into windows at read boundaries, each window's PreIdx
    (its hits' rows and its reads' noise rows) at most `budget` bytes and
    the windows of about one size. A read whose own rows exceed the budget
    gets a window of its own. `budget` None: one window.

    read_offsets: [N+1] int64, the hits of read r are
    read_offsets[r]:read_offsets[r+1]."""
    off = np.asarray(read_offsets, dtype=np.int64)
    n = len(off) - 1
    if n <= 0:
        return [Window(0, 0, 0, 0)]
    row = preidx_row_bytes(cfg)
    # PreIdx bytes of reads [0, r): row * (hits before r + r)
    cum = (off + np.arange(n + 1, dtype=np.int64)) * row
    if budget is None or cum[-1] <= budget:
        return [Window(0, n, int(off[0]), int(off[-1]))]
    budget = max(int(budget), 0)
    # as many windows as the budget needs, of about one size: a cut may
    # overshoot the even share by at most one read's rows
    n_win = -(-int(cum[-1]) // max(budget, 1))
    biggest = int(np.max(np.diff(off))) + 1
    cap = min(budget, -(-int(cum[-1]) // n_win) + biggest * row)
    out, r0 = [], 0
    while r0 < n:
        r1 = int(np.searchsorted(cum, cum[r0] + cap, side="right")) - 1
        r1 = min(max(r1, r0 + 1), n)
        out.append(Window(r0, r1, int(off[r0]), int(off[r1])))
        r0 = r1
    return out


def hits_window(hits: HitsDevice, w: Window) -> HitsDevice:
    """The window's hits: contiguous 1-D views that keep their global read
    ids (rid indexes the whole read arrays) and the global read_offsets of
    the window's reads."""
    sl = slice(w.h0, w.h1)
    return HitsDevice(
        rid=hits.rid[sl], sid=hits.sid[sl], dir=hits.dir[sl],
        pos=hits.pos[sl],
        insert_len=hits.insert_len[sl] if hits.insert_len is not None
        else None,
        read_offsets=hits.read_offsets[w.r0:w.r1 + 1])


def reads_window(mate: Optional[ReadsDevice], w: Window
                 ) -> Optional[ReadsDevice]:
    """The window's reads of one mate (contiguous row views)."""
    if mate is None:
        return None
    sl = slice(w.r0, w.r1)
    return ReadsDevice(codes=mate.codes[sl], lens=mate.lens[sl],
                       quals=mate.quals[sl] if mate.quals is not None
                       else None, lq=mate.lq[sl])


# --------------------------------------------------------------------- #
# distribution lookups (vector, log and linear)                          #
# --------------------------------------------------------------------- #
# torch.where takes a Python scalar as a scalar argument of the tensor's
# dtype (as a weak scalar is in JAX): no host-to-device copy, hence no host
# sync on CUDA; every where below relies on that.
def _nonzero(x):
    """x with exact zeros replaced by 1 (a safe divisor)."""
    return torch.where(x == 0, torch.ones_like(x), x)


def log_lendist_adjusted(log_pdf, log_cdf, lb: int, ub: int, length, refL):
    """log of LenDist::getAdjustedProb (LenDist.h:63-70)."""
    span = ub - lb
    valid = (length > lb) & (length <= ub) & (refL > lb)
    denom = log_cdf[(refL.clamp(max=ub) - lb).clamp(0, span).long()]
    num = log_pdf[(length - lb).clamp(0, span).long()]
    return torch.where(valid & (num > NEG_INF) & (denom > NEG_INF), num - denom,
                  NEG_INF)


def lin_lendist_adjusted(pdf, cdf, lb: int, ub: int, length, refL):
    span = ub - lb
    valid = (length > lb) & (length <= ub) & (refL > lb)
    denom = cdf[(refL.clamp(max=ub) - lb).clamp(0, span).long()]
    num = pdf[(length - lb).clamp(0, span).long()]
    return torch.where(valid & (denom > 0), num / _nonzero(denom), 0.0)


def log_lendist_pdf(log_pdf, lb: int, ub: int, length):
    """log of LenDist::getProb."""
    span = ub - lb
    valid = (length > lb) & (length <= ub)
    return torch.where(valid, log_pdf[(length - lb).clamp(0, span).long()],
                  NEG_INF)


def rspd_eval_cdf(rspd_pdf, rspd_cdf, B: int, fpos, full_len):
    """RSPD::evalCDF linear interpolation (RSPD.h:63-68)."""
    i = torch.div(fpos.to(torch.int32) * B, full_len.to(torch.int32),
                  rounding_mode="floor").long()
    val = fpos.to(torch.float32) / full_len.to(torch.float32) * B
    return rspd_cdf[i] + (val - i.to(torch.float32)) * rspd_pdf[i + 1]


def lin_rspd_adjusted(cfg: KernelConfig, rspd_pdf, rspd_cdf, fpos, effL,
                      full_len):
    """RSPD::getAdjustedProb (RSPD.h:70-75); out-of-support positions -> 0."""
    ok = (fpos >= 0) & (fpos < full_len) & (effL >= 1)
    if not cfg.est_rspd:
        return torch.where(ok, 1.0 / effL.clamp(min=1).to(torch.float32), 0.0)
    fpos_c = torch.minimum(fpos.clamp(min=0), full_len - 1)
    effL_c = torch.minimum(effL.clamp(min=1), full_len)
    denom = rspd_eval_cdf(rspd_pdf, rspd_cdf, cfg.B, effL_c, full_len)
    num = rspd_eval_cdf(rspd_pdf, rspd_cdf, cfg.B, fpos_c + 1, full_len) \
        - rspd_eval_cdf(rspd_pdf, rspd_cdf, cfg.B, fpos_c, full_len)
    out = torch.where(denom > 0, num / _nonzero(denom), 0.0)
    return torch.where(ok, out, 0.0)


def _safe_log(x):
    return torch.where(x > 0, torch.log(torch.where(x > 0, x, torch.ones_like(x))),
                  NEG_INF)


# --------------------------------------------------------------------- #
# PreIdx: frozen profile-table indices (kernel K4)                       #
# --------------------------------------------------------------------- #
class PreIdx(NamedTuple):
    """Round-invariant per-(hit, position) profile-table indices.

    Layout contract: [H, pre_cols] int32 per mate (flat1/flat2) and
    [N, pre_cols] int32 per mate for the noise profile (nflat1/nflat2).
    Lanes past the read length and pad columns carry the SENTINEL slot
    (pro_keys / npro_keys), the zero slot of the padded table."""

    flat1: torch.Tensor
    flat2: Optional[torch.Tensor]
    nflat1: torch.Tensor
    nflat2: Optional[torch.Tensor]


def preidx_flat_plain(cfg: KernelConfig, ref: RefDevice, mate: ReadsDevice,
                      hits: HitsDevice, mate2: bool) -> torch.Tensor:
    """Plain PyTorch version of the K4 kernel: the gather formulation of
    rsem_tpu's profile_indices (conprb.py:112-156) with the same masking;
    reference positions outside the concatenated codes read 0, as the
    zero-padded windows of precompute_profile_indices_fused do."""
    dev = hits.rid.device
    L = cfg.max_read_len
    cols = pre_cols(L)
    sentinel = cfg.pro_keys()
    H = hits.n_hits
    T = ref.codes.shape[0]
    out = torch.full((H, cols), sentinel, dtype=torch.int32, device=dev)
    j = torch.arange(L, device=dev)[None, :]
    for a in range(0, H, PLAIN_CHUNK):
        b = min(a + PLAIN_CHUNK, H)
        rid = hits.rid[a:b].long()
        s = hits.sid[a:b].long()
        off = ref.offsets[s][:, None]
        tl = ref.tot_len[s].long()
        p = hits.pos[a:b].long()
        d = hits.dir[a:b].long()
        if mate2:
            p = tl - p - hits.insert_len[a:b].long()
            d = 1 - d
        rev = (d == 1)[:, None]
        q = torch.where(rev, off + tl[:, None] - 1 - p[:, None] - j,
                        off + p[:, None] + j)
        inr = (q >= 0) & (q < T)
        refc = torch.where(inr, ref.codes[q.clamp(0, max(T - 1, 0))].long(),
                           torch.zeros_like(q))
        refc = torch.where(rev & (refc < 4), 3 - refc, refc)
        readc = mate.codes[rid].long()
        key = mate.quals[rid].long() if cfg.has_qual else j.expand_as(readc)
        flat = (key * 5 + refc) * 5 + readc
        valid = j < mate.lens[rid].long()[:, None]
        out[a:b, :L] = torch.where(valid, flat,
                                   torch.full_like(flat, sentinel)).int()
    return out


def preidx_flat(cfg: KernelConfig, ref: RefDevice, mate: ReadsDevice,
                hits: HitsDevice, mate2: bool = False) -> torch.Tensor:
    """[H, pre_cols] int32 profile-table indices of one mate's hits
    (kernel K4 on CUDA tensors, preidx_flat_plain on CPU tensors)."""
    L = cfg.max_read_len
    if mate.codes.shape[1] != L:
        raise ValueError("read arrays must be max_read_len wide")
    if mate2 and hits.insert_len is None:
        raise ValueError("mate 2 needs insert lengths")
    dev = hits.rid.device
    if dev.type == "cpu":
        return preidx_flat_plain(cfg, ref, mate, hits, mate2)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    for t in (ref.codes, ref.offsets, ref.tot_len, mate.codes, mate.lens,
              hits.rid, hits.sid, hits.pos, hits.dir):
        if t.device != dev or not t.is_contiguous():
            raise ValueError("PreIdx inputs must be contiguous, on one device")
    if cfg.has_qual and (mate.quals is None or mate.quals.shape != mate.codes.shape):
        raise ValueError("quality-aware PreIdx needs [N, L] quals")
    H = hits.n_hits
    cols = pre_cols(L)
    out = torch.empty((H, cols), dtype=torch.int32, device=dev)
    _build.check(_build.lib().rsem_preidx(
        ref.codes.data_ptr(), ref.codes.numel(), ref.offsets.data_ptr(),
        ref.tot_len.data_ptr(), mate.codes.data_ptr(),
        mate.quals.data_ptr() if cfg.has_qual else None,
        mate.lens.data_ptr(), L, hits.rid.data_ptr(), hits.sid.data_ptr(),
        hits.pos.data_ptr(), hits.dir.data_ptr(),
        hits.insert_len.data_ptr() if mate2 else None, H, cols,
        cfg.pro_keys(), out.data_ptr(), _build.stream_of(out)), "preidx_flat")
    preidx_flat.launches += 1
    return out


preidx_flat.launches = 0


def noise_flat(cfg: KernelConfig, mate: ReadsDevice) -> torch.Tensor:
    """[N, pre_cols] int32 noise-profile indices (sentinel npro_keys),
    composed in place in the output; the one temporary, a bool mask, is
    built NOISE_CHUNK reads at a time."""
    N, L = mate.codes.shape
    sentinel = cfg.npro_keys()
    dev = mate.codes.device
    out = torch.full((N, pre_cols(cfg.max_read_len)), sentinel,
                     dtype=torch.int32, device=dev)
    j = torch.arange(L, device=dev)[None, :]
    for a in range(0, N, NOISE_CHUNK):
        sl = slice(a, a + NOISE_CHUNK)
        o = out[sl, :L]
        o.copy_(mate.codes[sl])
        if cfg.has_qual:
            o.add_(mate.quals[sl], alpha=5)
        o.masked_fill_(j >= mate.lens[sl, None], sentinel)
    return out


def window_preidx(cfg: KernelConfig, ref: RefDevice, m1: ReadsDevice,
                  m2: Optional[ReadsDevice], hits: HitsDevice,
                  w: Window) -> PreIdx:
    """One window's PreIdx: K4 over the window's hits (rows h0:h1), which
    read the whole read arrays through their global rids, and the noise
    indices of the window's reads (rows r0:r1) with plain tensor ops."""
    hw = hits_window(hits, w)
    return PreIdx(
        flat1=preidx_flat(cfg, ref, m1, hw),
        flat2=preidx_flat(cfg, ref, m2, hw, mate2=True) if cfg.paired
        else None,
        nflat1=noise_flat(cfg, reads_window(m1, w)),
        nflat2=noise_flat(cfg, reads_window(m2, w)) if cfg.paired else None)


def precompute_profile_indices_fused(cfg: KernelConfig, ref: RefDevice,
                                     m1: ReadsDevice,
                                     m2: Optional[ReadsDevice],
                                     hits: HitsDevice) -> PreIdx:
    """PreIdx for all mates, hits and reads: one window over everything."""
    return window_preidx(cfg, ref, m1, m2, hits,
                         Window(0, hits.n_reads, 0, hits.n_hits))


# --------------------------------------------------------------------- #
# table passes over PreIdx (kernels K2 / K3)                             #
# --------------------------------------------------------------------- #
def profile_sum_pre(cfg: KernelConfig, log_pro_flat: torch.Tensor,
                    flat: torch.Tensor) -> torch.Tensor:
    """[H] per-hit profile log-prob from frozen indices."""
    size = cfg.pro_keys()
    return gather_sum(padded_table(log_pro_flat, size), flat)


def noise_sum_pre(cfg: KernelConfig, log_npro_flat: torch.Tensor,
                  nflat: torch.Tensor) -> torch.Tensor:
    """[N] per-read noise-profile log-prob from frozen indices."""
    size = cfg.npro_keys()
    return gather_sum(padded_table(log_npro_flat, size), nflat)


# --------------------------------------------------------------------- #
# conprb                                                                 #
# --------------------------------------------------------------------- #
def _se_fraglen_term(cfg, model, l1, tl, fl, pos, dirs):
    """log of the single-end fragment-length/RSPD factor."""
    if not cfg.use_mld:
        fpos = torch.where(dirs == 1, tl - pos - l1, pos)
        effL = torch.minimum(fl, tl - l1 + 1)
        return log_lendist_adjusted(
            model["log_gld_pdf"], model["log_gld_cdf"], cfg.gld_lb,
            cfg.gld_ub, l1, tl,
        ) + _safe_log(lin_rspd_adjusted(
            cfg, model["rspd_pdf"], model["rspd_cdf"], fpos, effL, fl))
    # marginalize over fragment length (SingleModel.h:122-131)
    dev = l1.device
    fr = torch.arange(cfg.gld_lb + 1, cfg.gld_ub + 1, dtype=torch.int32,
                      device=dev)[None, :]
    out = torch.empty(l1.shape[0], dtype=torch.float32, device=dev)
    for a in range(0, l1.shape[0], MLD_CHUNK):
        sl = slice(a, a + MLD_CHUNK)
        l1c, tlc, flc = l1[sl][:, None], tl[sl][:, None], fl[sl][:, None]
        posc, dc = pos[sl][:, None], dirs[sl][:, None]
        minL = l1c.clamp(min=cfg.gld_lb + 1)
        maxL = (tlc - posc).clamp(max=cfg.gld_ub)
        in_r = (fr >= minL) & (fr <= maxL)
        pf = torch.where(dc == 1, tlc - posc - fr, posc.expand(-1, fr.shape[1]))
        effL = torch.minimum(flc, tlc - fr + 1)
        g = lin_lendist_adjusted(model["gld_pdf"], model["gld_cdf"],
                                 cfg.gld_lb, cfg.gld_ub, fr, tlc)
        r = lin_rspd_adjusted(cfg, model["rspd_pdf"], model["rspd_cdf"], pf,
                              effL, flc)
        m = lin_lendist_adjusted(model["mld_pdf"], model["mld_cdf"],
                                 cfg.mld_lb, cfg.mld_ub, l1c, fr)
        out[sl] = _safe_log(torch.where(in_r, g * r * m, 0.0).sum(1))
    return out


def compute_log_conprb(cfg: KernelConfig, ref: RefDevice, m1: ReadsDevice,
                       m2: Optional[ReadsDevice], hits: HitsDevice,
                       model: Dict[str, torch.Tensor],
                       pre: PreIdx, *, static_only: bool = False):
    """[H] float32 log conprb; -inf encodes the reference's exact zeros.

    The profile term comes from the frozen indices (profile_sum_pre, K2);
    the cutoff applies to the full product and mw divides last, the
    reference's order of operations.

    With `static_only` (the fused model loop, ops/model_loop.py), returns
    the pair (lp_static, log_mw_hit): the terms that stay fixed across the
    model-update rounds only, with no profile term, no EPSILON cutoff, no
    division by mw and, paired, no fragment-length term, which the loop
    evaluates again each round."""
    rid = hits.rid.long()
    sid = hits.sid.long()
    dirs, pos = hits.dir, hits.pos
    fl = ref.full_len[sid]
    tl = ref.tot_len[sid]
    msk = ref.mask_start[sid]
    l1 = m1.lens[rid]
    if m2 is None:
        lq = m1.lq[rid]
    else:
        lq = (m1.lq[rid] & m2.lq[rid]) | (l1 < cfg.seed_len) | (
            m2.lens[rid] < cfg.seed_len)
    log_ori = model["log_ori"]
    dl = dirs.long()

    if cfg.paired:
        ins = hits.insert_len
        l2 = m2.lens[rid]
        fpos = torch.where(dirs == 1, tl - pos - ins, pos)
        effL = torch.minimum(fl, tl - ins + 1)
        masked = (fpos >= fl) | ((fpos >= msk) & (fpos < fl))
        lp = (
            log_ori[dl]
            + (0.0 if static_only else log_lendist_adjusted(
                model["log_gld_pdf"], model["log_gld_cdf"], cfg.gld_lb,
                cfg.gld_ub, ins, tl))
            + _safe_log(lin_rspd_adjusted(cfg, model["rspd_pdf"],
                                          model["rspd_cdf"], fpos, effL, fl))
            + log_lendist_adjusted(model["log_mld_pdf"], model["log_mld_cdf"],
                                   cfg.mld_lb, cfg.mld_ub, l1, ins)
            + log_lendist_adjusted(model["log_mld_pdf"], model["log_mld_cdf"],
                                   cfg.mld_lb, cfg.mld_ub, l2, ins)
        )
    else:
        seed_pos = torch.where(dirs == 1, tl - pos - cfg.seed_len, pos)
        masked = (seed_pos >= fl) | ((seed_pos >= msk) & (seed_pos < fl))
        lp = log_ori[dl] + _se_fraglen_term(cfg, model, l1, tl, fl, pos, dirs)

    lp = torch.where(masked | lq, NEG_INF, lp)
    log_mw = model["log_mw"][sid]
    if static_only:
        return lp, log_mw
    log_pro = model["log_pro"].reshape(-1)
    lp = lp + profile_sum_pre(cfg, log_pro, pre.flat1)
    if cfg.paired:
        lp = lp + profile_sum_pre(cfg, log_pro, pre.flat2)
    lp = torch.where(lp < LOG_EPS, NEG_INF, lp)
    return torch.where(log_mw > NEG_INF, lp - log_mw, NEG_INF)


def compute_log_noise_conprb(cfg: KernelConfig, m1: ReadsDevice,
                             m2: Optional[ReadsDevice],
                             model: Dict[str, torch.Tensor],
                             pre: PreIdx) -> torch.Tensor:
    """[N] log noise conprb (getNoiseConPrb; mw[0] is always 1)."""
    log_npro = model["log_npro"].reshape(-1)

    def len_term(lens):
        if cfg.paired or cfg.use_mld:
            return log_lendist_pdf(model["log_mld_pdf"], cfg.mld_lb,
                                   cfg.mld_ub, lens)
        return log_lendist_pdf(model["log_gld_pdf"], cfg.gld_lb, cfg.gld_ub,
                               lens)

    lp = noise_sum_pre(cfg, log_npro, pre.nflat1) + len_term(m1.lens)
    if cfg.paired:
        lp = lp + noise_sum_pre(cfg, log_npro, pre.nflat2) + len_term(m2.lens)
        lq = (m1.lq & m2.lq) | (m1.lens < cfg.seed_len) | (
            m2.lens < cfg.seed_len)
    else:
        lq = m1.lq
    lp = torch.where(lq, NEG_INF, lp)
    return torch.where(lp < LOG_EPS, NEG_INF, lp)


def window_conprbs(cfg: KernelConfig, ref: RefDevice, m1: ReadsDevice,
                   m2: Optional[ReadsDevice], hits: HitsDevice,
                   model: Dict[str, torch.Tensor], w: Window, pre: PreIdx):
    """(log conprb [h1-h0], log noise conprb [r1-r0]) of one window, from
    its PreIdx `pre` (window_preidx): the window's slices of what
    compute_log_conprb and compute_log_noise_conprb give for all hits."""
    return (compute_log_conprb(cfg, ref, m1, m2, hits_window(hits, w),
                               model, pre),
            compute_log_noise_conprb(cfg, reads_window(m1, w),
                                     reads_window(m2, w), model, pre))
