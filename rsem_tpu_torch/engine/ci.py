"""Credibility intervals via Gamma resampling (reference: calcCI.cpp).

Counterpart of rsem_tpu/engine/ci.py, single-device path.

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
columns, and a chunk of genes (or transcripts) sums only its members'
contiguous columns. The mesh path is not ported (ROADMAP A12).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np
import torch

from ..constants import EPSILON
from ..utils.device import DeviceLike, resolve_device

CV_CHUNK = 50  # count vectors sampled per chunk (~200 MB of draws at M=20k)


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
    cat = lambda xs: torch.cat(xs).double().numpy()  # noqa: E731
    return CIBounds(cat(lbs), cat(ubs), cat(cqvs))


def group_starts(groups, M: int) -> np.ndarray:
    """The starts of a GroupInfo over sids 1..M, checked: the chunked
    segment sums need every group a non-empty contiguous run of columns."""
    starts = np.asarray(groups.starts, dtype=np.int64)
    if starts[0] != 1 or starts[-1] != M + 1 or (np.diff(starts) < 1).any():
        raise ValueError(f"groups do not tile sids 1..{M} in contiguous, "
                         "non-empty runs")
    return starts


def group_bounds(tpm: torch.Tensor, inv_lbar: torch.Tensor, groups,
                 member: CIBounds, member_fpkm: CIBounds, cover: int):
    """TPM and FPKM intervals of the groups' summed sample columns (genes
    over isoforms, transcripts over alleles); a group of one member copies
    its member's interval exactly (calcCI.cpp:350-357)."""
    n, M = tpm.shape
    starts = group_starts(groups, M)
    ids = torch.as_tensor(groups.gids_of(np.arange(1, M + 1)),
                          dtype=torch.int64, device=tpm.device)

    def chunk(scale):
        def get(lo, hi):
            c0, c1 = int(starts[lo]) - 1, int(starts[hi]) - 1
            cols = tpm[:, c0:c1]
            if scale is not None:
                cols = cols * scale
            out = torch.zeros((n, hi - lo), dtype=torch.float32,
                              device=tpm.device)
            return out.index_add_(1, ids[c0:c1] - lo, cols)
        return get

    g_tpm = _bounds_chunked(chunk(None), groups.m, n, cover)
    g_fpkm = _bounds_chunked(chunk(inv_lbar), groups.m, n, cover)
    single = np.diff(starts) == 1
    first = starts[:-1][single] - 1  # 0-based member index
    for b_group, b_member in ((g_tpm, member), (g_fpkm, member_fpkm)):
        for f in ("lb", "ub", "cqv"):
            getattr(b_group, f)[single] = getattr(b_member, f)[first]
    return g_tpm, g_fpkm


def run_ci(
    countvectors,  # [nCV, M+1] (Gibbs retained samples; tensor or array)
    eel: np.ndarray,
    mw: np.ndarray,
    gi,
    cfg: CIConfig,
    device: DeviceLike = None,
    ta=None,
) -> CIResult:
    """gi: gene GroupInfo; ta: transcript -> allele GroupInfo of an
    allele-specific reference (adds iso_tpm / iso_fpkm, the transcript
    intervals). Runs on CUDA unless device="cpu" is given."""
    dev = resolve_device(device)
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

    # ---- Phase I: the TPM sample matrix [n, M] on the device ----
    gen = torch.Generator(device=dev).manual_seed(int(cfg.seed))
    tpm = torch.empty((n, M), dtype=torch.float32, device=dev)
    l_bar = torch.empty(n, dtype=torch.float32, device=dev)
    for lo in range(0, nCV, CV_CHUNK):
        hi = min(nCV, lo + CV_CHUNK)
        t, lb = sample_tpm_chunk(gen, cvs[lo:hi], cfg.pseudo_count, inv_mw,
                                 eel_d, eel_ok, usable, cfg.nspc)
        tpm[lo * cfg.nspc:hi * cfg.nspc] = t
        l_bar[lo * cfg.nspc:hi * cfg.nspc] = lb
        del t, lb
    inv_lbar = (1e3 / l_bar)[:, None]

    # ---- Phase II ----
    iso_tpm = _bounds_chunked(lambda lo, hi: tpm[:, lo:hi], M, n, cover)
    iso_fpkm = _bounds_chunked(lambda lo, hi: tpm[:, lo:hi] * inv_lbar, M,
                               n, cover)

    gene_tpm, gene_fpkm = group_bounds(tpm, inv_lbar, gi, iso_tpm, iso_fpkm,
                                       cover)
    trans = (None, None) if ta is None else group_bounds(
        tpm, inv_lbar, ta, iso_tpm, iso_fpkm, cover)

    def with_zero(b: CIBounds) -> CIBounds:
        z = np.zeros(1)
        return CIBounds(np.concatenate([z, b.lb]), np.concatenate([z, b.ub]),
                        np.concatenate([z, b.cqv]))

    return CIResult(tpm=with_zero(iso_tpm), fpkm=with_zero(iso_fpkm),
                    gene_tpm=gene_tpm, gene_fpkm=gene_fpkm,
                    iso_tpm=trans[0], iso_fpkm=trans[1])
