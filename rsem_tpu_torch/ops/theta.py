"""Theta-only EM rounds over frozen conprbs (kernel K1) and their loop.

Counterpart of rsem_tpu/ops/pallas_round.py and rsem_tpu/ops/fast_estep.py
(and of ops/ddsum.py, which is not needed: f64 is native on the GPU).
After the model-update rounds the conprbs are frozen and scaled per read
by their max (so linear f32 never underflows); each round is then

    counts_m = theta_m * sum_{hits h of m} cps_h / denom(read of h)
    counts_0 = noise + n0;   theta_new = counts / sum(counts)

with denom(r) = sum_h theta[sid_h] * cps_h + theta_0 * ncs_r (EM.cpp:
199-244 over cached conprbs, 385-398). The hits stay in CSR order by
read_offsets: no K-buckets, no M cap, no quarter-power-of-2 shape menus.
theta stays float32 between rounds, as in the TPU loop; the kernel
accumulates in f64 and the M-step runs in f64.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from ..constants import MAX_ROUND, MIN_ROUND, STOP_CRITERIA, THETA_CUT
from . import _build
from .layout import HitsDevice


class ThetaData(NamedTuple):
    """Frozen per-dataset tensors of the theta loop (one device)."""

    sid: torch.Tensor  # [H] int32
    rid: torch.Tensor  # [H] int64 (plain version and final fractions)
    cps: torch.Tensor  # [H] f32 conprb scaled by its read's max
    ncs: torch.Tensor  # [N] f32 noise conprb scaled alike
    read_offsets: torch.Tensor  # [N+1] int64
    M: int
    n0: float


def scale_conprbs(hits: HitsDevice, log_conprb: torch.Tensor,
                  log_ncp: torch.Tensor, M: int, n0: float) -> ThetaData:
    """Freeze: per-read max-logit scaling on the device (in f64; the scale
    cancels in every round)."""
    rid = hits.rid.long()
    lcp = log_conprb.double()
    lnp = log_ncp.double()
    read_max = torch.full_like(lnp, float("-inf"))
    read_max.scatter_reduce_(0, rid, lcp, "amax", include_self=True)
    read_max = torch.maximum(read_max, lnp)
    safe = torch.where(torch.isfinite(read_max), read_max,
                       torch.zeros_like(read_max))
    cps = torch.exp(lcp - safe[rid])
    ncs = torch.exp(lnp - safe)
    cps = torch.where(torch.isfinite(lcp), cps, torch.zeros_like(cps))
    ncs = torch.where(torch.isfinite(lnp), ncs, torch.zeros_like(ncs))
    return ThetaData(sid=hits.sid, rid=rid, cps=cps.float().contiguous(),
                     ncs=ncs.float().contiguous(),
                     read_offsets=hits.read_offsets, M=M, n0=float(n0))


def _weights(theta: torch.Tensor, data: ThetaData):
    """Per hit w = theta[sid]*cps, per read w0 = theta_0*ncs and the
    inverse denominator 1/(sum w + w0) (0 where the denominator is 0)."""
    w = theta[data.sid.long()] * data.cps
    d = torch.zeros_like(data.ncs).index_add_(0, data.rid, w)
    w0 = theta[0] * data.ncs
    denom = d + w0
    inv = torch.where(denom > 0, 1.0 / torch.where(denom > 0, denom,
                                                    torch.ones_like(denom)),
                      torch.zeros_like(denom))
    return w, w0, inv


def theta_round_plain(theta: torch.Tensor, data: ThetaData
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of K1: (contrib f64 [M+1], noise f64 [1])."""
    _w, w0, inv = _weights(theta, data)
    u = data.cps * inv[data.rid]
    contrib = torch.zeros(data.M + 1, dtype=torch.float64,
                          device=theta.device)
    contrib.index_add_(0, data.sid.long(), u.double())
    noise = (w0 * inv).double().sum().reshape(1)
    return contrib, noise


def theta_round(theta: torch.Tensor, data: ThetaData
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One round's sums before the M-step: contrib f64 [M+1] with
    contrib[m] = sum_{hits of m} cps / denom, and noise f64 [1]."""
    if theta.dtype != torch.float32 or theta.shape != (data.M + 1,):
        raise ValueError("theta must be float32 [M+1]")
    if theta.device.type == "cpu":
        return theta_round_plain(theta, data)
    if theta.device.type != "cuda":
        raise ValueError(f"unsupported device {theta.device}")
    for t in (data.sid, data.cps, data.ncs, data.read_offsets):
        if t.device != theta.device or not t.is_contiguous():
            raise ValueError("theta-round inputs must be contiguous, on one "
                             "device")
    theta = theta.contiguous()
    contrib = torch.zeros(data.M + 1, dtype=torch.float64,
                          device=theta.device)
    noise = torch.zeros(1, dtype=torch.float64, device=theta.device)
    _build.check(_build.lib().rsem_theta_round(
        data.sid.data_ptr(), data.cps.data_ptr(), data.ncs.data_ptr(),
        data.read_offsets.data_ptr(), data.ncs.shape[0], theta.data_ptr(),
        contrib.data_ptr(), noise.data_ptr(), _build.stream_of(theta)),
        "theta_round")
    theta_round.launches += 1
    return contrib, noise


theta_round.launches = 0


def counts(theta: torch.Tensor, data: ThetaData) -> torch.Tensor:
    """f64 [M+1] expected counts at a fixed theta (counts[0] includes
    n0): the reference's final E-step (EM.cpp:460-478) reduced to the
    count vector."""
    contrib, noise = theta_round(theta, data)
    out = contrib * theta.double()
    out[0] = noise[0] + data.n0
    return out


def theta_step(theta: torch.Tensor, data: ThetaData
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One EM round with its M-step: (theta_new f32, counts f64)."""
    c = counts(theta, data)
    return (c / c.sum()).to(torch.float32), c


def n_unconverged(theta_new: torch.Tensor, theta: torch.Tensor) -> int:
    """Entries of theta >= THETA_CUT whose relative change is still >=
    STOP_CRITERIA (EM.cpp:407-416), in float32 as the TPU loop does."""
    mask = theta >= THETA_CUT
    rel = (theta_new - theta).abs() / torch.where(mask, theta,
                                                   torch.ones_like(theta))
    change = torch.where(mask, rel, torch.zeros_like(rel))
    return int((change >= STOP_CRITERIA).sum())


def run_theta_loop(theta0: torch.Tensor, data: ThetaData,
                   min_round: int = MIN_ROUND, max_round: int = MAX_ROUND,
                   start_round: int = 0) -> Tuple[torch.Tensor, int]:
    """The reference's convergence rule (EM.cpp:53-55,407-416): at least
    min_round and at most max_round rounds in total, stopping at the first
    round after which every theta >= THETA_CUT moved by < STOP_CRITERIA.
    The test runs every round (one host read of the count per round)."""
    theta = theta0.to(torch.float32)
    rounds = start_round
    tot = 1
    while rounds < min_round or (tot > 0 and rounds < max_round):
        theta_new, _ = theta_step(theta, data)
        tot = n_unconverged(theta_new, theta)
        theta = theta_new
        rounds += 1
    return theta, rounds


def final_fracs(theta: torch.Tensor, data: ThetaData
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Final posterior responsibilities (EM.cpp:460-478): per hit
    theta[sid]*cps/denom and per read theta_0*ncs/denom, f32, in the
    original hit/read order."""
    w, w0, inv = _weights(theta, data)
    return w * inv[data.rid], w0 * inv
