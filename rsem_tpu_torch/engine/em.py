"""The EM quantification engine (reference: EM.cpp).

Counterpart of rsem_tpu/engine/em.py, device backend, per-round model
path (em.py:639-662 there). Everything from the layout upload to the
final counts runs on one device:

  1. upload the reference, reads and hits;
  2. build PreIdx once (kernel K4);
  3. conprbs: per-hit terms + profile gather-sum (K2), noise likewise;
  4. 10 model-update rounds: E-step, sufficient-statistic scatter (K3),
     the host float64 refit (model.finish_round), new conprbs (K2);
  5. freeze the conprbs, scaled per read by their max;
  6. theta-only rounds with the reference's stop rule (kernel K1);
  7. final counts (and posteriors when asked for).

Convergence: max relative theta change over theta >= 1e-7 below 1e-3,
round count in [MIN_ROUND, MAX_ROUND] (EM.cpp:53-55,407-416).

The TPU package's `hybrid`/`native` backends (C++ sidecar model rounds),
its fused model loop and its multi-device path are not ported yet
(ROADMAP A8, A12).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ..convert import model_arrays_to_torch
from ..constants import (
    MAX_ROUND,
    MIN_ROUND,
    STOP_CRITERIA,
    THETA_CUT,
    UPDATE_MODEL_ROUNDS,
)
from ..io.results import calc_expression_values, polish_theta
from ..model.generative import GenerativeModel
from ..ops import theta as theta_ops
from ..ops.conprb import (
    compute_log_conprb,
    compute_log_noise_conprb,
    precompute_profile_indices_fused,
    preidx_bytes,
)
from ..ops.estep import estep_fracs, suffstats
from ..ops.layout import HitsDevice, KernelConfig, ReadsDevice, RefDevice
from ..utils.device import DeviceLike, fetch64, resolve_device


@dataclass
class EMConfig:
    update_model_rounds: int = UPDATE_MODEL_ROUNDS
    min_round: int = MIN_ROUND
    max_round: int = MAX_ROUND
    verbose: bool = False
    backend: str = "auto"  # auto | device (hybrid/native: not ported yet)

    def __post_init__(self):
        if self.min_round > self.max_round:
            raise ValueError(
                f"min_round ({self.min_round}) must be <= max_round "
                f"({self.max_round})"
            )


@dataclass
class EMResult:
    theta_raw: np.ndarray
    theta: np.ndarray
    counts: np.ndarray
    eel: np.ndarray
    tpm: np.ndarray
    fpkm: np.ndarray
    model: GenerativeModel
    rounds: int
    frac_hit: Optional[np.ndarray] = None
    frac_noise: Optional[np.ndarray] = None
    log_conprb: Optional[np.ndarray] = None
    log_ncp: Optional[np.ndarray] = None


def _bchange(theta_new: np.ndarray, theta_old: np.ndarray):
    mask = theta_old >= THETA_CUT
    change = np.zeros_like(theta_old)
    change[mask] = np.abs(theta_new[mask] - theta_old[mask]) / theta_old[mask]
    return change.max(initial=0.0), int((change >= STOP_CRITERIA).sum())


def _theta_init(cnt, M: int) -> np.ndarray:
    theta = np.empty(M + 1)
    theta[0] = max(cnt.N0 / (cnt.n_tot - cnt.N2), 1e-8)
    theta[1:] = (1.0 - theta[0]) / M
    return theta


def _safe_log_np(x: np.ndarray) -> np.ndarray:
    with np.errstate(divide="ignore"):
        return np.log(x)


def _finish(model, theta, counts, rounds, frac_hit, frac_noise, lcp_np,
            lnp_np, need_posteriors) -> EMResult:
    eel = model.calc_eel()
    theta_polished = polish_theta(theta, eel, model.mw)
    tpm, fpkm = calc_expression_values(theta_polished, eel)
    res = EMResult(
        theta_raw=theta.copy(), theta=theta_polished, counts=counts, eel=eel,
        tpm=tpm, fpkm=fpkm, model=model, rounds=rounds,
    )
    if need_posteriors:
        res.frac_hit = frac_hit
        res.frac_noise = frac_noise
        res.log_conprb = lcp_np
        res.log_ncp = lnp_np
    return res


def upload(ref, bundle, paired: bool, device: torch.device):
    """Layout upload: (RefDevice, mate-1 ReadsDevice, mate-2 ReadsDevice or
    None, HitsDevice); paired mates share one width."""
    refd = RefDevice.from_reference(ref, device)
    if paired:
        r1, r2 = bundle.reads.mate1, bundle.reads.mate2
        width = max(r1.codes.shape[1], r2.codes.shape[1])
        m1 = ReadsDevice.from_arrays(r1, device, width)
        m2 = ReadsDevice.from_arrays(r2, device, width)
    else:
        m1 = ReadsDevice.from_arrays(bundle.reads, device)
        m2 = None
    return refd, m1, m2, HitsDevice.from_arrays(bundle.hits, device)


def kernel_config(model, bundle, max_read_len: int) -> KernelConfig:
    """KernelConfig with the quality key window of the reads present."""
    spec = model.spec
    qmax = None
    if spec.has_qual:
        r1 = bundle.reads.mate1 if spec.paired else bundle.reads
        qmax = int(np.max(r1.quals)) if r1.quals is not None else None
        if spec.paired and bundle.reads.mate2.quals is not None:
            qmax = max(qmax or 0, int(np.max(bundle.reads.mate2.quals)))
    return KernelConfig.from_model(model, max_read_len, qmax=qmax)


def _run_em_device(model, ref, bundle, em_cfg: EMConfig,
                   need_posteriors: bool, device: torch.device) -> EMResult:
    spec = model.spec
    cnt = bundle.cnt
    M = ref.M
    N0 = cnt.N0

    refd, m1, m2, hd = upload(ref, bundle, spec.paired, device)
    kcfg = kernel_config(model, bundle, int(m1.codes.shape[1]))
    n_reads = hd.n_reads

    need = preidx_bytes(kcfg, hd.n_hits, n_reads)
    if device.type == "cuda":
        free, _total = torch.cuda.mem_get_info(device)
        if need > free:
            raise MemoryError(
                f"PreIdx needs {need} bytes, the device has {free} free")
    pre = precompute_profile_indices_fused(kcfg, refd, m1, m2, hd)

    sid = hd.sid.long()
    rid = hd.rid.long()
    theta = _theta_init(cnt, M)
    dev_model = model_arrays_to_torch(model.device_arrays(), device)
    log_conprb = compute_log_conprb(kcfg, refd, m1, m2, hd, dev_model, pre)
    log_ncp = compute_log_noise_conprb(kcfg, m1, m2, dev_model, pre)

    rounds = 0
    n_model_rounds = min(em_cfg.update_model_rounds, em_cfg.max_round)
    while rounds < n_model_rounds:
        rounds += 1
        log_theta = torch.as_tensor(_safe_log_np(theta),
                                    dtype=torch.float32).to(device)
        out = estep_fracs(log_theta, sid, rid, log_conprb, log_ncp, n_reads,
                          M)
        c = out.counts.clone()
        c[0] += float(N0)
        new_theta = fetch64(c / c.sum())
        suff = suffstats(kcfg, refd, m1, m2, hd, out.frac_hit,
                         out.frac_noise, float(spec.probF), pre)
        model.finish_round({k: fetch64(v) for k, v in suff.items()})
        dev_model = model_arrays_to_torch(model.device_arrays(), device)
        log_conprb = compute_log_conprb(kcfg, refd, m1, m2, hd, dev_model,
                                        pre)
        log_ncp = compute_log_noise_conprb(kcfg, m1, m2, dev_model, pre)
        bchg, _ = _bchange(new_theta, theta)
        theta = new_theta
        if em_cfg.verbose:
            print(f"ROUND = {rounds}, bChange = {bchg:.6g}")

    lcp_np = lnp_np = None
    if need_posteriors:
        lcp_np = fetch64(log_conprb)
        lnp_np = fetch64(log_ncp)
    data = theta_ops.scale_conprbs(hd, log_conprb, log_ncp, M, float(N0))
    del pre  # the theta loop needs only the frozen conprbs
    theta_t, rounds = theta_ops.run_theta_loop(
        torch.as_tensor(theta, dtype=torch.float32).to(device), data,
        min_round=em_cfg.min_round, max_round=em_cfg.max_round,
        start_round=rounds,
    )
    counts = fetch64(theta_ops.counts(theta_t, data))
    frac_hit = frac_noise = None
    if need_posteriors:
        fh, fn = theta_ops.final_fracs(theta_t, data)
        frac_hit, frac_noise = fetch64(fh), fetch64(fn)
    return _finish(model, fetch64(theta_t), counts, rounds, frac_hit,
                   frac_noise, lcp_np, lnp_np, need_posteriors)


def run_em(
    model: GenerativeModel,
    ref,
    bundle,
    em_cfg: Optional[EMConfig] = None,
    need_posteriors: bool = True,
    device: DeviceLike = None,
) -> EMResult:
    """model: GenerativeModel already initialized via estimate_from_stats;
    ref: refprep.Reference; bundle: io.AlignmentBundle. Runs on CUDA unless
    `device="cpu"` is given (the plain PyTorch versions of the kernels)."""
    em_cfg = em_cfg or EMConfig()
    dev = resolve_device(device)
    if em_cfg.backend not in ("auto", "device"):
        raise NotImplementedError(
            f"EM backend {em_cfg.backend!r} is not ported yet (ROADMAP: "
            "native ingest sidecar and hybrid backend)")
    if bundle.cnt.N1 <= 0:
        raise ValueError("No alignable reads")
    return _run_em_device(model, ref, bundle, em_cfg, need_posteriors, dev)


def write_theta_file(path: str, theta_raw: np.ndarray, theta: np.ndarray):
    """.theta interop (EM.cpp:484-500)."""
    with open(path, "w") as f:
        f.write(f"{len(theta)}\n")
        f.write(" ".join(f"{x:.15g}" for x in theta_raw) + "\n")
        f.write(" ".join(f"{x:.15g}" for x in theta) + "\n")
