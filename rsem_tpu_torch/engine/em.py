"""The EM quantification engine (reference: EM.cpp).

Counterpart of rsem_tpu/engine/em.py, single device. Three backends:

* `device` (and `auto`): everything from the layout upload to the final
  counts runs on one device:
    1. upload the reference, reads and hits;
    2. build PreIdx once (kernel K4);
    3. the model-update rounds: where `ops.model_loop.fused_supported`
       holds, all of them in the fused loop (`run_model_loop`: conprbs
       from frozen per-hit terms + profile and noise gather-sums (K2),
       E-step, sufficient-statistic scatters (K3), f32 table finishes, no
       host read between rounds), then one host float64 refit from the
       last round's statistics; elsewhere (poly(A) with paired reads or
       est-RSPD, ...) or with `EMConfig(fused_model=False)` the per-round
       path (em.py:639-662 there): E-step, scatter (K3), host refit and
       new conprbs (K2) every round;
    4. freeze the conprbs, scaled per read by their max;
    5. theta-only rounds with the reference's stop rule (kernel K1);
    6. final counts (and posteriors when asked for).
* `hybrid`: the model rounds and the final conprbs in the C++ sidecar
  (native/, float64 on the host), the theta loop on the run's device (K1
  on the card, its plain version on the CPU).
* `native`: all of it in the C++ sidecar on the host.

`auto` is `device` on CUDA and on the CPU alike: the JAX package picks
`hybrid` on a host without a TPU, but the port's CPU runs exist to run the
kernels' plain versions.

Convergence: max relative theta change over theta >= 1e-7 below 1e-3,
round count in [MIN_ROUND, MAX_ROUND] (EM.cpp:53-55,407-416). The
multi-device path is not ported yet (ROADMAP A12).
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
from .. import native
from ..io.results import calc_expression_values, polish_theta
from ..model.generative import GenerativeModel
from ..ops import model_loop
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
    backend: str = "auto"  # auto | device | hybrid | native
    # device backend: the fused model loop wherever it is supported; False
    # keeps the per-round path (tests and chip_smoke.py compare the two)
    fused_model: bool = True

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


def _fetch_stats(suff) -> dict:
    """The sufficient statistics on the host in float64, with one read."""
    flat = fetch64(torch.cat([v.reshape(-1).double() for v in suff.values()]))
    out, i = {}, 0
    for k, v in suff.items():
        out[k] = flat[i:i + v.numel()].reshape(tuple(v.shape))
        i += v.numel()
    return out


def _model_rounds(model, kcfg, refd, m1, m2, hd, pre, dev_model, theta,
                  n_rounds: int, verbose: bool, n0: float, device):
    """The per-round model path: each round an E-step, the sufficient-
    statistic scatter (K3), the host float64 refit and new conprbs (K2).
    Returns (theta f64, log_conprb, log_ncp)."""
    sid, rid = hd.sid.long(), hd.rid.long()
    log_conprb = compute_log_conprb(kcfg, refd, m1, m2, hd, dev_model, pre)
    log_ncp = compute_log_noise_conprb(kcfg, m1, m2, dev_model, pre)
    for rounds in range(1, n_rounds + 1):
        log_theta = torch.as_tensor(_safe_log_np(theta),
                                    dtype=torch.float32).to(device)
        out = estep_fracs(log_theta, sid, rid, log_conprb, log_ncp,
                          hd.n_reads, len(theta) - 1)
        c = out.counts.clone()
        c[0] += n0
        new_theta = fetch64(c / c.sum())
        suff = suffstats(kcfg, refd, m1, m2, hd, out.frac_hit,
                         out.frac_noise, float(model.spec.probF), pre)
        model.finish_round(_fetch_stats(suff))
        dev_model = model_arrays_to_torch(model.device_arrays(), device)
        log_conprb = compute_log_conprb(kcfg, refd, m1, m2, hd, dev_model,
                                        pre)
        log_ncp = compute_log_noise_conprb(kcfg, m1, m2, dev_model, pre)
        bchg, _ = _bchange(new_theta, theta)
        theta = new_theta
        if verbose:
            print(f"ROUND = {rounds}, bChange = {bchg:.6g}")
    return theta, log_conprb, log_ncp


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

    theta = _theta_init(cnt, M)
    dev_model = model_arrays_to_torch(model.device_arrays(), device)
    n_model_rounds = min(em_cfg.update_model_rounds, em_cfg.max_round)
    min_fl = int(np.min(ref.full_len[1:])) if M >= 1 else 0
    if em_cfg.fused_model and n_model_rounds > 0 and \
            model_loop.fused_supported(kcfg, spec.has_polya, min_fl):
        # every model-update round in one stream of device work; the
        # float64 reference refit runs once, on the last round's statistics
        mdata = model_loop.build_model_loop_data(
            kcfg, refd, m1, m2, hd, pre, dev_model, model.npro.c, N0,
            float(spec.probF))
        theta_t, suff = model_loop.run_model_loop(
            kcfg, mdata, model_loop.tables_from_model(kcfg, dev_model),
            torch.as_tensor(theta, dtype=torch.float32).to(device),
            n_model_rounds, n_reads, M)
        del mdata
        model.finish_round(_fetch_stats(suff))
        dev_model = model_arrays_to_torch(model.device_arrays(), device)
        log_conprb = compute_log_conprb(kcfg, refd, m1, m2, hd, dev_model,
                                        pre)
        log_ncp = compute_log_noise_conprb(kcfg, m1, m2, dev_model, pre)
    else:
        theta, log_conprb, log_ncp = _model_rounds(
            model, kcfg, refd, m1, m2, hd, pre, dev_model, theta,
            n_model_rounds, em_cfg.verbose, float(N0), device)
        theta_t = torch.as_tensor(theta, dtype=torch.float32).to(device)

    lcp_np = lnp_np = None
    if need_posteriors:
        lcp_np = fetch64(log_conprb)
        lnp_np = fetch64(log_ncp)
    data = theta_ops.scale_conprbs(hd, log_conprb, log_ncp, M, float(N0))
    del pre  # the theta loop needs only the frozen conprbs
    theta_t, rounds = theta_ops.run_theta_loop(
        theta_t, data, min_round=em_cfg.min_round,
        max_round=em_cfg.max_round, start_round=n_model_rounds)
    counts = fetch64(theta_ops.counts(theta_t, data))
    frac_hit = frac_noise = None
    if need_posteriors:
        fh, fn = theta_ops.final_fracs(theta_t, data)
        frac_hit, frac_noise = fetch64(fh), fetch64(fn)
    return _finish(model, fetch64(theta_t), counts, rounds, frac_hit,
                   frac_noise, lcp_np, lnp_np, need_posteriors)


def _run_em_hybrid(model, ref, bundle, em_cfg: EMConfig,
                   need_posteriors: bool, device: torch.device,
                   theta_on_host: bool) -> EMResult:
    """The model rounds and the final conprbs in the C++ sidecar, in
    float64 on the host; the theta loop on `device` (K1 on the card), or
    with `theta_on_host` (backend "native") the sidecar's E-step loop."""
    hits = bundle.hits
    M, N0 = ref.M, bundle.cnt.N0
    theta = _theta_init(bundle.cnt, M)
    rounds = 0
    while rounds < em_cfg.update_model_rounds and rounds < em_cfg.max_round:
        rounds += 1
        conprb, ncp = native.native_conprb(hits, bundle.reads, ref, model)
        frac, frac_noise, counts = native.native_em_count_step(
            hits, conprb, ncp, theta, M)
        counts[0] += N0
        new_theta = counts / counts.sum()
        model.finish_round(native.native_suffstats(
            hits, frac.astype(np.float32), frac_noise.astype(np.float32),
            bundle.reads, ref, model))
        bchg, _ = _bchange(new_theta, theta)
        theta = new_theta
        if em_cfg.verbose:
            print(f"ROUND = {rounds}, bChange = {bchg:.6g}")

    # the final model's conprbs
    conprb, ncp = native.native_conprb(hits, bundle.reads, ref, model)
    lcp_np, lnp_np = _safe_log_np(conprb), _safe_log_np(ncp)
    if theta_on_host:
        tot = 1
        while rounds < em_cfg.min_round or (
                tot > 0 and rounds < em_cfg.max_round):
            rounds += 1
            _f, _fn, counts = native.native_em_count_step(hits, conprb, ncp,
                                                          theta, M)
            counts[0] += N0
            new_theta = counts / counts.sum()
            _b, tot = _bchange(new_theta, theta)
            theta = new_theta
    else:
        data = theta_ops.scale_conprbs(
            HitsDevice.from_arrays(hits, device),
            torch.as_tensor(lcp_np).to(device),
            torch.as_tensor(lnp_np).to(device), M, float(N0))
        theta_t, rounds = theta_ops.run_theta_loop(
            torch.as_tensor(theta, dtype=torch.float32).to(device), data,
            min_round=em_cfg.min_round, max_round=em_cfg.max_round,
            start_round=rounds)
        theta = fetch64(theta_t)

    # final expected weights and counts (EM.cpp:460-478)
    frac_hit, frac_noise, counts = native.native_em_count_step(
        hits, conprb, ncp, theta, M)
    counts[0] += N0
    return _finish(model, theta, counts, rounds, frac_hit, frac_noise,
                   lcp_np, lnp_np, need_posteriors)


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
    `device="cpu"` is given (the plain PyTorch versions of the kernels).

    em_cfg.backend: `device` (and `auto`, on CUDA and on the CPU alike),
    `hybrid` or `native` (the C++ sidecar; it needs g++, and raises without
    it), as the module docstring sets out."""
    em_cfg = em_cfg or EMConfig()
    dev = resolve_device(device)
    backend = em_cfg.backend
    if backend not in ("auto", "device", "hybrid", "native"):
        raise ValueError(f"unknown EM backend {backend!r}")
    if bundle.cnt.N1 <= 0:
        raise ValueError("No alignable reads")
    if backend in ("hybrid", "native"):
        return _run_em_hybrid(model, ref, bundle, em_cfg, need_posteriors,
                              dev, theta_on_host=backend == "native")
    return _run_em_device(model, ref, bundle, em_cfg, need_posteriors, dev)


def write_theta_file(path: str, theta_raw: np.ndarray, theta: np.ndarray):
    """.theta interop (EM.cpp:484-500)."""
    with open(path, "w") as f:
        f.write(f"{len(theta)}\n")
        f.write(" ".join(f"{x:.15g}" for x in theta_raw) + "\n")
        f.write(" ".join(f"{x:.15g}" for x in theta) + "\n")
