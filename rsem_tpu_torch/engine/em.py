"""The EM quantification engine (reference: EM.cpp).

Counterpart of rsem_tpu/engine/em.py, single device. Three backends:

* `device` (and `auto`): everything from the layout upload to the final
  counts runs on one device:
    1. upload the reference, reads and hits;
    2. build PreIdx once (kernel K4) where it fits its byte budget
       (`EMConfig.preidx_budget`; by default the device's free memory
       less a headroom on CUDA, no limit on the CPU); where it does not,
       cut the reads into windows (ops/conprb.plan_windows), each
       window's PreIdx under the budget;
    3. the model-update rounds: with a whole PreIdx where
       `ops.model_loop.fused_supported` holds, all of them in the fused
       loop (`run_model_loop`: conprbs from frozen per-hit terms + profile
       and noise gather-sums (K2), E-step, sufficient-statistic scatters
       (K3), f32 table finishes, no host read between rounds), then one
       host float64 refit from the last round's statistics; elsewhere
       (windowed PreIdx, poly(A) with paired reads or est-RSPD, ...) or
       with `EMConfig(fused_model=False)` the per-round path (em.py:639-662
       there): conprbs (K2), E-step and statistics scatter (K3) every
       round, window after window when windowed (each window's PreIdx
       built by K4 and freed), then the host refit on the totals;
    4. the final model's conprbs (window after window when windowed),
       frozen and scaled per read by their max;
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
round count in [MIN_ROUND, MAX_ROUND] (EM.cpp:53-55,407-416).

Several devices (`dist`, a parallel.distributed process group; the JAX
package's `_run_em_device_sharded`): the device backend runs on every rank
over its own contiguous range of reads (parallel/mesh.shard_bundle_by_read,
no padding), with the steps above and their kernels, and sums over the
ranks where the JAX package psums: the fused loop's counts and statistics
once a round (ops/model_loop), the per-round path's counts and statistics
(its windows planned per rank over the rank's reads), the theta loop's
partial sums once a round (parallel/fast_sharded, K1 split around the
sum), the final counts. Every rank refits the host model from the same
sums, so all hold the same model; the final posteriors and conprbs are
gathered, whole, on every rank (Gibbs needs them whole). The `hybrid` and
`native` backends never shard: each rank runs them whole, as the JAX
package does.
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
    hits_window,
    plan_windows,
    precompute_profile_indices_fused,
    preidx_row_bytes,
    window_conprbs,
    window_preidx,
)
from ..ops.estep import (
    estep_window,
    expected_counts,
    suffstats,
    table_stats,
)
from ..ops.layout import HitsDevice, KernelConfig, ReadsDevice, RefDevice
from ..parallel.distributed import Dist, all_reduce_, all_reduce_dict_, \
    gather_rows
from ..parallel.fast_sharded import (
    counts_sharded,
    final_fracs_sharded,
    run_theta_loop_sharded,
)
from ..parallel.mesh import shard_bundle_by_read
from ..utils.device import DeviceLike, fetch64, fetch_list, \
    resolve_device, to_device
from ..utils.timing import count, span

# The default PreIdx budget on CUDA leaves this headroom of the free device
# memory to the rest of the pass: a fixed part; RUN_BYTES_PER_HIT for every
# hit of the run (the int64 sids, the round's posteriors and the final
# conprbs of _model_rounds); and WORK_BYTES_PER_HIT of working memory for
# every hit of a window beside that window's PreIdx rows (the conprb,
# E-step and statistics temporaries; the fused loop's per-hit data).
# chip_smoke.py measures the working memory with torch.cuda.
# max_memory_allocated (phases 4, 5c, 9 and 9b). On the H100 the most was
# 189.4 bytes per hit: the paired est-RSPD fused loop on a whole PreIdx
# at one hit per read, where per-read working memory weighs most (178.8
# at 2.5 hits per read and 98% of the budget; PERF.md). The constant
# keeps a third above that.
HEADROOM_BYTES = 2 << 30
RUN_BYTES_PER_HIT = 16
WORK_BYTES_PER_HIT = 256


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
    # device backend: PreIdx bytes one window may hold (ops/conprb.
    # plan_windows); None: the free device memory less a headroom on CUDA,
    # no limit on the CPU
    preidx_budget: Optional[int] = None

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
    windows: int = 1  # PreIdx windows of the device backend
    preidx_budget: Optional[int] = None  # the budget they were cut under


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
    None, HitsDevice); paired mates share one width. Served from the
    layout's device cache (ops/layout.py) where the host objects are
    unchanged since an earlier call."""
    refd = RefDevice.from_reference(ref, device)
    if paired:
        width = read_width(bundle, paired)
        m1 = ReadsDevice.from_arrays(bundle.reads.mate1, device, width)
        m2 = ReadsDevice.from_arrays(bundle.reads.mate2, device, width)
    else:
        m1 = ReadsDevice.from_arrays(bundle.reads, device)
        m2 = None
    return refd, m1, m2, HitsDevice.from_arrays(bundle.hits, device)


def read_width(bundle, paired: bool) -> int:
    """Columns of the uploaded read arrays (paired mates share one)."""
    if paired:
        return max(bundle.reads.mate1.codes.shape[1],
                   bundle.reads.mate2.codes.shape[1])
    return int(bundle.reads.codes.shape[1])


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


def preidx_budget(em_cfg: EMConfig, kcfg: KernelConfig,
                  device: torch.device, n_hits: int) -> Optional[int]:
    """The PreIdx bytes one window may hold: em_cfg.preidx_budget where
    set; else on CUDA the device's free memory (the caching allocator's
    unused blocks included) less HEADROOM_BYTES, RUN_BYTES_PER_HIT per hit
    of the run and WORK_BYTES_PER_HIT per hit of the window; else (the CPU)
    no limit."""
    if em_cfg.preidx_budget is not None:
        return int(em_cfg.preidx_budget)
    if device.type != "cuda":
        return None
    free, _total = torch.cuda.mem_get_info(device)
    free += (torch.cuda.memory_reserved(device)
             - torch.cuda.memory_allocated(device))
    avail = free - HEADROOM_BYTES - RUN_BYTES_PER_HIT * n_hits
    row = preidx_row_bytes(kcfg)
    return max(0, avail * row // (row + WORK_BYTES_PER_HIT))


def _window_pre(pre, kcfg, refd, m1, m2, hd, w):
    """The whole PreIdx where there is one, else window w's, built (K4)."""
    return pre if pre is not None else window_preidx(kcfg, refd, m1, m2,
                                                     hd, w)


def _final_conprbs(kcfg, refd, m1, m2, hd, windows, pre, dev_model):
    """The model's log conprb [H] and log noise conprb [N], window after
    window when PreIdx is windowed (`pre` None)."""
    dev = hd.rid.device
    lcp = torch.empty(hd.n_hits, dtype=torch.float32, device=dev)
    lnp = torch.empty(hd.n_reads, dtype=torch.float32, device=dev)
    for w in windows:
        pw = _window_pre(pre, kcfg, refd, m1, m2, hd, w)
        lcp[w.h0:w.h1], lnp[w.r0:w.r1] = window_conprbs(
            kcfg, refd, m1, m2, hd, dev_model, w, pw)
        del pw  # free this window's PreIdx before the next is built
    return lcp, lnp


def _model_rounds(model, kcfg, refd, m1, m2, hd, windows, pre, dev_model,
                  theta, n_rounds: int, verbose: bool, n0: float, device,
                  dist: Optional[Dist] = None):
    """The per-round model path. Each round, window after window: conprbs
    from the current model (K2), the E-step into the round's posteriors,
    the profile and noise scatters (K3) added into one float64 total; then
    the expected counts and the other statistics over all hits and the
    host float64 refit. `pre`: the whole PreIdx (one window), or None:
    each window's PreIdx is built (K4) in each pass and freed after it.
    With `dist` the hits are this rank's, and the counts and statistics
    are summed over the ranks before the refit (n0 added once).
    Returns (theta f64, the refit model's device arrays)."""
    M = len(theta) - 1
    probF = float(model.spec.probF)
    sid = hd.sid.long()
    for rounds in range(1, n_rounds + 1):
        log_theta = to_device(_safe_log_np(theta).astype(np.float32),
                              device)
        frac_hit = torch.empty(hd.n_hits, dtype=torch.float32, device=device)
        frac_noise = torch.empty(hd.n_reads, dtype=torch.float32,
                                 device=device)
        tables = None
        for w in windows:
            pw = _window_pre(pre, kcfg, refd, m1, m2, hd, w)
            lcp, lnp = window_conprbs(kcfg, refd, m1, m2, hd, dev_model, w,
                                      pw)
            out = estep_window(log_theta, hits_window(hd, w), w, lcp, lnp, M)
            frac_hit[w.h0:w.h1] = out.frac_hit
            frac_noise[w.r0:w.r1] = out.frac_noise
            tables = table_stats(kcfg, pw, out.frac_hit, out.frac_noise,
                                 tables)
            del pw, out, lcp, lnp  # free before the next window's build
        c = expected_counts(frac_hit, frac_noise, sid, M)
        if dist is not None:
            all_reduce_dict_({"counts": c, **tables}, dist)
        c[0] += n0
        new_theta = fetch64(c / c.sum())
        suff = suffstats(kcfg, refd, m1, m2, hd, frac_hit, frac_noise, probF,
                         tables=tables)
        if dist is not None:  # the histograms over all hits
            all_reduce_dict_({k: suff[k] for k in ("gld", "rspd")
                              if k in suff}, dist)
        dev_model = _refit(model, _fetch_stats(suff), device)
        bchg, _ = _bchange(new_theta, theta)
        theta = new_theta
        if verbose:
            print(f"ROUND = {rounds}, bChange = {bchg:.6g}")
    return theta, dev_model


def _refit(model, stats: dict, device) -> dict:
    """The host float64 refit from the statistics, and the refit model's
    tables on the device."""
    with span("rsem.em.refit"):
        model.finish_round(stats)
        return model_arrays_to_torch(model.device_arrays(), device)


def _any_rank(flag: bool, dist: Optional[Dist], device) -> bool:
    """`flag` on any rank (one host read); `flag` without a group."""
    if dist is None:
        return flag
    t = torch.tensor([float(flag)], device=device)
    return fetch_list(all_reduce_(t, dist))[0] > 0


def _run_em_device(model, ref, bundle, em_cfg: EMConfig,
                   need_posteriors: bool, device: torch.device,
                   dist: Optional[Dist] = None) -> EMResult:
    spec = model.spec
    cnt = bundle.cnt
    M = ref.M
    N0 = cnt.N0
    with span("rsem.em.setup"):
        shard = None if dist is None else shard_bundle_by_read(
            bundle, dist.world, dist.rank)
        local = bundle if shard is None else shard.bundle
        # from all reads: the ranks' tables must have one shape
        kcfg = kernel_config(model, bundle, read_width(local, spec.paired))
        theta = _theta_init(cnt, M)
        dev_model = model_arrays_to_torch(model.device_arrays(), device)
        n_model_rounds = min(em_cfg.update_model_rounds, em_cfg.max_round)
        min_fl = int(np.min(ref.full_len[1:])) if M >= 1 else 0

    # through the layout's device cache: a repeat call on the same host
    # objects copies nothing. A shard's reads and hits are new slice
    # objects on every call, so they miss it (and are evicted with them)
    with span("rsem.em.upload"):
        refd, m1, m2, hd = upload(ref, local, spec.paired, device)
    n_reads = hd.n_reads

    with span("rsem.em.model_loop"):
        budget = preidx_budget(em_cfg, kcfg, device, hd.n_hits)
        windows = plan_windows(kcfg, local.hits.read_offsets, budget)
        pre = precompute_profile_indices_fused(kcfg, refd, m1, m2, hd) \
            if len(windows) == 1 else None
        if em_cfg.verbose and pre is None:
            print(f"PreIdx in {len(windows)} windows of at most {budget} "
                  "bytes")
        # every rank takes the same path: the fused loop only where no
        # rank is windowed
        whole = not _any_rank(pre is None, dist, device)
        fused = whole and em_cfg.fused_model and n_model_rounds > 0 and \
            model_loop.fused_supported(kcfg, spec.has_polya, min_fl)
        if fused:
            # every model-update round in one stream of device work; the
            # float64 reference refit runs once, on the last round's
            # statistics
            mdata = model_loop.build_model_loop_data(
                kcfg, refd, m1, m2, hd, pre, dev_model, model.npro.c, N0,
                float(spec.probF))
            theta_t, suff = model_loop.run_model_loop(
                kcfg, mdata, model_loop.tables_from_model(kcfg, dev_model),
                to_device(theta.astype(np.float32), device),
                n_model_rounds, n_reads, M, dist=dist)
            del mdata
            stats = _fetch_stats(suff)
        else:
            theta, dev_model = _model_rounds(
                model, kcfg, refd, m1, m2, hd, windows, pre, dev_model,
                theta, n_model_rounds, em_cfg.verbose, float(N0), device,
                dist)
            theta_t = to_device(theta.astype(np.float32), device)
    if fused:
        dev_model = _refit(model, stats, device)

    with span("rsem.em.final_conprbs"):
        log_conprb, log_ncp = _final_conprbs(kcfg, refd, m1, m2, hd,
                                             windows, pre, dev_model)
        lcp_np = lnp_np = None
        if need_posteriors:
            if shard is not None:
                lcp_np = fetch64(gather_rows(log_conprb, shard.hit_sizes,
                                             dist))
                lnp_np = fetch64(gather_rows(log_ncp, shard.read_sizes,
                                             dist))
            else:
                lcp_np = fetch64(log_conprb)
                lnp_np = fetch64(log_ncp)
        data = theta_ops.scale_conprbs(hd, log_conprb, log_ncp, M, float(N0))
        del pre  # the theta loop needs only the frozen conprbs
    loop = dict(min_round=em_cfg.min_round, max_round=em_cfg.max_round,
                start_round=n_model_rounds)
    frac_hit = frac_noise = None
    if shard is not None:
        with span("rsem.em.theta_loop"):
            theta_t, rounds = run_theta_loop_sharded(theta_t, data, dist,
                                                     **loop)
        with span("rsem.em.counts"):
            counts = fetch64(counts_sharded(theta_t, data, dist))
            if need_posteriors:
                fh, fn = final_fracs_sharded(theta_t, data, dist,
                                             shard.hit_sizes,
                                             shard.read_sizes)
                frac_hit, frac_noise = fetch64(fh), fetch64(fn)
    else:
        with span("rsem.em.theta_loop"):
            theta_t, rounds = theta_ops.run_theta_loop(theta_t, data, **loop)
        with span("rsem.em.counts"):
            counts = fetch64(theta_ops.counts(theta_t, data))
            if need_posteriors:
                fh, fn = theta_ops.final_fracs(theta_t, data)
                frac_hit, frac_noise = fetch64(fh), fetch64(fn)
    with span("rsem.em.finish"):
        res = _finish(model, fetch64(theta_t), counts, rounds, frac_hit,
                      frac_noise, lcp_np, lnp_np, need_posteriors)
    res.windows, res.preidx_budget = len(windows), budget
    return res


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
            HitsDevice.from_arrays(hits, device),  # cached, as upload's
            to_device(lcp_np, device), to_device(lnp_np, device), M,
            float(N0))
        theta_t, rounds = theta_ops.run_theta_loop(
            to_device(theta.astype(np.float32), device), data,
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
    dist: Optional[Dist] = None,
) -> EMResult:
    """model: GenerativeModel already initialized via estimate_from_stats;
    ref: refprep.Reference; bundle: io.AlignmentBundle. Runs on CUDA unless
    `device="cpu"` is given (the plain PyTorch versions of the kernels).

    em_cfg.backend: `device` (and `auto`, on CUDA and on the CPU alike),
    `hybrid` or `native` (the C++ sidecar; it needs g++, and raises without
    it), as the module docstring sets out. dist: the process group
    (parallel.distributed.maybe_initialize); every rank passes the whole
    bundle and runs on dist.device; the device backend then shards the
    reads over the ranks, and every rank returns the same result."""
    em_cfg = em_cfg or EMConfig()
    dev = dist.device if dist is not None else resolve_device(device)
    backend = em_cfg.backend
    if backend not in ("auto", "device", "hybrid", "native"):
        raise ValueError(f"unknown EM backend {backend!r}")
    if bundle.cnt.N1 <= 0:
        raise ValueError("No alignable reads")
    count("em_calls")
    with span("rsem.em"):
        if backend in ("hybrid", "native"):
            return _run_em_hybrid(model, ref, bundle, em_cfg,
                                  need_posteriors, dev,
                                  theta_on_host=backend == "native")
        return _run_em_device(model, ref, bundle, em_cfg, need_posteriors,
                              dev, dist)


def write_theta_file(path: str, theta_raw: np.ndarray, theta: np.ndarray):
    """.theta interop (EM.cpp:484-500)."""
    with open(path, "w") as f:
        f.write(f"{len(theta)}\n")
        f.write(" ".join(f"{x:.15g}" for x in theta_raw) + "\n")
        f.write(" ".join(f"{x:.15g}" for x in theta) + "\n")
