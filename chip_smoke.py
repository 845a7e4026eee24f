"""Smoke test of the PyTorch/CUDA port (rsem_tpu_torch) on one GPU.

    python3 chip_smoke.py

Needs a CUDA device and nvcc (built with the kernels at first use).
Imports nothing of JAX or of the JAX package. Phases, each of which exits
non-zero on failure:

 1. device: require CUDA; print `nvidia-smi` name and power limit.
 2. build the CUDA kernels (csrc/*.cu) and print the build seconds.
 3. hold each kernel against its plain PyTorch version on the card at the
    shapes of the full-width workload (1M single-end 100 bp reads with
    qualities, ~2.5 alignments per read, M = 20,000 transcripts):
    K4 bit-identical, K2 within rtol 1e-6, K3 within rtol 1e-5 (atol
    1e-6), K1's whole round (E-step sums, M-step, stop count) with counts
    and theta within rtol 1e-5 and the stop count within 2 entries; time
    kernel (K1: per round inside one call of theta.SEGMENT rounds, and
    one round alone), plain version and, where one PyTorch call computes
    the same function, that call (CUDA events, >= 5 warm samples), and
    the bound from bytes and operations. Then the theta loop forced to
    500 rounds (min_round = max_round = 500) on the same frozen data, at
    segments of 1, 16, theta.SEGMENT and 64 rounds: wall ms per round.
 4. drive the main path: rsem_tpu_torch.engine.em.run_em on that workload
    (its default: the fused model loop, then the theta loop), launch
    counts zeroed just before and read just after (every kernel must have
    launched); then >= 5 warm passes; check sum(counts) = N1+N0 and
    sum(TPM) = 1e6.
 5. one more warm pass under torch.profiler, printing device time by
    kernel and the device's idle share.
 5a. the fused model loop against the per-round path at full width:
    run_model_loop for 10 rounds under torch.cuda.set_sync_debug_mode
    ("error") (any host sync fails), then its ms per round (CUDA events);
    run_em with fused_model=True and False in turns, >= 5 warm passes
    each (median, min, max); counts/N1 of the two within rtol 5e-3, atol
    1e-4 and the refit pro.p / npro.p within rtol 5e-3, atol 1e-5 (the
    tolerances of tests/test_model_loop.py:64-72); one warm pass of each
    under torch.profiler.
 5b. the hybrid and native backends (C++ sidecar built with g++), once
    each at full width: wall time, the sidecar's thread count, K1 must
    launch under hybrid, sum(counts) = N1+N0, counts/N1 within rtol 5e-3,
    atol 1e-4 of the device path's.
 6. drive the posterior path at the driver defaults (burn-in 200, 1000
    samples, 8 chains, 50 CI samples per count vector): run_em with
    posteriors -> run_gibbs -> run_ci, launch counts of all five kernels
    zeroed just before and read just after (each must have launched);
    stage wall times; every count vector sums to N0+N1, sum(pme TPM) =
    1e6, finite intervals with lb <= ub; then a warm run_gibbs + run_ci
    under torch.profiler as in phase 5.
 7. hold K5 (Gibbs tile sweep) against its plain version, one initial
    state, 3 sweeps of 8 chains, identical assignments and tables, on the
    layout of that EM's conprbs (T = 20,001), on a mixing variant, and on
    both relabelled s -> 10 s with the table widened to T = 200,001 (a
    human transcriptome's size); time one sweep of each (>= 5 warm
    samples), us per tile step, and the bound from the bytes this run's
    data moves.
 8. calculate-expression through the CLI entry point on the golden SAMs
    (tests/goldens/aln.sam.gz; aln_pe.sam.gz with --paired-end
    --estimate-rspd), each through the fused model loop (its calls are
    counted), compared with the reference RSEM goldens at the
    tolerances of tests/test_parity.py; then --calc-pme and --calc-ci on
    aln.sam.gz at the tolerances of tests/test_parity.py:109 and
    tests/test_parity_extra.py:189-210.

The next-to-last line is {"kernels": [...]}, the last line
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import copy
import gzip
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
GOLD = os.path.join(ROOT, "tests", "goldens")

# Device-memory rate and float32 (non-tensor) peak, from NVIDIA's data
# sheets (SXM parts), keyed by a substring of the device name.
PEAKS = (("H200", 4.8e12, 67e12), ("H100", 3.35e12, 67e12))

# full-width workload (bench.py's synthetic_arrays_fast configuration)
N_READS, M_TX, READ_LEN, TX_LEN = 1_000_000, 20_000, 100, 2000
WARM_PASSES = 5
TIMING_SAMPLES = 7
ISOFORMS_PER_GENE = 4  # gene grouping of the synthetic transcripts
K5_SWEEPS = 3  # sweeps held against the plain version


def fail(msg: str):
    raise RuntimeError(f"chip_smoke: {msg}")


def log(msg: str):
    print(msg, flush=True)


def time_cuda(fn, samples: int = TIMING_SAMPLES, warm: int = 2):
    """(median ms, min ms, max ms) of `fn` over `samples` CUDA-event
    timings after `warm` untimed calls."""
    import torch

    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(samples):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        ts.append(a.elapsed_time(b))
    return statistics.median(ts), min(ts), max(ts)


def bound(nbytes: float, nops: float, mem_rate: float, op_rate: float):
    tb, to = nbytes / mem_rate * 1e3, nops / op_rate * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def close(got, want, rtol: float, atol: float, what: str) -> float:
    """Max |got - want| over finite entries; infinities must coincide."""
    import torch

    g, w = got.double(), want.double()
    fin = torch.isfinite(w)
    if not torch.equal(torch.isfinite(g), fin) or not torch.equal(
            g[~fin], w[~fin]):
        fail(f"{what}: non-finite entries differ")
    d = (g[fin] - w[fin]).abs()
    err = float(d.max()) if d.numel() else 0.0
    bad = d > atol + rtol * w[fin].abs()
    if bool(bad.any()):
        fail(f"{what}: {int(bad.sum())} entries off (max abs err {err})")
    return err


def phase_device():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        sys.exit(2)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True,
        timeout=60,
    ).stdout.strip().splitlines()[0]
    log(smi)
    name = torch.cuda.get_device_name(0)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} device {name} "
        f"count {torch.cuda.device_count()}")
    for key, mem, ops in PEAKS:
        if key in name:
            return name, mem, ops
    log(f"warning: no peak table entry for {name}; using the H100 SXM's")
    return name, PEAKS[-1][1], PEAKS[-1][2]


def phase_build():
    from rsem_tpu_torch.ops import _build

    t0 = time.perf_counter()
    path = _build.build()
    log(f"build: {time.perf_counter() - t0:.2f} s ({path.name})")
    log(_build.build_log)
    _build.lib()


def make_workload():
    from rsem_tpu_torch.testing import synthetic_arrays_fast

    t0 = time.perf_counter()
    ref, bundle, spec, model = synthetic_arrays_fast(
        n_reads=N_READS, M=M_TX, read_len=READ_LEN, tx_len=TX_LEN,
        has_qual=True, seed=0)
    log(f"workload: N={bundle.hits.n_reads} H={bundle.hits.n_hits} "
        f"M={ref.M} T={ref.codes.shape[0]} "
        f"({time.perf_counter() - t0:.1f} s to generate)")
    return ref, bundle, model


def phase_kernels(ref, bundle, model, dev, mem_rate, op_rate):
    """Hold K1-K4 against their plain versions; returns the kernel rows
    (launches filled in later)."""
    import numpy as np
    import torch

    from rsem_tpu_torch.convert import model_arrays_to_torch
    from rsem_tpu_torch.engine import em
    from rsem_tpu_torch.ops import conprb, table, theta

    refd, m1, m2, hd = em.upload(ref, bundle, False, dev)
    kcfg = em.kernel_config(model, bundle, int(m1.codes.shape[1]))
    H, N, L = hd.n_hits, hd.n_reads, kcfg.max_read_len
    cols = conprb.pre_cols(L)
    rows = []

    # K4: PreIdx build
    flat = conprb.preidx_flat(kcfg, refd, m1, hd)
    flat_plain = conprb.preidx_flat_plain(kcfg, refd, m1, hd, False)
    torch.cuda.synchronize()
    if not torch.equal(flat, flat_plain):
        fail("K4 preidx_flat differs from its plain version")
    del flat_plain
    k_ms = time_cuda(lambda: conprb.preidx_flat(kcfg, refd, m1, hd))
    p_ms = time_cuda(
        lambda: conprb.preidx_flat_plain(kcfg, refd, m1, hd, False),
        samples=5, warm=1)
    nbytes = (H * cols * 4 + H * 4 * 4 + 2 * N * L + N * 4
              + refd.codes.numel() + refd.offsets.numel() * 8
              + refd.tot_len.numel() * 4)
    b_ms, b_by = bound(nbytes, H * cols * 4, mem_rate, op_rate)
    rows.append(dict(
        name="preidx_flat", id="K4", route="cuda",
        source="rsem_tpu_torch/csrc/preidx.cu",
        replaces="rsem_tpu/ops/conprb.py:354",
        shape=f"[{H}, {cols}] int32 from {N} reads x {L} bp",
        max_abs_err=0.0, tolerance="bit-identical", ms=k_ms[0],
        ms_min=k_ms[1], ms_max=k_ms[2], plain_ms=p_ms[0], library_ms=None,
        bound_ms=b_ms, bound_by=b_by))

    # K2: gather-sum, profile table over flat (and noise over nflat)
    dm = model_arrays_to_torch(model.device_arrays(), dev)
    tab = table.padded_table(dm["log_pro"].reshape(-1), kcfg.pro_keys())
    got = table.gather_sum(tab, flat)
    err = close(got, table.gather_sum_plain(tab, flat), 1e-6, 1e-6,
                "K2 gather_sum (profile)")
    nflat = conprb.noise_flat(kcfg, m1)
    ntab = table.padded_table(dm["log_npro"].reshape(-1), kcfg.npro_keys())
    err_n = close(table.gather_sum(ntab, nflat),
                  table.gather_sum_plain(ntab, nflat), 1e-6, 1e-6,
                  "K2 gather_sum (noise)")
    k_ms = time_cuda(lambda: table.gather_sum(tab, flat))
    p_ms = time_cuda(lambda: table.gather_sum_plain(tab, flat))
    tab2 = tab[:, None].contiguous()
    l_ms = time_cuda(lambda: torch.nn.functional.embedding_bag(
        flat, tab2, mode="sum"))
    kn_ms = time_cuda(lambda: table.gather_sum(ntab, nflat))
    nbytes = H * cols * 4 + tab.numel() * 4 + H * 4
    b_ms, b_by = bound(nbytes, H * cols, mem_rate, op_rate)
    log(f"K2 noise shape [{N}, {cols}]: {kn_ms[0]:.3f} ms "
        f"(max abs err {err_n:.3g})")
    rows.append(dict(
        name="gather_sum", id="K2", route="cuda",
        source="rsem_tpu_torch/csrc/table.cu",
        replaces="rsem_tpu/ops/pallas_table.py:67",
        shape=f"[{H}, {cols}] int32 idx, {tab.numel()}-slot f32 table",
        max_abs_err=max(err, err_n), tolerance="rtol 1e-6, atol 1e-6",
        ms=k_ms[0], ms_min=k_ms[1], ms_max=k_ms[2], plain_ms=p_ms[0],
        library_ms=l_ms[0], library_call="F.embedding_bag(mode='sum')",
        noise_shape_ms=kn_ms[0], bound_ms=b_ms, bound_by=b_by))

    # K3: scatter-add of per-row weights
    g = torch.Generator(device=dev)
    g.manual_seed(0)
    w = torch.rand(H, generator=g, device=dev, dtype=torch.float32)
    size = kcfg.pro_keys()
    err = close(table.scatter_add(flat, w, size),
                table.scatter_add_plain(flat, w, size), 1e-5, 1e-6,
                "K3 scatter_add (profile)")
    wn = torch.rand(N, generator=g, device=dev, dtype=torch.float32)
    err_n = close(table.scatter_add(nflat, wn, kcfg.npro_keys()),
                  table.scatter_add_plain(nflat, wn, kcfg.npro_keys()),
                  1e-5, 1e-6, "K3 scatter_add (noise)")
    k_ms = time_cuda(lambda: table.scatter_add(flat, w, size))
    p_ms = time_cuda(lambda: table.scatter_add_plain(flat, w, size),
                     samples=5, warm=1)
    idx_l = flat.reshape(-1).long().clamp(max=size)
    w_rep = w.repeat_interleave(cols)
    acc = torch.zeros(size + 1, dtype=torch.float32, device=dev)
    l_ms = time_cuda(lambda: acc.index_add_(0, idx_l, w_rep))
    del idx_l, w_rep
    kn_ms = time_cuda(lambda: table.scatter_add(nflat, wn, kcfg.npro_keys()))
    nbytes = H * cols * 4 + H * 4 + size * 4
    b_ms, b_by = bound(nbytes, H * cols, mem_rate, op_rate)
    log(f"K3 noise shape [{N}, {cols}]: {kn_ms[0]:.3f} ms "
        f"(max abs err {err_n:.3g})")
    rows.append(dict(
        name="scatter_add", id="K3", route="cuda",
        source="rsem_tpu_torch/csrc/table.cu",
        replaces="rsem_tpu/ops/pallas_table.py:125",
        shape=f"[{H}, {cols}] int32 idx, f32 [{H}] weights, {size} slots",
        max_abs_err=max(err, err_n), tolerance="rtol 1e-5, atol 1e-6",
        ms=k_ms[0], ms_min=k_ms[1], ms_max=k_ms[2], plain_ms=p_ms[0],
        library_ms=l_ms[0],
        library_call="index_add_ over pre-expanded indices and weights",
        noise_shape_ms=kn_ms[0], bound_ms=b_ms, bound_by=b_by))

    # K1: theta rounds over the frozen conprbs of the initial model
    pre = conprb.PreIdx(flat, None, nflat, None)
    lcp = conprb.compute_log_conprb(kcfg, refd, m1, None, hd, dm, pre)
    lnp = conprb.compute_log_noise_conprb(kcfg, m1, None, dm, pre)
    del pre, flat, nflat
    data = theta.scale_conprbs(hd, lcp, lnp, ref.M, 0.0)
    th = torch.as_tensor(
        np.random.default_rng(1).dirichlet(np.ones(ref.M + 1)),
        dtype=torch.float32).to(dev)
    seg = theta.SEGMENT
    state = theta.round_state(data, seg, dev)
    state.ring[0] = th
    theta.theta_round(state, data, 1)
    t_p, c_p, n_p = theta.theta_round_plain(th, data)
    err = max(close(state.ring[1], t_p, 1e-5, 1e-9, "K1 theta_round theta"),
              close(state.counts, c_p, 1e-5, 1e-6, "K1 theta_round counts"))
    d_tot = abs(int(state.tot[0]) - int(n_p))
    if d_tot > 2:
        fail(f"K1 stop count {int(state.tot[0])}, plain {int(n_p)}")
    k_ms = [t / seg for t in time_cuda(
        lambda: theta.theta_round(state, data, seg))]
    one_ms = time_cuda(lambda: theta.theta_round(state, data, 1))
    p_ms = time_cuda(lambda: theta.theta_round_plain(th, data))
    # the function's own bytes: hits (sid, cps), reads (ncs, offsets),
    # theta read, counts written, the M-step's counts and theta read and
    # theta_new written, the stop count
    M1 = ref.M + 1
    nbytes = H * 8 + N * 4 + (N + 1) * 8 + M1 * (4 + 8 + 8 + 4) + 4
    b_ms, b_by = bound(nbytes, 4 * H + 3 * N + 6 * M1, mem_rate, op_rate)
    loop = phase_theta_loop(data, dev)
    rows.append(dict(
        name="theta_round", id="K1", route="cuda",
        source="rsem_tpu_torch/csrc/theta_round.cu",
        replaces="rsem_tpu/ops/pallas_round.py:337",
        shape=f"CSR H={H} N={N} M+1={M1}",
        timed=f"one round (E-step sums, M-step, stop count) inside one "
              f"call of {seg} rounds into preallocated buffers",
        max_abs_err=err, stop_count_diff=d_tot,
        tolerance="theta and counts rtol 1e-5 (atol 1e-9 / 1e-6), stop "
                  "count within 2",
        ms=k_ms[0], ms_min=k_ms[1], ms_max=k_ms[2],
        ms_one_round_call=one_ms[0], plain_ms=p_ms[0], library_ms=None,
        bound_ms=b_ms, bound_by=b_by, **loop))
    for r in rows:
        log(f"{r['id']} {r['name']}: kernel {r['ms']:.4f} ms "
            f"[{r['ms_min']:.4f}, {r['ms_max']:.4f}], plain "
            f"{r['plain_ms']:.3f} ms, library {r['library_ms']}, bound "
            f"{r['bound_ms']:.3f} ms ({r['bound_by']}), max abs err "
            f"{r['max_abs_err']:.3g}")
    return rows


def phase_theta_loop(data, dev, rounds: int = 500, samples: int = 3):
    """The theta loop forced to `rounds` rounds (min_round = max_round) on
    the frozen data, from a uniform theta, with segments of 1 round (a
    host read of the stop count after every round), of theta.SEGMENT and,
    for the choice of it, of 16 and 64 rounds: wall ms per round (host
    clock around a synchronised call, median of `samples`)."""
    import torch

    from rsem_tpu_torch.ops import theta

    th0 = torch.full((data.M + 1,), 1.0 / (data.M + 1), device=dev)
    kept = theta.SEGMENT
    per_round = {}
    try:
        for seg in sorted({1, 16, kept, 64}):
            theta.SEGMENT = seg
            ws = []
            for _ in range(samples):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                _t, r = theta.run_theta_loop(th0, data, min_round=rounds,
                                             max_round=rounds)
                torch.cuda.synchronize()
                ws.append((time.perf_counter() - t0) * 1e3 / rounds)
                if r != rounds:
                    fail(f"theta loop ran {r} rounds, not {rounds}")
            per_round[seg] = statistics.median(ws)
            log(f"theta loop, {rounds} rounds, segment {seg}: "
                f"{per_round[seg]:.4f} ms per round (median of {samples}; "
                f"{', '.join(f'{w:.4f}' for w in ws)})")
    finally:
        theta.SEGMENT = kept
    return {"segment": kept, f"loop{rounds}_ms_per_round": per_round[kept],
            f"loop{rounds}_ms_per_round_segment_1": per_round[1],
            f"loop{rounds}_ms_per_round_by_segment": {
                str(k): v for k, v in per_round.items()}}


def kernel_wrappers():
    """Every kernel wrapper of the port, by the name its row carries."""
    from rsem_tpu_torch.ops import conprb, gibbs, table, theta

    return {"preidx_flat": conprb.preidx_flat,
            "gather_sum": table.gather_sum,
            "scatter_add": table.scatter_add,
            "theta_round": theta.theta_round,
            "sweep_part": gibbs.sweep_part}


def phase_main_path(ref, bundle, model0, dev):
    """Full-width run_em: cold pass with launch counts, then warm passes."""
    import numpy as np
    import torch

    from rsem_tpu_torch.engine.em import EMConfig, run_em

    wrappers = kernel_wrappers()
    del wrappers["sweep_part"]  # not on this path
    for fn in wrappers.values():
        fn.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    res = run_em(copy.deepcopy(model0), ref, bundle, EMConfig(),
                 need_posteriors=False, device=dev)
    cold = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in wrappers.items()}
    log(f"main path: run_em cold {cold:.3f} s, rounds {res.rounds}, "
        f"launches {launches}, peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    for k, n in launches.items():
        if n <= 0:
            fail(f"kernel {k} was not launched on the main path")
    warm = []
    for _ in range(WARM_PASSES):
        t0 = time.perf_counter()
        r = run_em(copy.deepcopy(model0), ref, bundle, EMConfig(),
                   need_posteriors=False, device=dev)
        warm.append(time.perf_counter() - t0)
        if r.rounds != res.rounds:
            fail(f"warm pass took {r.rounds} rounds, cold {res.rounds}")
    log(f"main path: run_em warm median {statistics.median(warm):.3f} s "
        f"min {min(warm):.3f} max {max(warm):.3f} over {len(warm)} passes")
    cnt = bundle.cnt
    want = cnt.N1 + cnt.N0
    if not np.all(np.isfinite(res.counts)) or res.counts.shape != (ref.M + 1,):
        fail("counts are not finite [M+1]")
    if abs(res.counts.sum() - want) > 1e-5 * want:
        fail(f"sum(counts) {res.counts.sum()} != N1+N0 {want}")
    if abs(res.tpm.sum() - 1e6) > 1.0:
        fail(f"sum(TPM) {res.tpm.sum()} != 1e6")
    log(f"main path: sum(counts) {res.counts.sum():.3f} (N1+N0 {want}), "
        f"sum(TPM) {res.tpm.sum():.6f}")
    return launches, cold, warm, res.rounds


def phase_profile(label, fn):
    """One warm call of `fn` under torch.profiler: device time by kernel
    and the device's idle share of the call's wall time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kern = [e for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kern:
        fail("the profiler saw no device activity")
    busy_us = sum(e.device_time for e in kern)
    by_name = {}
    for e in kern:
        n, t = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (n + 1, t + e.device_time)
    log(f"profile: {label} wall {wall * 1e3:.1f} ms (profiled), device busy "
        f"{busy_us / 1e3:.1f} ms, idle share {1 - busy_us / 1e6 / wall:.3f}")
    for n, (c, t) in sorted(by_name.items(), key=lambda kv: -kv[1][1])[:15]:
        log(f"profile:   {t / 1e3:9.3f} ms  {c:5d}x  {n[:90]}")


def agree(got, want, rtol: float, atol: float, what: str) -> float:
    """Max |got - want| of two host arrays; fails outside atol + rtol |want|."""
    import numpy as np

    d = np.abs(np.asarray(got, dtype=float) - np.asarray(want, dtype=float))
    bad = d > atol + rtol * np.abs(want)
    if bad.any():
        fail(f"{what}: {int(bad.sum())} entries off (max abs err "
             f"{d.max()})")
    return float(d.max())


def phase_fused(ref, bundle, model0, dev, rounds: int = 10):
    """The fused model loop against the per-round path at full width.
    Returns (the fused run_em result, a summary for the log)."""
    import numpy as np
    import torch

    from rsem_tpu_torch.convert import model_arrays_to_torch
    from rsem_tpu_torch.engine import em
    from rsem_tpu_torch.ops import conprb, model_loop

    refd, m1, m2, hd = em.upload(ref, bundle, False, dev)
    kcfg = em.kernel_config(model0, bundle, int(m1.codes.shape[1]))
    pre = conprb.precompute_profile_indices_fused(kcfg, refd, m1, m2, hd)
    dm = model_arrays_to_torch(model0.device_arrays(), dev)
    data = model_loop.build_model_loop_data(
        kcfg, refd, m1, m2, hd, pre, dm, model0.npro.c, bundle.cnt.N0,
        float(model0.spec.probF))
    tables = model_loop.tables_from_model(kcfg, dm)
    theta0 = torch.as_tensor(em._theta_init(bundle.cnt, ref.M),
                             dtype=torch.float32).to(dev)

    def loop():
        return model_loop.run_model_loop(kcfg, data, tables, theta0, rounds,
                                         hd.n_reads, ref.M)

    torch.cuda.synchronize()
    mode = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        theta, _suff = loop()
    except RuntimeError as exc:
        fail(f"the fused loop synchronised with the host: {exc}")
    finally:
        torch.cuda.set_sync_debug_mode(mode)
    torch.cuda.synchronize()
    if not bool(torch.isfinite(theta).all()) or abs(
            float(theta.double().sum()) - 1.0) > 1e-4:
        fail("fused loop: theta is not a finite distribution")
    ms = [t / rounds for t in time_cuda(loop, samples=5, warm=1)]
    log(f"fused loop: {rounds} rounds with no host sync (sync debug mode "
        f"'error'); {ms[0]:.4f} ms per round [{ms[1]:.4f}, {ms[2]:.4f}] "
        f"(CUDA events, median of 5)")
    del data, pre, tables, refd, m1, hd
    torch.cuda.empty_cache()

    def run(fused):
        return em.run_em(copy.deepcopy(model0), ref, bundle,
                         em.EMConfig(fused_model=fused),
                         need_posteriors=False, device=dev)

    res = {True: run(True), False: run(False)}
    walls = {True: [], False: []}
    for i in range(WARM_PASSES):
        for fused in ((True, False) if i % 2 == 0 else (False, True)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res[fused] = run(fused)
            walls[fused].append(time.perf_counter() - t0)
    summary = {"loop_ms_per_round": ms[0], "loop_ms_per_round_min": ms[1],
               "loop_ms_per_round_max": ms[2]}
    for fused, name in ((True, "fused"), (False, "per_round")):
        w = walls[fused]
        summary[f"{name}_warm_s"] = w
        log(f"run_em {name}: {res[fused].rounds} rounds, warm median "
            f"{statistics.median(w):.3f} s min {min(w):.3f} max {max(w):.3f}"
            f" over {len(w)} passes (in turns with the other path)")
    a, b, n1 = res[True], res[False], bundle.cnt.N1
    if a.rounds != b.rounds:
        fail(f"fused path took {a.rounds} rounds, per-round {b.rounds}")
    errs = (agree(a.counts / n1, b.counts / n1, 5e-3, 1e-4, "counts/N1"),
            agree(a.model.pro.p, b.model.pro.p, 5e-3, 1e-5, "pro.p"),
            agree(a.model.npro.p, b.model.npro.p, 5e-3, 1e-5, "npro.p"))
    summary["max_abs_err_counts_pro_npro"] = errs
    log(f"fused vs per-round: max abs err counts/N1 {errs[0]:.3g}, pro.p "
        f"{errs[1]:.3g}, npro.p {errs[2]:.3g} (rtol 5e-3; atol 1e-4 / "
        f"1e-5)")
    if not np.all(np.isfinite(a.counts)):
        fail("fused path: counts are not finite")
    phase_profile("run_em fused", lambda: run(True))
    phase_profile("run_em per-round", lambda: run(False))
    return a, summary


def phase_backends(ref, bundle, model0, dev, device_res):
    """The hybrid (C++ model rounds, K1 theta loop) and native (all on the
    host) backends once each at full width, against the device path."""
    import torch

    from rsem_tpu_torch import native
    from rsem_tpu_torch.engine import em
    from rsem_tpu_torch.ops import theta

    t0 = time.perf_counter()
    native.lib()
    log(f"native sidecar: built or loaded in {time.perf_counter() - t0:.2f}"
        f" s ({native.library_path().parent.name}), "
        f"{native.default_threads()} threads")
    cnt = bundle.cnt
    want = cnt.N1 + cnt.N0
    out = {}
    for backend in ("hybrid", "native"):
        k1 = theta.theta_round.launches
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = em.run_em(copy.deepcopy(model0), ref, bundle,
                      em.EMConfig(backend=backend), need_posteriors=False,
                      device=dev)
        wall = time.perf_counter() - t0
        k1 = theta.theta_round.launches - k1
        if backend == "hybrid" and k1 <= 0:
            fail("K1 was not launched under the hybrid backend")
        if abs(r.counts.sum() - want) > 1e-6 * want:
            fail(f"{backend}: sum(counts) {r.counts.sum()} != N1+N0 {want}")
        err = agree(r.counts / cnt.N1, device_res.counts / cnt.N1, 5e-3,
                    1e-4, f"{backend} counts/N1 against the device path")
        out[backend] = {"wall_s": wall, "rounds": r.rounds,
                        "k1_launches": k1, "threads": native.default_threads()}
        log(f"backend {backend}: {wall:.3f} s at full width, {r.rounds} "
            f"rounds, {native.default_threads()} C++ threads, K1 launches "
            f"{k1}, sum(counts) {r.counts.sum():.3f}, counts/N1 max abs err "
            f"against the device path {err:.3g}")
    return out


def gene_groups(M: int):
    from rsem_tpu_torch.refprep.transcripts import GroupInfo
    import numpy as np

    return GroupInfo(np.concatenate(
        [np.arange(1, M + 1, ISOFORMS_PER_GENE), [M + 1]]))


def phase_posterior(ref, bundle, model0, dev):
    """The posterior path at full width and the driver defaults: run_em
    with posteriors -> run_gibbs -> run_ci. Returns (em result, fitted
    model, launches, stage seconds)."""
    import numpy as np
    import torch

    from rsem_tpu_torch.engine.ci import CIConfig, run_ci
    from rsem_tpu_torch.engine.em import EMConfig, run_em
    from rsem_tpu_torch.engine.gibbs import GibbsConfig, run_gibbs

    M, cnt = ref.M, bundle.cnt
    gi = gene_groups(M)
    gcfg = GibbsConfig(seed=1)  # burnin 200, 1000 samples, 8 chains
    wrappers = kernel_wrappers()
    for fn in wrappers.values():
        fn.launches = 0
    torch.cuda.synchronize()
    secs = {}
    t0 = time.perf_counter()
    model = copy.deepcopy(model0)
    em = run_em(model, ref, bundle, EMConfig(), need_posteriors=True,
                device=dev)
    t1 = time.perf_counter()
    secs["em"] = t1 - t0
    gres = run_gibbs(bundle.hits, em.log_conprb, em.log_ncp, M, cnt.N0,
                     em.eel, model.mw, gi, gcfg, omit=bundle.omit,
                     device=dev)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    secs["gibbs"] = t2 - t1
    ci = run_ci(gres.countvectors, em.eel, model.mw, gi, CIConfig(seed=2),
                device=dev)
    torch.cuda.synchronize()
    secs["ci"] = time.perf_counter() - t2
    launches = {k: fn.launches for k, fn in wrappers.items()}
    log(f"posterior path: stage seconds {secs}, launches {launches}, peak "
        f"device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    for k, n in launches.items():
        if n <= 0:
            fail(f"kernel {k} was not launched on the posterior path")
    cv = gres.countvectors
    if tuple(cv.shape) != (gcfg.nsamples, M + 1):
        fail(f"countvectors shape {tuple(cv.shape)}")
    want = cnt.N0 + cnt.N1
    sums = cv.double().sum(1)
    if not bool((sums == want).all()) or bool((cv[:, 1:] < 0).any()):
        fail(f"count vectors do not conserve N0+N1 = {want} (sums "
             f"{float(sums.min())}..{float(sums.max())})")
    tpm_sum = float(gres.pme_tpm.sum())
    # per-sample TPMs are f32 vectors of 20,000 entries summing to 1e6
    if abs(tpm_sum - 1e6) > 1e-5 * 1e6:
        fail(f"sum(pme TPM) {tpm_sum} != 1e6")
    for name in ("tpm", "fpkm", "gene_tpm", "gene_fpkm"):
        b = getattr(ci, name)
        if not (np.isfinite(b.lb).all() and np.isfinite(b.ub).all()
                and (b.lb <= b.ub + 1e-6).all()):
            fail(f"CI {name}: non-finite bounds or lb > ub")
    log(f"posterior path: every count vector sums to {want}, sum(pme TPM) "
        f"{tpm_sum:.6f}, sum(pme counts) {gres.pme_c.sum():.3f}, CI "
        f"median TPM width {np.median(ci.tpm.ub[1:] - ci.tpm.lb[1:]):.3f}")
    phase_profile("run_gibbs + run_ci", lambda: run_ci(run_gibbs(
        bundle.hits, em.log_conprb, em.log_ncp, M, cnt.N0, em.eel, model.mw,
        gi, gcfg, omit=bundle.omit, device=dev).countvectors, em.eel,
        model.mw, gi, CIConfig(seed=2), device=dev))
    return em, model, launches, secs


def phase_k5(ref, bundle, em, dev, mem_rate, op_rate):
    """K5 against its plain version at full width, K5_SWEEPS sweeps of 8
    chains from one initial state each way: on the posterior path's layout
    (T = M+1 = 20,001), on a mixing variant (the same alignments with
    conprbs drawn from a seed, so reads move between alignments and noise;
    the workload's decoy alignments have conprbs that underflow, which pins
    most reads), and on both relabelled s -> 10 s with the table widened to
    T = 200,001. Then one sweep's time of each. Returns the K5 row."""
    import numpy as np
    import torch

    from rsem_tpu_torch.ops import gibbs
    from rsem_tpu_torch.testing import relabel_layout

    M, C = ref.M, 8

    def setup(lcp, lnp, label):
        t0 = time.perf_counter()
        layout = gibbs.build_layout(bundle.hits, lcp, lnp, M, device=dev)
        t1 = time.perf_counter()
        base = torch.ones(M + 1)
        base[0] += bundle.cnt.N0 + layout.n_noise_fixed
        assigns, tab = gibbs.init_chains(layout, base, C, seed=1, device=dev)
        log(f"K5 {label} layout: {len(layout.parts)} parts, widths "
            f"{[p.K for p in layout.parts]}, {layout.n_tiles} tiles per "
            f"sweep, {layout.n_reads} reads, {layout.n_slots} slots; host "
            f"build {t1 - t0:.3f} s, chain init {time.perf_counter() - t1:.3f}"
            f" s")
        return layout, assigns, tab

    def hold(layout, assigns, tab, label):
        """Identical to the plain version over K5_SWEEPS sweeps, one delta
        scratch for all of them; returns the kernel's (median, min, max) ms
        per sweep, the plain sweep, and the assignments and table entries
        that one sweep changes (mean over the plain sweeps)."""
        seeds = [gibbs.part_seed(1, pi) for pi in range(len(layout.parts))]
        a_k = [a.clone() for a in assigns]
        a_p = [a.clone() for a in assigns]
        t_k, t_p = tab.clone(), tab.clone()
        scratch = gibbs.delta_scratch(t_k)

        def kern(a, t, part, sp, s):
            gibbs.sweep_part(a, t, part, sp, s, scratch)

        def sweep(fn, a_s, t, s):
            for part, a, sp in zip(layout.parts, a_s, seeds):
                fn(a, t, part, sp, s)

        n0 = gibbs.sweep_part.launches
        moved = changed = 0
        for s in range(K5_SWEEPS):
            sweep(kern, a_k, t_k, s)
            a_0, t_0 = [a.clone() for a in a_p], t_p.clone()
            sweep(gibbs.sweep_part_plain, a_p, t_p, s)
            moved += sum(int((x != y).sum()) for x, y in zip(a_p, a_0))
            changed += int((t_p != t_0).sum())
        torch.cuda.synchronize()
        if gibbs.sweep_part.launches - n0 != K5_SWEEPS * len(layout.parts):
            fail(f"K5 ({label}) launched {gibbs.sweep_part.launches - n0} "
                 f"times, not {K5_SWEEPS * len(layout.parts)}")
        n_diff = sum(int((x != y).sum()) for x, y in zip(a_k, a_p))
        if n_diff or not torch.equal(t_k, t_p) or bool(scratch.any()):
            fail(f"K5 ({label}) differs from its plain version after "
                 f"{K5_SWEEPS} sweeps: {n_diff} assignments, max table diff "
                 f"{float((t_k - t_p).abs().max())}, scratch left non-zero "
                 f"{bool(scratch.any())}")
        k_ms = time_cuda(lambda: sweep(kern, a_k, t_k, K5_SWEEPS))
        log(f"K5 {label} (T = {tab.shape[1]}): identical to the plain version"
            f" over {K5_SWEEPS} sweeps x {C} chains ({moved} of "
            f"{K5_SWEEPS * C * layout.n_reads} read assignments moved); "
            f"{k_ms[0]:.3f} ms per sweep [{k_ms[1]:.3f}, {k_ms[2]:.3f}], "
            f"{k_ms[0] * 1e3 / layout.n_tiles:.2f} us per tile step")
        return (k_ms, lambda: sweep(gibbs.sweep_part_plain, a_p, t_p,
                                    K5_SWEEPS),
                moved / K5_SWEEPS, changed / K5_SWEEPS)

    def k5_bound(layout, moved, changed):
        """Bytes of one sweep: each placed slot's sid and cps and each
        read's ncs once; every chain's assignments read once and the ones
        that move written; every chain's table entries that the layout
        touches (its distinct sids and the noise entry) read once and the
        ones that change written. Operations: ~8 f32 per slot and per read
        per chain."""
        n_sids = int(torch.unique(torch.cat(
            [p.sid for p in layout.parts])).numel()) + 1
        nbytes = (layout.n_slots * 8 + layout.n_reads * 4 +
                  C * layout.n_reads * 4 + moved * 4 + C * n_sids * 4 +
                  changed * 4)
        return bound(nbytes, C * (layout.n_slots + layout.n_reads) * 8,
                     mem_rate, op_rate) + (nbytes, n_sids)

    layout, assigns, tab = setup(em.log_conprb, em.log_ncp, "EM conprbs")
    k_ms, plain_sweep, moved, changed = hold(layout, assigns, tab,
                                             "EM conprbs")
    p_ms = time_cuda(plain_sweep, samples=5, warm=1)
    big_layout, big = relabel_layout(layout, tab)
    big_ms, _p, big_moved, big_changed = hold(
        big_layout, assigns, big, "EM conprbs relabelled")
    rng = np.random.default_rng(5)
    kept = np.isfinite(em.log_conprb)
    lcp_mix = np.where(kept, rng.normal(-20.0, 2.0, kept.shape), -np.inf)
    lnp_mix = rng.normal(-23.0, 2.0, em.log_ncp.shape)
    mix = setup(lcp_mix, lnp_mix, "mixing variant")
    mix_ms, _p, mix_moved, _c = hold(*mix, "mixing variant")
    big_mix = relabel_layout(mix[0], mix[2])
    big_mix_ms, _p, _m, _c = hold(big_mix[0], mix[1], big_mix[1],
                                  "mixing variant relabelled")
    n_tiles = layout.n_tiles
    b_ms, b_by, nbytes, n_sids = k5_bound(layout, moved, changed)
    bl_ms, _by, _nb, _ns = k5_bound(big_layout, big_moved, big_changed)
    log(f"K5: one sweep = {n_tiles} tile steps in sequence per chain; "
        f"{k_ms[0] * 1e3 / n_tiles:.2f} us per tile step at T = {M + 1}, "
        f"{big_ms[0] * 1e3 / n_tiles:.2f} at T = {big.shape[1]}; bound "
        f"{b_ms * 1e3:.2f} us per sweep ({b_by}: {nbytes} bytes, {n_sids} "
        f"table entries touched per chain, {moved:.0f} assignments and "
        f"{changed:.0f} table entries changed per sweep; mixing variant "
        f"{mix_moved:.0f} assignments moved per sweep), "
        f"{bl_ms * 1e3:.2f} us at the large table")
    us = lambda ms: ms[0] * 1e3 / n_tiles  # noqa: E731
    return dict(
        name="sweep_part", id="K5", route="cuda",
        source="rsem_tpu_torch/csrc/gibbs_sweep.cu",
        replaces="rsem_tpu/ops/pallas_gibbs.py:371",
        shape=f"{len(layout.parts)} parts, {n_tiles} tiles of 8192 "
              f"slots, {layout.n_reads} reads, {layout.n_slots} slots, {C} "
              f"chains, table [{C}, {M + 1}] (large table [{C}, "
              f"{big.shape[1]}])",
        max_abs_err=0.0, tolerance="identical assignments and tables",
        ms=k_ms[0], ms_min=k_ms[1], ms_max=k_ms[2], us_per_tile=us(k_ms),
        plain_ms=p_ms[0], library_ms=None, bound_ms=b_ms, bound_by=b_by,
        ms_large_table=big_ms[0], ms_large_table_min=big_ms[1],
        ms_large_table_max=big_ms[2], us_per_tile_large_table=us(big_ms),
        bound_ms_large_table=bl_ms, ms_mixing=mix_ms[0],
        ms_large_table_mixing=big_mix_ms[0], tiles_per_sweep=n_tiles)


def _read_table(path):
    rows = [l.rstrip("\n").split("\t") for l in open(path)]
    return {r[0]: r for r in rows[1:]}


def phase_goldens():
    """calculate-expression on the golden SAMs, against reference RSEM."""
    from rsem_tpu_torch.ops import model_loop
    from rsem_tpu_torch.pipeline.calculate_expression import main as calc

    cases = (("aln", "golden", [], 0.011, 2e-4),
             ("aln_pe", "golden_pe", ["--paired-end", "--estimate-rspd"],
              0.05, 5e-4))
    loop, fused_calls = model_loop.run_model_loop, []
    model_loop.run_model_loop = lambda *a, **k: (
        fused_calls.append(1), loop(*a, **k))[1]
    try:
        _goldens(cases, calc, fused_calls)
    finally:
        model_loop.run_model_loop = loop


def _goldens(cases, calc, fused_calls):
    with tempfile.TemporaryDirectory() as d:
        for f in ("ref.seq", "ref.ti", "ref.grp"):
            shutil.copy(os.path.join(GOLD, f), d)
        for sam, gold, extra, eff_abs, tpm_rel in cases:
            with gzip.open(os.path.join(GOLD, f"{sam}.sam.gz"), "rb") as fi, \
                    open(os.path.join(d, f"{sam}.sam"), "wb") as fo:
                shutil.copyfileobj(fi, fo)
            out = os.path.join(d, sam)
            n_fused = len(fused_calls)
            t0 = time.perf_counter()
            rc = calc(["--alignments", os.path.join(d, f"{sam}.sam"),
                       os.path.join(d, "ref"), out, "-q", "--device", "cuda"]
                      + extra)
            secs = time.perf_counter() - t0
            if rc != 0:
                fail(f"calculate-expression on {sam} returned {rc}")
            if len(fused_calls) != n_fused + 1:
                fail(f"calculate-expression on {sam} did not run the fused "
                     f"model loop once")
            g_cnt = open(os.path.join(GOLD, f"{gold}.cnt")).read()
            o_cnt = open(os.path.join(d, f"{sam}.stat", f"{sam}.cnt")).read()
            if o_cnt.splitlines()[:3] != g_cnt.splitlines()[:3]:
                fail(f"{sam}: .cnt differs from the golden")
            gold_t = _read_table(os.path.join(GOLD, f"{gold}.isoforms.results"))
            mine = _read_table(f"{out}.isoforms.results")
            if set(gold_t) != set(mine):
                fail(f"{sam}: transcript sets differ")
            cnt_err = tpm_err = eff_err = 0.0
            for tid, g in gold_t.items():
                o = mine[tid]
                eff_err = max(eff_err, abs(float(o[3]) - float(g[3])))
                cnt_err = max(cnt_err, abs(float(o[4]) - float(g[4])))
                tpm_err = max(tpm_err, abs(float(o[5]) - float(g[5])) / 1e6)
            log(f"golden {sam} (fused model loop): {secs:.2f} s, max count "
                f"err {cnt_err:.4g}, "
                f"max rel TPM err {tpm_err:.3g}, max eff-len err "
                f"{eff_err:.3g}")
            if cnt_err >= 1.0 or tpm_err >= tpm_rel or eff_err > eff_abs:
                fail(f"{sam}: results outside the golden tolerances")
        phase_posterior_goldens(d, calc)


def phase_posterior_goldens(d, calc):
    """--calc-pme and --calc-ci on aln.sam (already in `d`) on the card."""
    sam, ref = os.path.join(d, "aln.sam"), os.path.join(d, "ref")
    common = ["--alignments", sam, ref, "-q", "--device", "cuda", "--seed",
              "1234", "--gibbs-burnin", "50", "--no-bam-output"]
    t0 = time.perf_counter()
    out = os.path.join(d, "pme")
    if calc(common[:3] + [out] + common[3:] + [
            "--calc-pme", "--gibbs-number-of-samples", "400"]) != 0:
        fail("calculate-expression --calc-pme failed")
    gold_t = _read_table(os.path.join(GOLD, "golden_pme.isoforms.results"))
    mine = _read_table(f"{out}.isoforms.results")
    hdr = open(os.path.join(GOLD, "golden_pme.isoforms.results")).readline(
        ).rstrip("\n").split("\t")
    pme_i = hdr.index("posterior_mean_count")
    sd_i = hdr.index("posterior_standard_deviation_of_count")
    worst = 0.0
    for tid, g in gold_t.items():
        dev_ = abs(float(mine[tid][pme_i]) - float(g[pme_i]))
        lim = max(2.0 * float(g[sd_i]), 1.5)
        worst = max(worst, dev_ / lim)
        if dev_ >= lim:
            fail(f"--calc-pme {tid}: pme {mine[tid][pme_i]} vs golden "
                 f"{g[pme_i]} (sd {g[sd_i]})")
    t1 = time.perf_counter()
    log(f"golden --calc-pme: {t1 - t0:.2f} s, worst |pme - golden| / "
        f"max(2 sd, 1.5) = {worst:.3f}")
    out = os.path.join(d, "ci")
    if calc(common[:3] + [out] + common[3:] + [
            "--calc-ci", "--gibbs-number-of-samples", "320"]) != 0:
        fail("calculate-expression --calc-ci failed")
    rows = [l.rstrip("\n").split("\t")
            for l in open(f"{out}.isoforms.results")]
    ghdr = open(os.path.join(GOLD, "golden_ci.isoforms.results")).readline(
        ).rstrip("\n").split("\t")
    if rows[0] != ghdr:
        fail("--calc-ci: isoform columns differ from the golden's")
    i_lb, i_ub = ghdr.index("TPM_ci_lower_bound"), ghdr.index(
        "TPM_ci_upper_bound")
    i_pme = ghdr.index("pme_TPM")
    n_pos = 0
    for r in rows[1:]:
        lb, ub, pme = float(r[i_lb]), float(r[i_ub]), float(r[i_pme])
        if lb > ub + 1e-6:
            fail(f"--calc-ci {r[0]}: lb {lb} > ub {ub}")
        if pme > 1.0:
            n_pos += 1
            if lb > pme * 1.25 + 1.0 or ub < pme * 0.75 - 1.0:
                fail(f"--calc-ci {r[0]}: [{lb}, {ub}] far from pme {pme}")
    if n_pos <= 10:
        fail(f"--calc-ci: only {n_pos} expressed transcripts")
    log(f"golden --calc-ci: {time.perf_counter() - t1:.2f} s, {n_pos} "
        f"expressed transcripts inside the checks")


def main() -> int:
    _name, mem_rate, op_rate = phase_device()
    import torch

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    phase_build()
    ref, bundle, model = make_workload()
    rows = phase_kernels(ref, bundle, model, dev, mem_rate, op_rate)
    torch.cuda.empty_cache()
    launches, cold, warm, rounds = phase_main_path(ref, bundle, model, dev)
    from rsem_tpu_torch.engine.em import EMConfig, run_em

    phase_profile("run_em", lambda: run_em(
        copy.deepcopy(model), ref, bundle, EMConfig(),
        need_posteriors=False, device=dev))
    torch.cuda.empty_cache()
    fused_res, fused = phase_fused(ref, bundle, model, dev)
    torch.cuda.empty_cache()
    backends = phase_backends(ref, bundle, model, dev, fused_res)
    del fused_res
    torch.cuda.empty_cache()
    em, _fitted, post_launches, post_secs = phase_posterior(
        ref, bundle, model, dev)
    torch.cuda.empty_cache()
    rows.append(phase_k5(ref, bundle, em, dev, mem_rate, op_rate))
    for r in rows:
        # EM kernels: launches of the main path; K5: of the posterior path
        r["launches"] = launches.get(r["name"], post_launches[r["name"]])
        r["posterior_launches"] = post_launches[r["name"]]
        r["kernel_ms"] = r["ms"]
    phase_goldens()
    log(json.dumps({"run_em": {"cold_s": cold, "warm_s": warm,
                               "rounds": rounds},
                    "fused_vs_per_round": fused, "backends": backends,
                    "posterior_s": post_secs}))
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
