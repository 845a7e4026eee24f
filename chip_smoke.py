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
    K4 bit-identical, K2 within rtol 1e-6, K1/K3 within rtol 1e-5
    (atol 1e-6); time kernel, plain version and, where one PyTorch call
    computes the same function, that call (CUDA events, >= 5 warm
    samples), and the bound from bytes and operations.
 4. drive the main path: rsem_tpu_torch.engine.em.run_em on that workload,
    launch counts zeroed just before and read just after (every kernel
    must have launched); then >= 5 warm passes; check sum(counts) = N1+N0
    and sum(TPM) = 1e6.
 5. one more warm pass under torch.profiler, printing device time by
    kernel and the device's idle share.
 6. calculate-expression through the CLI entry point on the golden SAMs
    (tests/goldens/aln.sam.gz; aln_pe.sam.gz with --paired-end
    --estimate-rspd), compared with the reference RSEM goldens at the
    tolerances of tests/test_parity.py.

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

    # K1: theta round over the frozen conprbs of the initial model
    pre = conprb.PreIdx(flat, None, nflat, None)
    lcp = conprb.compute_log_conprb(kcfg, refd, m1, None, hd, dm, pre)
    lnp = conprb.compute_log_noise_conprb(kcfg, m1, None, dm, pre)
    del pre, flat, nflat
    data = theta.scale_conprbs(hd, lcp, lnp, ref.M, 0.0)
    th = torch.as_tensor(
        np.random.default_rng(1).dirichlet(np.ones(ref.M + 1)),
        dtype=torch.float32).to(dev)
    c_k, n_k = theta.theta_round(th, data)
    c_p, n_p = theta.theta_round_plain(th, data)
    err = max(close(c_k, c_p, 1e-5, 1e-6, "K1 theta_round contrib"),
              close(n_k, n_p, 1e-5, 1e-6, "K1 theta_round noise"))
    k_ms = time_cuda(lambda: theta.theta_round(th, data))
    p_ms = time_cuda(lambda: theta.theta_round_plain(th, data))
    nbytes = (H * 8 + N * 4 + (N + 1) * 8 + (ref.M + 1) * 4
              + (ref.M + 1) * 8 + 8)
    b_ms, b_by = bound(nbytes, 4 * H + 3 * N, mem_rate, op_rate)
    rows.append(dict(
        name="theta_round", id="K1", route="cuda",
        source="rsem_tpu_torch/csrc/theta_round.cu",
        replaces="rsem_tpu/ops/pallas_round.py:337",
        shape=f"CSR H={H} N={N} M+1={ref.M + 1}",
        max_abs_err=err, tolerance="rtol 1e-5, atol 1e-6", ms=k_ms[0],
        ms_min=k_ms[1], ms_max=k_ms[2], plain_ms=p_ms[0], library_ms=None,
        bound_ms=b_ms, bound_by=b_by))
    for r in rows:
        log(f"{r['id']} {r['name']}: kernel {r['ms']:.3f} ms "
            f"[{r['ms_min']:.3f}, {r['ms_max']:.3f}], plain "
            f"{r['plain_ms']:.3f} ms, library {r['library_ms']}, bound "
            f"{r['bound_ms']:.3f} ms ({r['bound_by']}), max abs err "
            f"{r['max_abs_err']:.3g}")
    return rows


def phase_main_path(ref, bundle, model0, dev):
    """Full-width run_em: cold pass with launch counts, then warm passes."""
    import numpy as np
    import torch

    from rsem_tpu_torch.engine.em import EMConfig, run_em
    from rsem_tpu_torch.ops import conprb, table, theta

    wrappers = {"preidx_flat": conprb.preidx_flat,
                "gather_sum": table.gather_sum,
                "scatter_add": table.scatter_add,
                "theta_round": theta.theta_round}
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


def phase_profile(ref, bundle, model0, dev):
    """One warm run_em pass under torch.profiler: device time by kernel
    and the device's idle share of the pass's wall time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from rsem_tpu_torch.engine.em import EMConfig, run_em

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run_em(copy.deepcopy(model0), ref, bundle, EMConfig(),
               need_posteriors=False, device=dev)
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
    log(f"profile: run_em wall {wall * 1e3:.1f} ms (profiled), device busy "
        f"{busy_us / 1e3:.1f} ms, idle share {1 - busy_us / 1e6 / wall:.3f}")
    for n, (c, t) in sorted(by_name.items(), key=lambda kv: -kv[1][1])[:15]:
        log(f"profile:   {t / 1e3:9.3f} ms  {c:5d}x  {n[:90]}")


def _read_table(path):
    rows = [l.rstrip("\n").split("\t") for l in open(path)]
    return {r[0]: r for r in rows[1:]}


def phase_goldens():
    """calculate-expression on the golden SAMs, against reference RSEM."""
    from rsem_tpu_torch.pipeline.calculate_expression import main as calc

    cases = (("aln", "golden", [], 0.011, 2e-4),
             ("aln_pe", "golden_pe", ["--paired-end", "--estimate-rspd"],
              0.05, 5e-4))
    with tempfile.TemporaryDirectory() as d:
        for f in ("ref.seq", "ref.ti", "ref.grp"):
            shutil.copy(os.path.join(GOLD, f), d)
        for sam, gold, extra, eff_abs, tpm_rel in cases:
            with gzip.open(os.path.join(GOLD, f"{sam}.sam.gz"), "rb") as fi, \
                    open(os.path.join(d, f"{sam}.sam"), "wb") as fo:
                shutil.copyfileobj(fi, fo)
            out = os.path.join(d, sam)
            t0 = time.perf_counter()
            rc = calc(["--alignments", os.path.join(d, f"{sam}.sam"),
                       os.path.join(d, "ref"), out, "-q", "--device", "cuda"]
                      + extra)
            secs = time.perf_counter() - t0
            if rc != 0:
                fail(f"calculate-expression on {sam} returned {rc}")
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
            log(f"golden {sam}: {secs:.2f} s, max count err {cnt_err:.4g}, "
                f"max rel TPM err {tpm_err:.3g}, max eff-len err "
                f"{eff_err:.3g}")
            if cnt_err >= 1.0 or tpm_err >= tpm_rel or eff_err > eff_abs:
                fail(f"{sam}: results outside the golden tolerances")


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
    for r in rows:
        r["launches"] = launches[r["name"]]
        r["kernel_ms"] = r["ms"]
    phase_profile(ref, bundle, model, dev)
    phase_goldens()
    log(json.dumps({"run_em": {"cold_s": cold, "warm_s": warm,
                               "rounds": rounds}}))
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
