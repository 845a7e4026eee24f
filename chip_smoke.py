"""Smoke test of the PyTorch/CUDA port (rsem_tpu_torch) on one GPU.

    python3 chip_smoke.py [--k3-parent DIR] [--estep]

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
    the bound from bytes and operations (K2 and K3 at the profile and the
    noise shape). Then the theta loop forced to
    500 rounds (min_round = max_round = 500) on the same frozen data, at
    segments of 1, 16, theta.SEGMENT and 64 rounds: wall ms per round.
 3b. the fused loop's E-step statistics kernel at a bulk sample's shapes
    (13.5M aligned pairs, ~37M alignments, M = 73,599, paired with
    est-RSPD) against its plain version and the ops it took over (frac
    rtol 1e-6, f64 sums rtol 1e-6), each timed beside the bound; with
    --estep, phases 1, 2 and 3b alone.
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
    under torch.profiler. K3 is held and timed on the loop's own
    last-round inputs (K3Shapes, below).
 5b. the hybrid and native backends (C++ sidecar built with g++), once
    each at full width: wall time, the sidecar's thread count, K1 must
    launch under hybrid, sum(counts) = N1+N0, counts/N1 within rtol 5e-3,
    atol 1e-4 of the device path's.
 5c. windowed PreIdx at full width: run_em with EMConfig(preidx_budget=)
    a quarter of the workload's whole PreIdx (>= 4 windows; the per-round
    path), launch counts zeroed just before and read just after (K4, K2,
    K3 and K1 must launch), against the unwindowed per-round path in the
    same call: same rounds, theta, counts and frac_hit within rtol 1e-5,
    the refit pro.p and npro.p within rtol 1e-5; ms per model round of
    each path as (wall of 10 model + 10 theta rounds - wall of 10 theta
    rounds) / 10, in turns, median of 3; peak device memory of each.
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
    data moves. Each layout (the EM conprbs' and the mixing variant's) is
    built and its chains drawn on the card (build_layout, init_chains:
    seconds of each, synchronised), then by the same functions on the
    CPU (seconds of each at full width): the card's parts, widths, tile
    counts, fills and sids equal the CPU's and its scaled conprbs lie
    within one f32 ulp; its initial assignments and tables equal the
    CPU's on the same layout bit for bit; a warm card set-up under
    torch.profiler copies no more than SETUP_D2H_LIMIT bytes to the host
    (sizes only, never a per-hit or per-read array).
 7b. the Gibbs sampler's posterior spread at a real sample's size: 10,000
    pairs of isoforms with 50 reads each (500,000 reads, 1M alignments,
    M = 20,000; testing.pair_hits), half with equal conprbs and half with
    conprb ratio 1.1, no noise slot, whose exact posterior is known
    (testing.pair_posterior); run_gibbs on the card with 8 chains, burn-in
    1,000 and 8,000 samples, launch counts zeroed just before and read
    just after (K5 once per sweep and part, no other kernel). Gates, for
    each half: pooled SD within 3% of the exact SD, pooled mean within
    0.03 exact SDs of the exact mean; at most one read of a pair in any
    tile (logged beside the same statistic for the sorted front-to-back
    packing of the JAX Pallas layout); K5 identical to its plain version
    over 3 sweeps on this layout, its ms per sweep (>= 5 warm samples)
    and bound; the set-up held and timed on the card and the CPU as in
    phase 7.
 7c. the Gibbs set-up at a real sample's size (phase 17c's input: 40M
    reads of 1-5 hits, 120M hits, M = 200,000, log conprbs drawn as
    tests/test_scale.py:146-148 draws them), run with 17c: build_layout
    and init_chains of 8 chains on the card from device copies of the
    inputs: seconds of each, parts, tiles, the peak device memory above
    the inputs; one K5 sweep over every part (CUDA events, median of 3).
    No host run at that size.
 8. calculate-expression through the CLI entry point on the golden SAMs
    (tests/goldens/aln.sam.gz; aln_pe.sam.gz with --paired-end
    --estimate-rspd), each through native ingest and the fused model loop
    (the calls of both are counted), compared with the reference RSEM
    goldens at the tolerances of tests/test_parity.py; then --calc-pme
    and --calc-ci on aln.sam.gz at the tolerances of
    tests/test_parity.py:109 and tests/test_parity_extra.py:189-210.
 9. the main path at a real sample's size, nothing forced: 14M paired-end
    150 bp reads with qualities (synthetic_arrays_fast, ~35M alignments,
    M = 20,000), whose PreIdx (~100 GB) exceeds the card's memory; log
    its bytes beside torch.cuda.mem_get_info, run_em with the default
    budget (launch counts zeroed just before and read just after; more
    than one window; sum(counts) = N1+N0, sum(TPM) = 1e6), then at half
    that budget (counts within rtol 1e-5), then with no model rounds for
    ms per model round; windows, peak device memory, wall times and the
    workload's generation time; K3 on the first window's mate-1 profile and
    noise rows (256 columns) with torch.rand weights (K3Shapes).
 9b. the fused loop on the largest prefix of that workload whose whole
    PreIdx stays under 98% of the default budget, and on the workload cut
    to one hit per read (est-RSPD model, so every paired leaf of the
    loop): one window and one fused-loop call each, peak device memory
    and the working bytes per hit beside engine/em.WORK_BYTES_PER_HIT;
    running out of memory fails.
10. ingest rate: a synthetic single-end BAM of >= 1M records (multireads,
    unmapped reads; testing.synthetic_bam, outside the timed window)
    parsed with use_native=True and use_native=False: identical bundles,
    records/s of each; the native parser must have run.
11. simulate_reads on the card at full width: 10M single-end 100 bp reads
    with qualities from the model phase 6 fitted, on the full-width
    reference (M = 20,000), with phase 6's TPM and theta0 = 0.05, written
    to a temporary directory; wall time, and host-clock seconds with the
    device synchronised before each reading: the draws, the records built
    on the device and copied to the host, the host's file writes; reads/s,
    bytes written, resimulated reads and peak device memory
    (the simulator's own must stay under 4 GiB). Checks: counts sum to N,
    4N lines, every transcript's count within 6 sd + 3 of N theta and a
    chi-square p > 1e-6 (testing.counts_vs_theta), the read-length
    histogram within 5 sd + 3 per bin of gld truncated at each
    transcript. Then 1M pairs from tests/goldens/golden_pe.model on the
    golden reference: counts against theta as above, the fragment lengths
    of the read names against gld and the mate lengths against mld
    truncated at each fragment, 5 sd + 3 per bin.
12. the round trip through the port's CLI on the card, in a temporary
    directory: prepare-reference on tests/goldens/tx.fa + map.txt (ref.seq,
    .ti, .grp, .transcripts.fa byte-identical to the goldens),
    simulate-reads of 100,000 reads from golden.model and
    golden.isoforms.results (theta0 0.05, seed 7), the binomial z-test
    against golden_sim's counts (tests/test_parity_extra.py:315-346),
    calculate-expression --alignments on the provenance SAM (each read's
    true alignment, from its name): expected counts equal the
    simulator's true counts within 1e-2, and its .sim.isoforms.results
    counts equal the names' counts; wall time.
13. allele-specific quantification through the port's CLI, in process, on
    the card: a seeded allele reference of 5,000 genes x 2 transcripts of
    2,000 bp (90% of the transcripts with two alleles differing at SNPs,
    one per ~250 bp; ~19,000 alleles; prepare-reference
    --allele-to-gene-map), 1M reads simulated from golden.model with
    lognormal allele TPMs (theta0 0.05), each read aligned to every allele
    of its transcript at its true position; calculate-expression
    --calc-pme --calc-ci --no-bam-output, launch counts zeroed just before
    and read just after (K1-K5 must launch). Gates: transcript expected
    counts within 1e-2 of the truth; allele counts summing to their
    transcript's and gene's (rel 1e-6, plus half a unit of the tables'
    last digit per summed number); Pearson r >= 0.9 of allele counts
    against the truth over two-allele transcripts with >= 50 true reads;
    transcript PME within max(3 sd, 1.5) of the truth; lb <= ub in every
    CI column; a single-allele transcript's CI columns equal its allele's.
    Then each kernel against its plain version on the inputs this run
    gave it (the driver's run_em and run_gibbs record them,
    driver_capture): K4 bit-identical, K2 rtol 1e-6, K3 and K1 rtol 1e-5
    (hold_path_em), K5 identical chains from the run's own initial state
    over 3 sweeps; run_gibbs on the card and on the CPU over 3 sweeps on
    the same inputs: identical count vectors and allele and transcript
    moments within rtol 1e-5; the run's pme_c, pve_c and pve_c_trans
    within rtol 1e-5 of a float64 recomputation from its count vectors
    (hold_path_gibbs); the tables' allele PME and SD and transcript SD
    columns equal those moments to the printed digit.
14. the BAM options through the port's CLI on a genome reference: a seeded
    genome of 4 x 1 Mbp with 1,000 genes of two isoforms sharing exons
    (prepare-reference --gtf), 100,000 pairs from golden_pe.model, each
    aligned to its isoform and, where the fragment lies wholly in exons the
    sibling shares at the same genome positions, to the sibling
    (testing.SharedExonSiblings, from the GTF coordinates);
    calculate-expression --paired-end --output-genome-bam
    --sort-bam-by-coordinate, then --sort-bam-by-read-name on a copy of the
    SAM with its reads shuffled. Gates: each genome record's mismatches
    against the genome equal its transcript records' against the
    transcripts; ZW per read equal in both BAMs; genome records = 2 per
    pair (a pair's alignments collapse to one locus); sorted BAMs in
    samtools order holding the same records; each BAI finds every record
    (testing.bai_finds_all); the name-sorted rerun's .cnt and tables
    identical; gene expected counts within 1e-2 of the truth; K1-K4
    against their plain versions on both mates' inputs of the first run
    (hold_path_em; launch counts are of that run alone). Records/s of
    the transcript-BAM write, tbam2gbam, the coordinate sort with its BAI
    and the name sort (the driver's --time stages).
15. pRSEM through the port's CLI on a genome reference at full width: a
    seeded genome of 8 x 9 Mbp with 12,000 genes (testing.synthetic_genome,
    seed 15): 8,000 of two isoforms, 4,000 of one isoform spanning at
    least 1,003 bp in slots of 6,000 bp, so no other TSS lies within 500
    bp of theirs (pRSEM's training genes); 20,000 transcripts
    (prepare-reference --gtf); a BED of peaks over the TSSs of a seeded
    40% of the genes; 1M single-end reads from golden.model with
    lognormal TPMs, the peak genes' raised 4x (theta0 0.05), each aligned
    to its isoform and, where it lies in shared exons, to the sibling;
    calculate-expression --calc-pme --run-pRSEM --chipseq-peak-file
    --keep-intermediate-files --no-bam-output --time at the driver's
    Gibbs defaults, launch counts zeroed just before and read just after
    (K1-K5 must launch; K5 in both Gibbs runs, the uniform prior's and the
    rerun with pRSEM's prior). Gates: p-value < 0.01; one prior line per
    isoform, the peak partition with the larger alpha; the uniform-prior
    tables moved to out.stat/; posterior_mean_count summing to the
    aligned reads within 2%; gene expected counts within 1e-2 of the
    truth. K1-K4 on the run's inputs (hold_path_em) and K5 on both Gibbs
    runs' (hold_path_gibbs, with the pseudo-counts each run used). 15b:
    learn_prior on the run's uniform-prior PME counts with the pk model
    and two tagAlign replicates of 1M tags each (60% from fragments
    around the planted TSSs, the rest anywhere), peaks called natively:
    the called peaks overlap >= 95% of the planted ones and cover < 4x
    their footprint (tests/test_chipseq_groundtruth.py:68-84); the prior
    is informative. Stage times, K5 launches per Gibbs run, the training
    set's size and the card's name and power limit are printed.
16. the process group on the one card. 16a, world size 1 through NCCL in
    this process (parallel.distributed.init_group), at full width and
    the driver defaults: run_em, run_gibbs and run_ci with the group,
    launch counts zeroed just before and read just after (K2-K5 and K1's
    two halves, theta_partial and theta_finish, must launch; theta_round
    is the one-process entry), against the same calls without it: counts
    within rtol 1e-5, rounds within 2; Gibbs count vectors identical on
    the same frozen conprbs, CI bounds identical on the same count
    vectors. The fused loop and a theta-loop segment with the group run
    under torch.cuda.set_sync_debug_mode("error") after a warm call. K1's
    halves held against their plain versions (phase 3's tolerances) and
    timed beside their bounds; the theta loop's ms per round with and
    without the group in turns (ABBA twice, 500 rounds) and the bytes
    summed per round. Then calculate-expression --calc-pme --calc-ci on
    phase 15's reference and reads, as a subprocess with the RSEM_TPU_*
    variables of one process, against the same run in this process
    without them: .cnt identical, expected counts and TPM within rtol
    1e-5, posterior means within max(2 sd, 1.5), CI bounds at
    tests/test_torch_ci.py's golden tolerances. 16b, world size 2 on the
    one card over gloo: `chip_smoke.py --rank16 DIR COORD RANK` twice,
    each rank a gloo group member on cuda:0 (distributed.init_group)
    running run_em, run_gibbs and run_ci on the full-width workload; rank 0 holds them against 16a's world-1
    results at 16a's tolerances; each rank holds K1's halves on its reads
    and K5 on its chains (chain0 0 and 4) against their plain versions,
    and counts every kernel's launches. Two ranks share one card: their
    stage times are a correctness run's, not a scaling measurement.
17. the layout's device cache and the streamed theta loop (17a runs
    right after phase 5, 17b-c after phase 16). 17a: run_em
    on the full-width workload, the cache cleared just before its first
    pass and launch counts zeroed just before and read just after (K1-K4
    must launch); the cache then holds exactly the layout's bytes; 5 warm
    passes with the cache and 5 with clear_device_cache() before each, in
    turns (median, min, max), counts within rtol 1e-5 of the first pass;
    the upload alone (host clock, median of 3); one profiled pass each
    way, after a warm-up pass in the same profiler session: host-to-device
    copies, their device ms and bytes (the chrome trace's), idle share.
    17b: the streamed loop on
    phase 3's frozen conprbs in 8 pinned chunks against the resident
    loop, both at 25 rounds (theta within rtol 1e-5, K1 partial launches
    25 x 8), one streamed round under torch.cuda.set_sync_debug_mode
    ("error"), one convergent run each way (rounds printed), ms per round
    of each (median of 3, in turns). 17c: a real sample's size with frozen
    conprbs: 40M reads of 1-5 hits (120M hits), M = 200,000, log conprbs
    drawn as tests/test_scale.py:146-148 draws them; streamed in chunks of
    at most 256 MiB against the resident loop on the same arrays, 25
    rounds each (theta within rtol 1e-5); peak device memory of each
    (the streamed one must stay under two chunk buffers, the RoundState
    and 16 MiB), ms per round, the streamed host-to-device GB/s against
    one 1 GiB pinned copy, the seconds to generate and to build and pin
    the chunks. Every phase that uploads a layout clears the cache at its
    end: phase 9 plans its windows from free memory, and each of its runs
    clears it first, so each uploads as before the cache.

K3 is held against its plain version (rtol 1e-5, atol 1e-6) and timed at
every input above that reaches it (K3Shapes: phase 3's two shapes, the
fused loop's last round, one phase-9 window, phases 13-15's own inputs),
each beside its bound from the bytes those inputs need (index rows of
zero weight are not read) and the share of zero weights; the K3 row's
`shapes` lists them. With --k3-parent DIR, the K3 of DIR's
rsem_tpu_torch/csrc/table.cu (another tree, e.g. the parent commit
unpacked with git archive) is built alone and timed beside this tree's on
the same inputs, in turns; the port never calls it.

The line before `kernels` holds the stage numbers (phases 11-12 under
`simulate`, 13 under `allele`, 14 under `bam_options`, 15 under
`prsem`, 16 under `group`, 17 under `cache` and `streamed`, 7 under
`gibbs_setup`, 7b under `spread`, which the K5 row's `spread_launches`
and `spread_ms_per_sweep` repeat, 7c under `gibbs_setup_real`); each
kernel row adds its launches with the group of one (`sharded_launches`;
K1: its partial half's), on each rank of the group of two
(`sharded_world2_launches`) and in 17a's first pass (`cache_launches`);
K1's row adds its partial's launches in 17b and 17c
(`streamed_launches`); the next-to-last line is {"kernels": [...]}, the
last line {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import contextlib
import copy
import gzip
import importlib
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
SETUP_D2H_LIMIT = 64 * 2**10  # bytes the card's Gibbs set-up may copy back
# phase 7b: 10,000 pairs of isoforms, 50 reads each (500,000 reads, 1M
# alignments), half of conprb ratio 1.1; 8 chains, burn-in 1,000, 8,000
# samples
SPREAD_PAIRS, SPREAD_READS, SPREAD_RATIO = 10_000, 50, 1.1
SPREAD_BURNIN, SPREAD_SAMPLES = 1000, 8000
# the run at a real sample's size: paired-end 150 bp, ~35M alignments
LARGE_READS, LARGE_READ_LEN = 14_000_000, 150
# phase 3b: the E-step statistics kernel at a bulk sample's shapes
ESTEP_READS, ESTEP_M = 13_500_000, 73_599
INGEST_READS, INGEST_M = 420_000, 2000  # ~1.04M BAM records
# phase 11: reads simulated at full width (single end) and on the golden
# reference (paired end); noise share theta0
SIM_READS, SIM_PAIRS, SIM_THETA0 = 10_000_000, 1_000_000, 0.05
SIM_PEAK_LIMIT = 4 * 2**30  # the simulator's own peak device memory
ROUND_TRIP_READS = 100_000  # phase 12 (the size of golden_sim)
ALLELE_GENES, ALLELE_READS = 5000, 1_000_000  # phase 13
# phase 14: a genome of 4 x 1 Mbp, 1,000 genes of two isoforms
GENOME_PAIRS, GENOME_GENES, GENOME_CHROM_LEN = 100_000, 1000, 1_000_000
# phase 15: pRSEM on a genome of 8 x 9 Mbp, 12,000 genes (4,000 of one
# isoform: pRSEM's training genes), TSS peaks on 40% of the genes, whose
# TPM is raised 4x; 15b: two ChIP-seq replicates of 1M tags each
PRSEM_GENES, PRSEM_SINGLE, PRSEM_READS = 12_000, 4000, 1_000_000
PRSEM_CHROMS, PRSEM_CHROM_LEN = 8, 9_000_000
PRSEM_PEAK_SHARE, PRSEM_PEAK_TPM = 0.4, 4.0
CHIP_TAGS, CHIP_FRAGLEN, CHIP_READ_LEN = 1_000_000, 150, 50


def fail(msg: str):
    raise RuntimeError(f"chip_smoke: {msg}")


def log(msg: str):
    print(msg, flush=True)


def time_samples(fn, samples: int = TIMING_SAMPLES, warm: int = 2):
    """`samples` CUDA-event timings (ms) of `fn` after `warm` untimed
    calls."""
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
    return ts


def time_cuda(fn, samples: int = TIMING_SAMPLES, warm: int = 2):
    """(median ms, min ms, max ms) of `fn` over `samples` CUDA-event
    timings after `warm` untimed calls."""
    ts = time_samples(fn, samples, warm)
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


PLAIN_CHUNK = 1 << 19  # rows per call of K3's plain version


def k3_parent(root: str):
    """rsem_scatter_add of `root`'s rsem_tpu_torch/csrc/table.cu, built alone
    with nvcc into this checkout's rsem_tpu_torch/_build/ and loaded with
    ctypes: only timed, beside this tree's K3; the port never calls it."""
    import ctypes
    import hashlib

    from rsem_tpu_torch.ops import _build

    csrc = os.path.join(os.path.abspath(root), "rsem_tpu_torch", "csrc")
    h = hashlib.sha256()
    for name in ("table.cu", "common.cuh"):
        with open(os.path.join(csrc, name), "rb") as f:
            h.update(f.read())
    lib = _build.BUILD_ROOT / f"k3-parent-{h.hexdigest()[:16]}" / "lib.so"
    if not lib.exists():
        lib.parent.mkdir(parents=True, exist_ok=True)
        t0 = time.perf_counter()
        res = subprocess.run(
            [_build.nvcc(), *_build.NVCC_FLAGS, "-shared", "-I", csrc,
             os.path.join(csrc, "table.cu"), "-o", str(lib)],
            capture_output=True, text=True)
        if res.returncode:
            fail(f"nvcc failed for {csrc}/table.cu:\n{res.stdout}"
                 f"{res.stderr}")
        log(f"K3 of {root}: built in {time.perf_counter() - t0:.2f} s")
    fn = ctypes.CDLL(str(lib)).rsem_scatter_add
    P = ctypes.c_void_p
    fn.argtypes = [P, ctypes.c_int64, ctypes.c_int, P, ctypes.c_int, P, P]
    fn.restype = ctypes.c_int
    return fn


class K3Shapes:
    """K3 at every input a run gives it (phases 3, 5a, 9, 13, 14): each
    held against its plain version, timed and bounded by `hold`, recorded
    in `shapes`. `parent`: another tree's rsem_scatter_add (k3_parent),
    timed beside this tree's K3 on the same inputs."""

    REPS = 10  # launches per timed sample

    def __init__(self, mem_rate: float = PEAKS[-1][1],
                 op_rate: float = PEAKS[-1][2], parent=None):
        self.rates = (mem_rate, op_rate)
        self.parent = parent
        self.shapes = []

    def _launches(self, fn, idx, w, size: int, acc, reps: int = REPS):
        """`reps` back-to-back launches of the C entry `fn` into `acc`, as
        the fused loop and the window passes make them (the host runs
        ahead, so a small input is not timed with the host's launch
        overhead)."""
        from rsem_tpu_torch.ops import _build

        args = (idx.data_ptr(), idx.shape[0], idx.shape[1], w.data_ptr(),
                size, acc.data_ptr(), _build.stream_of(idx))

        def run():
            for _ in range(reps):
                err = fn(*args)
                if err:
                    fail(f"K3 launch returned CUDA error {err}")
        return run

    def hold(self, label: str, idx, w, size: int) -> dict:
        """K3 on one input: held against its plain version (in f64,
        PLAIN_CHUNK rows at a time) at rtol 1e-5, atol 1e-6; on the card
        timed per launch with CUDA events over REPS launches into a
        caller's f64 table (with a parent, the parent's K3 and this one in
        turns: parent, this, this, parent; the parent's result held too)
        beside its bound: the bytes these inputs need (every weight, the
        index rows of the non-zero weights, the f64 table) and the adds
        they make."""
        import torch

        from rsem_tpu_torch.ops import _build, table

        rows, cols = idx.shape
        want = torch.zeros(size, dtype=torch.float64, device=idx.device)
        nz = n_add = 0
        for a in range(0, rows, PLAIN_CHUNK):
            i, ww = idx[a:a + PLAIN_CHUNK], w[a:a + PLAIN_CHUNK]
            table.scatter_add_plain(i, ww, size, want)
            live = ww != 0
            nz += int(live.sum())
            n_add += int(((i < size) & live[:, None]).sum())
        rec = {"shape": label, "rows": rows, "cols": cols, "size": size,
               "nonzero_rows": nz, "zero_share": 1 - nz / max(rows, 1),
               "max_abs_err": close(table.scatter_add(idx, w, size), want,
                                    1e-5, 1e-6, f"{label}: K3 scatter_add")}
        if idx.device.type == "cuda":
            rec["bound_ms"], rec["bound_by"] = bound(
                rows * 4 + nz * cols * 4 + size * 8, n_add, *self.rates)
            acc = torch.zeros_like(want)
            run = self._launches(_build.lib().rsem_scatter_add, idx, w,
                                 size, acc)
            ps = []
            if self.parent is None:
                ts = time_samples(run)
            else:
                par = self._launches(self.parent, idx, w, size, acc)
                acc.zero_()
                self._launches(self.parent, idx, w, size, acc, 1)()
                rec["parent_max_abs_err"] = close(
                    acc, want, 1e-5, 1e-6, f"{label}: the parent's K3")
                ps = time_samples(par)
                ts = time_samples(run) + time_samples(run)
                ps += time_samples(par)
            n = self.REPS
            rec.update(ms=statistics.median(ts) / n, ms_min=min(ts) / n,
                       ms_max=max(ts) / n,
                       parent_ms=statistics.median(ps) / n if ps else None)
            other = f", parent {rec['parent_ms']:.4f} ms" if ps else ""
            log(f"K3 {label}: [{rows}, {cols}] -> {size} slots, zero share "
                f"{rec['zero_share']:.3f}: {rec['ms']:.4f} ms{other}, bound "
                f"{rec['bound_ms']:.4f} ms ({rec['bound_by']}), max abs err "
                f"{rec['max_abs_err']:.3g}")
        self.shapes.append(rec)
        return rec


def _card() -> str:
    """The card's name and power limit as nvidia-smi reports them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True,
        timeout=60).stdout.strip().splitlines()[0]


def phase_device():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        sys.exit(2)
    log(_card())
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
    # the quality transition counts fill the model's QualDist, which no
    # kernel reads and phase 11's quality chain draws from
    ref, bundle, spec, model = synthetic_arrays_fast(
        n_reads=N_READS, M=M_TX, read_len=READ_LEN, tx_len=TX_LEN,
        has_qual=True, seed=0, collect_qual_stats=True)
    log(f"workload: N={bundle.hits.n_reads} H={bundle.hits.n_hits} "
        f"M={ref.M} T={ref.codes.shape[0]} "
        f"({time.perf_counter() - t0:.1f} s to generate)")
    return ref, bundle, model


def phase_kernels(ref, bundle, model, dev, mem_rate, op_rate, k3):
    """Hold K1-K4 against their plain versions; returns the kernel rows
    (launches filled in later) and K1's frozen log conprbs on the host."""
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
    bn_ms, _ = bound(N * cols * 4 + ntab.numel() * 4 + N * 4, N * cols,
                     mem_rate, op_rate)
    log(f"K2 noise shape [{N}, {cols}]: {kn_ms[0]:.3f} ms, bound "
        f"{bn_ms:.4f} ms (max abs err {err_n:.3g})")
    rows.append(dict(
        name="gather_sum", id="K2", route="cuda",
        source="rsem_tpu_torch/csrc/table.cu",
        replaces="rsem_tpu/ops/pallas_table.py:67",
        shape=f"[{H}, {cols}] int32 idx, {tab.numel()}-slot f32 table",
        max_abs_err=max(err, err_n), tolerance="rtol 1e-6, atol 1e-6",
        ms=k_ms[0], ms_min=k_ms[1], ms_max=k_ms[2], plain_ms=p_ms[0],
        library_ms=l_ms[0], library_call="F.embedding_bag(mode='sum')",
        noise_shape_ms=kn_ms[0], noise_shape_bound_ms=bn_ms,
        bound_ms=b_ms, bound_by=b_by))

    # K3: scatter-add of per-row weights
    g = torch.Generator(device=dev)
    g.manual_seed(0)
    w = torch.rand(H, generator=g, device=dev, dtype=torch.float32)
    size = kcfg.pro_keys()
    prof = k3.hold("phase 3 profile, torch.rand weights", flat, w, size)
    wn = torch.rand(N, generator=g, device=dev, dtype=torch.float32)
    noise = k3.hold("phase 3 noise, torch.rand weights", nflat, wn,
                    kcfg.npro_keys())
    p_ms = time_cuda(lambda: table.scatter_add_plain(flat, w, size),
                     samples=5, warm=1)
    idx_l = flat.reshape(-1).long().clamp(max=size)
    w_rep = w.repeat_interleave(cols)
    acc = torch.zeros(size + 1, dtype=torch.float32, device=dev)
    l_ms = time_cuda(lambda: acc.index_add_(0, idx_l, w_rep))
    del idx_l, w_rep
    rows.append(dict(
        name="scatter_add", id="K3", route="cuda",
        source="rsem_tpu_torch/csrc/table.cu",
        replaces="rsem_tpu/ops/pallas_table.py:125",
        shape=f"[{H}, {cols}] int32 idx, f32 [{H}] weights, {size} slots",
        max_abs_err=max(prof["max_abs_err"], noise["max_abs_err"]),
        tolerance="rtol 1e-5, atol 1e-6", ms=prof["ms"],
        ms_min=prof["ms_min"], ms_max=prof["ms_max"], plain_ms=p_ms[0],
        library_ms=l_ms[0],
        library_call="index_add_ over pre-expanded indices and weights",
        noise_shape_ms=noise["ms"], noise_shape_bound_ms=noise["bound_ms"],
        parent_ms=prof["parent_ms"], parent_noise_shape_ms=noise["parent_ms"],
        bound_ms=prof["bound_ms"], bound_by=prof["bound_by"],
        shapes=k3.shapes))

    # K1: theta rounds over the frozen conprbs of the initial model
    pre = conprb.PreIdx(flat, None, nflat, None)
    lcp = conprb.compute_log_conprb(kcfg, refd, m1, None, hd, dm, pre)
    lnp = conprb.compute_log_noise_conprb(kcfg, m1, None, dm, pre)
    del pre, flat, nflat
    data = theta.scale_conprbs(hd, lcp, lnp, ref.M, 0.0)
    k1_in = (lcp.cpu().numpy(), lnp.cpu().numpy())  # phase 17b's
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
    return rows, k1_in


def phase_estep(dev, mem_rate, op_rate, n_reads: int = ESTEP_READS,
                M: int = ESTEP_M):
    """The fused loop's E-step statistics kernel at a bulk sample's shapes
    (tcga_bulk_em's: 13.5M aligned pairs, ~37M alignments, M = 73,599,
    paired with est-RSPD, 999 fragment-length slots, 20 read-start bins;
    inputs from testing.synthetic_estep_inputs): against its plain version
    (frac rtol 1e-6, the f64 sums rtol 1e-6) and against the ops it took
    over (the loop's former inline E-step: five float64 index_add_ and the
    elementwise ops around them, on int64 indices with s0 gathered per
    hit), each timed, beside the bound. Returns the kernel's row."""
    import torch

    from rsem_tpu_torch.ops import model_loop
    from rsem_tpu_torch.testing import synthetic_estep_inputs

    cfg, data, lp, lnp, th = synthetic_estep_inputs(n_reads, M, True, True,
                                                    0, dev)
    H, N = int(data.sid.shape[0]), n_reads
    sizes = [M + 1, cfg.gld_ub - cfg.gld_lb, cfg.B]
    red = torch.zeros(sum(sizes), dtype=torch.float64, device=dev)
    parts = red.split(sizes)
    frac = torch.empty(H, dtype=torch.float32, device=dev)
    frac_noise = torch.empty(N, dtype=torch.float32, device=dev)

    def kernel():
        model_loop.estep_stats(cfg, data, lp, lnp, th, *parts, frac,
                               frac_noise)

    def plain():
        model_loop.estep_stats_plain(cfg, data, lp, lnp, th, *parts, frac,
                                     frac_noise)

    # the ops the kernel took over, as the loop ran them
    sid64, rid64 = data.sid.long(), data.rid.long()
    ins64, b0_64, b1_64 = (data.ins_idx.long(), data.rs_b0.long(),
                           data.rs_b1.long())
    s0_hit = data.s0[rid64]
    denom = torch.empty(N, dtype=torch.float64, device=dev)
    counts, gld, rspd = parts

    def before():
        ltheta = model_loop._safe_log(th)
        w = torch.exp((lp + ltheta[sid64] - s0_hit).clamp(
            max=model_loop.MAX_DRIFT))
        w0 = torch.exp((lnp + ltheta[0] - data.s0).clamp(
            max=model_loop.MAX_DRIFT))
        denom.zero_().index_add_(0, rid64, w.double())
        d = denom + w0
        inv = torch.where(d > 0, 1.0 / torch.where(d > 0, d, 1.0),
                          0.0).to(torch.float32)
        f = w * inv[rid64]
        fn = w0 * inv
        red.zero_()
        counts.index_add_(0, sid64, f.double())
        counts[0] += fn.sum(dtype=torch.float64)
        gld.index_add_(0, ins64, f.double())
        rspd.index_add_(0, b0_64, (f * data.rs_w0).double())
        rspd.index_add_(0, b1_64, (f * data.rs_w1).double())
        return f, fn

    f_b, fn_b = before()
    want = red.clone()
    red.zero_()
    kernel()
    torch.cuda.synchronize()
    err = max(close(frac, f_b, 1e-6, 0.0, "E-step kernel frac"),
              close(frac_noise, fn_b, 1e-6, 0.0, "E-step kernel frac_noise"))
    for (a, b), what in zip(zip(red.split(sizes), want.split(sizes)),
                            ("counts", "gld", "rspd")):
        close(a, b, 1e-6, 0.0, f"E-step kernel {what}")
    del f_b, fn_b, want
    k_ms = time_cuda(kernel)
    p_ms = time_cuda(plain, samples=5, warm=1)
    b_ms = time_cuda(before, samples=5, warm=1)
    # each input byte read once, each output written once: per hit lp,
    # sid, rid, the insert slot, two bins and their weights, frac; per read
    # lnp, s0, its offset, frac_noise; theta, counts and the histograms
    nbytes = (H * (8 * 4 + 4) + N * (4 + 4 + 8 + 4) + 8
              + (M + 1) * (4 + 8) + (sizes[1] + sizes[2]) * 8)
    # per hit: log, exp, 3 adds, the denominator's add, a product, the
    # count's, the slot's and two bins' adds and products; per read likewise
    nops = H * 12 + N * 6
    bnd_ms, bnd_by = bound(nbytes, nops, mem_rate, op_rate)
    row = dict(
        name="estep_stats", id="E", route="cuda",
        source="rsem_tpu_torch/csrc/model_estep.cu",
        replaces="none (stands for seg_sum_sorted and onehot_scatter in "
                 "rsem_tpu/ops/model_loop.py)",
        shape=f"CSR H={H} N={N} M+1={M + 1}, paired, est-RSPD "
              f"({sizes[1]} fragment-length slots, {sizes[2]} bins)",
        max_abs_err=err, tolerance="frac rtol 1e-6; f64 sums rtol 1e-6 "
                                   "of the ops it replaced",
        ms=k_ms[0], ms_min=k_ms[1], ms_max=k_ms[2], plain_ms=p_ms[0],
        before_ms=b_ms[0], before_ms_min=b_ms[1], before_ms_max=b_ms[2],
        before="the loop's former inline E-step: five float64 index_add_ "
               "and the elementwise ops around them",
        library_ms=None, bound_ms=bnd_ms, bound_by=bnd_by)
    log(f"E estep_stats at bulk shapes (H={H} N={N}): kernel "
        f"{k_ms[0]:.4f} ms [{k_ms[1]:.4f}, {k_ms[2]:.4f}], before "
        f"{b_ms[0]:.3f} ms [{b_ms[1]:.3f}, {b_ms[2]:.3f}], plain "
        f"{p_ms[0]:.3f} ms, bound {bnd_ms:.4f} ms ({bnd_by}), max abs err "
        f"{err:.3g}")
    return row


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


def layout_bytes(ref, bundle) -> int:
    """Device bytes of run_em's layout upload (ops/layout.py)."""
    import numpy as np

    M1, H, N = ref.M + 1, bundle.hits.n_hits, bundle.hits.n_reads
    mates = [bundle.reads.mate1, bundle.reads.mate2] if bundle.paired \
        else [bundle.reads]
    width = max(m.codes.shape[1] for m in mates)
    reads = sum(N * width * (2 if m.quals is not None else 1) + 5 * N
                for m in mates)
    hits = H * 4 * (5 if bundle.paired else 4) + (N + 1) * 8
    return int(np.asarray(ref.codes).size + (M1 + 1) * 8 + 12 * M1 + reads
               + hits)


def work_per_hit(peak, ref, bundle, kcfg, budget) -> float:
    """Device bytes per hit of the largest window at a run's peak beyond
    the layout, RUN_BYTES_PER_HIT per hit of the run and that window's
    PreIdx: the WORK_BYTES_PER_HIT that engine/em.py's default budget
    leaves (budget None: the whole PreIdx, one window)."""
    from rsem_tpu_torch.engine import em
    from rsem_tpu_torch.ops import conprb

    wins = conprb.plan_windows(kcfg, bundle.hits.read_offsets, budget)
    big = max(wins, key=lambda w: w.h1 - w.h0 + w.r1 - w.r0)
    rest = (peak - layout_bytes(ref, bundle)
            - em.RUN_BYTES_PER_HIT * bundle.hits.n_hits
            - conprb.preidx_bytes(kcfg, big.h1 - big.h0, big.r1 - big.r0))
    return rest / max(big.h1 - big.h0, 1)


OFF_EM_PATH = ("sweep_part",)  # counted on the EM runs, not required there


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

    from rsem_tpu_torch.engine import em as em_mod
    from rsem_tpu_torch.engine.em import EMConfig, run_em
    from rsem_tpu_torch.ops import model_loop

    wrappers = kernel_wrappers()
    del wrappers["sweep_part"]  # not on this path
    wrappers["estep_stats"] = model_loop.estep_stats  # the fused loop's
    for fn in wrappers.values():
        fn.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    res = run_em(copy.deepcopy(model0), ref, bundle, EMConfig(),
                 need_posteriors=False, device=dev)
    cold = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in wrappers.items()}
    peak = torch.cuda.max_memory_allocated()
    kcfg = em_mod.kernel_config(model0, bundle, READ_LEN)
    log(f"main path: run_em cold {cold:.3f} s, rounds {res.rounds}, "
        f"launches {launches}, peak device memory {peak / 2**30:.2f} GiB, "
        f"{work_per_hit(peak, ref, bundle, kcfg, None):.0f} bytes per hit "
        f"beyond the layout and PreIdx (fused loop, whole PreIdx)")
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


def profiled(fn, warmup: bool = False):
    """(profiler, wall s) of one call of `fn` under torch.profiler, the
    device synchronised at its end; with `warmup`, after one call in a
    warm-up step of the same session, whose events are dropped."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule

    torch.cuda.synchronize()
    sched = schedule(wait=0, warmup=1, active=1, repeat=1) if warmup \
        else None
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=sched) as prof:
        if warmup:
            fn()
            torch.cuda.synchronize()
            prof.step()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return prof, wall


def phase_profile(label, fn, prof_wall=None):
    """One warm call of `fn` under torch.profiler (or the `profiled`
    result given): device time by kernel and the device's idle share of
    the call's wall time. Returns {kernel name: (launches, device us)}
    and the idle share."""
    import torch

    prof, wall = prof_wall or profiled(fn)
    # a scheduled session's step annotation spans the step on the device
    kern = [e for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and not e.name.startswith("ProfilerStep")]
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
    return by_name, 1 - busy_us / 1e6 / wall


def agree(got, want, rtol: float, atol: float, what: str) -> float:
    """Max |got - want| of two host arrays; fails outside atol + rtol |want|."""
    import numpy as np

    d = np.abs(np.asarray(got, dtype=float) - np.asarray(want, dtype=float))
    bad = d > atol + rtol * np.abs(want)
    if bad.any():
        fail(f"{what}: {int(bad.sum())} entries off (max abs err "
             f"{d.max()})")
    return float(d.max())


def phase_fused(ref, bundle, model0, dev, k3, rounds: int = 10):
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
    # K3 on the loop's own last-round inputs: flat1, nflat1 (flat2, nflat2)
    scatter, seen = model_loop.scatter_add, []

    def record(idx, w, size, acc=None):
        seen.append((idx, w.clone(), size))
        return scatter(idx, w, size, acc)

    model_loop.scatter_add = record
    try:
        loop()
    finally:
        model_loop.scatter_add = scatter
    last = seen[-(4 if kcfg.paired else 2):]
    for (idx, w, size), what in zip(last, ("profile", "noise",
                                           "mate-2 profile", "mate-2 noise")):
        k3.hold(f"phase 5a {what}, the fused loop's last-round weights",
                idx, w, size)
    del seen, last
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


def phase_windowed(ref, bundle, model0, dev, parts: int = 4,
                   samples: int = 3):
    """Windowed PreIdx at full width against the unwindowed per-round
    path. Returns (launches of the windowed run, a summary)."""
    import torch

    from rsem_tpu_torch.engine import em
    from rsem_tpu_torch.ops import conprb

    kcfg = em.kernel_config(model0, bundle, READ_LEN)
    whole = conprb.preidx_bytes(kcfg, bundle.hits.n_hits, bundle.hits.n_reads)
    budget = whole // parts
    paths = {"windowed": dict(preidx_budget=budget),
             "per_round": dict(fused_model=False)}

    def run(name, posteriors=False, **kw):
        return em.run_em(copy.deepcopy(model0), ref, bundle,
                         em.EMConfig(**paths[name], **kw),
                         need_posteriors=posteriors, device=dev)

    wrappers = kernel_wrappers()
    for fn in wrappers.values():
        fn.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    win = run("windowed", True)
    launches = {k: fn.launches for k, fn in wrappers.items()}
    peak = {"windowed": torch.cuda.max_memory_allocated()}
    for k, n in launches.items():
        if n <= 0 and k not in OFF_EM_PATH:
            fail(f"kernel {k} was not launched on the windowed path")
    if win.windows < parts:
        fail(f"budget {budget} gave {win.windows} windows, not >= {parts}")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    per = run("per_round", True)
    peak["per_round"] = torch.cuda.max_memory_allocated()
    if win.rounds != per.rounds:
        fail(f"windowed run took {win.rounds} rounds, per-round {per.rounds}")
    n_win = win.windows
    work = {"windowed": work_per_hit(peak["windowed"], ref, bundle, kcfg,
                                     budget),
            "per_round": work_per_hit(peak["per_round"], ref, bundle, kcfg,
                                      None)}
    errs = {
        "theta": agree(win.theta_raw, per.theta_raw, 1e-5, 1e-12, "theta"),
        "counts": agree(win.counts, per.counts, 1e-5, 1e-9, "counts"),
        "frac_hit": agree(win.frac_hit, per.frac_hit, 1e-5, 1e-12,
                          "frac_hit"),
        "pro.p": agree(win.model.pro.p, per.model.pro.p, 1e-5, 1e-12,
                       "pro.p"),
        "npro.p": agree(win.model.npro.p, per.model.npro.p, 1e-5, 1e-12,
                        "npro.p")}
    del win, per
    walls = {(n, r): [] for n in paths for r in (10, 0)}
    for i in range(samples):
        for name in (paths if i % 2 == 0 else list(paths)[::-1]):
            for r in (10, 0):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                run(name, update_model_rounds=r, min_round=r + 10,
                    max_round=r + 10)
                walls[(name, r)].append(time.perf_counter() - t0)
    ms = {n: (statistics.median(walls[(n, 10)])
              - statistics.median(walls[(n, 0)])) * 1e3 / 10 for n in paths}
    summary = {"budget_bytes": budget, "whole_preidx_bytes": whole,
               "windows": n_win,
               "launches": launches, "ms_per_model_round": ms,
               "peak_bytes": peak, "work_bytes_per_hit": work,
               "max_abs_err": errs,
               "walls_s": {f"{n}_{r}": w for (n, r), w in walls.items()}}
    log(f"windowed PreIdx: {whole} bytes whole, budget {budget}, "
        f"{summary['windows']} windows; launches {launches}; ms per model "
        f"round windowed {ms['windowed']:.2f} / per-round "
        f"{ms['per_round']:.2f} (median of {samples}, in turns); peak "
        f"device memory windowed {peak['windowed'] / 2**30:.2f} GiB, "
        f"per-round {peak['per_round'] / 2**30:.2f} GiB (beyond the layout "
        f"and the largest window's PreIdx: {work['windowed']:.0f} / "
        f"{work['per_round']:.0f} bytes per hit); max abs err against the "
        f"per-round path {errs} (rtol 1e-5)")
    phase_profile("run_em windowed", lambda: run("windowed"))
    return launches, summary


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


def k5_replay(layout, assigns, tab, seed: int, label: str,
              sweeps: int = K5_SWEEPS, chain0: int = 0):
    """K5 against its plain version over `sweeps` sweeps from one chain
    state (copied for each), with the per-part seeds of Gibbs seed `seed`
    and one delta scratch for all sweeps: identical assignments and tables,
    one launch per part and sweep; chain0 is the global index of the first
    chain (a rank's chains of a split run). Returns (kernel sweeps, plain
    sweeps), each a function of the sweep index that sweeps its own copy
    on, and the read assignments moved and table entries changed per
    plain sweep."""
    import torch

    from rsem_tpu_torch.ops import gibbs

    seeds = [gibbs.part_seed(seed, pi) for pi in range(len(layout.parts))]
    a_k = [a.clone() for a in assigns]
    a_p = [a.clone() for a in assigns]
    t_k, t_p = tab.clone(), tab.clone()
    scratch = gibbs.delta_scratch(t_k)

    def kern_sweep(s):
        for part, a, sp in zip(layout.parts, a_k, seeds):
            gibbs.sweep_part(a, t_k, part, sp, s, scratch, chain0)

    def plain_sweep(s):
        for part, a, sp in zip(layout.parts, a_p, seeds):
            gibbs.sweep_part_plain(a, t_p, part, sp, s, chain0)

    n0 = gibbs.sweep_part.launches
    moved = changed = 0
    for s in range(sweeps):
        kern_sweep(s)
        a_0, t_0 = [a.clone() for a in a_p], t_p.clone()
        plain_sweep(s)
        moved += sum(int((x != y).sum()) for x, y in zip(a_p, a_0))
        changed += int((t_p != t_0).sum())
    if t_k.is_cuda:  # on the CPU the wrapper runs the plain version
        torch.cuda.synchronize()
        launched = gibbs.sweep_part.launches - n0
    else:
        launched = sweeps * len(layout.parts)
    if launched != sweeps * len(layout.parts):
        fail(f"K5 ({label}) launched {launched} times, not "
             f"{sweeps * len(layout.parts)}")
    n_diff = sum(int((x != y).sum()) for x, y in zip(a_k, a_p))
    if n_diff or not torch.equal(t_k, t_p) or bool(scratch.any()):
        fail(f"K5 ({label}) differs from its plain version after {sweeps} "
             f"sweeps: {n_diff} assignments, max table diff "
             f"{float((t_k - t_p).abs().max())}, scratch left non-zero "
             f"{bool(scratch.any())}")
    return kern_sweep, plain_sweep, moved / sweeps, changed / sweeps


def k5_bound(layout, C, moved, changed, mem_rate, op_rate):
    """K5's bound for one sweep of C chains. Bytes: each placed slot's sid
    and cps and each placed read's ncs once; every chain's assignments
    read once and the ones that move written; every chain's table entries
    that the layout touches (its distinct sids and the noise entry) read
    once and the ones that change written. Operations: ~8 f32 per slot
    and per read per chain. Returns (ms, by, bytes, distinct sids)."""
    import torch

    noise = torch.zeros(1, dtype=torch.int32,
                        device=layout.parts[0].sid.device)
    n_sids = int(torch.unique(torch.cat(
        [p.sid for p in layout.parts] + [noise])).numel())
    nbytes = (layout.n_slots * 8 + layout.n_reads * 4 +
              C * layout.n_reads * 4 + moved * 4 + C * n_sids * 4 +
              changed * 4)
    return bound(nbytes, C * (layout.n_slots + layout.n_reads) * 8,
                 mem_rate, op_rate) + (nbytes, n_sids)


def _layouts_match(g, c, what: str) -> int:
    """The card's layout g against the CPU's c: every integer field
    exactly, cps and ncs within one f32 ulp. Returns the slots that differ
    by that ulp."""
    import numpy as np

    if (g.n_reads, g.n_noise_fixed, [(p.K, p.n_tiles) for p in g.parts]) != (
            c.n_reads, c.n_noise_fixed, [(p.K, p.n_tiles) for p in c.parts]):
        fail(f"{what}: the card's layout has other parts than the CPU's")
    off = 0
    for p, q in zip(g.parts, c.parts):
        if not (np.array_equal(p.fill, q.fill) and
                np.array_equal(p.sid.cpu().numpy(), q.sid.numpy())):
            fail(f"{what}: the card's fills or sids differ from the CPU's")
        for x, y in ((p.cps, q.cps), (p.ncs, q.ncs)):
            x, y = x.cpu().numpy(), y.numpy()
            d = np.abs(x - y)
            if (d > np.spacing(np.maximum(np.abs(x), np.abs(y)))).any():
                fail(f"{what}: scaled conprbs differ by more than one ulp")
            off += int((d > 0).sum())
    return off


def trace_copies(prof, kind: str) -> tuple:
    """(memcpy events whose name holds `kind`, "HtoD" or "DtoH", in a
    profiler's chrome trace; the byte counts of those that carry one)."""
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            trace = json.load(f)
    ev = [e for e in trace.get("traceEvents", [])
          if kind in str(e.get("name", ""))]
    return len(ev), [e["args"]["bytes"] for e in ev
                     if "bytes" in e.get("args", {})]


def hold_gibbs_setup(label, hits, lcp, lnp, M, C, seed, base_of, dev):
    """build_layout and init_chains of C chains on the card, each timed
    (synchronised), then on the CPU; the card's layout against the CPU's
    (_layouts_match) and its initial state against the CPU's on the same
    layout, bit for bit; a warm card set-up under torch.profiler copies at
    most SETUP_D2H_LIMIT bytes to the host. base_of(layout): the f32 table
    base. Returns (card layout, assignments, table, numbers)."""
    import torch

    from rsem_tpu_torch.ops import gibbs

    def card():
        lay = gibbs.build_layout(hits, lcp, lnp, M, device=dev)
        return (lay,) + gibbs.init_chains(lay, base_of(lay).to(dev), C,
                                          seed=seed)

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    layout = gibbs.build_layout(hits, lcp, lnp, M, device=dev)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    base = base_of(layout)
    assigns, tab = gibbs.init_chains(layout, base.to(dev), C, seed=seed)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    prof, warm_s = profiled(card)
    n_d2h, got = trace_copies(prof, "DtoH")
    most, total = (max(got), sum(got)) if got else (None, None)
    if most is not None and most > SETUP_D2H_LIMIT:
        fail(f"{label}: the card's Gibbs set-up copied {most} bytes to the "
             f"host at once (limit {SETUP_D2H_LIMIT})")
    t3 = time.perf_counter()
    cpu_layout = gibbs.build_layout(hits, lcp, lnp, M, device="cpu")
    t4 = time.perf_counter()
    a_c, t_c = gibbs.init_chains(cpu_layout, base, C, seed=seed)
    t5 = time.perf_counter()
    off = _layouts_match(layout, cpu_layout, label)
    if off:  # the states compare on one layout
        a_c, t_c = gibbs.init_chains(layout.to("cpu"), base, C, seed=seed)
    if not (torch.equal(tab.cpu(), t_c) and all(
            torch.equal(x.cpu(), y) for x, y in zip(assigns, a_c))):
        fail(f"{label}: the card's initial state differs from the CPU's")
    out = dict(build_s=t1 - t0, init_s=t2 - t1, warm_setup_s=warm_s,
               cpu_build_s=t4 - t3, cpu_init_s=t5 - t4, ulp_slots=off,
               d2h_copies=n_d2h, d2h_max_bytes=most, d2h_bytes=total,
               parts=len(layout.parts), tiles=layout.n_tiles)
    log(f"Gibbs set-up ({label}): {len(layout.parts)} parts, widths "
        f"{[p.K for p in layout.parts]}, {layout.n_tiles} tiles, "
        f"{layout.n_reads} reads, {layout.n_slots} slots; card build "
        f"{out['build_s']:.4f} s, init {out['init_s']:.4f} s ({C} chains; "
        f"warm, profiled, both {warm_s:.4f} s); CPU build "
        f"{out['cpu_build_s']:.3f} s, init {out['cpu_init_s']:.3f} s; "
        f"layout equal to the CPU's ({off} conprbs one ulp apart), initial "
        f"state identical; {n_d2h} device-to-host copies, at most {most} "
        f"bytes, {total} in all")
    return layout, assigns, tab, out


def phase_k5(ref, bundle, em, dev, mem_rate, op_rate):
    """K5 against its plain version at full width, K5_SWEEPS sweeps of 8
    chains from one initial state each way: on the posterior path's layout
    (T = M+1 = 20,001), on a mixing variant (the same alignments with
    conprbs drawn from a seed, so reads move between alignments and noise;
    the workload's decoy alignments have conprbs that underflow, which pins
    most reads), and on both relabelled s -> 10 s with the table widened to
    T = 200,001. Then one sweep's time of each. The set-up of each layout
    is held and timed on the card and the CPU (hold_gibbs_setup). Returns
    the K5 row and the set-up numbers."""
    import numpy as np
    import torch

    from rsem_tpu_torch.testing import relabel_layout

    M, C = ref.M, 8
    setups = {}

    def base_of(layout):
        base = torch.ones(M + 1)
        base[0] += bundle.cnt.N0 + layout.n_noise_fixed
        return base

    def setup(lcp, lnp, label):
        layout, assigns, tab, setups[label] = hold_gibbs_setup(
            f"K5 {label}", bundle.hits, lcp, lnp, M, C, 1, base_of, dev)
        return layout, assigns, tab

    def hold(layout, assigns, tab, label):
        """k5_replay, then the kernel's (median, min, max) ms per sweep;
        returns those, the plain sweep, and the assignments and table
        entries that one sweep changes."""
        kern_sweep, plain_sweep, moved, changed = k5_replay(
            layout, assigns, tab, 1, label)
        k_ms = time_cuda(lambda: kern_sweep(K5_SWEEPS))
        log(f"K5 {label} (T = {tab.shape[1]}): identical to the plain version"
            f" over {K5_SWEEPS} sweeps x {C} chains ({moved * K5_SWEEPS:.0f} "
            f"of {K5_SWEEPS * C * layout.n_reads} read assignments moved); "
            f"{k_ms[0]:.3f} ms per sweep [{k_ms[1]:.3f}, {k_ms[2]:.3f}], "
            f"{k_ms[0] * 1e3 / layout.n_tiles:.2f} us per tile step")
        return k_ms, lambda: plain_sweep(K5_SWEEPS), moved, changed

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
    b_ms, b_by, nbytes, n_sids = k5_bound(layout, C, moved, changed,
                                          mem_rate, op_rate)
    bl_ms, _by, _nb, _ns = k5_bound(big_layout, C, big_moved, big_changed,
                                    mem_rate, op_rate)
    log(f"K5: one sweep = {n_tiles} tile steps in sequence per chain; "
        f"{k_ms[0] * 1e3 / n_tiles:.2f} us per tile step at T = {M + 1}, "
        f"{big_ms[0] * 1e3 / n_tiles:.2f} at T = {big.shape[1]}; bound "
        f"{b_ms * 1e3:.2f} us per sweep ({b_by}: {nbytes} bytes, {n_sids} "
        f"table entries touched per chain, {moved:.0f} assignments and "
        f"{changed:.0f} table entries changed per sweep; mixing variant "
        f"{mix_moved:.0f} assignments moved per sweep), "
        f"{bl_ms * 1e3:.2f} us at the large table")
    us = lambda ms: ms[0] * 1e3 / n_tiles  # noqa: E731
    return setups, dict(
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


def sorted_packing_max(hits, log_conprb, reads_per_tile: int) -> int:
    """The largest number of one `testing.pair_hits` pair's reads in one
    tile under the packing of the JAX Pallas layout (and of this port's
    before it dealt reads over tiles): each bucket's reads in the order of
    their smallest table row (rows of 128 sids; reads spanning 16 rows or
    more last), tiles filled front to back. For two-hit reads, one bucket
    of `reads_per_tile` reads a tile."""
    import numpy as np

    sid = hits.sid.astype(np.int64).reshape(-1, 2)
    kept = np.isfinite(log_conprb).reshape(-1, 2)
    rows = np.where(kept, sid >> 7, np.iinfo(np.int64).max)
    r_min = rows.min(1)
    wide = (np.where(kept, sid >> 7, -1).max(1) - r_min) >= 16
    order = np.lexsort((r_min, wide))
    pair = (sid[order, 0] - 1) // 2
    tile = np.arange(len(order)) // reads_per_tile
    return int(np.unique(tile * (pair.max() + 1) + pair,
                         return_counts=True)[1].max())


def phase_spread(dev, mem_rate, op_rate, n_pairs: int = SPREAD_PAIRS,
                 n: int = SPREAD_READS, burnin: int = SPREAD_BURNIN,
                 samples: int = SPREAD_SAMPLES):
    """Phase 7b: the sampler's posterior spread at a real sample's size.
    SPREAD_PAIRS pairs of isoforms (testing.pair_hits), SPREAD_READS reads
    each, half with equal conprbs and half with SPREAD_RATIO : 1, no noise
    slot; run_gibbs on the card (8 chains, burn-in 1,000, 8,000 samples),
    launch counts zeroed just before and read just after (K5 must launch
    once per sweep and part). Gates, for each half: the pooled posterior
    SD (root mean pve_c over the pairs' first members) within 3% of the
    exact SD and the pooled mean within 0.03 exact SDs of the exact mean
    (testing.pair_posterior); at most one read of a pair in any tile. K5
    held against its plain version on this layout; its ms per sweep (on
    the card). Returns (launches, numbers)."""
    import numpy as np
    import torch

    from rsem_tpu_torch.engine.gibbs import GibbsConfig, run_gibbs
    from rsem_tpu_torch.ops import gibbs
    from rsem_tpu_torch.ops.layout import clear_device_cache
    from rsem_tpu_torch.refprep.transcripts import GroupInfo
    from rsem_tpu_torch.testing import (
        pair_hits,
        pair_posterior,
        pair_tile_max,
    )

    half = n_pairs // 2
    hits, lcp, lnp = pair_hits([1.0] * half + [SPREAD_RATIO] * half, n)
    M = 2 * n_pairs
    eel, mw = np.full(M + 1, 1000.0), np.ones(M + 1)
    gi = GroupInfo(np.concatenate([np.arange(1, M + 1, 2), [M + 1]]))
    C = 8
    gcfg = GibbsConfig(burnin=burnin, nsamples=samples, n_chains=C, seed=7,
                       keep_countvectors=False)
    on_card = torch.device(dev).type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    if on_card:
        layout, assigns, tab, setup = hold_gibbs_setup(
            "spread", hits, lcp, lnp, M, C, 1, lambda _l: torch.ones(M + 1),
            dev)
    else:  # the CPU rehearsal: no card to hold against
        t0 = time.perf_counter()
        layout = gibbs.build_layout(hits, lcp, lnp, M, device=dev)
        t1 = time.perf_counter()
        assigns, tab = gibbs.init_chains(layout, torch.ones(M + 1), C, seed=1)
        setup = dict(build_s=t1 - t0, init_s=time.perf_counter() - t1)
    most = pair_tile_max(layout)
    packed = sorted_packing_max(hits, lcp, layout.parts[0].reads_per_tile)
    log(f"spread: {hits.n_reads} reads, {hits.n_hits} alignments, M = {M};"
        f" layout {len(layout.parts)} part(s), {layout.n_tiles} tiles per "
        f"sweep, build {setup['build_s']:.4f} s, init "
        f"{setup['init_s']:.4f} s; at most {most} read(s) of one pair in a "
        f"tile (the sorted packing: {packed})")
    if most > 1:
        fail(f"spread: {most} reads of one pair share a tile")
    wrappers = kernel_wrappers()
    for fn in wrappers.values():
        fn.launches = 0
    sync()
    t0 = time.perf_counter()
    res = run_gibbs(hits, lcp, lnp, M, 0, eel, mw, gi, gcfg, device=dev)
    sync()
    wall = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in wrappers.items()}
    sweeps = gcfg.burnin + gcfg.nsamples // C
    if on_card and launches["sweep_part"] != sweeps * len(layout.parts):
        fail(f"spread: K5 launched {launches['sweep_part']} times, not "
             f"{sweeps * len(layout.parts)}")
    out = dict(reads=hits.n_reads, alignments=hits.n_hits, M=M,
               tiles_per_sweep=layout.n_tiles, parts=len(layout.parts),
               setup=setup, pair_tile_max=most,
               sorted_packing_pair_tile_max=packed, run_gibbs_s=wall,
               launches=launches["sweep_part"], sweeps=sweeps)
    for name, ratio, first in (("equal", 1.0, slice(1, M // 2, 2)),
                               ("ratio", SPREAD_RATIO,
                                slice(M // 2 + 1, M + 1, 2))):
        mean, sd = pair_posterior(ratio, n)
        got_sd = float(np.sqrt(res.pve_c[first].mean()))
        got_mean = float(res.pme_c[first].mean())
        out[name] = dict(exact_sd=sd, sd=got_sd, sd_ratio=got_sd / sd,
                         exact_mean=mean, mean=got_mean,
                         mean_dev_in_sd=(got_mean - mean) / sd)
        log(f"spread ({name}, r = {ratio}): pooled SD {got_sd:.4f} against "
            f"exact {sd:.4f} (ratio {got_sd / sd:.4f}); pooled mean "
            f"{got_mean:.4f} against {mean:.4f} ({(got_mean - mean) / sd:+.4f}"
            f" SD)")
        if abs(got_sd / sd - 1.0) > 0.03:
            fail(f"spread ({name}): pooled SD {got_sd} not within 3% of the "
                 f"exact {sd}")
        if abs(got_mean - mean) > 0.03 * sd:
            fail(f"spread ({name}): pooled mean {got_mean} not within 0.03 "
                 f"SD of the exact {mean}")
    kern_sweep, _p, moved, changed = k5_replay(layout, assigns, tab, 7,
                                               "spread")
    k_ms = time_cuda(lambda: kern_sweep(K5_SWEEPS)) if on_card else (
        float("nan"),) * 3
    b_ms, b_by, _nb, _ns = k5_bound(layout, C, moved, changed, mem_rate,
                                    op_rate)
    out.update(ms_per_sweep=k_ms[0], ms_per_sweep_min=k_ms[1],
               ms_per_sweep_max=k_ms[2], bound_ms=b_ms, bound_by=b_by,
               moved_per_sweep=moved)
    log(f"spread: K5 identical to its plain version over {K5_SWEEPS} sweeps;"
        f" {launches['sweep_part']} launches in run_gibbs ({wall:.3f} s); "
        f"{k_ms[0]:.4f} ms per sweep [{k_ms[1]:.4f}, {k_ms[2]:.4f}] "
        f"({k_ms[0] * 1e3 / layout.n_tiles:.2f} us per tile step), bound "
        f"{b_ms:.4f} ms ({b_by}), {moved:.0f} assignments moved per sweep")
    del res, layout, assigns, tab
    clear_device_cache()
    return launches, out


def _read_table(path):
    rows = [l.rstrip("\n").split("\t") for l in open(path)]
    return {r[0]: r for r in rows[1:]}


def phase_goldens():
    """calculate-expression on the golden SAMs, against reference RSEM,
    through native ingest (its calls are counted)."""
    from rsem_tpu_torch.native import bamparse
    from rsem_tpu_torch.ops import model_loop
    from rsem_tpu_torch.pipeline.calculate_expression import main as calc

    cases = (("aln", "golden", [], 0.011, 2e-4),
             ("aln_pe", "golden_pe", ["--paired-end", "--estimate-rspd"],
              0.05, 5e-4))
    loop, fused_calls = model_loop.run_model_loop, []
    sam_parse, native_calls = bamparse.parse_sam_native, []
    model_loop.run_model_loop = lambda *a, **k: (
        fused_calls.append(1), loop(*a, **k))[1]
    bamparse.parse_sam_native = lambda *a, **k: (
        native_calls.append(1), sam_parse(*a, **k))[1]
    try:
        _goldens(cases, calc, fused_calls)
    finally:
        model_loop.run_model_loop = loop
        bamparse.parse_sam_native = sam_parse
    if len(native_calls) != 4:
        fail(f"{len(native_calls)} of the 4 golden calculate-expression runs "
             f"went through native ingest")
    log("goldens: all 4 calculate-expression runs parsed their SAM through "
        "native ingest")


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


def phase_large(dev, k3, seed: int = 0):
    """The main path at a real sample's size (phase 9); K3 held and timed
    on one window through `k3` (a K3Shapes). Returns its launches and a
    summary."""
    import numpy as np
    import torch

    from rsem_tpu_torch.engine import em
    from rsem_tpu_torch.ops import conprb
    from rsem_tpu_torch.ops.layout import clear_device_cache
    from rsem_tpu_torch.testing import synthetic_arrays_fast

    t0 = time.perf_counter()
    ref, bundle, _spec, model0 = synthetic_arrays_fast(
        paired=True, read_len=LARGE_READ_LEN, n_reads=LARGE_READS, M=M_TX,
        tx_len=TX_LEN, has_qual=True, seed=seed)
    gen_s = time.perf_counter() - t0
    H, N = bundle.hits.n_hits, bundle.hits.n_reads
    kcfg = em.kernel_config(model0, bundle, LARGE_READ_LEN)
    whole = conprb.preidx_bytes(kcfg, H, N)
    free, total = torch.cuda.mem_get_info()
    log(f"large workload: N={N} paired {LARGE_READ_LEN} bp, H={H}, "
        f"M={ref.M} ({gen_s:.1f} s to generate); PreIdx {whole} bytes "
        f"({whole / 1e9:.1f} GB) against {free} free of {total} device "
        f"bytes (torch.cuda.mem_get_info)")

    def run(**kw):
        clear_device_cache()  # each run uploads, so the walls compare
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        r = em.run_em(copy.deepcopy(model0), ref, bundle, em.EMConfig(**kw),
                      need_posteriors=False, device=dev)
        torch.cuda.synchronize()
        return r, time.perf_counter() - t0, torch.cuda.max_memory_allocated()

    wrappers = kernel_wrappers()
    for fn in wrappers.values():
        fn.launches = 0
    torch.cuda.empty_cache()
    free0 = torch.cuda.mem_get_info()[0]
    res, wall, peak = run()
    launches = {k: fn.launches for k, fn in wrappers.items()}
    work = work_per_hit(peak, ref, bundle, kcfg, res.preidx_budget)
    log(f"large run_em (default budget {res.preidx_budget} bytes): "
        f"{res.windows} windows, {res.rounds} rounds, {wall:.2f} s, peak "
        f"device memory {peak / 2**30:.2f} GiB ({work:.0f} bytes per window "
        f"hit beyond the layout and the window's PreIdx), launches "
        f"{launches}")
    for k, n in launches.items():
        if n <= 0 and k not in OFF_EM_PATH:
            fail(f"kernel {k} was not launched on the large run")
    if res.windows < 2:
        fail("the large run's PreIdx was not windowed")
    cnt = bundle.cnt
    want = cnt.N1 + cnt.N0
    if not np.all(np.isfinite(res.counts)) or abs(
            res.counts.sum() - want) > 1e-5 * want:
        fail(f"large run: sum(counts) {res.counts.sum()} != N1+N0 {want}")
    if abs(res.tpm.sum() - 1e6) > 1.0:
        fail(f"large run: sum(TPM) {res.tpm.sum()} != 1e6")
    half, wall_half, peak_half = run(preidx_budget=res.preidx_budget // 2)
    if half.rounds != res.rounds:
        fail(f"half budget took {half.rounds} rounds, not {res.rounds}")
    err = agree(half.counts, res.counts, 1e-5, 1e-9,
                "large run counts at half the budget")
    work_half = work_per_hit(peak_half, ref, bundle, kcfg,
                             res.preidx_budget // 2)
    log(f"large run_em at half the budget: {half.windows} windows, "
        f"{wall_half:.2f} s, peak {peak_half / 2**30:.2f} GiB "
        f"({work_half:.0f} bytes per window hit), counts max abs err "
        f"{err:.3g} (rtol 1e-5)")
    theta_rounds = res.rounds - 10
    _r0, wall0, _p0 = run(update_model_rounds=0, min_round=theta_rounds,
                          max_round=theta_rounds)
    ms_round = (wall - wall0) * 1e3 / 10
    log(f"large run: {ms_round:.1f} ms per model round ((wall {wall:.2f} s"
        f" - {wall0:.2f} s with no model rounds) / 10)")
    # K3 on the first window's mate-1 rows (256 columns) as the windowed
    # rounds build them, with torch.rand weights
    refd, m1, _m2, hd = em.upload(ref, bundle, True, dev)
    win = conprb.plan_windows(kcfg, bundle.hits.read_offsets,
                              res.preidx_budget)[0]
    g = torch.Generator(device=dev)
    g.manual_seed(9)
    what = f"phase 9 window 1 of {res.windows}, mate 1"
    flat1 = conprb.preidx_flat(kcfg, refd, m1, conprb.hits_window(hd, win))
    k3.hold(f"{what} profile, torch.rand weights", flat1,
             torch.rand(flat1.shape[0], generator=g, device=dev),
             kcfg.pro_keys())
    del flat1
    nflat1 = conprb.noise_flat(kcfg, conprb.reads_window(m1, win))
    k3.hold(f"{what} noise, torch.rand weights", nflat1,
             torch.rand(nflat1.shape[0], generator=g, device=dev),
             kcfg.npro_keys())
    del nflat1, refd, m1, _m2, hd
    clear_device_cache()
    torch.cuda.empty_cache()
    whole_fit = phase_whole_fit(ref, bundle, kcfg, dev, res.preidx_budget,
                                free0)
    return launches, {
        "reads": N, "hits": H, "read_len": LARGE_READ_LEN, "paired": True,
        "generate_s": gen_s, "preidx_bytes": whole, "free_bytes": free,
        "total_bytes": total, "budget_bytes": res.preidx_budget,
        "windows": res.windows, "rounds": res.rounds, "wall_s": wall,
        "peak_bytes": peak, "work_bytes_per_hit": work,
        "half_budget_work_bytes_per_hit": work_half,
        "half_budget_windows": half.windows,
        "half_budget_wall_s": wall_half, "half_budget_peak_bytes": peak_half,
        "half_budget_max_abs_err_counts": err,
        "no_model_rounds_wall_s": wall0, "ms_per_model_round": ms_round,
        "whole_fit": whole_fit}


def prefix_bundle(bundle, n: int):
    """The first n reads of a paired bundle and their hits (views)."""
    import dataclasses

    from rsem_tpu_torch.io.hits import HitArrays
    from rsem_tpu_torch.io.reads import PairedReadArrays, ReadArrays

    hi, h = bundle.hits, int(bundle.hits.read_offsets[n])
    hits = HitArrays(hi.rid[:h], hi.sid[:h], hi.dir[:h], hi.pos[:h],
                     hi.insert_len[:h], hi.read_offsets[:n + 1])
    mates = [ReadArrays(m.codes[:n], m.lens[:n], m.quals[:n], m.lq[:n])
             for m in (bundle.reads.mate1, bundle.reads.mate2)]
    reads = PairedReadArrays(*mates, bundle.reads.lq[:n])
    cnt = dataclasses.replace(bundle.cnt, N1=n, n_hits=h)
    return dataclasses.replace(bundle, reads=reads, hits=hits, cnt=cnt)


def first_hits_bundle(bundle):
    """Every read of a paired bundle with its first hit alone: one hit per
    read, the share of uniquely aligned reads in a real sample."""
    import dataclasses

    import numpy as np

    from rsem_tpu_torch.io.hits import HitArrays

    hi, n = bundle.hits, bundle.hits.n_reads
    fh = hi.read_offsets[:-1]
    hits = HitArrays(hi.rid[fh], hi.sid[fh], hi.dir[fh], hi.pos[fh],
                     hi.insert_len[fh], np.arange(n + 1, dtype=np.int64))
    cnt = dataclasses.replace(bundle.cnt, n_hits=n)
    return dataclasses.replace(bundle, hits=hits, cnt=cnt)


def phase_whole_fit(ref, bundle, kcfg, dev, budget_full: int, free0: int,
                    target: float = 0.98):
    """Phase 9b: the fused loop on a whole PreIdx near the default budget,
    which holds WORK_BYTES_PER_HIT to the fused loop's working memory at
    its largest: the largest prefix of the large workload whose whole
    PreIdx is at most `target` of the budget run_em computes for it, and
    the workload cut to one hit per read (all reads, or the largest such
    prefix). Prefixes are chosen from the whole run's budget (free0: the
    free device memory before it); run_em must plan one window and take
    the fused loop. Returns a summary of each."""
    import numpy as np
    import torch

    from rsem_tpu_torch.engine import em
    from rsem_tpu_torch.model.generative import GenerativeModel
    from rsem_tpu_torch.model.spec import ModelSpec
    from rsem_tpu_torch.ops import conprb, model_loop
    from rsem_tpu_torch.ops.layout import clear_device_cache

    row = conprb.preidx_row_bytes(kcfg)
    work = em.WORK_BYTES_PER_HIT
    # the free memory the whole run's budget saw (em.preidx_budget
    # inverted), hence the device bytes its upload took over layout_bytes
    seen = (budget_full * (row + work) // row + em.HEADROOM_BYTES
            + em.RUN_BYTES_PER_HIT * bundle.hits.n_hits)
    scale = (free0 - seen) / layout_bytes(ref, bundle)

    def fits(wl, n: int, t: float) -> bool:
        sub = prefix_bundle(wl, n)
        h = sub.hits.n_hits
        free = free0 - scale * layout_bytes(ref, sub)
        budget = ((free - em.HEADROOM_BYTES - em.RUN_BYTES_PER_HIT * h)
                  * row / (row + work))
        return conprb.preidx_bytes(kcfg, h, n) <= t * budget

    spec = ModelSpec(model_type=bundle.read_type, seed_len=25,
                     has_polya=False, est_rspd=True)
    model0 = GenerativeModel(spec, ref)
    model0.estimate_from_stats(bundle.stats)

    def fit_run(label, wl):
        for t in (target, target - 0.03, target - 0.06):
            lo, hi = 1, wl.hits.n_reads
            while lo < hi:
                mid = (lo + hi + 1) // 2
                lo, hi = (mid, hi) if fits(wl, mid, t) else (lo, mid - 1)
            sub = prefix_bundle(wl, lo)
            calls.clear()
            clear_device_cache()
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            try:
                res = em.run_em(copy.deepcopy(model0), ref, sub,
                                em.EMConfig(), need_posteriors=False,
                                device=dev)
            except torch.cuda.OutOfMemoryError as exc:
                fail(f"fused loop ({label}) at {lo} reads ran out of device "
                     f"memory (peak {torch.cuda.max_memory_allocated()} "
                     f"bytes): {exc}")
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            if res.windows == 1:
                break
            log(f"whole-fit ({label}) prefix of {lo} reads at {t} of the "
                f"estimated budget was windowed ({res.windows}); trying a "
                "smaller one")
        else:
            fail(f"whole-fit ({label}): no prefix under the default budget "
                 "ran in one window")
        peak = torch.cuda.max_memory_allocated()
        total = torch.cuda.mem_get_info()[1]
        if calls != [1]:
            fail(f"the whole-fit run ({label}) made {len(calls)} fused-loop "
                 "calls, not 1")
        h = sub.hits.n_hits
        if not np.all(np.isfinite(res.counts)) or abs(
                res.counts.sum() - lo) > 1e-5 * lo:
            fail(f"whole-fit run ({label}): sum(counts) {res.counts.sum()} "
                 f"!= N1 {lo}")
        whole = conprb.preidx_bytes(kcfg, h, lo)
        w = work_per_hit(peak, ref, sub, kcfg, None)
        log(f"whole-fit run ({label}; paired, est-RSPD, fused loop): {lo} "
            f"reads, {h} hits, PreIdx {whole} bytes = "
            f"{whole / res.preidx_budget:.4f} of the default budget "
            f"{res.preidx_budget}; {res.rounds} rounds, {wall:.2f} s, peak "
            f"{peak} of {total} device bytes ({peak / total:.4f}); {w:.1f} "
            f"working bytes per hit (WORK_BYTES_PER_HIT "
            f"{em.WORK_BYTES_PER_HIT})")
        return {"reads": lo, "hits": h, "preidx_bytes": whole,
                "budget_bytes": res.preidx_budget, "windows": res.windows,
                "rounds": res.rounds, "wall_s": wall, "peak_bytes": peak,
                "total_bytes": total, "work_bytes_per_hit": w}

    loop, calls = model_loop.run_model_loop, []
    model_loop.run_model_loop = lambda *a, **k: (calls.append(1),
                                                 loop(*a, **k))[1]
    try:
        return {"prefix": fit_run("prefix", bundle),
                "one_hit_per_read": fit_run("one hit per read",
                                            first_hits_bundle(bundle))}
    finally:
        model_loop.run_model_loop = loop


def bundles_equal(a, b) -> bool:
    """Two AlignmentBundles hold the same arrays, counts and statistics."""
    import numpy as np

    def same(x, y):
        return (x is None and y is None) or (
            x is not None and y is not None and x.dtype == y.dtype
            and np.array_equal(x, y))

    mates = [(a.reads, b.reads)] if not a.paired else [
        (a.reads.mate1, b.reads.mate1), (a.reads.mate2, b.reads.mate2)]
    return (vars(a.cnt) == vars(b.cnt) and same(a.omit, b.omit)
            and all(same(getattr(a.hits, f), getattr(b.hits, f)) for f in (
                "rid", "sid", "dir", "pos", "insert_len", "read_offsets"))
            and all(same(getattr(x, f), getattr(y, f)) for x, y in mates
                    for f in ("codes", "lens", "quals", "lq"))
            and all(vars(a.stats[c]).keys() == vars(b.stats[c]).keys()
                    and all(np.array_equal(np.asarray(u), np.asarray(
                        vars(b.stats[c])[k])) for k, u in
                        vars(a.stats[c]).items()) for c in range(3)))


def phase_ingest(d: str, n_reads: int = INGEST_READS):
    """Records/s of the native and the Python BAM ingest (phase 10)."""
    from rsem_tpu_torch.io.sam import parse_alignments
    from rsem_tpu_torch.native import bamparse
    from rsem_tpu_torch.testing import synthetic_bam

    path = os.path.join(d, "ingest.bam")
    t0 = time.perf_counter()
    n_rec = synthetic_bam(path, n_reads, M=INGEST_M)
    gen_s = time.perf_counter() - t0
    if n_rec < 1_000_000:
        fail(f"the ingest BAM has {n_rec} records, fewer than 1M")
    names = [""] + [f"t{i}" for i in range(INGEST_M)]
    t0 = time.perf_counter()
    bamparse.lib()
    build_s = time.perf_counter() - t0
    calls, parse = [], bamparse.parse_bam_native
    bamparse.parse_bam_native = lambda *a, **k: (calls.append(1),
                                                 parse(*a, **k))[1]
    try:
        t0 = time.perf_counter()
        nat = parse_alignments(path, names, 1, False, 25, use_native=True)
        nat_s = time.perf_counter() - t0
    finally:
        bamparse.parse_bam_native = parse
    if calls != [1]:
        fail("the native BAM parser did not run")
    t0 = time.perf_counter()
    py = parse_alignments(path, names, 1, False, 25, use_native=False)
    py_s = time.perf_counter() - t0
    if not bundles_equal(nat, py):
        fail("native and Python ingest gave different bundles")
    lib_path = bamparse.build()
    out = {"records": n_rec, "reads": n_reads, "bam_bytes":
           os.path.getsize(path), "generate_s": gen_s, "build_s": build_s,
           "libdeflate": bamparse.uses_libdeflate(lib_path),
           "threads": os.cpu_count(), "native_s": nat_s, "python_s": py_s,
           "native_records_per_s": n_rec / nat_s,
           "python_records_per_s": n_rec / py_s}
    log(f"ingest: {n_rec} records ({os.path.getsize(path)} BAM bytes, "
        f"{gen_s:.1f} s to write); sidecar built in {build_s:.2f} s "
        f"(libdeflate {out['libdeflate']}, {os.cpu_count()} threads); native "
        f"{nat_s:.3f} s = {n_rec / nat_s:,.0f} records/s, Python "
        f"{py_s:.2f} s = {n_rec / py_s:,.0f} records/s; bundles identical "
        f"(N1 {nat.cnt.N1}, N0 {nat.cnt.N0}, {nat.cnt.n_hits} hits)")
    return out


def line_lengths(path: str):
    """Length of every line of a text file that ends in a newline."""
    import numpy as np

    buf = np.fromfile(path, dtype=np.uint8)
    nl = np.flatnonzero(buf == 10)
    if buf.size and buf[-1] != 10:
        fail(f"{path} does not end in a newline")
    return nl - np.concatenate([[-1], nl[:-1]]) - 1


def check_fastq(path: str, n: int):
    """Read lengths of a FASTQ of n records (4 lines each, quality lines
    as long as the sequences)."""
    import numpy as np

    lens = line_lengths(path)
    if lens.size != 4 * n:
        fail(f"{path}: {lens.size} lines, not 4 x {n}")
    if not np.array_equal(lens[1::4], lens[3::4]) or (lens[2::4] != 1).any():
        fail(f"{path}: malformed FASTQ records")
    return lens[1::4]


def check_counts(what: str, counts, theta, n: int):
    from rsem_tpu_torch.testing import counts_vs_theta

    if counts.sum() != n:
        fail(f"{what}: counts sum to {counts.sum()}, not {n}")
    worst, p = counts_vs_theta(counts, theta, n)
    if worst > 1.0 or p <= 1e-6:
        fail(f"{what}: counts against N theta: worst |O - E| / (6 sd + 3) "
             f"= {worst:.3f}, chi-square p = {p:.3g}")
    return worst, p


def check_hist(what: str, obs, exp) -> float:
    from rsem_tpu_torch.testing import hist_vs_expected

    worst = hist_vs_expected(obs, exp)
    if worst > 1.0:
        fail(f"{what}: a bin is off by more than 5 sd + 3 ({worst:.3f})")
    return worst


def _table_col(path: str, col: str):
    rows = [l.rstrip("\n").split("\t") for l in open(path)]
    return {r[0]: float(r[rows[0].index(col)]) for r in rows[1:]}


def phase_simulate(ref, model, tpm, dev, d: str):
    """simulate_reads at full width and paired end on the golden reference
    (phase 11)."""
    import numpy as np
    import torch

    from rsem_tpu_torch.engine import simulate as sim
    from rsem_tpu_torch.model.generative import GenerativeModel
    from rsem_tpu_torch.refprep.reference import Reference
    from rsem_tpu_torch.testing import truncated_length_hist

    n = SIM_READS
    theta = sim.sim_theta(model, tpm, SIM_THETA0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    prefix = os.path.join(d, "full")
    t0 = time.perf_counter()
    res = sim.simulate_reads(model, ref, tpm, SIM_THETA0, n, prefix,
                             seed=11, device=dev)
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() - base
    path = prefix + ".fq"
    nbytes = os.path.getsize(path)
    t0 = time.perf_counter()
    lens = check_fastq(path, n)
    os.remove(path)
    worst, p = check_counts("phase 11 single end", res.counts, theta, n)
    refL = np.where(np.arange(ref.M + 1) == 0, -1, ref.tot_len)
    h_len = check_hist("phase 11 read lengths", np.bincount(lens),
                       truncated_length_hist(model.gld, refL, res.counts))
    check_s = time.perf_counter() - t0
    if peak >= SIM_PEAK_LIMIT:
        fail(f"simulate_reads peaked at {peak} device bytes beyond its "
             f"inputs, over {SIM_PEAK_LIMIT}")
    se = {"reads": n, "M": ref.M, "read_len": int(model.gld.maxL),
          "wall_s": wall, "sample_s": res.sample_seconds,
          "assemble_s": res.assemble_seconds, "write_s": res.write_seconds,
          "reads_per_s": n / wall,
          "bytes_written": nbytes, "n_resimulated": res.n_resimulated,
          "peak_device_bytes": peak, "counts_worst": worst,
          "chi2_p": p, "length_hist_worst": h_len, "check_s": check_s}
    log(f"simulate (single end): {n} reads, M {ref.M}, {wall:.2f} s = "
        f"{n / wall:,.0f} reads/s; device draws {res.sample_seconds:.2f} s, "
        f"records built on the device and copied out "
        f"{res.assemble_seconds:.2f} s, host writes "
        f"{res.write_seconds:.2f} s; {nbytes} bytes; "
        f"{res.n_resimulated} resimulated; peak {peak / 2**30:.3f} GiB "
        f"beyond its inputs; counts worst {worst:.3f} (<= 1), chi-square p "
        f"{p:.3g}; length histogram worst {h_len:.3f}; checks {check_s:.1f} s")

    gref = Reference.load_seq(os.path.join(GOLD, "ref.seq"))
    pe = GenerativeModel.read(os.path.join(GOLD, "golden_pe.model"),
                              refs=gref)
    tab = _table_col(os.path.join(GOLD, "golden_pe.isoforms.results"), "TPM")
    tpm_pe = np.array([0.0] + [tab[t] for t in gref.names[1:]])
    n = SIM_PAIRS
    prefix = os.path.join(d, "pe")
    t0 = time.perf_counter()
    res = sim.simulate_reads(pe, gref, tpm_pe, SIM_THETA0, n, prefix,
                             seed=12, device=dev)
    pe_wall = time.perf_counter() - t0
    mates = [check_fastq(f"{prefix}_{m}.fq", n) for m in (1, 2)]
    with open(f"{prefix}_1.fq", "rb") as f:
        names = f.read().split(b"\n")[0:4 * n:4]
    fields = np.array([x[1:-2].split(b"_") for x in names], dtype=np.int64)
    for m in (1, 2):
        os.remove(f"{prefix}_{m}.fq")
    pw, pp = check_counts("phase 11 paired end", res.counts,
                          sim.sim_theta(pe, tpm_pe, SIM_THETA0), n)
    if not np.array_equal(np.bincount(fields[:, 2], minlength=gref.M + 1),
                          res.counts):
        fail("phase 11 paired end: read names disagree with the counts")
    refL = np.where(np.arange(gref.M + 1) == 0, -1, gref.tot_len)
    h_frag = check_hist("phase 11 fragment lengths", np.bincount(fields[:, 4]),
                        truncated_length_hist(pe.gld, refL, res.counts))
    fr, fc = np.unique(np.where(fields[:, 2] == 0, -1, fields[:, 4]),
                       return_counts=True)
    h_mate = check_hist("phase 11 mate lengths",
                        np.bincount(np.concatenate(mates)),
                        truncated_length_hist(pe.mld, fr, 2 * fc))
    pe_out = {"pairs": n, "M": gref.M, "wall_s": pe_wall,
              "sample_s": res.sample_seconds,
              "assemble_s": res.assemble_seconds,
              "write_s": res.write_seconds,
              "n_resimulated": res.n_resimulated, "counts_worst": pw,
              "chi2_p": pp, "fragment_hist_worst": h_frag,
              "mate_hist_worst": h_mate}
    log(f"simulate (paired end, golden_pe.model): {n} pairs in "
        f"{pe_wall:.2f} s (draws {res.sample_seconds:.2f} s, records "
        f"{res.assemble_seconds:.2f} s, writes {res.write_seconds:.2f} s); "
        f"counts worst {pw:.3f}, chi-square p "
        f"{pp:.3g}; fragment-length histogram worst {h_frag:.3f}, mate "
        f"lengths {h_mate:.3f}")
    return {"single_end": se, "paired_end": pe_out}


def phase_round_trip(d: str):
    """prepare-reference -> simulate-reads -> calculate-expression through
    the port's CLI, in process, on the card (phase 12)."""
    import numpy as np

    from rsem_tpu_torch.__main__ import main as cli
    from rsem_tpu_torch.refprep.reference import Reference
    from rsem_tpu_torch.testing import provenance_sam, two_sample_counts_ok

    n = ROUND_TRIP_READS
    cwd = os.getcwd()
    t0 = time.perf_counter()
    os.chdir(d)
    try:
        if cli(["prepare-reference", "--transcript-to-gene-map",
                os.path.join(GOLD, "map.txt"), os.path.join(GOLD, "tx.fa"),
                "ref", "-q"]) != 0:
            fail("prepare-reference failed")
        for name in ("ref.seq", "ref.ti", "ref.grp", "ref.transcripts.fa"):
            with open(name, "rb") as a, open(os.path.join(GOLD, name),
                                             "rb") as b:
                if a.read() != b.read():
                    fail(f"prepare-reference: {name} differs from the golden")
        t1 = time.perf_counter()
        if cli(["simulate-reads", "ref", os.path.join(GOLD, "golden.model"),
                os.path.join(GOLD, "golden.isoforms.results"),
                str(SIM_THETA0), str(n), "sim", "--seed", "7", "-q"]) != 0:
            fail("simulate-reads failed")
        t2 = time.perf_counter()
        refs = Reference.load_seq("ref.seq")
        tids = refs.names[1:]
        truth = _table_col("sim.sim.isoforms.results", "count")
        mine = np.array([0.0] + [truth[t] for t in tids])
        mine[0] = n - mine.sum()
        gold_t = _table_col(os.path.join(GOLD, "golden_sim.isoforms.results"),
                            "count")
        gold = np.array([0.0] + [gold_t[t] for t in tids])
        gold[0] = n - gold.sum()
        z_ok = two_sample_counts_ok(mine, gold, n)
        if not z_ok.all():
            fail(f"simulate-reads against golden_sim: entries "
                 f"{np.nonzero(~z_ok)[0].tolist()} outside 4.5 sd")
        prov = provenance_sam(refs, "sim.fq", "simaln.sam")
        if not np.array_equal(prov, mine):
            fail("sim.sim.isoforms.results counts differ from the names'")
        t3 = time.perf_counter()
        if cli(["calculate-expression", "--alignments", "simaln.sam", "ref",
                "ours", "-q", "--device", "cuda"]) != 0:
            fail("calculate-expression on the simulated reads failed")
        t4 = time.perf_counter()
        got = _table_col("ours.isoforms.results", "expected_count")
        err = max(abs(got[t] - prov[k]) for k, t in enumerate(tids, 1))
        if err > 1e-2:
            fail(f"round trip: expected counts off the truth by {err}")
    finally:
        os.chdir(cwd)
    out = {"reads": n, "wall_s": t4 - t0, "prepare_s": t1 - t0,
           "simulate_s": t2 - t1, "sam_s": t3 - t2,
           "calculate_expression_s": t4 - t3, "max_count_err": err,
           "noise_reads": int(mine[0])}
    log(f"round trip: {t4 - t0:.2f} s (prepare-reference {t1 - t0:.2f}, "
        f"simulate-reads {t2 - t1:.2f}, provenance SAM {t3 - t2:.2f}, "
        f"calculate-expression {t4 - t3:.2f}); reference byte-identical to "
        f"the goldens, z-test against golden_sim passed, expected counts "
        f"within {err:.2e} of the truth")
    return out


def _rows(path):
    rows = [l.rstrip("\n").split("\t") for l in open(path)]
    return rows[0], rows[1:]


def _col(hdr, rows, name):
    import numpy as np

    return np.array([float(r[hdr.index(name)]) for r in rows])


def _stage_seconds(path: str) -> dict:
    """The per-stage lines (# name: s s.) of a --time file."""
    out = {}
    for line in open(path):
        if line.startswith("# "):
            name, secs = line[2:].rsplit(":", 1)
            out[name] = out.get(name, 0.0) + float(secs.split()[0])
    return out


def _sum_ok(parts, total, k, what: str) -> float:
    """Summed table entries against their total: rel 1e-6, plus half a unit
    of the tables' last printed digit (0.005) for each of the k + 1 printed
    numbers."""
    import numpy as np

    d = np.abs(parts - total)
    bad = d > 1e-6 * np.abs(total) + 0.005 * (k + 1)
    if bad.any():
        fail(f"{what}: {int(bad.sum())} entries off (max {d.max():.4g})")
    return float(d.max())


@contextlib.contextmanager
def driver_capture():
    """For the length of one CLI run, the driver's run_em and run_gibbs
    record every call, in order: (args, kwargs, result, the kernel
    launches made during the call); run_em's model is recorded as a copy
    taken before run_em refits it (inside the run's timed em stage).
    Yields {"run_em": [...], "run_gibbs": [...]}."""
    ce = importlib.import_module(
        "rsem_tpu_torch.pipeline.calculate_expression")
    got = {"run_em": [], "run_gibbs": []}
    orig = {name: getattr(ce, name) for name in got}
    wrappers = kernel_wrappers()

    def recorder(name):
        def rec(*args, **kw):
            kept = args
            if name == "run_em":
                kept = (copy.deepcopy(args[0]),) + args[1:]
            n0 = {k: fn.launches for k, fn in wrappers.items()}
            res = orig[name](*args, **kw)
            got[name].append((kept, kw, res, {
                k: fn.launches - n0[k] for k, fn in wrappers.items()}))
            return res
        return rec

    for name in got:
        setattr(ce, name, recorder(name))
    try:
        yield got
    finally:
        for name, fn in orig.items():
            setattr(ce, name, fn)


def hold_path_em(label: str, call, dev, k3=None) -> dict:
    """K4, K2, K3 and K1 against their plain versions on the inputs one
    run_em call of a CLI run gave them (a driver_capture record), at the
    tolerances of phase 3: K4
    builds each mate's PreIdx of the run's bundle (bit-identical); K2
    gathers the initial model's profile and noise tables over them (rtol
    1e-6); K3 scatters the run's final hit and noise posteriors by them
    (rtol 1e-5); K1 runs one round from the run's initial and one from its
    final theta over its final conprbs (theta and counts rtol 1e-5, stop
    count within 2). K3 goes through `k3.hold` (a K3Shapes), which also
    times it on the card. Returns the max abs error of each kernel."""
    import torch

    from rsem_tpu_torch.convert import model_arrays_to_torch
    from rsem_tpu_torch.engine import em as em_mod
    from rsem_tpu_torch.ops import conprb, table, theta

    (model, ref, bundle, _cfg), _kw, res, _launches = call
    refd, m1, m2, hd = em_mod.upload(ref, bundle, model.spec.paired, dev)
    kcfg = em_mod.kernel_config(model, bundle, int(m1.codes.shape[1]))
    dm = model_arrays_to_torch(model.device_arrays(), dev)
    pro, npro = kcfg.pro_keys(), kcfg.npro_keys()
    tab = table.padded_table(dm["log_pro"].reshape(-1), pro)
    ntab = table.padded_table(dm["log_npro"].reshape(-1), npro)
    f32 = lambda x: torch.as_tensor(x, dtype=torch.float32).to(dev)  # noqa
    w, wn = f32(res.frac_hit), f32(res.frac_noise)
    k3 = k3 or K3Shapes()
    err = {"K4": 0.0, "K2": 0.0, "K3": 0.0, "K1": 0.0}
    for i, mate in enumerate((m1, m2) if model.spec.paired else (m1,)):
        what = f"{label}, mate {i + 1}"
        flat = conprb.preidx_flat(kcfg, refd, mate, hd, mate2=i == 1)
        if not torch.equal(flat, conprb.preidx_flat_plain(kcfg, refd, mate,
                                                          hd, i == 1)):
            fail(f"{what}: K4 preidx_flat differs from its plain version")
        nflat = conprb.noise_flat(kcfg, mate)
        err["K2"] = max(
            err["K2"],
            close(table.gather_sum(tab, flat),
                  table.gather_sum_plain(tab, flat), 1e-6, 1e-6,
                  f"{what}: K2 gather_sum (profile)"),
            close(table.gather_sum(ntab, nflat),
                  table.gather_sum_plain(ntab, nflat), 1e-6, 1e-6,
                  f"{what}: K2 gather_sum (noise)"))
        err["K3"] = max(
            err["K3"],
            k3.hold(f"{what} profile, the run's final posteriors", flat, w,
                    pro)["max_abs_err"],
            k3.hold(f"{what} noise, the run's final posteriors", nflat, wn,
                    npro)["max_abs_err"])
        del flat, nflat
    data = theta.scale_conprbs(
        hd, torch.as_tensor(res.log_conprb).to(dev),
        torch.as_tensor(res.log_ncp).to(dev), ref.M, float(bundle.cnt.N0))
    for which, th in (("initial", em_mod._theta_init(bundle.cnt, ref.M)),
                      ("final", res.theta_raw)):
        th = f32(th)
        state = theta.round_state(data, 1, dev)
        state.ring[0] = th
        theta.theta_round(state, data, 1)
        t_p, c_p, n_p = theta.theta_round_plain(th, data)
        what = f"{label}: K1 theta_round from the {which} theta"
        err["K1"] = max(err["K1"],
                        close(state.ring[1], t_p, 1e-5, 1e-9, what),
                        close(state.counts, c_p, 1e-5, 1e-6, what))
        if abs(int(state.tot[0]) - int(n_p)) > 2:
            fail(f"{what}: stop count {int(state.tot[0])}, plain {int(n_p)}")
    return err


def hold_path_gibbs(label: str, call, dev, sweeps: int = K5_SWEEPS) -> dict:
    """K5 and the posteriors on the inputs one run_gibbs call of a CLI run
    gave it (a driver_capture record; its pseudo-counts too, pRSEM's prior
    where the rerun passed one). K5 against its plain version from the
    run's own initial chain state and seeds, over its first `sweeps`
    sweeps (identical chains, as phase 7). run_gibbs on the card and on
    the CPU, the same inputs at `sweeps` sweeps: identical count vectors,
    every moment within rtol 1e-5 (atol 1e-6). The run's own moments
    against a float64 recomputation from its count vectors: pme_c, pve_c
    and, with an allele reference, pve_c_trans (the variance of each
    transcript's summed allele counts) within rtol 1e-5 (atol 1e-6).
    Returns the max abs errors."""
    import dataclasses

    import numpy as np
    import torch

    from rsem_tpu_torch.engine import gibbs as eg
    from rsem_tpu_torch.ops import gibbs

    args, kw, res, _launches = call
    hits, lcp, lnp, M, N0, _eel, _mw, _gi, cfg = args
    init, pseudo, _totc = eg.setup_counts(cfg, M, N0, hits.n_reads,
                                          kw.get("omit"), kw.get("prior"))
    layout = gibbs.build_layout(hits, lcp, lnp, M, device=dev)
    base = torch.as_tensor(init + pseudo, dtype=torch.float32)
    base[0] += N0 + layout.n_noise_fixed
    assigns, tab = gibbs.init_chains(layout, base, cfg.n_chains, cfg.seed,
                                     dev)
    k5_replay(layout, assigns, tab, cfg.seed, f"{label}, the run's chains",
              sweeps)
    del layout, assigns, tab

    def near(got_, want, what):
        return close(torch.as_tensor(got_), torch.as_tensor(want), 1e-5,
                     1e-6, f"{label}: {what}")

    short = dataclasses.replace(cfg, burnin=sweeps - 2,
                                nsamples=2 * cfg.n_chains, gap=1,
                                keep_countvectors=True)
    on = {d: eg.run_gibbs(*args[:8], short, **{**kw, "device": d})
          for d in (dev, "cpu")}
    if not torch.equal(on[dev].countvectors.cpu(), on["cpu"].countvectors):
        fail(f"{label}: run_gibbs on the card and on the CPU drew different "
             f"count vectors over {sweeps} sweeps")
    ta = kw.get("ta")
    fields = ("pme_c", "pve_c", "pme_tpm", "pme_fpkm", "pve_c_genes") + (
        ("pve_c_trans",) if ta is not None else ())
    err = {"cpu": max(near(getattr(on[dev], f), getattr(on["cpu"], f), f)
                      for f in fields)}
    cv = res.countvectors.double().cpu().numpy()
    err["f64"] = max(near(res.pme_c, cv.mean(0), "pme_c"),
                     near(res.pve_c, cv.var(0, ddof=1), "pve_c"))
    if ta is not None:
        tsum = np.add.reduceat(cv[:, 1:], ta.starts[:-1] - 1, axis=1)
        err["f64"] = max(err["f64"], near(res.pve_c_trans,
                                          tsum.var(0, ddof=1),
                                          "pve_c_trans"))
    return err


def phase_allele(d: str, device: str = "cuda", n_genes: int = ALLELE_GENES,
                 n_reads: int = ALLELE_READS, k3=None):
    """Allele-specific quantification through the port's CLI, in process,
    at full width (phase 13); K3 held on its inputs through `k3` (a
    K3Shapes). Returns (launches, summary)."""
    import numpy as np
    import torch

    from rsem_tpu_torch.__main__ import main as cli
    from rsem_tpu_torch.engine import simulate as sim
    from rsem_tpu_torch.model.generative import GenerativeModel
    from rsem_tpu_torch.refprep.reference import Reference
    from rsem_tpu_torch.refprep.transcripts import GroupInfo
    from rsem_tpu_torch.testing import (
        allele_siblings,
        lognormal_tpm,
        provenance_sam,
        synthetic_allele_reference,
    )

    wrappers = kernel_wrappers()
    cwd = os.getcwd()
    os.chdir(d)
    try:
        t0 = time.perf_counter()
        synthetic_allele_reference(".", n_genes, seed=13)
        if cli(["prepare-reference", "--allele-to-gene-map", "amap.txt",
                "alleles.fa", "aref", "-q"]) != 0:
            fail("phase 13: prepare-reference failed")
        t1 = time.perf_counter()
        ref = Reference.load_seq("aref.seq")
        ta, gt = GroupInfo.load("aref.ta"), GroupInfo.load("aref.gt")
        model = GenerativeModel.read(os.path.join(GOLD, "golden.model"),
                                     refs=ref)
        sim.simulate_reads(model, ref, lognormal_tpm(ref.M, seed=13),
                           SIM_THETA0, n_reads, "sim", seed=13, device=device)
        t2 = time.perf_counter()
        truth = provenance_sam(ref, "sim.fq", "aln.sam",
                               also=allele_siblings(ta))
        os.remove("sim.fq")
        n_rec = sum(1 for line in open("aln.sam") if line[0] != "@")
        t3 = time.perf_counter()
        with driver_capture() as got:
            for fn in wrappers.values():
                fn.launches = 0
            rc = cli(["calculate-expression", "--alignments", "aln.sam",
                      "aref", "out", "-q", "--device", device, "--calc-pme",
                      "--calc-ci", "--no-bam-output", "--seed", "13",
                      "--time"])
            launches = {k: fn.launches for k, fn in wrappers.items()}
        t4 = time.perf_counter()
        if rc != 0:
            fail("phase 13: calculate-expression failed")
        stages = _stage_seconds("out.time")
        ah, arows = _rows("out.alleles.results")
        ih, irows = _rows("out.isoforms.results")
        gh, grows = _rows("out.genes.results")
        if len(arows) != ref.M or len(irows) != ta.m or len(grows) != gt.m:
            fail("phase 13: table sizes differ from the reference's")
        tids = ta.gids_of(np.arange(1, ref.M + 1))
        gids = gt.gids_of(tids)
        true_t = np.bincount(tids, weights=truth[1:], minlength=ta.m)
        a_cnt = _col(ah, arows, "expected_count")
        t_cnt = _col(ih, irows, "expected_count")
        g_cnt = _col(gh, grows, "expected_count")
        err = float(np.abs(t_cnt - true_t).max())
        if err > 1e-2:
            fail(f"phase 13: transcript expected counts off the truth by "
                 f"{err}")
        k_t = np.bincount(tids, minlength=ta.m)
        k_g = np.bincount(gids, minlength=gt.m)
        sum_t = _sum_ok(np.bincount(tids, weights=a_cnt, minlength=ta.m),
                        t_cnt, k_t, "phase 13: alleles -> transcripts")
        sum_g = _sum_ok(np.bincount(gids, weights=a_cnt, minlength=gt.m),
                        g_cnt, k_g, "phase 13: alleles -> genes")
        two = k_t == 2
        sel = two & (true_t >= 50)
        pick = np.isin(tids, np.flatnonzero(sel))
        r = float(np.corrcoef(a_cnt[pick], truth[1:][pick])[0, 1])
        if not r >= 0.9:
            fail(f"phase 13: allele counts against the truth: Pearson r {r}")
        pme = _col(ih, irows, "posterior_mean_count")
        sd = _col(ih, irows, "posterior_standard_deviation_of_count")
        pme_w = float((np.abs(pme - true_t) / np.maximum(3 * sd, 1.5)).max())
        if pme_w > 1.0:
            fail(f"phase 13: transcript PME off the truth: worst |pme - "
                 f"truth| / max(3 sd, 1.5) = {pme_w}")
        ci_cols = [c for c in ih if "_ci_" in c or "quartile" in c]
        for hdr, rows, what in ((ah, arows, "alleles"), (ih, irows,
                                                         "isoforms"),
                                (gh, grows, "genes")):
            for unit in ("TPM", "FPKM"):
                lb = _col(hdr, rows, f"{unit}_ci_lower_bound")
                ub = _col(hdr, rows, f"{unit}_ci_upper_bound")
                if (lb > ub).any() or not np.isfinite(lb).all():
                    fail(f"phase 13: {what} {unit} CI with lb > ub")
        first = ta.starts[:-1] - 1
        for t in np.flatnonzero(k_t == 1):
            for c in ci_cols:
                if irows[t][ih.index(c)] != arows[first[t]][ah.index(c)]:
                    fail(f"phase 13: transcript {irows[t][0]} {c} differs "
                         f"from its single allele's")
        # the kernels and the allele posteriors on this run's own inputs
        t5 = time.perf_counter()
        dev = torch.device(device)
        holds = {"em": hold_path_em("phase 13", got["run_em"][0], dev, k3),
                 "gibbs": hold_path_gibbs("phase 13", got["run_gibbs"][0],
                                          dev)}
        gres = got["run_gibbs"][0][2]
        col = "posterior_standard_deviation_of_count"
        for hdr, rows, want, what in (
                (ah, arows, gres.pme_c[1:], "allele PME"),
                (ah, arows, np.sqrt(gres.pve_c[1:]), "allele SD"),
                (ih, irows, np.sqrt(gres.pve_c_trans), "transcript SD")):
            name = "posterior_mean_count" if what.endswith("PME") else col
            _sum_ok(_col(hdr, rows, name), want, 0, f"phase 13: {what} "
                    f"column against the run's moments")
        t6 = time.perf_counter()
    finally:
        os.chdir(cwd)
    out = {"genes": n_genes, "transcripts": ta.m, "alleles": ref.M,
           "single_allele_transcripts": int((k_t == 1).sum()),
           "reads": n_reads, "sam_records": n_rec,
           "noise_reads": int(truth[0]), "prepare_s": t1 - t0,
           "simulate_s": t2 - t1, "sam_s": t3 - t2,
           "calculate_expression_s": t4 - t3, "stages_s": stages,
           "max_count_err": err, "allele_sum_err": sum_t,
           "gene_sum_err": sum_g, "pearson_r": r,
           "pearson_transcripts": int(sel.sum()), "pme_worst": pme_w,
           "path_kernels_max_abs_err": holds, "path_holds_s": t6 - t5}
    log(f"allele: {ref.M} alleles of {ta.m} transcripts "
        f"({out['single_allele_transcripts']} with one allele), {n_reads} "
        f"reads, {n_rec} SAM records; prepare {t1 - t0:.2f} s, simulate "
        f"{t2 - t1:.2f} s, SAM {t3 - t2:.2f} s, "
        f"calculate-expression {t4 - t3:.2f} s (stages "
        + ", ".join(f"{k} {v:.2f}" for k, v in stages.items())
        + f"); launches {launches}; counts within {err:.2e} of the truth, "
        f"Pearson r {r:.4f} over {int(sel.sum())} transcripts, PME worst "
        f"{pme_w:.3f}; K1-K5 on this run's inputs equal their plain versions"
        f" and run_gibbs on the card the CPU's ({holds}, {t6 - t5:.2f} s)")
    return launches, out


def _fasta(path: str) -> dict:
    seqs, name, buf = {}, None, []
    for line in open(path):
        if line.startswith(">"):
            if name is not None:
                seqs[name] = "".join(buf)
            name, buf = line[1:].split()[0], []
        else:
            buf.append(line.strip())
    if name is not None:
        seqs[name] = "".join(buf)
    return seqs


def _mismatches(rec, target: str) -> int:
    """Mismatches of a record's bases against its target through the cigar
    (M compares; N and D skip the target; I and S skip the read)."""
    seq = rec.seq_string()
    t, q, mm = rec.pos, 0, 0
    for ln, op in rec.cigar_ops():
        if op in "M=X":
            a = seq[q:q + ln]
            b = target[t:t + ln]
            mm += sum(x != y for x, y in zip(a, b)) + ln - len(b)
            t, q = t + ln, q + ln
        elif op in "ND":
            t += ln
        elif op in "IS":
            q += ln
    return mm


def _shuffle_reads(src: str, dst: str, seed: int) -> None:
    """Copy a SAM with its reads (each read's records kept together, in
    order) in a seeded random order."""
    import numpy as np

    head, reads, cur, name = [], [], [], None
    for line in open(src):
        if line[0] == "@":
            head.append(line)
            continue
        q = line.split("\t", 1)[0]
        if q != name and cur:
            reads.append(cur)
            cur = []
        name = q
        cur.append(line)
    if cur:
        reads.append(cur)
    order = np.random.default_rng(seed).permutation(len(reads))
    with open(dst, "w") as f:
        f.write("".join(head))
        for i in order:
            f.write("".join(reads[i]))


def phase_genome_bam(d: str, device: str = "cuda", n_pairs: int = GENOME_PAIRS,
                     n_genes: int = GENOME_GENES,
                     chrom_len: int = GENOME_CHROM_LEN, k3=None):
    """--output-genome-bam, --sort-bam-by-coordinate and
    --sort-bam-by-read-name through the port's CLI, in process, on a genome
    reference (phase 14); K3 held on its inputs through `k3` (a
    K3Shapes). Returns (launches, summary)."""
    import numpy as np
    import torch

    from rsem_tpu_torch.__main__ import main as cli
    from rsem_tpu_torch.engine import simulate as sim
    from rsem_tpu_torch.io.bamio import BamRecReader
    from rsem_tpu_torch.model.generative import GenerativeModel
    from rsem_tpu_torch.refprep.reference import Reference
    from rsem_tpu_torch.refprep.transcripts import Transcripts
    from rsem_tpu_torch.testing import (
        SharedExonSiblings,
        bai_finds_all,
        bam_records,
        lognormal_tpm,
        provenance_sam,
        record_span,
        synthetic_genome,
    )

    wrappers = kernel_wrappers()
    cwd = os.getcwd()
    os.chdir(d)
    try:
        t0 = time.perf_counter()
        synthetic_genome(".", seed=14, n_genes=n_genes, chrom_len=chrom_len)
        if cli(["prepare-reference", "--gtf", "anno.gtf", "genome.fa",
                "gref", "-q"]) != 0:
            fail("phase 14: prepare-reference failed")
        ref = Reference.load_seq("gref.seq")
        ts = Transcripts.read_ti("gref.ti")
        model = GenerativeModel.read(os.path.join(GOLD, "golden_pe.model"),
                                     refs=ref)
        sim.simulate_reads(model, ref, lognormal_tpm(ref.M, seed=14),
                           SIM_THETA0, n_pairs, "pe", seed=14, device=device)
        sib = SharedExonSiblings(ts)
        truth = provenance_sam(ref, "pe_1.fq", "aln.sam", fastq2="pe_2.fq",
                               also=sib)
        _shuffle_reads("aln.sam", "shuf.sam", seed=14)
        n_tx = 2 * (n_pairs + sib.n_siblings)  # transcript BAM records
        n_gen = 2 * n_pairs  # one genome locus per pair after collapsing
        t1 = time.perf_counter()
        with driver_capture() as got:
            for fn in wrappers.values():
                fn.launches = 0
            if cli(["calculate-expression", "--alignments", "aln.sam",
                    "gref", "out", "-q", "--device", device, "--paired-end",
                    "--output-genome-bam", "--sort-bam-by-coordinate",
                    "--time"]) != 0:
                fail("phase 14: calculate-expression failed")
            launches = {k: fn.launches for k, fn in wrappers.items()}
        t2 = time.perf_counter()
        holds = hold_path_em("phase 14", got["run_em"][0],
                             torch.device(device), k3)
        del got
        t2b = time.perf_counter()
        if cli(["calculate-expression", "--alignments", "shuf.sam", "gref",
                "ns", "-q", "--device", device, "--paired-end",
                "--sort-bam-by-read-name", "--no-bam-output",
                "--time"]) != 0:
            fail("phase 14: calculate-expression --sort-bam-by-read-name "
                 "failed")
        t3 = time.perf_counter()
        st, st_ns = _stage_seconds("out.time"), _stage_seconds("ns.time")

        # the name-sorted rerun: identical .cnt and tables
        for a, b in (("out.stat/out.cnt", "ns.stat/ns.cnt"),
                     ("out.isoforms.results", "ns.isoforms.results"),
                     ("out.genes.results", "ns.genes.results")):
            if open(a).read() != open(b).read():
                fail(f"phase 14: {b} differs from {a} (name-sorted rerun)")
        gh, grows = _rows("out.genes.results")
        true_g = {}
        for sid, t in enumerate(ts.transcripts, 1):
            true_g[t.gene_id] = true_g.get(t.gene_id, 0.0) + truth[sid]
        g_err = max(abs(float(r[gh.index("expected_count")]) - true_g[r[0]])
                    for r in grows)
        if g_err > 1e-2:
            fail(f"phase 14: gene expected counts off the truth by {g_err}")

        # genome records against transcript records
        tseq = _fasta("gref.transcripts.fa")
        gseq = _fasta("genome.fa")
        tx = list(BamRecReader("out.transcript.bam"))
        gb = list(BamRecReader("out.genome.bam"))
        if len(tx) != n_tx:
            fail(f"phase 14: transcript BAM has {len(tx)} records, the "
                 f"helper wrote {n_tx}")
        if len(gb) != n_gen:
            fail(f"phase 14: genome BAM has {len(gb)} records, {n_gen} "
                 f"expected after collapsing")
        tnames = BamRecReader("out.transcript.bam").header.target_names
        gnames = BamRecReader("out.genome.bam").header.target_names
        mm_t, zw_t, zw_g = {}, {}, {}
        for rec in tx:
            if not rec.is_mapped:
                continue
            key = (rec.canonical_name, rec.is_read1)
            mm_t.setdefault(key, set()).add(
                _mismatches(rec, tseq[tnames[rec.tid]]))
            if rec.is_read1:
                zw_t[key[0]] = zw_t.get(key[0], 0.0) + rec.get_tag("ZW")
        n_cmp = 0
        for rec in gb:
            if not rec.is_mapped:
                continue
            key = (rec.canonical_name, rec.is_read1)
            mm = _mismatches(rec, gseq[gnames[rec.tid]])
            if mm_t.get(key) != {mm}:
                fail(f"phase 14: {key}: {mm} mismatches against the genome, "
                     f"{mm_t.get(key)} against the transcripts")
            n_cmp += 1
            if rec.is_read1:
                zw_g[key[0]] = zw_g.get(key[0], 0.0) + rec.get_tag("ZW")
        if zw_t.keys() != zw_g.keys() or any(
                abs(zw_g[k] - v) > 1e-5 * max(v, 1e-3) + 1e-6
                for k, v in zw_t.items()):
            fail("phase 14: ZW per read differs between the transcript and "
                 "the genome BAM")

        # sorted copies: samtools order, same records, a BAI that finds all
        n_bai = 0
        for src in ("out.transcript", "out.genome"):
            recs, _v, _h = bam_records(f"{src}.bam")
            srt, _v, _h = bam_records(f"{src}.sorted.bam")
            if sorted(recs) != sorted(srt):
                fail(f"phase 14: {src}.sorted.bam holds other records")
            keys = []
            for raw in srt:
                tid, pos, _e = record_span(raw)
                keys.append((tid if tid >= 0 else 2**31, pos))
            if keys != sorted(keys):
                fail(f"phase 14: {src}.sorted.bam is not in coordinate order")
            n_bai += bai_finds_all(f"{src}.sorted.bam",
                                   f"{src}.sorted.bam.bai")
    finally:
        os.chdir(cwd)
    rate = lambda n, s: n / s if s > 0 else float("nan")  # noqa: E731
    out = {"pairs": n_pairs, "genes": n_genes, "transcripts": ref.M,
           "noise_pairs": int(truth[0]), "sibling_alignments": sib.n_siblings,
           "transcript_records": n_tx, "genome_records": n_gen,
           "stages_s": st, "name_sort_stages_s": st_ns,
           "transcript_bam_records_per_s": rate(n_tx, st["bam-output"]),
           "tbam2gbam_records_per_s": rate(n_tx, st["tbam2gbam"]),
           "coordinate_sort_records_per_s": rate(
               n_tx + n_gen, st["sort-bam-by-coordinate"]),
           "name_sort_records_per_s": rate(n_tx, st_ns["sort-by-read-name"]),
           "setup_s": t1 - t0, "run_s": t2 - t1,
           "path_kernels_max_abs_err": holds, "path_holds_s": t2b - t2,
           "name_sorted_run_s": t3 - t2b,
           "checks_s": time.perf_counter() - t3, "gene_count_err": g_err,
           "genome_records_checked": n_cmp, "bai_lookups": n_bai}
    log(f"genome BAM: {n_pairs} pairs on {ref.M} transcripts of {n_genes} "
        f"genes ({sib.n_siblings} sibling alignments); {n_tx} transcript "
        f"and {n_gen} genome records; records/s: transcript BAM "
        f"{out['transcript_bam_records_per_s']:,.0f}, tbam2gbam "
        f"{out['tbam2gbam_records_per_s']:,.0f}, coordinate sort + BAI "
        f"{out['coordinate_sort_records_per_s']:,.0f}, name sort "
        f"{out['name_sort_records_per_s']:,.0f}; launches {launches}; "
        f"stages " + ", ".join(f"{k} {v:.2f}" for k, v in st.items())
        + f"; K1-K4 on the first run's inputs equal their plain versions "
        f"({holds}); name-sorted rerun identical; gene counts within "
        f"{g_err:.2e}; "
        f"{n_cmp} genome records match their transcript records, {n_bai} "
        f"BAI lookups")
    return launches, out


def _chip_replicates(ts, planted, n_tags: int, chrom_len: int, seed: int):
    """Two tagAlign replicates of n_tags each (tests/test_prsem.py's
    construction): 60% of the tags from fragments centred within 80 bp of
    a planted TSS (a + tag at the fragment's left end or a - tag at its
    right end), the rest from fragments anywhere on the chromosomes."""
    import numpy as np

    rng = np.random.default_rng(seed)
    chroms = sorted({t.seqname for t in ts.transcripts})
    pc = np.array([chroms.index(c) for c, _ in planted])
    pt = np.array([tss for _c, tss in planted])
    fl, rl = CHIP_FRAGLEN, CHIP_READ_LEN
    paths = []
    for r in range(2):
        n_pk = int(0.6 * n_tags)
        k = rng.integers(0, len(planted), n_pk)
        ch = np.concatenate([pc[k], rng.integers(0, len(chroms),
                                                 n_tags - n_pk)])
        centre = np.concatenate([pt[k] + rng.integers(-80, 81, n_pk),
                                 rng.integers(fl, chrom_len - fl,
                                              n_tags - n_pk)])
        minus = rng.random(n_tags) < 0.5
        start = np.where(minus, centre + fl // 2 - rl, centre - fl // 2)
        start = np.maximum(start, 0)
        path = f"chip_rep{r + 1}.tagAlign"
        with open(path, "w") as f:
            f.write("".join(
                f"{chroms[c]}\t{a}\t{a + rl}\tN\t1000\t{'-' if m else '+'}\n"
                for c, a, m in zip(ch.tolist(), start.tolist(),
                                   minus.tolist())))
        paths.append(path)
    return paths


def phase_prsem(d: str, device: str = "cuda", n_genes: int = PRSEM_GENES,
                n_single: int = PRSEM_SINGLE, n_reads: int = PRSEM_READS,
                n_chrom: int = PRSEM_CHROMS,
                chrom_len: int = PRSEM_CHROM_LEN, n_tags: int = CHIP_TAGS,
                gibbs_args=(), k3=None):
    """calculate-expression --calc-pme --run-pRSEM through the port's CLI,
    in process, on a genome reference at full width (phase 15), then the
    ChIP-seq leg on tagAlign replicates (15b); K3 held on its inputs
    through `k3` (a K3Shapes). gibbs_args: extra calculate-expression
    arguments (the driver's Gibbs defaults when empty). Returns
    (launches, K5 launches of each Gibbs run, summary)."""
    import numpy as np
    import torch

    from rsem_tpu_torch.__main__ import main as cli
    from rsem_tpu_torch.engine import simulate as sim
    from rsem_tpu_torch.model.generative import GenerativeModel
    from rsem_tpu_torch.prsem import PrsemConfig, learn_prior, read_peaks
    from rsem_tpu_torch.refprep.reference import Reference
    from rsem_tpu_torch.refprep.transcripts import Transcripts
    from rsem_tpu_torch.testing import (
        SharedExonSiblings,
        lognormal_tpm,
        provenance_sam,
        synthetic_genome,
    )

    wrappers = kernel_wrappers()
    cwd = os.getcwd()
    os.chdir(d)
    try:
        t0 = time.perf_counter()
        synthetic_genome(".", seed=15, n_chrom=n_chrom, chrom_len=chrom_len,
                         n_genes=n_genes, n_single=n_single)
        if cli(["prepare-reference", "--gtf", "anno.gtf", "genome.fa",
                "gref", "-q"]) != 0:
            fail("phase 15: prepare-reference failed")
        ref = Reference.load_seq("gref.seq")
        ts = Transcripts.read_ti("gref.ti")
        t1 = time.perf_counter()
        # TSS peaks on a seeded 40% of the genes (isoform 1's TSS), whose
        # transcripts' TPM is raised
        rng = np.random.default_rng(15)
        gene_ids = sorted({t.gene_id for t in ts.transcripts})
        pk_genes = {g for g, p in zip(gene_ids, rng.random(len(gene_ids)))
                    if p < PRSEM_PEAK_SHARE}
        planted = [(t.seqname, t.structure[0][0] if t.strand == "+"
                    else t.structure[-1][1]) for t in ts.transcripts
                   if t.gene_id in pk_genes and t.transcript_id.endswith(
                       ".0")]
        with open("peaks.bed", "w") as f:
            f.write("".join(f"{c}\t{tss - 101}\t{tss + 100}\n"
                            for c, tss in planted))
        pk_tx = np.array([t.gene_id in pk_genes for t in ts.transcripts])
        tpm = lognormal_tpm(ref.M, seed=15)
        tpm[1:][pk_tx] *= PRSEM_PEAK_TPM
        tpm[1:] *= 1e6 / tpm[1:].sum()
        model = GenerativeModel.read(os.path.join(GOLD, "golden.model"),
                                     refs=ref)
        sim.simulate_reads(model, ref, tpm, SIM_THETA0, n_reads, "sim",
                           seed=15, device=device)
        sib = SharedExonSiblings(ts)
        truth = provenance_sam(ref, "sim.fq", "aln.sam", also=sib)
        os.remove("sim.fq")
        n_mapped = float(truth[1:].sum())
        t2 = time.perf_counter()
        with driver_capture() as got:
            for fn in wrappers.values():
                fn.launches = 0
            rc = cli(["calculate-expression", "--alignments", "aln.sam",
                      "gref", "out", "-q", "--device", device, "--calc-pme",
                      "--run-pRSEM", "--chipseq-peak-file", "peaks.bed",
                      "--keep-intermediate-files", "--no-bam-output",
                      "--seed", "15", "--time"] + list(gibbs_args))
            launches = {k: fn.launches for k, fn in wrappers.items()}
        t3 = time.perf_counter()
        if rc != 0:
            fail("phase 15: calculate-expression --run-pRSEM failed")
        if len(got["run_gibbs"]) != 2:
            fail(f"phase 15: {len(got['run_gibbs'])} Gibbs runs, not 2 (the "
                 f"prior was not informative?)")
        k5_runs = [c[3]["sweep_part"] for c in got["run_gibbs"]]
        stages = _stage_seconds("out.time")

        # gates: the prior, the moved tables, the final tables
        pval, logl = (float(x) for x in open("out.stat/out_prsem.pval_LL")
                      .read().splitlines()[1].split("\t"))
        if not pval < 0.01:
            fail(f"phase 15: pRSEM p-value {pval} is not below 0.01")
        prior = [float(line.split()[0]) for line in
                 open("out.temp/out_prsem.all_tr_prior")]
        fh, frows = _rows("out.temp/out_prsem.all_tr_features")
        part = _col(fh, frows, "partition").astype(int)
        n_train = int(_col(fh, frows, "is_training").sum())
        if len(prior) != ref.M or len(frows) != ref.M:
            fail(f"phase 15: {len(prior)} prior lines for {ref.M} isoforms")
        alpha = {int(p): a for p, a in zip(part, prior)}
        if sorted(alpha) != [0, 1] or not alpha[1] > alpha[0]:
            fail(f"phase 15: partition alphas {alpha}: the peak partition "
                 f"(1) must have the larger one")
        for kind in ("isoforms", "genes"):
            if not os.path.exists(
                    f"out.stat/out_uniform_prior_1.{kind}.results"):
                fail(f"phase 15: the uniform-prior {kind} table was not "
                     f"moved to out.stat/")
        ih, irows = _rows("out.isoforms.results")
        pme_sum = float(_col(ih, irows, "posterior_mean_count").sum())
        if abs(pme_sum - n_mapped) > 0.02 * n_mapped:
            fail(f"phase 15: posterior_mean_count sums to {pme_sum}, the "
                 f"aligned reads {n_mapped}")
        gh, grows = _rows("out.genes.results")
        true_g = {}
        for sid, t in enumerate(ts.transcripts, 1):
            true_g[t.gene_id] = true_g.get(t.gene_id, 0.0) + truth[sid]
        g_err = max(abs(float(r[gh.index("expected_count")]) - true_g[r[0]])
                    for r in grows)
        if g_err > 1e-2:
            fail(f"phase 15: gene expected counts off the truth by {g_err}")
        pme_prior = np.array([float(r[ih.index("posterior_mean_count")])
                              for r in irows])
        uh, urows = _rows("out.stat/out_uniform_prior_1.isoforms.results")
        pme_uniform = _col(uh, urows, "posterior_mean_count")

        # the kernels on this run's own inputs, both Gibbs runs
        t4 = time.perf_counter()
        dev = torch.device(device)
        holds = {"em": hold_path_em("phase 15", got["run_em"][0], dev, k3)}
        for i, call in enumerate(got["run_gibbs"]):
            which = ("uniform prior", "pRSEM prior")[i]
            holds[f"gibbs, {which}"] = hold_path_gibbs(
                f"phase 15, Gibbs with the {which}", call, dev)
        pme_c0 = got["run_gibbs"][0][2].pme_c[1:]
        del got
        t5 = time.perf_counter()

        # 15b: the ChIP-seq leg on tagAlign replicates, peaks called natively
        reps = _chip_replicates(ts, planted, n_tags, chrom_len, seed=16)
        t6 = time.perf_counter()
        os.makedirs("chip", exist_ok=True)
        chip_log = []
        pres = learn_prior(
            ts, pme_c0, PrsemConfig(partition_model="pk",
                                    chipseq_target_read_files=reps,
                                    temp_dir="chip"),
            imd_name="chip/out", ref=ref, log=chip_log.append)
        t7 = time.perf_counter()
        called = read_peaks("chip/idr_target_vs_control.regionPeak.gz")
        hit = 0
        for c, tss in planted:
            pk = called.get(c)
            if pk is None:
                continue
            k = int(np.searchsorted(pk[:, 1], tss - 80, side="left"))
            hit += int(k < len(pk) and pk[k, 0] <= tss + 80)
        called_bp = int(sum((v[:, 1] - v[:, 0] + 1).sum()
                            for v in called.values()))
        planted_bp = len(planted) * (160 + 2 * CHIP_FRAGLEN)
        if hit < 0.95 * len(planted):
            fail(f"phase 15b: called peaks overlap {hit} of {len(planted)} "
                 f"planted TSS peaks")
        if not called_bp < 4 * planted_bp:
            fail(f"phase 15b: called peaks cover {called_bp} bp, 4 x the "
                 f"planted {planted_bp} bp or more")
        if not pres.informative:
            fail(f"phase 15b: the prior from called peaks is not "
                 f"informative (p-value {pres.pvalue})")
    finally:
        os.chdir(cwd)
    out = {"genes": len(gene_ids), "one_isoform_genes": n_single,
           "transcripts": ref.M, "peak_genes": len(pk_genes),
           "reads": n_reads, "aligned_reads": n_mapped,
           "sibling_alignments": sib.n_siblings, "training_set": n_train,
           "pvalue": pval, "loglikelihood": logl,
           "alpha": [alpha[0], alpha[1]], "stages_s": stages,
           "k5_launches_per_gibbs_run": k5_runs,
           "pme_sum": pme_sum, "gene_count_err": g_err,
           "pme_change_max": float(np.abs(pme_prior - pme_uniform).max()),
           "reference_s": t1 - t0, "reads_s": t2 - t1,
           "calculate_expression_s": t3 - t2, "checks_s": t4 - t3,
           "path_kernels_max_abs_err": holds, "path_holds_s": t5 - t4,
           "chip": {"tags_per_replicate": n_tags,
                    "log": chip_log,
                    "planted_peaks": len(planted), "planted_hit": hit,
                    "called_bp": called_bp, "planted_bp": planted_bp,
                    "pvalue": pres.pvalue, "alpha": pres.alpha.tolist(),
                    "write_s": t6 - t5, "learn_prior_s": t7 - t6},
           "phase_s": time.perf_counter() - t0,
           "card": _card() if device != "cpu" else "cpu"}
    log(f"prsem: {ref.M} transcripts of {len(gene_ids)} genes ({n_single} "
        f"of one isoform), {len(pk_genes)} with a TSS peak; {n_reads} reads "
        f"({sib.n_siblings} sibling alignments); training set {n_train}, "
        f"p-value {pval:.4g}, alphas {alpha[0]:.4g} / {alpha[1]:.4g}; "
        f"calculate-expression {t3 - t2:.2f} s, stages "
        + ", ".join(f"{k} {v:.2f}" for k, v in stages.items())
        + f"; K5 launches per Gibbs run {k5_runs}, all {launches}; K1-K5 on "
        f"this run's inputs equal their plain versions, both Gibbs runs "
        f"({t5 - t4:.2f} s); 15b: {n_tags} tags per replicate, "
        f"{hit}/{len(planted)} planted peaks called, {called_bp} bp called "
        f"against {planted_bp} planted, p-value {pres.pvalue:.4g} "
        f"({t7 - t6:.2f} s); phase {out['phase_s']:.1f} s; "
        f"card {out['card']}")
    return launches, k5_runs, out


# ------------------------------------------------------------------ #
# phase 16: the process group on the one card                        #
# ------------------------------------------------------------------ #
GROUP_TIMEOUT_S = 600  # a rank's time limit in 16b (and its collectives')
SPLIT_K1 = ("theta_partial", "theta_finish")


def _free_port() -> int:
    """A free port below Linux's ephemeral range (32768 up): a rank's store
    client retries its connect until rank 0 listens, and on an ephemeral
    port one of those connects can draw the port itself as its source and
    connect to itself."""
    import random
    import socket

    rng = random.Random(os.getpid() ^ time.time_ns())
    for _ in range(100):
        port = rng.randrange(20000, 32000)
        with socket.socket() as s:
            try:
                s.bind(("127.0.0.1", port))
            except OSError:
                continue
            return port
    fail("no free port in 20000..32000")


def group_wrappers():
    """kernel_wrappers() and K1's two halves, which the read-sharded theta
    rounds launch in place of theta_round."""
    from rsem_tpu_torch.ops import theta

    w = kernel_wrappers()
    w.update(theta_partial=theta.theta_partial,
             theta_finish=theta.theta_finish)
    return w


def _path_launches(label, wrappers, launches):
    """Every kernel of the sharded path launched: K2-K5 and K1's halves
    (theta_round, K1 whole, is the one-process entry)."""
    for k, n in launches.items():
        if n <= 0 and k != "theta_round":
            fail(f"{label}: kernel {k} was not launched")


def _bounds_equal(a, b, what):
    import numpy as np

    for lvl in ("tpm", "fpkm", "gene_tpm", "gene_fpkm"):
        for f in ("lb", "ub", "cqv"):
            x, y = getattr(getattr(a, lvl), f), getattr(getattr(b, lvl), f)
            if not np.array_equal(x, y):
                fail(f"{what}: CI {lvl}.{f} differs in "
                     f"{int((x != y).sum())} entries")


def hold_split_k1(data, th, dist, label):
    """K1's partial and finish against their plain versions on `data`
    (this rank's reads), the partial sums summed over `dist` on both
    sides: the partial sums, theta and counts within rtol 1e-5, the stop
    count within 2 (phase 3's tolerances). Returns the max abs error."""
    from rsem_tpu_torch.ops import theta
    from rsem_tpu_torch.parallel.distributed import all_reduce_

    state = theta.round_state(data, 1, th.device)
    state.ring[0] = th
    theta.theta_partial(state, data, 0)
    red_p = theta.theta_partial_plain(th, data)
    err = close(state.reduced, red_p, 1e-5, 1e-9, f"{label}: K1 partial")
    all_reduce_(state.reduced, dist)
    all_reduce_(red_p, dist)
    theta.theta_finish(state, data, 0)
    t_p, c_p, n_p = theta.theta_finish_plain(th, red_p, data.n0)
    err = max(err, close(state.ring[1], t_p, 1e-5, 1e-9,
                         f"{label}: K1 finish theta"),
              close(state.counts, c_p, 1e-5, 1e-6,
                    f"{label}: K1 finish counts"))
    if abs(int(state.tot[0]) - int(n_p)) > 2:
        fail(f"{label}: K1 finish stop count {int(state.tot[0])}, plain "
             f"{int(n_p)}")
    return err


def phase_group(ref, bundle, model0, dev, mem_rate, op_rate, d):
    """16a: world size 1 through NCCL, in process, on the full-width
    workload at the driver defaults: run_em, run_gibbs and run_ci with the
    group (launches counted), against the same calls without it; the fused
    loop and a theta-loop segment with the group under sync debug 'error';
    K1's halves held and timed; the theta loop's ms per round with and
    without the group, in turns. Saves what 16b compares with into `d`.
    Returns (launches, summary, the K1 split's figures)."""
    import numpy as np
    import torch

    from rsem_tpu_torch.convert import model_arrays_to_torch
    from rsem_tpu_torch.engine import em as em_mod
    from rsem_tpu_torch.engine.ci import CIConfig, run_ci
    from rsem_tpu_torch.engine.em import EMConfig, run_em
    from rsem_tpu_torch.engine.gibbs import GibbsConfig, run_gibbs
    from rsem_tpu_torch.ops import conprb, model_loop, theta
    from rsem_tpu_torch.parallel import distributed, fast_sharded

    t_start = time.perf_counter()
    d1 = distributed.init_group("cuda", f"tcp://127.0.0.1:{_free_port()}",
                                1, 0)
    if d1.backend != "nccl":
        fail(f"16a: the group's backend is {d1.backend}, not nccl")
    M, cnt, hits = ref.M, bundle.cnt, bundle.hits
    gi = gene_groups(M)
    gcfg = GibbsConfig(seed=1)  # burn-in 200, 1000 samples, 8 chains
    cicfg = CIConfig(seed=2)
    wrappers = group_wrappers()

    # the path with the group, launches counted
    secs = {}
    for fn in wrappers.values():
        fn.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    em_g = run_em(copy.deepcopy(model0), ref, bundle, EMConfig(),
                  need_posteriors=True, device=dev, dist=d1)
    t1 = time.perf_counter()
    g_g = run_gibbs(hits, em_g.log_conprb, em_g.log_ncp, M, cnt.N0,
                    em_g.eel, em_g.model.mw, gi, gcfg, omit=bundle.omit,
                    device=dev, dist=d1)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    run_ci(g_g.countvectors, em_g.eel, em_g.model.mw, gi, cicfg, device=dev,
           dist=d1)
    torch.cuda.synchronize()
    secs["group"] = {"em": t1 - t0, "gibbs": t2 - t1,
                     "ci": time.perf_counter() - t2}
    launches = {k: fn.launches for k, fn in wrappers.items()}
    _path_launches("16a, world 1 through NCCL", wrappers, launches)
    if launches["theta_partial"] != launches["theta_finish"]:
        fail(f"16a: K1 partial launched {launches['theta_partial']} times, "
             f"finish {launches['theta_finish']}")

    # the same calls without the group
    t0 = time.perf_counter()
    em_1 = run_em(copy.deepcopy(model0), ref, bundle, EMConfig(),
                  need_posteriors=True, device=dev)
    secs["one_process_em"] = time.perf_counter() - t0
    err_em = close(torch.as_tensor(em_g.counts),
                   torch.as_tensor(em_1.counts), 1e-5, 1e-6,
                   "16a: counts with the group against without")
    if abs(em_g.rounds - em_1.rounds) > 2:
        fail(f"16a: {em_g.rounds} rounds with the group, {em_1.rounds} "
             f"without")
    lcp, lnp, eel, mw = em_1.log_conprb, em_1.log_ncp, em_1.eel, \
        em_1.model.mw
    g_1, g_d = (run_gibbs(hits, lcp, lnp, M, cnt.N0, eel, mw, gi, gcfg,
                          omit=bundle.omit, device=dev, dist=x)
                for x in (None, d1))
    if not torch.equal(g_1.countvectors, g_d.countvectors):
        fail("16a: Gibbs count vectors differ with the group, on the same "
             "frozen conprbs")
    c_1, c_d = (run_ci(g_1.countvectors, eel, mw, gi, cicfg, device=dev,
                       dist=x) for x in (None, d1))
    _bounds_equal(c_d, c_1, "16a: with the group, the same count vectors")

    # sync-free with the group: the fused loop and a theta-loop segment
    refd, m1, m2, hd = em_mod.upload(ref, bundle, False, dev)
    kcfg = em_mod.kernel_config(model0, bundle, int(m1.codes.shape[1]))
    pre = conprb.precompute_profile_indices_fused(kcfg, refd, m1, m2, hd)
    dm = model_arrays_to_torch(model0.device_arrays(), dev)
    mdata = model_loop.build_model_loop_data(
        kcfg, refd, m1, m2, hd, pre, dm, model0.npro.c, cnt.N0,
        float(model0.spec.probF))
    tables = model_loop.tables_from_model(kcfg, dm)
    th0 = torch.as_tensor(em_mod._theta_init(cnt, M),
                          dtype=torch.float32).to(dev)
    data = theta.scale_conprbs(hd, torch.as_tensor(lcp).to(dev),
                               torch.as_tensor(lnp).to(dev), M,
                               float(cnt.N0))
    state = theta.round_state(data, theta.SEGMENT, dev)
    state.ring[0] = th0

    def fused():
        return model_loop.run_model_loop(kcfg, mdata, tables, th0, 10,
                                         hd.n_reads, M, dist=d1)

    fused()  # warm: the loop's first collectives
    torch.cuda.synchronize()
    mode = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        th_f, _suff = fused()
        fast_sharded.sharded_rounds(state, data, theta.SEGMENT, d1)
    except RuntimeError as exc:
        fail(f"16a: the fused loop or the sharded theta rounds synchronised "
             f"with the host: {exc}")
    finally:
        torch.cuda.set_sync_debug_mode(mode)
    torch.cuda.synchronize()
    if abs(float(th_f.double().sum()) - 1.0) > 1e-4:
        fail("16a: the fused loop's theta is not a distribution")
    del mdata, pre, tables

    # K1's halves at full width: held, timed, bound
    th = torch.as_tensor(np.random.default_rng(1).dirichlet(np.ones(M + 1)),
                         dtype=torch.float32).to(dev)
    err_k1 = hold_split_k1(data, th, d1, "16a")
    st1 = theta.round_state(data, 1, dev)
    st1.ring[0] = th
    part_ms = time_cuda(lambda: theta.theta_partial(st1, data, 0))
    fin_ms = time_cuda(lambda: theta.theta_finish(st1, data, 0))
    H, N, M1 = hd.n_hits, hd.n_reads, M + 1
    # partial: sid, rid, cps per hit, ncs and offsets per read, theta read,
    # contrib and the noise sum written; finish: contrib, theta read,
    # counts and theta_new written
    pb_ms, pb_by = bound(H * 12 + N * 12 + M1 * 12, 4 * H + 3 * N, mem_rate,
                         op_rate)
    fb_ms, fb_by = bound(M1 * (8 + 4 + 8 + 4), 6 * M1, mem_rate, op_rate)

    # the theta loop with and without the group, in turns (ABBA twice)
    rounds = 500
    walls = {"one_process": [], "group": []}
    for which in ("one_process", "group", "group", "one_process") * 2:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if which == "group":
            _t, r = fast_sharded.run_theta_loop_sharded(
                th0, data, d1, min_round=rounds, max_round=rounds)
        else:
            _t, r = theta.run_theta_loop(th0, data, min_round=rounds,
                                         max_round=rounds)
        torch.cuda.synchronize()
        walls[which].append((time.perf_counter() - t0) * 1e3 / rounds)
        if r != rounds:
            fail(f"16a: theta loop ran {r} rounds, not {rounds}")
    per_round = {k: statistics.median(v) for k, v in walls.items()}
    # device time of K1's halves inside the sharded loop (the per-call
    # times above include the host's enqueue, which the card waits for)
    prof_rounds = 100
    by_name, idle = phase_profile(
        f"16a sharded theta loop, {prof_rounds} rounds",
        lambda: fast_sharded.run_theta_loop_sharded(
            th0, data, d1, min_round=prof_rounds, max_round=prof_rounds))

    def device_us(*kernels):  # per launch: the profiler may drop events
        return sum(t / c for n, (c, t) in by_name.items()
                   if any(k in n for k in kernels))

    part_dev, fin_dev = (device_us("reads_kernel"),
                         device_us("counts_kernel", "total_kernel",
                                   "mstep_kernel"))

    # what 16b compares with
    np.savez(os.path.join(d, "world1.npz"), lcp=lcp, lnp=lnp, eel=eel,
             mw=mw, counts=em_1.counts, rounds=em_1.rounds,
             cvs=g_1.countvectors.cpu().numpy(),
             **{f"{lvl}.{f}": getattr(getattr(c_1, lvl), f)
                for lvl in ("tpm", "fpkm", "gene_tpm", "gene_fpkm")
                for f in ("lb", "ub", "cqv")})
    del em_g, g_g, g_1, g_d, c_1, c_d, data, state, st1
    torch.cuda.empty_cache()
    out = {"backend": d1.backend, "world": d1.world, "stage_s": secs,
           "rounds": em_1.rounds, "counts_max_abs_err": err_em,
           "gibbs_countvectors": "identical", "ci_bounds": "identical",
           "theta_loop_ms_per_round": per_round,
           "theta_loop_walls_ms_per_round": walls,
           "bytes_reduced_per_round": (M + 2) * 8,
           "phase_s": time.perf_counter() - t_start}
    split = {"split_partial_ms": part_ms[0], "split_finish_ms": fin_ms[0],
             "split_partial_device_ms": part_dev / 1e3,
             "split_finish_device_ms": fin_dev / 1e3,
             "sharded_loop_idle_share": idle,
             "split_partial_bound_ms": pb_ms, "split_partial_bound_by": pb_by,
             "split_finish_bound_ms": fb_ms, "split_finish_bound_by": fb_by,
             "split_max_abs_err": err_k1}
    log(f"16a: world 1 through NCCL: launches {launches}; stages with the "
        f"group {secs['group']}, run_em without {secs['one_process_em']:.3f}"
        f" s; counts within {err_em:.3g} of the run without the group, "
        f"{em_1.rounds} rounds; Gibbs count vectors and CI bounds identical "
        f"on shared inputs; the fused loop and {theta.SEGMENT} sharded theta "
        f"rounds ran with no host sync; K1 partial {part_ms[0]:.4f} ms a "
        f"call, {part_dev / 1e3:.4f} ms on the device (bound {pb_ms:.4f}, "
        f"{pb_by}), finish {fin_ms[0]:.4f} ms a call, {fin_dev / 1e3:.4f} "
        f"on the device (bound {fb_ms:.4f}); sharded loop idle share "
        f"{idle:.3f}; theta loop {per_round['one_process']:.4f} ms per "
        f"round without the group, {per_round['group']:.4f} with it "
        f"(ABBA x 2, {rounds} rounds), {(M + 2) * 8} bytes summed per round;"
        f" card {_card()}")
    return launches, out, split


def phase_group_driver(d, device: str = "cuda"):
    """16a, the driver: calculate-expression --calc-pme --calc-ci on phase
    15's reference and reads (in `d`) as a subprocess with the RSEM_TPU_*
    variables of one process (an NCCL group of 1), against the same run in
    this process without them: .cnt identical, expected counts and TPM
    within rtol 1e-5, posterior means within max(2 sd, 1.5), CI bounds at
    tests/test_torch_ci.py's golden tolerances."""
    import numpy as np

    from rsem_tpu_torch.__main__ import main as cli

    def args(out):
        return ["calculate-expression", "--alignments", "aln.sam", "gref",
                out, "-q", "--calc-pme", "--calc-ci", "--no-bam-output",
                "--seed", "16", "--time", "--device", device]

    env = dict(os.environ, PYTHONPATH=ROOT, RSEM_TPU_NUM_PROCESSES="1",
               RSEM_TPU_PROCESS_ID="0",
               RSEM_TPU_COORDINATOR=f"127.0.0.1:{_free_port()}")
    t0 = time.perf_counter()
    res = subprocess.run([sys.executable, "-m", "rsem_tpu_torch",
                          *args("grp")], cwd=d, env=env, text=True,
                         capture_output=True, timeout=GROUP_TIMEOUT_S)
    t1 = time.perf_counter()
    if res.returncode != 0:
        fail(f"16a: calculate-expression with the variables set failed:\n"
             f"{res.stdout[-2000:]}\n{res.stderr[-4000:]}")
    cwd = os.getcwd()
    os.chdir(d)
    try:
        if cli(args("one")) != 0:
            fail("16a: calculate-expression in process failed")
    finally:
        os.chdir(cwd)
    t2 = time.perf_counter()
    p = lambda name: os.path.join(d, name)  # noqa: E731
    cnt = [open(p(f"{x}.stat/{x}.cnt")).read() for x in ("grp", "one")]
    if cnt[0] != cnt[1]:
        fail("16a: the driver's .cnt differs with the group")
    worst = {}
    for kind in ("isoforms", "genes"):
        h, got = _rows(p(f"grp.{kind}.results"))
        h1, want = _rows(p(f"one.{kind}.results"))
        if h != h1 or len(got) != len(want):
            fail(f"16a: {kind} tables differ in shape")
        for c in ("expected_count", "TPM"):
            g, w = _col(h, got, c), _col(h, want, c)
            bad = np.abs(g - w) > 1e-8 + 1e-5 * np.abs(w)
            if bad.any():
                fail(f"16a: {kind} {c} off in {int(bad.sum())} rows")
        sd = np.maximum(_col(h, got, "posterior_standard_deviation_of_count"),
                        _col(h, want, "posterior_standard_deviation_of_count"))
        dp = np.abs(_col(h, got, "posterior_mean_count")
                    - _col(h, want, "posterior_mean_count"))
        if (dp > np.maximum(2 * sd, 1.5)).any():
            fail(f"16a: {kind} posterior means off in "
                 f"{int((dp > np.maximum(2 * sd, 1.5)).sum())} rows")
        lb, ub = (_col(h, want, c) for c in ("TPM_ci_lower_bound",
                                             "TPM_ci_upper_bound"))
        width = np.maximum(ub - lb, 1.0)
        for c, ref_c in (("TPM_ci_lower_bound", lb),
                         ("TPM_ci_upper_bound", ub)):
            if (np.abs(_col(h, got, c) - ref_c) >= 0.12 * width + 0.5).any():
                fail(f"16a: {kind} {c} off the golden tolerance")
        cq, cq1 = (_col(h, x, "TPM_coefficient_of_quartile_variation")
                   for x in (got, want))
        if (np.abs(cq - cq1) > np.maximum(0.03, 0.12 * np.abs(cq1))).any():
            fail(f"16a: {kind} CQV off the golden tolerance")
        worst[kind] = float((dp / np.maximum(2 * sd, 1.5)).max())
    stages = {x: _time_stages(p(f"{x}.time")) for x in ("grp", "one")}
    for x, wall in (("grp", t1 - t0), ("one", t2 - t1)):
        # interpreter start, imports and kernel loads: before the driver's
        # first stage
        stages[x]["outside the stages"] = wall - sum(stages[x].values())
    out = {"with_variables_s": t1 - t0, "in_process_s": t2 - t1,
           "stages_with_variables_s": stages["grp"],
           "stages_in_process_s": stages["one"],
           "pme_worst_share_of_tolerance": worst}
    split = "; ".join(f"{k} {stages['grp'][k]:.2f} / "
                      f"{stages['one'].get(k, 0.0):.2f}"
                      for k in stages["grp"])
    log(f"16a: calculate-expression --calc-pme --calc-ci on phase 15's "
        f"1M reads: with the variables (NCCL group of 1, subprocess) "
        f"{t1 - t0:.2f} s, in process without {t2 - t1:.2f} s; .cnt "
        f"identical, counts and TPM within rtol 1e-5, PME and CI within "
        f"tolerance (worst PME at {worst} of it); seconds by --time stage, "
        f"with / without: {split}")
    return out


def _time_stages(path):
    """{stage: seconds} of a driver's .time file (its comment lines; a
    stage run twice is summed)."""
    secs = {}
    for line in open(path).read().splitlines()[3:]:
        name, dt = line[2:].split(": ")
        secs[name] = secs.get(name, 0.0) + float(dt.split()[0])
    return secs


def phase_group_world2(d):
    """16b: world size 2 on the one card over gloo: two subprocesses
    (rank16_main), each with its own gloo group on cuda:0, run run_em,
    run_gibbs and run_ci on the full-width workload; rank 0 holds them
    against 16a's results (world1.npz in `d`), both hold K1's halves and
    K5 (chain0 = 0 and 4) against their plain versions. Two ranks share
    one card, so their times are those of a correctness run, not of
    scaling; each rank's default PreIdx budget reads the card's free
    memory as its own (at full width a rank's PreIdx is ~0.64 GB, far
    below it)."""
    import json as _json

    port = _free_port()
    t0 = time.perf_counter()
    procs = []
    for r in range(2):
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--rank16", d,
             f"127.0.0.1:{port}", str(r)],
            env=dict(os.environ, PYTHONPATH=ROOT), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=GROUP_TIMEOUT_S)[0])
    finally:
        for p in procs:
            p.kill()
            p.wait()
    for r, p in enumerate(procs):
        if p.returncode != 0:
            fail(f"16b: rank {r} failed:\n{logs[r][-6000:]}")
    ranks = [_json.load(open(os.path.join(d, f"rank{r}.json")))
             for r in range(2)]
    out = {"ranks": ranks, "phase_s": time.perf_counter() - t0}
    log(f"16b: world 2 on one card over gloo: rank 0 equals 16a's world 1 "
        f"(counts within {ranks[0]['counts_max_abs_err']:.3g}, "
        f"{ranks[0]['rounds']} rounds; Gibbs count vectors and CI bounds "
        f"identical); K1 halves and K5 at chain0 "
        f"{[x['chain0'] for x in ranks]} equal their plain versions; "
        f"launches {[x['launches'] for x in ranks]}; correctness-run stage "
        f"seconds (two ranks share one card) "
        f"{[x['stage_s'] for x in ranks]}; phase {out['phase_s']:.1f} s")
    return out


def rank16_main(d: str, coord: str, rank: int) -> int:
    """One rank of 16b, started by phase_group_world2: a gloo group of 2
    on cuda:0 with its rendezvous at `coord` (host:port)."""
    import json as _json

    import numpy as np
    import torch

    from rsem_tpu_torch.engine import em as em_mod
    from rsem_tpu_torch.engine.ci import CIConfig, run_ci
    from rsem_tpu_torch.engine.em import EMConfig, run_em
    from rsem_tpu_torch.engine.gibbs import GibbsConfig, run_gibbs
    from rsem_tpu_torch.ops import gibbs, theta
    from rsem_tpu_torch.parallel import distributed, mesh

    dist = distributed.init_group("cuda:0", f"tcp://{coord}", 2, rank,
                                  backend="gloo", timeout_s=GROUP_TIMEOUT_S)
    if dist.world != 2 or dist.backend != "gloo":
        fail(f"16b: no gloo group of 2 ({dist})")
    dev = dist.device
    ref, bundle, model = make_workload()
    w1 = np.load(os.path.join(d, "world1.npz"))
    M, cnt, hits = ref.M, bundle.cnt, bundle.hits
    gi = gene_groups(M)
    wrappers = group_wrappers()
    for fn in wrappers.values():
        fn.launches = 0
    secs = {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    em = run_em(copy.deepcopy(model), ref, bundle, EMConfig(),
                need_posteriors=False, device=dev, dist=dist)
    t1 = time.perf_counter()
    g = run_gibbs(hits, w1["lcp"], w1["lnp"], M, cnt.N0, w1["eel"],
                  w1["mw"], gi, GibbsConfig(seed=1), omit=bundle.omit,
                  device=dev, dist=dist)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    ci = run_ci(w1["cvs"], w1["eel"], w1["mw"], gi, CIConfig(seed=2),
                device=dev, dist=dist)
    torch.cuda.synchronize()
    secs = {"em": t1 - t0, "gibbs": t2 - t1, "ci": time.perf_counter() - t2}
    launches = {k: fn.launches for k, fn in wrappers.items()}
    _path_launches(f"16b rank {dist.rank}", wrappers, launches)
    err = close(torch.as_tensor(em.counts), torch.as_tensor(w1["counts"]),
                1e-5, 1e-6, f"16b rank {dist.rank}: counts against world 1")
    if abs(em.rounds - int(w1["rounds"])) > 2:
        fail(f"16b: {em.rounds} rounds, world 1 {int(w1['rounds'])}")
    if not np.array_equal(g.countvectors.cpu().numpy(), w1["cvs"]):
        fail(f"16b rank {dist.rank}: Gibbs count vectors differ from world "
             f"1's on the same frozen conprbs")
    for lvl in ("tpm", "fpkm", "gene_tpm", "gene_fpkm"):
        for f in ("lb", "ub", "cqv"):
            if not np.array_equal(getattr(getattr(ci, lvl), f),
                                  w1[f"{lvl}.{f}"]):
                fail(f"16b rank {dist.rank}: CI {lvl}.{f} differs from "
                     f"world 1's on the same count vectors")

    # K1's halves on this rank's reads, K5 on this rank's chains
    shard = mesh.shard_bundle_by_read(bundle, dist.world, dist.rank)
    _refd, _m1, _m2, hd = em_mod.upload(ref, shard.bundle, False, dev)
    h0, h1 = shard.hit_bounds[dist.rank], shard.hit_bounds[dist.rank + 1]
    r0, r1 = shard.bounds[dist.rank], shard.bounds[dist.rank + 1]
    data = theta.scale_conprbs(hd, torch.as_tensor(w1["lcp"][h0:h1]).to(dev),
                               torch.as_tensor(w1["lnp"][r0:r1]).to(dev), M,
                               float(cnt.N0))
    th = torch.as_tensor(np.random.default_rng(1).dirichlet(np.ones(M + 1)),
                         dtype=torch.float32).to(dev)
    err_k1 = hold_split_k1(data, th, dist, f"16b rank {dist.rank}")
    layout = gibbs.build_layout(hits, w1["lcp"], w1["lnp"], M, device=dev)
    base = torch.ones(M + 1)
    base[0] += cnt.N0 + layout.n_noise_fixed
    chain0 = 4 * dist.rank
    assigns, tab = gibbs.init_chains(layout, base, 8, seed=1, device=dev,
                                     chains=slice(chain0, chain0 + 4))
    k5_replay(layout, assigns, tab, 1, f"16b rank {dist.rank}, chains "
              f"{chain0}-{chain0 + 3}", chain0=chain0)
    with open(os.path.join(d, f"rank{dist.rank}.json"), "w") as f:
        _json.dump({"rank": dist.rank, "device": str(dev),
                    "launches": launches, "stage_s": secs,
                    "rounds": em.rounds, "counts_max_abs_err": err,
                    "k1_split_max_abs_err": err_k1, "chain0": chain0}, f)
    torch.distributed.destroy_process_group()
    return 0

# phase 17c: a real sample's size with frozen conprbs (40M reads, 1-5
# hits each, the annotation scale of tests/test_scale.py:26), streamed in
# chunks of at most STREAM_CHUNK_BYTES; rounds of 17b and 17c
STREAM_READS, STREAM_M = 40_000_000, 200_000
STREAM_CHUNK_BYTES = 256 * 2**20
STREAM_ROUNDS = 25


def h2d_of(prof) -> tuple:
    """(host-to-device copies, their device ms, their bytes or None) in a
    profiler's events; the bytes from its chrome trace's memcpy events."""
    import torch

    ev = [e for e in prof.events()
          if e.device_type == torch.autograd.DeviceType.CUDA
          and "HtoD" in e.name]
    ms = sum(e.device_time for e in ev) / 1e3
    got = trace_copies(prof, "HtoD")[1]
    return len(ev), ms, (int(sum(got)) if got else None)


def phase_cache(ref, bundle, model0, dev):
    """17a: run_em on the full-width workload with the layout's device
    cache and with the cache cleared before each pass, in turns. Returns
    (launches of the first pass, a summary)."""
    import numpy as np
    import torch

    from rsem_tpu_torch.engine import em
    from rsem_tpu_torch.engine.em import EMConfig, run_em
    from rsem_tpu_torch.ops.layout import (clear_device_cache,
                                           device_cache_bytes)

    def run():
        return run_em(copy.deepcopy(model0), ref, bundle, EMConfig(),
                      need_posteriors=False, device=dev)

    def cleared():
        clear_device_cache()
        return run()

    wrappers = kernel_wrappers()
    del wrappers["sweep_part"]
    clear_device_cache()
    for fn in wrappers.values():
        fn.launches = 0
    first = run()
    launches = {k: fn.launches for k, fn in wrappers.items()}
    for k, n in launches.items():
        if n <= 0:
            fail(f"17a: kernel {k} was not launched by run_em")
    cached = device_cache_bytes()
    want = layout_bytes(ref, bundle)
    if cached != want:
        fail(f"17a: the cache holds {cached} bytes, the layout is {want}")
    walls = {"cached": [], "cleared": []}
    errs = {}
    for i in range(WARM_PASSES):
        for mode in (("cached", "cleared") if i % 2 == 0
                     else ("cleared", "cached")):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            r = run() if mode == "cached" else cleared()
            walls[mode].append(time.perf_counter() - t0)
            errs[mode] = max(errs.get(mode, 0.0), agree(
                r.counts, first.counts, 1e-5, 1e-6, f"17a counts ({mode})"))
            if r.rounds != first.rounds:
                fail(f"17a: a pass ({mode}) took {r.rounds} rounds, the "
                     f"first {first.rounds}")
    out = {"cached_bytes": cached, "first_pass_launches": launches,
           "max_abs_err_counts": errs, "rounds": first.rounds}
    for mode, w in walls.items():
        out[f"{mode}_warm_s"] = w
        log(f"17a run_em, cache {mode}: warm median "
            f"{statistics.median(w):.4f} s min {min(w):.4f} max "
            f"{max(w):.4f} over {len(w)} passes (in turns); counts max abs "
            f"err {errs[mode]:.3g} (rtol 1e-5)")
    # the upload alone, host clock around a synchronised call
    up = []
    for _ in range(3):
        clear_device_cache()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        em.upload(ref, bundle, False, dev)
        torch.cuda.synchronize()
        up.append((time.perf_counter() - t0) * 1e3)
    out["upload_ms"] = up
    log(f"17a: the layout's upload alone {statistics.median(up):.2f} ms "
        f"(median of 3; {', '.join(f'{u:.2f}' for u in up)}) for "
        f"{device_cache_bytes()} bytes")
    # one profiled pass each way, after a warm-up pass in the same session
    # (without it, run at the script's end, the profiler lost the first
    # device events of the window)
    for mode, fn in (("cached", run), ("cleared", cleared)):
        prof_wall = profiled(fn, warmup=True)
        _by, idle = phase_profile(f"run_em, cache {mode}", fn, prof_wall)
        n, ms, nbytes = h2d_of(prof_wall[0])
        out[f"{mode}_profile"] = {"wall_ms": prof_wall[1] * 1e3,
                                  "idle_share": idle, "h2d_copies": n,
                                  "h2d_ms": ms, "h2d_bytes": nbytes}
        log(f"17a profile, cache {mode}: {n} host-to-device copies, "
            f"{ms:.3f} ms on the device, {nbytes} bytes; idle share "
            f"{idle:.3f}")
        if mode == "cleared" and (nbytes or 0) < cached:
            log(f"17a warning: the profiler saw {nbytes} bytes copied to "
                f"the device, under the layout's {cached}")
    log(f"17a: the cache held {cached} bytes ({cached / 2**20:.1f} MiB, "
        f"the layout's); first pass launches {launches}")
    if not np.all(np.isfinite(first.counts)):
        fail("17a: counts are not finite")
    clear_device_cache()
    return launches, out


def _stream_walls(runs, samples: int = 3):
    """Host-clock seconds of each named run (synchronised), in turns."""
    import torch

    walls = {k: [] for k in runs}
    names = list(runs)
    for i in range(samples):
        for k in (names if i % 2 == 0 else names[::-1]):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            runs[k]()
            torch.cuda.synchronize()
            walls[k].append(time.perf_counter() - t0)
    return walls


def _launches_of(fn) -> int:
    """Launches of theta_partial during fn() (the count zeroed before)."""
    from rsem_tpu_torch.ops import theta

    theta.theta_partial.launches = 0
    fn()
    return theta.theta_partial.launches


def phase_streamed(bundle, k1_in, M: int, dev):
    """17b: the streamed theta loop at full width on phase 3's frozen
    conprbs, 8 chunks, against the resident loop. Returns a summary."""
    import numpy as np
    import torch

    from rsem_tpu_torch.ops import theta
    from rsem_tpu_torch.ops.layout import HitsDevice, clear_device_cache
    from rsem_tpu_torch.parallel.fast_sharded import build_theta_chunks

    lcp, lnp = k1_in
    data = theta.scale_conprbs(HitsDevice.from_arrays(bundle.hits, dev),
                               torch.as_tensor(lcp).to(dev),
                               torch.as_tensor(lnp).to(dev), M, 0.0)
    t0 = time.perf_counter()
    chunks, _b, _hb = build_theta_chunks(bundle.hits, lcp, lnp, M, 0.0, 8,
                                         device=dev)
    build_s = time.perf_counter() - t0
    th0 = torch.full((M + 1,), 1.0 / (M + 1), device=dev)
    # one streamed round with no host sync (after a warm one)
    feed = theta.ChunkStream(chunks, M, 0.0, dev)
    state = theta.round_state(feed.data, 1, dev)
    state.ring[0] = th0
    feed.rounds(state, 1)
    mode = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        feed.rounds(state, 1)
    except RuntimeError as exc:
        fail(f"17b: a streamed round synchronised with the host: {exc}")
    finally:
        torch.cuda.set_sync_debug_mode(mode)
    feed.close()
    torch.cuda.synchronize()
    del feed, state
    fixed = dict(min_round=STREAM_ROUNDS, max_round=STREAM_ROUNDS)
    got = {}

    def streamed(**kw):
        got["streamed"] = theta.run_theta_loop_streamed(th0, chunks, M, 0.0,
                                                        device=dev, **kw)

    def resident(**kw):
        got["resident"] = theta.run_theta_loop(th0, data, **kw)

    launches = _launches_of(lambda: streamed(**fixed))
    if launches != STREAM_ROUNDS * len(chunks):
        fail(f"17b: {launches} K1 partial launches, not "
             f"{STREAM_ROUNDS} x {len(chunks)}")
    resident(**fixed)
    (th_s, c_s, r_s), (th_r, r_r) = got["streamed"], got["resident"]
    if r_s != r_r or r_s != STREAM_ROUNDS:
        fail(f"17b: {r_s} streamed rounds, {r_r} resident")
    err = close(th_s, th_r, 1e-5, 1e-9, "17b streamed theta")
    n = bundle.hits.n_reads
    if abs(float(c_s.sum()) - n) > 1e-5 * n:
        fail(f"17b: streamed counts sum to {float(c_s.sum())}, not {n}")
    walls = _stream_walls({"streamed": lambda: streamed(**fixed),
                           "resident": lambda: resident(**fixed)})
    ms = {k: statistics.median(w) * 1e3 / STREAM_ROUNDS
          for k, w in walls.items()}
    conv_launches = _launches_of(streamed)
    resident()
    r_sc, r_rc = got["streamed"][2], got["resident"][1]
    th_sc = got["streamed"][0]
    if not bool(torch.isfinite(th_sc).all()) or abs(
            float(th_sc.double().sum()) - 1.0) > 1e-4:
        fail("17b: the convergent streamed theta is not a distribution")
    nbytes = sum(t.numel() * t.element_size() for c in chunks for t in c
                 if isinstance(t, torch.Tensor))
    log(f"17b streamed theta loop, full width (H={data.sid.shape[0]} N={n} "
        f"M+1={M + 1}), 8 chunks of {nbytes} bytes in all (built and "
        f"pinned in {build_s:.3f} s): {STREAM_ROUNDS} rounds each way, "
        f"theta max abs err {err:.3g} (rtol 1e-5); ms per round streamed "
        f"{ms['streamed']:.4f}, resident {ms['resident']:.4f} (median of 3 "
        f"in turns); K1 partial launches {launches}; convergent run "
        f"{r_sc} rounds streamed ({conv_launches} partial launches), "
        f"{r_rc} resident; a streamed round made no host sync")
    del data, chunks
    clear_device_cache()
    torch.cuda.empty_cache()
    return {"chunks": 8, "chunk_bytes": nbytes, "build_s": build_s,
            "rounds": STREAM_ROUNDS, "max_abs_err_theta": err,
            "ms_per_round": ms, "walls_s": walls, "launches": launches,
            "convergent_rounds": {"streamed": r_sc, "resident": r_rc},
            "convergent_launches": conv_launches}


def synthetic_theta_csr(n_reads: int, M: int, seed: int = 17):
    """A frozen-conprb CSR in numpy: 1-5 hits a read (3 on average),
    uniform transcripts, log conprbs drawn as tests/test_scale.py:146-148
    draws them. Returns (hits with sid, rid, read_offsets, lcp, lnp)."""
    import types

    import numpy as np

    rng = np.random.default_rng(seed)
    nh = rng.integers(1, 6, size=n_reads, dtype=np.int64)
    offsets = np.zeros(n_reads + 1, dtype=np.int64)
    np.cumsum(nh, out=offsets[1:])
    H = int(offsets[-1])
    hits = types.SimpleNamespace(
        sid=rng.integers(1, M + 1, size=H, dtype=np.int32),
        rid=np.repeat(np.arange(n_reads, dtype=np.int32), nh),
        read_offsets=offsets, n_reads=n_reads, n_hits=H)
    return hits, rng.normal(-20, 3, H), rng.normal(-25, 3, n_reads)


def pinned_rate(dev, nbytes: int = 2**30, samples: int = 3) -> float:
    """GB/s of one pinned host-to-device copy of nbytes (CUDA events)."""
    import torch

    src = torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
    dst = torch.empty(nbytes, dtype=torch.uint8, device=dev)
    ts = time_samples(lambda: dst.copy_(src, non_blocking=True),
                      samples=samples, warm=1)
    return nbytes / (statistics.median(ts) / 1e3) / 1e9


def phase_gibbs_setup_real(dev, hits, lcp, lnp, C: int = 8, seed: int = 1):
    """7c: build_layout and init_chains of C chains on the card at a real
    sample's size (17c's input, on the card before either runs), each
    timed (synchronised); parts, tiles, the peak device memory above the
    inputs; one K5 sweep over every part (CUDA events, median of 3).
    Returns a summary."""
    import gc

    import torch

    from rsem_tpu_torch.ops import gibbs
    from rsem_tpu_torch.ops.layout import HitsDevice

    M = STREAM_M
    offs = torch.as_tensor(hits.read_offsets).to(dev)
    hd = HitsDevice(rid=torch.as_tensor(hits.rid).to(dev),
                    sid=torch.as_tensor(hits.sid).to(dev), dir=None,
                    pos=None, insert_len=None, read_offsets=offs)
    lcp_d = torch.as_tensor(lcp).to(dev)
    lnp_d = torch.as_tensor(lnp).to(dev)
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base_bytes = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    layout = gibbs.build_layout(hd, lcp_d, lnp_d, M)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    peak_build = torch.cuda.max_memory_allocated() - base_bytes
    base = torch.ones(M + 1, device=dev)
    base[0] += layout.n_noise_fixed
    assigns, tab = gibbs.init_chains(layout, base, C, seed=seed)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    peak = torch.cuda.max_memory_allocated() - base_bytes
    state_bytes = (sum(a.numel() for a in assigns) * 4 + tab.numel() * 4)
    layout_bytes = sum(p.sid.numel() * 8 + p.ncs.numel() * 4
                       for p in layout.parts)
    if tab.shape != (C, M + 1) or int(
            (tab.double().sum(1) - base.double().sum()).ne(
                layout.n_reads).sum()):
        fail("7c: the initial tables do not hold every placed read once")
    seeds = [gibbs.part_seed(seed, pi) for pi in range(len(layout.parts))]
    scratch = gibbs.delta_scratch(tab)
    n0 = gibbs.sweep_part.launches

    def sweep():
        for part, a, sp in zip(layout.parts, assigns, seeds):
            gibbs.sweep_part(a, tab, part, sp, 0, scratch)

    ms = time_samples(sweep, samples=3, warm=1)
    torch.cuda.synchronize()
    if gibbs.sweep_part.launches - n0 != 4 * len(layout.parts):
        fail("7c: K5 did not launch once per part and sweep")
    if bool(scratch.any()) or not bool(torch.isfinite(tab).all()):
        fail("7c: K5 left its scratch non-zero or a non-finite table")
    out = dict(reads=hits.n_reads, hits=hits.n_hits, M=M, chains=C,
               parts=len(layout.parts), widths=[p.K for p in layout.parts],
               tiles=layout.n_tiles, placed_reads=layout.n_reads,
               slots=layout.n_slots, build_s=t1 - t0, init_s=t2 - t1,
               peak_bytes_build=peak_build, peak_bytes=peak,
               input_bytes=base_bytes, layout_bytes=layout_bytes,
               state_bytes=state_bytes,
               k5_ms_per_sweep=statistics.median(ms),
               k5_ms_min=min(ms), k5_ms_max=max(ms))
    log(f"7c Gibbs set-up at a real sample's size: N={hits.n_reads} "
        f"H={hits.n_hits} M+1={M + 1}, {C} chains; {len(layout.parts)} "
        f"parts, widths {out['widths']}, {layout.n_tiles} tiles, "
        f"{layout.n_slots} slots; card build {t1 - t0:.4f} s, init "
        f"{t2 - t1:.4f} s; peak device memory above the inputs "
        f"({base_bytes} bytes) {peak} bytes ({peak / 2**30:.3f} GiB; build "
        f"alone {peak_build / 2**30:.3f} GiB; layout {layout_bytes}, chain "
        f"state {state_bytes} bytes); one K5 sweep "
        f"{out['k5_ms_per_sweep']:.3f} ms [{min(ms):.3f}, {max(ms):.3f}] "
        f"({out['k5_ms_per_sweep'] * 1e3 / layout.n_tiles:.2f} us per tile "
        f"step)")
    del layout, assigns, tab, scratch, hd, lcp_d, lnp_d, offs
    gc.collect()
    torch.cuda.empty_cache()
    return out


def phase_streamed_real(dev, hits, lcp, lnp, gen_s: float):
    """17c: the streamed loop at a real sample's size (synthetic_theta_csr
    at STREAM_READS, STREAM_M, generated in gen_s seconds) against the
    resident loop, peak device memory of each. Returns a summary."""
    import gc

    import torch

    from rsem_tpu_torch.ops import theta
    from rsem_tpu_torch.parallel.fast_sharded import build_theta_chunks

    H, N, M = hits.n_hits, hits.n_reads, STREAM_M
    whole = 12 * H + 12 * N + 8
    n_chunks = -(-whole * 21 // 20 // STREAM_CHUNK_BYTES)  # 5% margin
    t0 = time.perf_counter()
    chunks, b, hb = build_theta_chunks(hits, lcp, lnp, M, 0.0, n_chunks,
                                       device=dev)
    build_s = time.perf_counter() - t0
    del lcp, lnp
    sizes = [sum(t.numel() * t.element_size() for t in c
                 if isinstance(t, torch.Tensor)) for c in chunks]
    if max(sizes) > STREAM_CHUNK_BYTES:
        fail(f"17c: a chunk holds {max(sizes)} bytes, over "
             f"{STREAM_CHUNK_BYTES}")
    th0 = torch.full((M + 1,), 1.0 / (M + 1), device=dev)
    fixed = dict(min_round=STREAM_ROUNDS, max_round=STREAM_ROUNDS)
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    got = {}

    def streamed():
        got["streamed"] = theta.run_theta_loop_streamed(
            th0, chunks, M, 0.0, device=dev, **fixed)

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    launches = _launches_of(streamed)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    peak_s = torch.cuda.max_memory_allocated() - base
    state_bytes = (2 * (M + 1) * 4 + (M + 1) * 8 + 4 + (M + 3) * 8)
    cap = 2 * max(sizes) + state_bytes + 16 * 2**20
    if peak_s > cap:
        fail(f"17c: the streamed loop peaked at {peak_s} device bytes, "
             f"over two chunk buffers and the RoundState ({cap} with 16 "
             "MiB for theta, counts and the allocator)")
    if launches != STREAM_ROUNDS * len(chunks):
        fail(f"17c: {launches} K1 partial launches, not "
             f"{STREAM_ROUNDS} x {len(chunks)}")
    # the resident loop on the same arrays, concatenated on the card; its
    # peak counts the data from before it was built
    base = torch.cuda.memory_allocated()

    def cat(name, shifts=None):
        return torch.cat([getattr(c, name).to(dev) + int(s) if s else
                          getattr(c, name).to(dev) for c, s in
                          zip(chunks, shifts if shifts is not None
                              else [0] * len(chunks))])

    data = theta.ThetaData(
        sid=cat("sid"), rid=cat("rid", b[:-1]), cps=cat("cps"),
        ncs=cat("ncs"),
        read_offsets=torch.cat(
            [torch.cat([c.read_offsets[:-1].to(dev) + int(h)
                        for c, h in zip(chunks, hb[:-1])]),
             torch.tensor([H], dtype=torch.int64, device=dev)]),
        M=M, n0=0.0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    got["resident"] = theta.run_theta_loop(th0, data, **fixed)
    torch.cuda.synchronize()
    wall_r = time.perf_counter() - t0
    peak_r = torch.cuda.max_memory_allocated() - base
    (th_s, c_s, r_s), (th_r, r_r) = got["streamed"], got["resident"]
    if r_s != r_r or r_s != STREAM_ROUNDS:
        fail(f"17c: {r_s} streamed rounds, {r_r} resident")
    err = close(th_s, th_r, 1e-5, 1e-9, "17c streamed theta")
    if abs(float(c_s.sum()) - N) > 1e-5 * N:
        fail(f"17c: streamed counts sum to {float(c_s.sum())}, not {N}")
    resident_bytes = sum(t.numel() * t.element_size() for t in data
                         if isinstance(t, torch.Tensor))
    del data
    torch.cuda.empty_cache()
    walls = _stream_walls({"streamed": streamed}, samples=2)
    ms = {"streamed": statistics.median(walls["streamed"] + [wall_s])
          * 1e3 / STREAM_ROUNDS, "resident": wall_r * 1e3 / STREAM_ROUNDS}
    rate = sum(sizes) / (ms["streamed"] / 1e3) / 1e9
    pinned = pinned_rate(dev)
    log(f"17c streamed theta loop at a real sample's size: N={N} H={H} "
        f"M+1={M + 1}, {len(chunks)} chunks of at most {max(sizes)} bytes "
        f"({sum(sizes)} in all; generated in {gen_s:.1f} s, built and "
        f"pinned in {build_s:.2f} s); {STREAM_ROUNDS} rounds each way, "
        f"theta max abs err {err:.3g} (rtol 1e-5); peak device memory "
        f"streamed {peak_s} bytes ({peak_s / 2**30:.3f} GiB), resident "
        f"{peak_r} ({peak_r / 2**30:.3f} GiB; its ThetaData "
        f"{resident_bytes}); ms per round streamed {ms['streamed']:.3f} "
        f"(median of 3), resident {ms['resident']:.4f}; host-to-device "
        f"{rate:.2f} GB/s streamed against {pinned:.2f} GB/s for one 1 GiB "
        f"pinned copy; K1 partial launches {launches}")
    del chunks, got
    gc.collect()
    torch.cuda.empty_cache()
    return {"reads": N, "hits": H, "M": M, "chunks": len(sizes),
            "max_chunk_bytes": max(sizes), "chunk_bytes": sum(sizes),
            "generate_s": gen_s, "build_pin_s": build_s,
            "rounds": STREAM_ROUNDS, "max_abs_err_theta": err,
            "peak_bytes": {"streamed": peak_s, "resident": peak_r},
            "resident_data_bytes": resident_bytes,
            "ms_per_round": ms, "h2d_gb_s": rate,
            "pinned_copy_gb_s": pinned, "launches": launches}


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--k3-parent", metavar="DIR",
                    help="another tree (e.g. the parent commit unpacked "
                         "with git archive) whose K3 is timed beside this "
                         "tree's at every K3 input")
    ap.add_argument("--estep", action="store_true",
                    help="phases 1, 2 and 3b alone: the E-step statistics "
                         "kernel at a bulk sample's shapes")
    ap.add_argument("--rank16", nargs=3, metavar=("DIR", "COORD", "RANK"),
                    help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.rank16:  # one rank of phase 16b, started by phase_group_world2
        d, coord, rank = args.rank16
        return rank16_main(d, coord, int(rank))
    _name, mem_rate, op_rate = phase_device()
    import torch

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    phase_build()
    if args.estep:
        print(json.dumps({"kernels": [phase_estep(dev, mem_rate, op_rate)]}))
        return 0
    k3 = K3Shapes(mem_rate, op_rate,
                  k3_parent(args.k3_parent) if args.k3_parent else None)
    ref, bundle, model = make_workload()
    rows, k1_in = phase_kernels(ref, bundle, model, dev, mem_rate, op_rate,
                                k3)
    estep_row = phase_estep(dev, mem_rate, op_rate)
    torch.cuda.empty_cache()
    # every phase that uploads a layout drops it from the device cache at
    # its end: later phases plan windows and budgets from free memory
    from rsem_tpu_torch.ops.layout import clear_device_cache

    clear_device_cache()
    torch.cuda.empty_cache()
    launches, cold, warm, rounds = phase_main_path(ref, bundle, model, dev)
    from rsem_tpu_torch.engine.em import EMConfig, run_em

    phase_profile("run_em", lambda: run_em(
        copy.deepcopy(model), ref, bundle, EMConfig(),
        need_posteriors=False, device=dev))
    clear_device_cache()
    torch.cuda.empty_cache()
    # phase 17a (the layout's device cache) on the warm workload
    cache_launches, cache = phase_cache(ref, bundle, model, dev)
    torch.cuda.empty_cache()
    fused_res, fused = phase_fused(ref, bundle, model, dev, k3)
    clear_device_cache()
    torch.cuda.empty_cache()
    backends = phase_backends(ref, bundle, model, dev, fused_res)
    del fused_res
    clear_device_cache()
    torch.cuda.empty_cache()
    win_launches, windowed = phase_windowed(ref, bundle, model, dev)
    clear_device_cache()
    torch.cuda.empty_cache()
    em, _fitted, post_launches, post_secs = phase_posterior(
        ref, bundle, model, dev)
    clear_device_cache()
    torch.cuda.empty_cache()
    gibbs_setup, k5_row = phase_k5(ref, bundle, em, dev, mem_rate, op_rate)
    rows.append(k5_row)
    spread_launches, spread = phase_spread(dev, mem_rate, op_rate)
    for k, n in spread_launches.items():
        if n > 0 and k != "sweep_part":
            fail(f"kernel {k} launched on the spread phase's Gibbs run")
    phase_goldens()
    sim_tpm = em.tpm  # phase 11 draws from phase 6's fit
    del em  # the workload stays for phase 16
    clear_device_cache()
    torch.cuda.empty_cache()
    large_launches, large = phase_large(dev, k3)
    clear_device_cache()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as d:
        ingest = phase_ingest(d)
    with tempfile.TemporaryDirectory() as d:
        simulate = phase_simulate(ref, _fitted, sim_tpm, dev, d)
    with tempfile.TemporaryDirectory() as d:
        simulate["round_trip"] = phase_round_trip(d)
    with tempfile.TemporaryDirectory() as d:
        allele_launches, allele = phase_allele(d, k3=k3)
    for k, n in allele_launches.items():
        if n <= 0:
            fail(f"kernel {k} was not launched on the allele path")
    clear_device_cache()
    with tempfile.TemporaryDirectory() as d:
        bam_launches, bam_options = phase_genome_bam(d, k3=k3)
    for k, n in bam_launches.items():
        if n <= 0 and k not in OFF_EM_PATH:
            fail(f"kernel {k} was not launched on the genome-BAM run")
    clear_device_cache()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as d:
        prsem_launches, prsem_k5, prsem = phase_prsem(d, k3=k3)
        for k, n in prsem_launches.items():
            if n <= 0:
                fail(f"kernel {k} was not launched on the pRSEM run")
        if min(prsem_k5) <= 0:
            fail(f"K5 launches per pRSEM Gibbs run: {prsem_k5}")
        clear_device_cache()
        torch.cuda.empty_cache()
        # phase 16: the process group (16a in process, 16b two ranks)
        group_launches, group, k1_split = phase_group(
            ref, bundle, model, dev, mem_rate, op_rate, d)
        group["driver"] = phase_group_driver(d)
        clear_device_cache()
        torch.cuda.empty_cache()
        group["world2"] = phase_group_world2(d)
        torch.distributed.destroy_process_group()
    clear_device_cache()
    torch.cuda.empty_cache()
    # phase 17b-c: the streamed theta loop
    streamed = {"full_width": phase_streamed(bundle, k1_in, ref.M, dev)}
    # 7c and 17c share one input at a real sample's size
    t0 = time.perf_counter()
    real = synthetic_theta_csr(STREAM_READS, STREAM_M)
    gen_s = time.perf_counter() - t0
    gibbs_setup_real = phase_gibbs_setup_real(dev, *real)
    streamed["real_size"] = phase_streamed_real(dev, *real, gen_s)
    del real
    for r in rows:
        # EM kernels: launches of the main path; K5: of the posterior path
        r["launches"] = launches.get(r["name"], post_launches[r["name"]])
        r["posterior_launches"] = post_launches[r["name"]]
        r["windowed_launches"] = win_launches[r["name"]]
        r["large_run_launches"] = large_launches[r["name"]]
        r["allele_launches"] = allele_launches[r["name"]]
        r["bam_options_launches"] = bam_launches[r["name"]]
        r["prsem_launches"] = prsem_launches[r["name"]]
        if r["name"] == "sweep_part":  # uniform prior, then pRSEM's
            r["prsem_gibbs_launches"] = prsem_k5
            r["spread_launches"] = spread["launches"]
            r["spread_ms_per_sweep"] = spread["ms_per_sweep"]
        # phase 16: the posterior path with a group of 1 (NCCL), and each
        # rank's of the group of 2 (gloo); K1 runs as its two halves there
        name = "theta_partial" if r["name"] == "theta_round" else r["name"]
        r["sharded_launches"] = group_launches[name]
        r["sharded_world2_launches"] = [
            x["launches"][name] for x in group["world2"]["ranks"]]
        if r["name"] == "theta_round":
            r.update(k1_split)
            # phase 17: K1's partial, once per chunk and round
            r["streamed_launches"] = {
                "full_width": streamed["full_width"]["launches"],
                "full_width_convergent":
                    streamed["full_width"]["convergent_launches"],
                "real_size": streamed["real_size"]["launches"]}
        r["cache_launches"] = cache_launches.get(r["name"], 0)
        r["kernel_ms"] = r["ms"]
    # the E-step statistics kernel runs in the fused loop alone
    estep_row["launches"] = launches["estep_stats"]
    estep_row["kernel_ms"] = estep_row["ms"]
    rows.append(estep_row)
    log(json.dumps({"run_em": {"cold_s": cold, "warm_s": warm,
                               "rounds": rounds},
                    "fused_vs_per_round": fused, "backends": backends,
                    "windowed": windowed, "posterior_s": post_secs,
                    "large_run": large, "ingest": ingest,
                    "simulate": simulate, "allele": allele,
                    "bam_options": bam_options, "prsem": prsem,
                    "group": group, "cache": cache,
                    "streamed": streamed, "spread": spread,
                    "gibbs_setup": gibbs_setup,
                    "gibbs_setup_real": gibbs_setup_real}))
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
