"""Wall time of the port's CI stage (engine/ci.run_ci) at full width, with
gene groups of equal size and with a heavy-tailed isoform count per gene.

    python3 ci_timing.py [--root DIR] [--reps N]

Times `run_ci` and, alone, its gene-level sums and bounds (`group_bounds`)
of the tree at DIR (default: this file's directory), on the card, at the
driver defaults: 1,000 count vectors of M = 20,000 transcripts, 50 samples
each (a [50,000 x 20,000] f32 sample matrix). The count vectors, lengths
and sample matrix are made from a seed, so two trees see the same inputs;
each time is the median of --reps warm calls (the host clock around a
call and a device sync). Groupings:

  uniform   5,000 genes of 4 isoforms (chip_smoke.py's gene_groups)
  skewed    Zipf(2.0) isoforms per gene, capped at 300, drawn until they
            cover M: 4,103 genes, 60% of one isoform, mean 4.9, the largest
            ones of 300 (a heavy tail like a GENCODE annotation's, with
            more genes at the cap than GENCODE has)

Prints the card's name and power limit, then one JSON line. Needs CUDA.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

M = 20_000
N_CV = 1_000
NSPC = 50
MAX_ISOFORMS = 300


def skewed_starts(M: int, seed: int = 0):
    import numpy as np

    rng = np.random.default_rng(seed)
    sizes = []
    left = M
    while left > 0:
        s = int(min(rng.zipf(2.0), MAX_ISOFORMS, left))
        sizes.append(s)
        left -= s
    sizes = np.array(sizes)
    rng.shuffle(sizes)
    return np.concatenate([[1], 1 + np.cumsum(sizes)])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.abspath(
        __file__)), help="tree whose rsem_tpu_torch is timed")
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.abspath(args.root))

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("ci_timing.py: no CUDA device", file=sys.stderr)
        return 1
    from rsem_tpu_torch.engine import ci
    from rsem_tpu_torch.refprep.transcripts import GroupInfo

    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    theta = rng.dirichlet(np.full(M + 1, 0.5))
    cvs = rng.poisson(1e6 * theta, (N_CV, M + 1)).astype(np.float32)
    eel = np.full(M + 1, 1901.0)
    eel[0] = 0.0
    mw = np.ones(M + 1)
    gen = torch.Generator(device=dev).manual_seed(1)
    n = N_CV * NSPC
    tpm = torch.rand((n, M), generator=gen, device=dev) * 100.0
    inv_lbar = (1e3 / (1500.0 + torch.rand((n, 1), generator=gen,
                                           device=dev)))
    zeros = ci.CIBounds(np.zeros(M), np.zeros(M), np.zeros(M))
    cover = int(0.95 * n - 1e-8) + 1  # as run_ci derives it
    groupings = {
        "uniform": np.concatenate([np.arange(1, M + 1, 4), [M + 1]]),
        "skewed": skewed_starts(M),
    }

    def timed(fn):
        fn()  # warm
        ts = []
        for _ in range(args.reps):
            torch.cuda.synchronize()
            t = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            ts.append(time.perf_counter() - t)
        return statistics.median(ts), ts

    out = {"root": os.path.abspath(args.root), "groupings": {}}
    for name, starts in groupings.items():
        gi = GroupInfo(starts)
        sizes = np.diff(starts)
        run_s, run_all = timed(lambda: ci.run_ci(
            cvs, eel, mw, gi, ci.CIConfig(seed=2), device=dev))
        grp_s, grp_all = timed(lambda: ci.group_bounds(
            tpm, inv_lbar, gi, zeros, zeros, cover))
        out["groupings"][name] = {
            "genes": int(gi.m), "max_isoforms": int(sizes.max()),
            "single_isoform_share": float((sizes == 1).mean()),
            "run_ci_s": run_s, "run_ci_all_s": run_all,
            "group_bounds_s": grp_s, "group_bounds_all_s": grp_all}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi)
    out["device"] = smi
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
