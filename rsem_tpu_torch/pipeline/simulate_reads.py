"""CLI: simulate reads from a learned model (rsem-simulate-reads equivalent).

Usage: python -m rsem_tpu_torch simulate-reads \
           ref_name model_file isoform_results theta0 N output_name \
           [--seed s] [--device cuda|cpu]
(reference: simulation.cpp:144). The draws run on --device (default
cuda; without CUDA the command raises unless --device cpu is given).
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from ..engine.simulate import simulate_reads
from ..io.results import write_simulation_results
from ..model.generative import GenerativeModel
from ..refprep.reference import Reference
from ..refprep.transcripts import GroupInfo, Transcripts


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="rsem-tpu-torch-simulate-reads")
    p.add_argument("reference_name")
    p.add_argument("model_file")
    p.add_argument("isoform_results")
    p.add_argument("theta0", type=float)
    p.add_argument("N", type=int)
    p.add_argument("output_name")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda",
                   help="torch device: cuda (default) or cpu")
    p.add_argument("-q", "--quiet", action="store_true")
    args = p.parse_args(argv)

    ref = Reference.load_seq(f"{args.reference_name}.seq")
    ts = Transcripts.read_ti(f"{args.reference_name}.ti")
    gi = GroupInfo.load(f"{args.reference_name}.grp")
    model = GenerativeModel.read(args.model_file, refs=ref)

    # TPM column of the isoforms results file
    tpm = np.zeros(ref.M + 1)
    with open(args.isoform_results) as f:
        header = f.readline().rstrip("\n").split("\t")
        tpm_col = header.index("TPM")
        for i in range(1, ref.M + 1):
            tpm[i] = float(f.readline().split("\t")[tpm_col])

    res = simulate_reads(
        model, ref, tpm, args.theta0, args.N, args.output_name,
        seed=args.seed, device=args.device,
    )
    write_simulation_results(
        args.output_name, ts, gi, model.calc_eel(), res.counts, ts.lengths()
    )
    if not args.quiet:
        print(
            f"Simulated {args.N} reads ({res.n_resimulated} resimulated), "
            f"noise reads: {int(res.counts[0])}."
        )
    return 0


if __name__ == "__main__":
    sys.exit(main())
