"""The control of a cell's comparison: the plain reference of the cell's
path put in the program's place, computed one precision lower (its
reference at "control"; for `em`, reference/em.py CONTROL: bfloat16 values
and position sums, float32 sums over hits and reads), and judged by the
path's numbers as the program is. Each number's upper reading is the
smallest the control gives.

    python3 gpubench/control.py --workload <cell> --seeds 1 2 3 [--samples 2]

runs at the cell's own size on the card (the traffic file's sizes; the
first `--samples` distinct samples of each seed) and prints one JSON line
per seed with the control's numbers. The benchmark's own runs do not run
it. gpubench/tests/test_gpubench_control.py runs it at a size a CPU test
can hold.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Dict, List, Optional

if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))

from gpubench.harness import HERE, load_cell, load_path  # noqa: E402


def control_numbers(cell, seed: int, samples: int, device: str,
                    precision: str = "control") -> Dict[str, float]:
    """The largest of each number over the first `samples` distinct
    samples of `seed`: the path's reference at `precision` ("control", or
    "stated" for the configuration's own precision; each at its own stop)
    against its reference at "reference", and the two round counts where
    the path's reference has them."""
    from gpubench.gen import synth

    path = load_path(cell)
    ann = synth.make_annotation(cell.config, cell.traffic, device)
    worst: Dict[str, float] = {}
    for k in range(samples):
        raw = synth.make_sample(ann, cell.config, cell.traffic, seed, k,
                                device)
        ctl = path.reference(ann, raw, cell.config, device, precision)
        ref = path.reference(ann, raw, cell.config, device, "reference")
        g = path.gaps(ctl.values, ref, ann)
        if hasattr(ref, "rounds"):
            g["its_rounds"] = ctl.rounds
            g["reference_rounds"] = ref.rounds
        for name, v in g.items():
            worst[name] = max(worst.get(name, 0.0), float(v))
    return worst


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--samples", type=int, default=2)
    p.add_argument("--stated", action="store_true",
                   help="also read the configuration's own precision "
                        "(for em: float32 values, float64 sums) against "
                        "the reference: a witness of the sound runs' "
                        "readings")
    a = p.parse_args(argv)
    cell = load_cell(HERE.parent, a.workload)
    for seed in a.seeds:
        t0 = time.perf_counter()
        line = {"workload": a.workload, "seed": seed,
                "control": control_numbers(cell, seed, a.samples, "cuda:0")}
        if a.stated:
            line["stated"] = control_numbers(cell, seed, a.samples,
                                             "cuda:0", "stated")
        line["seconds"] = time.perf_counter() - t0
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
