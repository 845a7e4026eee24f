"""Entry point of the benchmark: python3 gpubench/run.py --workload <cell>
--seed <n> --seconds <s> --trace <0|1>, from the repository's root (see
gpubench/harness.py)."""

import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
if sys.path and os.path.abspath(sys.path[0]) == HERE:
    sys.path[0] = ROOT
else:
    sys.path.insert(0, ROOT)
os.environ.setdefault("USE_FLAX", "0")
os.environ.setdefault("USE_JAX", "0")


def _threads(argv):
    """The cell's configuration's `--num-threads` (RSEM's threads for
    expression estimation), or None where the cell cannot be found (the
    harness then says why). The CPU math libraries read it once, when they
    load, so it is set before numpy and torch are imported."""
    try:
        cell = argv[argv.index("--workload") + 1]
        with open("BENCHMARK.json") as f:
            entry = next(w for w in json.load(f)["workloads"]
                         if w["name"] == cell)
        with open(os.path.join(HERE, "configs", entry["config"] + ".json")
                  ) as f:
            return int(json.load(f)["rsem"]["num_threads"])
    except (ValueError, IndexError, OSError, StopIteration, KeyError):
        return None


n = _threads(sys.argv)
if n is not None:
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ[var] = str(n)

from gpubench.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main())
