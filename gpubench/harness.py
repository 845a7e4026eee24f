"""The benchmark's entry: one run of one cell.

    python3 gpubench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Everything a run does is found by name from the cell's entry in the
repository's BENCHMARK.json: `workloads/<cell>.json` (its configuration,
traffic mix, chips and the limits of its comparison),
`configs/<config>.json`, `traffic/<traffic>.json`, the configuration's
estimation path `paths/<path>.py` (`em` where the configuration names
none; `paths/__init__.py` says what a path holds), and one reader
`metrics/<metric>.py` per metric it reports. A run

1. refuses without the CUDA cards the cell asks for (exit 3, no result);
2. refuses (exit 5, no result) where the path's module is missing or lacks
   a member of the interface, or the cell's `limits` do not name exactly
   the path's `NUMBERS`;
3. sets up: makes the annotation and the cell's distinct samples on the
   card from the seed, copies them to host memory as ingest leaves them,
   and runs one sample through the path, so that the kernels are built and
   the allocator is warm (all of this is `setup_s`, counted from the
   process's start);
4. measures for `--seconds` seconds: samples one after another, cycling
   through the distinct samples; the sample in flight at the end is
   finished and counted;
5. with `--trace 1`, then traces a few more samples under torch.profiler;
6. reads the device's memory peak, frees the program's state, and works
   out each distinct sample's values again with the path's plain
   reference, judging every result of the window with the path's numbers;
7. refuses (exit 4, no result) if JAX or the JAX package was loaded;
8. prints the compared numbers beside their limits on standard error and
   one JSON line on standard output.
"""

from __future__ import annotations

import argparse
import gc
import importlib.util
import json
import os
import sys
import time
from dataclasses import dataclass
from pathlib import Path
from types import ModuleType
from typing import Dict, List, Optional

import numpy as np

from .paths import DEFAULT, INTERFACE

HERE = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "rsem_tpu")


class CellError(Exception):
    """The cell's files do not fit together (exit 5)."""


def process_age() -> float:
    """Seconds since this process started (Linux /proc)."""
    with open("/proc/self/stat") as f:
        start_ticks = float(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    return uptime - start_ticks / os.sysconf("SC_CLK_TCK")


def load_json(path: Path) -> Dict:
    with open(path) as f:
        return json.load(f)


@dataclass
class Cell:
    name: str
    bench: Dict
    workload: Dict
    config: Dict
    traffic: Dict
    files: Path = HERE  # where its files (and its path and readers) lie

    @property
    def path_name(self) -> str:
        return self.config.get("path", DEFAULT)


def load_cell(root: Path, name: str, files: Path = HERE) -> Cell:
    bench = load_json(root / "BENCHMARK.json")
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    wl = load_json(files / "workloads" / f"{name}.json")
    cfg = load_json(files / "configs" / f"{entry['config']}.json")
    tr = load_json(files / "traffic" / f"{entry['traffic']}.json")
    return Cell(name, bench, wl, cfg, tr, files)


def metric_entries(cell: Cell, trace: bool) -> List[Dict]:
    """The cell's end-to-end metrics (trace 0) or per-layer metrics
    (trace 1), as BENCHMARK.json lists them."""
    key = "per_layer" if trace else "end_to_end"
    return [m for m in cell.bench[key]
            if "workloads" not in m or cell.name in m["workloads"]]


def _exec(module: str, path: Path) -> ModuleType:
    spec = importlib.util.spec_from_file_location(module, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_reader(name: str, files: Path = HERE) -> ModuleType:
    return _exec(f"gpubench.metrics.{name.replace('.', '_')}",
                 files / "metrics" / f"{name}.py")


def load_path(cell: Cell) -> ModuleType:
    """The cell's estimation path, checked against its interface and the
    cell's limits; raises CellError saying what does not fit."""
    name = cell.path_name
    file = cell.files / "paths" / f"{name}.py"
    if not (isinstance(name, str) and name.isascii() and name.isidentifier()
            and file.is_file()):
        raise CellError(f"configuration {cell.workload['config']!r} names "
                        f"path {name!r}, but there is no {file}")
    # Two loaders only so that tests can patch the repository's own path:
    # it is imported as the package's module, one object a name; a path
    # of another directory (a test's cell) is executed from its file.
    if cell.files == HERE:
        mod = importlib.import_module(f"gpubench.paths.{name}")
    else:
        mod = _exec(f"gpubench_paths_{name}", file)
    lacks = [m for m in INTERFACE if not hasattr(mod, m)]
    if lacks:
        raise CellError(f"path {name!r} ({file}) lacks "
                        f"{', '.join(lacks)}")
    if not mod.NUMBERS:
        raise CellError(f"path {name!r} ({file}) judges no number")
    limits, numbers = set(cell.workload["limits"]), set(mod.NUMBERS)
    if limits != numbers:
        raise CellError(
            f"workload {cell.name!r} has limits for "
            f"{sorted(limits)}, but path {name!r} judges "
            f"{sorted(numbers)}")
    return mod


@dataclass
class Context:
    """What the metric readers read."""

    cell: Cell
    setup_s: float
    window_s: float
    samples: list  # sut.Sample of the window
    trace: Optional[object] = None  # trace.Trace of the traced samples


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's
    (compared whole: rsem_tpu_torch is not rsem_tpu)."""
    return sorted({m.split(".", 1)[0] for m in list(sys.modules)
                   if m.split(".", 1)[0] in FORBIDDEN})


def check_devices(chips: int) -> Optional[str]:
    import torch

    if not torch.cuda.is_available():
        return "torch.cuda.is_available() is false"
    if torch.cuda.device_count() < chips:
        return (f"the cell needs {chips} CUDA device(s), "
                f"{torch.cuda.device_count()} present")
    return None


def run(args, device: str = "cuda:0", check_chip: bool = True,
        root: Optional[Path] = None, out=sys.stdout, err=sys.stderr,
        files: Path = HERE) -> int:
    """One run; returns the exit code. Tests call it with device="cpu" and
    check_chip=False at small sizes (the traffic file's values can be
    overridden through args.override, a dict), and with `files`, the
    directory of the cells' files, paths and readers, to run cells of
    their own."""
    root = root or Path.cwd()
    cell = load_cell(root, args.workload, files)
    for k, v in (getattr(args, "override", None) or {}).items():
        (cell.traffic if k in cell.traffic else cell.config)[k] = v
    chips = int(cell.workload["chips"])
    if check_chip:
        why = check_devices(chips)
        if why:
            print(f"gpubench: {why}; no result", file=err)
            return 3
    try:
        path = load_path(cell)
    except CellError as e:
        print(f"gpubench: {e}; no result", file=err)
        return 5

    import torch

    from . import sut
    from .gen import bundle as gb
    from .gen import synth

    cuda = torch.device(device).type == "cuda"
    seed = int(args.seed)
    torch.set_num_threads(int(cell.config["rsem"]["num_threads"]))

    # ---- set-up ----
    ann = synth.make_annotation(cell.config, cell.traffic, device)
    n_samples = int(cell.traffic["samples"])
    raws = [synth.make_sample(ann, cell.config, cell.traffic, seed, k,
                              device) for k in range(n_samples)]
    ref = gb.reference_of(ann)
    gi = gb.groups_of(ann)
    spec = gb.spec_of(cell.config)
    seed_len = int(cell.config["rsem"]["seed_length"])
    inputs = [sut.Inputs(k, ref, gi, spec, gb.bundle_of(r, seed_len),
                         ref.full_len) for k, r in enumerate(raws)]
    if cuda:
        torch.cuda.empty_cache()
    order = np.random.default_rng(synth.sub_seed(seed, 7)).permutation(
        n_samples)
    # builds the kernels, warms the allocator
    path.run_sample(inputs[order[-1]], device, keep_values=False)
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    setup_s = process_age()

    # ---- the measured window: the distinct samples in the seed's order ----
    samples = []
    t0 = time.perf_counter()
    i = 0
    while True:
        if cuda:
            torch.cuda.reset_peak_memory_stats(device)
        s = path.run_sample(inputs[order[i % n_samples]], device)
        if cuda:
            s.peak_bytes = int(torch.cuda.max_memory_allocated(device))
            peak = max(peak, s.peak_bytes)
        samples.append(s)
        i += 1
        if time.perf_counter() - t0 >= float(args.seconds):
            break
    window_s = time.perf_counter() - t0

    # ---- the traced samples ----
    trace = None
    if int(args.trace):
        from .trace import profile_samples

        tw = cell.workload.get("trace", {"warmup": 1, "active": 2})

        def one(j):
            inp = inputs[order[(i + j) % n_samples]]
            s = path.run_sample(inp, device, keep_values=False)
            return path.work(inp, s)

        trace = profile_samples(one, int(tw["warmup"]), int(tw["active"]))
        if cuda:
            peak = max(peak, int(torch.cuda.max_memory_allocated(device)))

    # ---- metrics ----
    ctx = Context(cell, setup_s, window_s, samples, trace)
    metrics: Dict[str, Dict] = {}
    for entry in metric_entries(cell, bool(int(args.trace))):
        value = load_reader(entry["name"], cell.files).read(ctx)
        if value is not None:
            metrics[entry["name"]] = {"value": float(value),
                                      "unit": entry["unit"]}

    # ---- correctness, after the program's state is freed ----
    del inputs
    from rsem_tpu_torch.ops.layout import clear_device_cache

    clear_device_cache()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    limits = cell.workload["limits"]
    worst = {name: 0.0 for name in limits}
    failed = 0
    for k in sorted({s.index for s in samples}):
        want = path.reference(ann, raws[k], cell.config, device,
                              "reference")
        for s in samples:
            if s.index != k:
                continue
            g = path.gaps(s.values, want, ann)
            bad = False
            for name in limits:
                worst[name] = max(worst[name], g[name])
                bad |= not g[name] <= float(limits[name])
            failed += bad
        del want
    checks = {name: {"value": worst[name], "limit": float(limits[name])}
              for name in limits}
    correct = failed == 0 and len(samples) > 0

    # ---- refusals ----
    found = forbidden_modules()
    if found:
        print(f"gpubench: loaded {', '.join(found)}; no result", file=err)
        return 4

    line = {"correct": bool(correct), "attempted": len(samples),
            "failed": int(failed), "metrics": metrics,
            "device": device_info(device, chips, peak, trace)}
    if trace is not None:
        line["breakdown"] = trace.breakdown()
    line["checks"] = checks
    for name, c in checks.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=err)
    err.flush()
    print(json.dumps(line), file=out)
    out.flush()
    return 0


def device_info(device: str, chips: int, peak: int, trace) -> Dict:
    import torch

    if torch.device(device).type == "cuda":
        info = {"platform": "gpu",
                "kind": torch.cuda.get_device_name(device), "count": chips,
                "memory_peak_bytes": int(peak)}
    else:
        info = {"platform": "cpu", "kind": "cpu", "count": 0,
                "memory_peak_bytes": 0}
    if trace is not None:
        info["busy_s"] = trace.busy_s()
        info["window_s"] = trace.window_s
    return info


def parse(argv: List[str]):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv: Optional[List[str]] = None) -> int:
    return run(parse(sys.argv[1:] if argv is None else argv))
