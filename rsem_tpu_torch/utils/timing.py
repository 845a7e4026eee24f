"""Per-stage wall-clock instrumentation for the pipeline drivers.

The reference records coarse stage times behind --time
(rsem-calculate-expression:102-103,820-828 writing sample.time); this
extends that with a per-stage breakdown, derived throughput metrics, and an
optional torch.profiler trace of the device work.

Counterpart of rsem_tpu/utils/timing.py; `maybe_profile` records a
torch.profiler trace instead of a jax.profiler one.
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set, Tuple


@dataclass
class StageTimer:
    """Accumulates named stage durations in insertion order."""

    stages: List[Tuple[str, float]] = field(default_factory=list)
    t0: float = field(default_factory=time.time)
    _open: Dict[str, float] = field(default_factory=dict)
    _comment_only: Set[str] = field(default_factory=set)

    @contextlib.contextmanager
    def stage(self, name: str, headline: bool = True):
        """Times the block as stage `name`. A stage with headline=False is
        only a comment line of the .time file: it stays out of the
        reference's `Estimating expression levels` sum."""
        if not headline:
            self._comment_only.add(name)
        t = time.perf_counter()
        try:
            yield
        finally:
            self.stages.append((name, time.perf_counter() - t))

    def add(self, name: str, seconds: float) -> None:
        self.stages.append((name, seconds))

    def total(self) -> float:
        return time.time() - self.t0

    def get(self, name: str) -> float:
        return sum(dt for n, dt in self.stages if n == name)

    def report(self, log=print, n_reads: int = 0, n_chips: int = 1) -> None:
        for name, dt in self.stages:
            log(f"  {name:<28s} {dt:9.2f} s")
        tot = self.total()
        log(f"  {'total':<28s} {tot:9.2f} s")
        if n_reads and tot > 0:
            log(
                f"  throughput: {n_reads / tot / 1e6:.2f} M reads/s "
                f"end-to-end ({n_reads / tot / max(n_chips, 1) / 1e6:.2f} "
                "M reads/s/chip)"
            )

    def write_time_file(self, path: str, aligning: float = 0.0) -> None:
        """The reference's sample.time format
        (rsem-calculate-expression:820-828), with the per-stage breakdown
        appended as comments."""
        ci = self.get("ci")
        est = sum(dt for n, dt in self.stages
                  if n != "ci" and n not in self._comment_only) or self.total()
        with open(path, "w") as f:
            f.write(f"Aligning reads: {aligning:.0f} s.\n")
            f.write(f"Estimating expression levels: {est:.2f} s.\n")
            f.write(f"Calculating credibility intervals: {ci:.2f} s.\n")
            for name, dt in self.stages:
                f.write(f"# {name}: {dt:.3f} s.\n")


@contextlib.contextmanager
def maybe_profile(trace_dir: Optional[str]):
    """torch.profiler trace (CPU and CUDA activity) over the wrapped block
    when a directory is given; writes a Chrome trace into it."""
    if not trace_dir:
        yield
        return
    import os

    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(trace_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(trace_dir, "trace.json"))
