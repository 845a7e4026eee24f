"""Instrumentation of the port: stage times, spans inside the program,
counters, and the torch.profiler trace.

The reference records coarse stage times behind --time
(rsem-calculate-expression:102-103,820-828 writing sample.time); this
extends that with a per-stage breakdown, derived throughput metrics, and an
optional torch.profiler trace of the device work.

Spans. `span(name)` marks a block of the program (the EM engine's phases,
`rsem.em.*`, and every host read of device memory, `rsem.sync`). It costs
one check when nothing listens. Inside `tracing()` it records the block's
name, enclosing span and host-clock start and end in memory; while a
torch.profiler records, it also enters `record_function(name)`, so the
range lies on the profiler's clock beside the device events (a
`--profile-dir` trace carries it). With neither on it returns one shared
null context: no clock read, no allocation, no record_function (which
costs ~12 us even with no profiler running).

Counters. `count(name, n)` adds to a process-wide integer, always on:
host reads of device memory (`d2h_reads`), copies to a CUDA device that
the host waits for (`h2d_copies`), the layout's host bytes copied to the
device (`upload_bytes`), `run_em` calls (`em_calls`) and launches of
the fused loop's E-step statistics kernel (`model_estep_launches`).
`counters()` returns a snapshot, `reset_counters()` clears them. The
kernels' `.launches` attributes (ops/table, theta, conprb, gibbs,
model_loop) are counters of their own.

Counterpart of rsem_tpu/utils/timing.py; `maybe_profile` records a
torch.profiler trace instead of a jax.profiler one.
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field
from typing import Dict, Iterator, List, Optional, Set, Tuple

import torch


@dataclass
class Span:
    """One recorded block: `parent` is the index, in the recorded list, of
    the span open around it (-1 for none); times are perf_counter_ns."""

    name: str
    parent: int
    start: int
    end: int = 0

    @property
    def seconds(self) -> float:
        return (self.end - self.start) * 1e-9


_NULL = contextlib.nullcontext()
_rec: Optional["_Recorder"] = None  # what tracing() records into
_counts: Dict[str, int] = {}


class _Recorder:
    def __init__(self):
        self.spans: List[Span] = []
        self.open: List[int] = []  # indices of the spans open now


class _Span:
    __slots__ = ("name", "rf", "rec", "index")

    def __init__(self, name: str, profiling: bool):
        self.name = name
        self.rf = torch.profiler.record_function(name) if profiling else None
        self.rec = _rec

    def __enter__(self):
        if self.rf is not None:
            self.rf.__enter__()
        rec = self.rec
        if rec is not None:
            self.index = len(rec.spans)
            rec.spans.append(Span(self.name,
                                  rec.open[-1] if rec.open else -1,
                                  time.perf_counter_ns()))
            rec.open.append(self.index)
        return self

    def __exit__(self, *exc):
        rec = self.rec
        if rec is not None:
            rec.spans[self.index].end = time.perf_counter_ns()
            rec.open.pop()
        if self.rf is not None:
            self.rf.__exit__(*exc)
        return False


def span(name: str):
    """Context manager marking a block of the program as span `name`."""
    profiling = torch.autograd._profiler_enabled()
    if _rec is None and not profiling:
        return _NULL
    return _Span(name, profiling)


@contextlib.contextmanager
def tracing() -> Iterator[List[Span]]:
    """Record spans in memory while the block runs; yields the list they
    are recorded into, in the order they opened."""
    global _rec
    outer, _rec = _rec, _Recorder()
    try:
        yield _rec.spans
    finally:
        _rec = outer


def span_totals(spans: List[Span]) -> Dict[str, float]:
    """Seconds by span name, summed over the name's spans, in the order
    the names first opened."""
    out: Dict[str, float] = {}
    for s in spans:
        out[s.name] = out.get(s.name, 0.0) + s.seconds
    return out


def count(name: str, n: int = 1) -> None:
    _counts[name] = _counts.get(name, 0) + n


def counters() -> Dict[str, int]:
    return dict(_counts)


def reset_counters() -> None:
    _counts.clear()


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

    def add_spans(self, spans: List[Span]) -> None:
        """Each `rsem.em.*` span's total as a comment-only stage
        (`em.upload`), after the stages timed so far."""
        for name, dt in span_totals(spans).items():
            if name.startswith("rsem.em."):
                name = name[len("rsem."):]
                self._comment_only.add(name)
                self.stages.append((name, dt))

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
    when a directory is given; writes a Chrome trace into it, which
    carries the program's `rsem.*` spans as host ranges."""
    if not trace_dir:
        yield
        return
    import os

    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(trace_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(trace_dir, "trace.json"))
