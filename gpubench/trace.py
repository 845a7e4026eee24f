"""The device trace of a few whole samples, read from torch.profiler.

`profile_samples` runs samples under the profiler (CPU and CUDA activity):
the first `warmup` of them warm the profiler up (a profiler's first window
can lose device events), the next `active` are traced. `Trace` keeps the
traced device activity (kernels, copies, sets) and the host spans on the
profiler's clock, and the host clock's length of the traced samples. The
per-layer readers in `metrics/` take what they need from it.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

import torch

TOP = 10  # entries of each list of the breakdown
DEVICE_KINDS = ("kernel", "gpu_memcpy", "gpu_memset")


@dataclass
class Event:
    name: str
    start: float  # seconds, profiler clock
    end: float


@dataclass
class Trace:
    events: List[Event]  # device activity of the traced samples
    host: List[Event]  # host spans of the traced samples
    window_s: float  # host clock across the traced samples
    samples: int
    work: List[Dict] = field(default_factory=list)  # per traced sample

    def device_seconds(self, match: Callable[[str], bool]) -> float:
        return sum(e.end - e.start for e in self.events if match(e.name))

    def busy_intervals(self) -> List[Tuple[float, float]]:
        """The union of device activity as sorted, disjoint intervals."""
        out: List[List[float]] = []
        for e in sorted(self.events, key=lambda e: e.start):
            if out and e.start <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e.end)
            else:
                out.append([e.start, e.end])
        return [(a, b) for a, b in out]

    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals())

    def _host_at(self, t: float) -> str:
        """What the host was doing at t: the benchmark's stage (its
        `gpubench.*` span) and the innermost operation open then, not
        counting CUDA runtime calls (`stage/op`)."""
        open_ = [h for h in self.host if h.start <= t < h.end]
        stages = [h for h in open_ if h.name.startswith("gpubench.")]
        ops = [h for h in open_ if not h.name.startswith(("gpubench.",
                                                          "cuda",
                                                          "ProfilerStep"))]
        stage = min(stages, key=lambda h: h.end - h.start).name \
            if stages else "(no stage)"
        op = min(ops, key=lambda h: h.end - h.start).name if ops else "-"
        return f"{stage}/{op}"

    def breakdown(self) -> Dict[str, list]:
        """The device operations that took most time, and the longest idle
        gaps between device activity labelled by what the host was doing
        at the gap's start."""
        by_name: Dict[str, float] = {}
        for e in self.events:
            by_name[e.name] = by_name.get(e.name, 0.0) + e.end - e.start
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
        busy = self.busy_intervals()
        gaps = [(busy[i][1], busy[i + 1][0]) for i in range(len(busy) - 1)
                if busy[i + 1][0] > busy[i][1]]
        gaps.sort(key=lambda g: g[0] - g[1])
        labelled = []
        for a, b in gaps[:TOP]:
            labelled.append([self._host_at(a), b - a])
        return {"device_ops": [[n[:160], s] for n, s in ops],
                "idle_gaps": [[n[:160], s] for n, s in labelled]}


def _ns(ev, what: str) -> float:
    f = getattr(ev, f"{what}_ns", None)
    if f is not None:
        return f() * 1e-9
    return getattr(ev, f"{what}_us")() * 1e-6


def _device_activity(ev) -> bool:
    """A kernel, copy or set on the card; not a range that the profiler
    mirrors onto the device's timeline from a host annotation."""
    if ev.device_type() != torch.autograd.DeviceType.CUDA:
        return False
    kind = getattr(ev, "activity_type", None)
    if kind is not None:
        return str(kind()).lower() in DEVICE_KINDS
    user = getattr(ev, "is_user_annotation", None)
    return not (user is not None and user()) and not ev.name().startswith(
        ("gpubench.", "ProfilerStep"))


def _read(prof) -> Tuple[List[Event], List[Event]]:
    dev, host = [], []
    for ev in prof.profiler.kineto_results.events():
        start = _ns(ev, "start")
        end = start + _ns(ev, "duration")
        if ev.device_type() == torch.autograd.DeviceType.CUDA:
            if _device_activity(ev):
                dev.append(Event(ev.name(), start, end))
        else:
            host.append(Event(ev.name(), start, end))
    return dev, host


def profile_samples(run_one: Callable[[int], Optional[Dict]], warmup: int,
                    active: int) -> Trace:
    """Run run_one(i) for i < warmup + active under the profiler, the last
    `active` traced; run_one ends each sample synchronised and returns the
    sample's work sizes (yardstick.work.Work fields) or None."""
    from torch.profiler import ProfilerActivity, profile, schedule

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    sched = schedule(wait=0, warmup=warmup, active=active, repeat=1)
    work: List[Dict] = []
    t0 = t1 = 0.0
    with profile(activities=acts, schedule=sched) as prof:
        for i in range(warmup + active):
            if i == warmup:
                t0 = time.perf_counter()
            w = run_one(i)
            if i >= warmup and w is not None:
                work.append(w)
            prof.step()
        t1 = time.perf_counter()
    dev, host = _read(prof)
    return Trace(dev, host, t1 - t0, active, work)
