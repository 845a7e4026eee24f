"""Shared arithmetic of the metric readers in `metrics/`.

A reader returns None where it finds nothing to read (no traced samples, no
device time of its kernels, no span of its stage), and the harness then
leaves the metric out of the result line; a roofline share is never
reported as 0.
"""

from __future__ import annotations

import re
import statistics
from typing import Callable, Iterable, List, Optional, Tuple

from .yardstick.peaks import H100_SXM, least_seconds
from .yardstick.work import Work


def kernel_matcher(kernels: Iterable[str]) -> Callable[[str], bool]:
    """Matches a device event whose name is one of `kernels`' function
    names (as the profiler prints it: namespace, name, then template or
    argument list). A name with its first template argument
    (`indexFuncLargeIndex<double`) matches only that instantiation."""
    alts = [re.escape(k) + (r"(?![A-Za-z0-9_])" if "<" in k else r"\s*[(<]")
            for k in kernels]
    pat = re.compile(r"(?:^|[^A-Za-z0-9_])(?:" + "|".join(alts) + ")")
    return lambda name: bool(pat.search(name))


def roofline(ctx, kernels: Iterable[str],
             work: Callable[[Work], Tuple[float, float]]) -> Optional[float]:
    """Least time of the traced samples' work over the device time of
    `kernels` in them, in percent."""
    tr = ctx.trace
    if tr is None or not tr.work:
        return None
    busy = tr.device_seconds(kernel_matcher(kernels))
    if busy <= 0:
        return None
    least = 0.0
    for w in tr.work:
        b, f = work(Work(**w))
        least += least_seconds(b, f, H100_SXM)
    if least <= 0:
        return None
    return 100.0 * least / busy


def span_median(ctx, stage: str, scale: float = 1.0) -> Optional[float]:
    vals: List[float] = [s.spans[stage] for s in ctx.samples
                         if stage in s.spans]
    return statistics.median(vals) * scale if vals else None
