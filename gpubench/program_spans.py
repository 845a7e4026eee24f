"""The program's own spans in the traced samples.

While torch.profiler records, `rsem_tpu_torch.utils.timing.span` enters a
`record_function` range of the span's name, so the host trace of the
traced samples (`trace.Trace.host`) holds every `rsem.` range on the
profiler's clock. Each traced sample's `run_em` is one `rsem.em` range;
the `rsem.` ranges inside it nest into a tree. The readers of the EM's
phases take one number from each traced sample's tree and report the
median; they time the program under the profiler, which adds its own
cost to each range (PERF.md gives it). A program without such spans (a
commit before them) leaves no `rsem.` range, and the readers then return
None.
"""

from __future__ import annotations

import statistics
from dataclasses import dataclass, field
from typing import Callable, Iterator, List, Optional

PREFIX = "rsem."


@dataclass
class Node:
    name: str
    start: float  # seconds, profiler clock
    end: float
    kids: List["Node"] = field(default_factory=list)

    @property
    def seconds(self) -> float:
        return self.end - self.start

    def self_seconds(self) -> float:
        """Duration less that of the `rsem.` ranges directly inside."""
        return self.seconds - sum(k.seconds for k in self.kids)

    def walk(self) -> Iterator["Node"]:
        yield self
        for k in self.kids:
            yield from k.walk()

    def total(self, name: str) -> float:
        return sum(n.seconds for n in self.walk() if n.name == name)


def em_trees(ctx) -> List[Node]:
    """One tree of `rsem.` ranges per traced run_em, in trace order."""
    tr = ctx.trace
    if tr is None:
        return []
    evs = sorted((h for h in tr.host if h.name.startswith(PREFIX)),
                 key=lambda h: (h.start, -h.end))
    roots: List[Node] = []
    stack: List[Node] = []
    for h in evs:
        n = Node(h.name, h.start, h.end)
        while stack and h.start >= stack[-1].end:
            stack.pop()
        (stack[-1].kids if stack else roots).append(n)
        stack.append(n)
    return [r for r in roots if r.name == "rsem.em"]


def median_over_samples(ctx, one: Callable[[Node, int], Optional[float]]
                        ) -> Optional[float]:
    """Median of one(tree, k) over the traced samples' trees (k is the
    sample's index among the traced ones), None values left out."""
    vals = [v for k, t in enumerate(em_trees(ctx))
            if (v := one(t, k)) is not None]
    return statistics.median(vals) if vals else None
