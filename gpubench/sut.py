"""The system under test's shared types: one parsed sample as the program
holds it (`Inputs`), what one pass over it produced (`Sample`), and the
span every stage of a path runs inside (`_span`). What a pass runs is the
configuration's path's (`paths/<name>.py`).

Each stage runs inside a `torch.profiler.record_function` span of its own
name, which the traced run's breakdown labels idle gaps with, and its host
time is kept (`Sample.spans`).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict

import numpy as np
from torch.profiler import record_function


@dataclass
class Inputs:
    """One distinct sample as calculate-expression holds it after the parse."""

    index: int
    ref: object  # refprep.Reference
    gi: object  # refprep.transcripts.GroupInfo
    spec: object  # model.ModelSpec
    bundle: object  # io.AlignmentBundle
    tlens: np.ndarray  # [M+1] transcript lengths


@dataclass
class Sample:
    """What one pass produced: host spans, counters and the values the
    comparison judges."""

    index: int
    seconds: float
    spans: Dict[str, float] = field(default_factory=dict)
    rounds: int = 0
    peak_bytes: int = 0
    values: Dict[str, np.ndarray] = field(default_factory=dict)


def _span(spans: Dict[str, float], name: str):
    class _S:
        def __enter__(self):
            self.rf = record_function(f"gpubench.{name}")
            self.rf.__enter__()
            self.t = time.perf_counter()

        def __exit__(self, *exc):
            spans[name] = time.perf_counter() - self.t
            self.rf.__exit__(*exc)
            return False

    return _S()
