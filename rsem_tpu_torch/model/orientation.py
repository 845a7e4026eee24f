"""Strand orientation prior (reference: Orientation.h)."""

from __future__ import annotations

import numpy as np


class Orientation:
    def __init__(self, probF: float = 0.5):
        self.prob = np.array([probF, 1.0 - probF])

    def get_prob(self, direction: int) -> float:
        return float(self.prob[direction])

    def write(self, fo):
        fo.write(f"{self.prob[0]:.10g}\n")

    @classmethod
    def from_tokens(cls, tok) -> "Orientation":
        return cls(float(next(tok)))
