"""Median EM rounds per sample (EMResult.rounds: the 10 model-update rounds
and the theta-only rounds to RSEM's stop rule): how much the theta loop
works."""

import statistics


def read(ctx):
    r = [s.rounds for s in ctx.samples]
    return statistics.median(r) if r else None
