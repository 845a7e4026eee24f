"""Median host time of engine.em.run_em over the window's samples (it
returns host arrays, so the clock is synchronised)."""

from gpubench.readers import span_median


def read(ctx):
    return span_median(ctx, "em")
