"""Median host time of the model's set-up (a fresh GenerativeModel and
estimate_from_stats, float64 on the host) over the window's samples."""

from gpubench.readers import span_median


def read(ctx):
    return span_median(ctx, "model_init", 1e3)
