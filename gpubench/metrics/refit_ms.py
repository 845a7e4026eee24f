"""Host time of the model's refit per traced sample: the total of the
program's `rsem.em.refit` spans (the float64 refit from the model rounds'
statistics and the refit tables' copy to the card), under the profiler."""

from gpubench.program_spans import median_over_samples


def read(ctx):
    return median_over_samples(
        ctx, lambda t, _k: 1e3 * t.total("rsem.em.refit") or None)
