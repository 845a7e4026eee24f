"""How long the host waits on its reads of device memory per traced
sample: the total of the program's `rsem.sync` spans (every fetch of a
device tensor to the host, which waits for the work producing it),
under the profiler."""

from gpubench.program_spans import median_over_samples


def read(ctx):
    return median_over_samples(
        ctx, lambda t, _k: 1e3 * t.total("rsem.sync") or None)
