"""Rate of the layout's upload: the host bytes the program's layout copies
to the card per run_em (its `upload_bytes` counter over `em_calls`, over
every sample of the run: each sample clears the layout cache, and the
samples of a cell differ in size by a fraction of a percent), over the
median duration of its `rsem.em.upload` span in the traced samples, under
the profiler, in GB/s."""

from gpubench.program_spans import median_over_samples


def read(ctx):
    try:
        from rsem_tpu_torch.utils.timing import counters
    except ImportError:
        return None
    c = counters()
    if not c.get("em_calls") or not c.get("upload_bytes"):
        return None
    s = median_over_samples(
        ctx, lambda t, _k: t.total("rsem.em.upload") or None)
    return c["upload_bytes"] / c["em_calls"] / s / 1e9 if s else None
