"""Largest device memory peak of one sample of the window
(torch.cuda.max_memory_allocated after reset_peak_memory_stats), GiB."""


def read(ctx):
    p = [s.peak_bytes for s in ctx.samples if s.peak_bytes]
    return max(p) / 2**30 if p else None
