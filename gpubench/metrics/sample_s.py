"""Wall time per sample: the window's host-clock length over the samples it
completed (the sample in flight when the window ran out is finished and
counted). What a pipeline pays per sample."""


def read(ctx):
    return ctx.window_s / len(ctx.samples) if ctx.samples else None
