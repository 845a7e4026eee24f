"""Share of the traced samples' host-clock time in which no device activity
ran (1 - union of kernels, copies and sets / window), in percent."""


def read(ctx):
    tr = ctx.trace
    if tr is None or tr.window_s <= 0 or not tr.events:
        return None
    return 100.0 * max(0.0, 1.0 - tr.busy_s() / tr.window_s)
