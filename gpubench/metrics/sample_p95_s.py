"""95th percentile of the wall times of all samples of the window (numpy's
linear interpolation): the stalls a mean hides. A 51 s window holds some
two hundred samples of a single cell, ten or more of them beyond it."""

import numpy as np


def read(ctx):
    t = [s.seconds for s in ctx.samples]
    return float(np.percentile(t, 95)) if t else None
