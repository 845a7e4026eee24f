"""Share of its roofline of the theta loop's kernel K1 (csrc/theta_round.cu):
the least time of the theta-only rounds and the final count as the sample
defines them (yardstick.work.theta_loop: per round and hit its conprb and
transcript id, theta once) over the device time of K1's kernels in the
traced samples. Rounds enqueued past the stop count as device time, not as
work."""

from gpubench.readers import roofline
from gpubench.yardstick.work import theta_loop

KERNELS = ["reads_kernel", "counts_kernel", "mstep_kernel", "total_kernel"]


def read(ctx):
    return roofline(ctx, KERNELS, theta_loop)
