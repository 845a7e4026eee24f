"""Share of its roofline of the model-update rounds' device work: the least
time of the work the sample defines (yardstick.work.model_loop: per round
and hit its record, the read's bases and qualities and the reference span,
per read its bases for the noise profile, the tables once) over the device
time of the kernels named here in the traced samples: K4's PreIdx build,
K2's gather-sum, K3's scatter-add, and ATen's float64 `index_add_`, which
a sample runs in its model rounds alone (each round's per-read
denominators, expected counts, and fragment-length and read-start
statistics). The rounds' elementwise PyTorch ops are not named: their
kernels are shared with other stages, and only ranges inside the program
could tell them apart."""

from gpubench.readers import roofline
from gpubench.yardstick.work import model_loop

KERNELS = ["preidx_kernel", "gather_sum_kernel", "scatter_add_kernel",
           "indexFuncLargeIndex<double", "indexFuncSmallIndex<double"]


def read(ctx):
    return roofline(ctx, KERNELS, model_loop)
