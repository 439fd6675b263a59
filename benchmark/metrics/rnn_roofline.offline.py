"""The recurrent layers' kernels (K1 or K7 with their affines) against
their roofline, in percent: the least time of the traced jobs' launches
(valid rows and steps) over the profiled time of ``cluster_rnn_kernel``
and ``affine_kernel``."""

from benchmark.harness import yardstick
from benchmark.harness.readers import RNN_KERNELS, roofline


def read(ctx):
    return roofline(ctx, yardstick.rnn_bound_s, RNN_KERNELS)
