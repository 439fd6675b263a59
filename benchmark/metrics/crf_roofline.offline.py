"""The CRF kernels (K3/K4, K5, K6) against their roofline, in percent:
the least time of the traced jobs' launches (valid rows and steps) over
the profiled time of the scan and traceback kernels."""

from benchmark.harness import yardstick
from benchmark.harness.readers import CRF_KERNELS, roofline


def read(ctx):
    return roofline(ctx, yardstick.crf_bound_s, CRF_KERNELS)
