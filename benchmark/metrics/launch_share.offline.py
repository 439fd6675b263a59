"""Share of the window in the program's ``dispatch_launch`` phase
(basecall.py: Python issuing a batch's kernels), in percent."""

from benchmark.harness.readers import phase_share


def read(ctx):
    return phase_share(ctx, ["dispatch_launch"])
