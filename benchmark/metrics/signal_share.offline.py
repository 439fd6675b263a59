"""Share of the window in the program's ``fast5_read`` and
``preprocess`` phases (signal/fast5.py, signal/preprocess.py; on the
preprocessing thread), their walls added, in percent."""

from benchmark.harness.readers import phase_share


def read(ctx):
    return phase_share(ctx, ["fast5_read", "preprocess"])
