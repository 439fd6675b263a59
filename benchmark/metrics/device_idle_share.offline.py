"""Share of the traced stretch (whole jobs) in which no operation ran
on the card (torch.profiler's CUDA activity), in percent."""

from benchmark.harness.readers import idle_share


def read(ctx):
    return idle_share(ctx)
