"""Share of the window in which the card was idle while the thread that
fed it waited for a preprocessing wave (the program's ``wave_wait``
span), in percent: the idle time that faster reading or preprocessing
would remove.  None as ``batch_idle_share``."""

from benchmark.harness.program_spans import program_idle


def read(ctx):
    idle = program_idle(ctx)
    return None if idle is None else 100.0 * idle.get("wave_wait", 0.0) / ctx.win["window_s"]
