"""Share of the window in which the card was idle while the thread that
fed it was collecting a batch's output on the host (the program's
``collect_host`` span: unpacking and assembling reads), in percent.
None as ``batch_idle_share``."""

from benchmark.harness.program_spans import program_idle


def read(ctx):
    idle = program_idle(ctx)
    return None if idle is None else 100.0 * idle.get("collect_host", 0.0) / ctx.win["window_s"]
