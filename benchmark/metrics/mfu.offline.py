"""The whole step's share of the card's f32 peak, in percent: the model
operations of every read of every job in the window, each read's blocks
once (no overlap), over the window, over the f32 peak (these
configurations run no tensor core)."""

from benchmark.harness import yardstick
from benchmark.harness.readers import trimmed


def read(ctx):
    jobs = ctx.win.get("job_reads")
    if not jobs:
        return None
    widths = ctx.cell.config["widths"]
    ops = sum(yardstick.model_ops(widths, trimmed(ctx, i)) for job in jobs for i in job)
    return 100.0 * ops / ctx.win["window_s"] / ctx.peak["f32_ops"]
