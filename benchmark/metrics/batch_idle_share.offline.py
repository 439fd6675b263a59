"""Share of the window in which no batch was in flight on the card, in
percent: the program's own record (``flappie_tpu_torch.timing``), each
batch in flight from a CUDA event before its upload to the event after
its output copy, over the whole window (not only the traced jobs).
None where the program keeps no such record (the CPU, or a program
without it)."""

from benchmark.harness.program_spans import program_idle


def read(ctx):
    idle = program_idle(ctx)
    return None if idle is None else 100.0 * sum(idle.values()) / ctx.win["window_s"]
