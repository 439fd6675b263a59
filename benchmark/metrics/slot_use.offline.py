"""The samples the batches packed in the window own (a chunk row's owned
blocks times the stride, a bucket row's length) over their slots (rows
times the row's width in samples), in percent: what dummy rows, chunk
overlap and bucket padding leave of the card's work.  The program's
counters at its pack spans; None where it keeps none."""

from benchmark.harness.program_spans import program_counters


def read(ctx):
    c = program_counters(ctx)
    return None if not c or not c.get("slots") else 100.0 * c["owned"] / c["slots"]
