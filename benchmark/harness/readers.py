"""What the per-layer metric readers (``metrics/<name>.py``) share.

A reader gets ``ctx``: ``win`` (the window's record: ``window_s``,
``phase_s`` by program phase), ``profile`` (the traced stretch reduced,
or None), ``traced_reads`` (the read indices of each traced job),
``inputs``, ``cell`` and ``peak``.
"""

from __future__ import annotations

from . import profile, yardstick
from ..reference import signal

RNN_KERNELS = ("cluster_rnn_kernel", "affine_kernel")
CRF_KERNELS = ("crf_sum_kernel", "crf_fwdbwd_kernel", "crf_viterbi_kernel", "traceback_kernel")


def phase_share(ctx, names) -> float:
    """Percent of the window that the program's phases ``names`` were
    open (their walls added: phases on other threads overlap them)."""
    got = [ctx.win["phase_s"][n] for n in names if n in ctx.win["phase_s"]]
    if not got:
        return None
    return 100.0 * sum(got) / ctx.win["window_s"]


def trimmed(ctx, i: int) -> int:
    """Read i's samples after trimming (the reference's trim), cached."""
    cache = ctx.__dict__.setdefault("_trimmed", {})
    if i not in cache:
        from .fast5 import CHANNEL

        d = ctx.cell.config["decode"]
        raw = signal.scale_to_pA(ctx.inputs.reads[i].adc, CHANNEL["offset"], CHANNEL["range"],
                                 CHANNEL["digitisation"])
        win = signal.trim(raw, *d["trim"], *d["segmentation"])
        cache[i] = 0 if win is None else win[1] - win[0]
    return cache[i]


def roofline(ctx, bound_fn, kernels) -> float:
    """Percent: the least time of the traced jobs' launches over the
    profiled time of ``kernels``."""
    took = profile.kernel_s(ctx.profile, kernels)
    if not took or not ctx.traced_reads:
        return None
    widths, decode = ctx.cell.config["widths"], ctx.cell.config["decode"]
    least = sum(bound_fn(yardstick.launches([trimmed(ctx, i) for i in job], widths, decode),
                         widths, ctx.peak) for job in ctx.traced_reads)
    return 100.0 * least / took


def idle_share(ctx) -> float:
    p = ctx.profile
    if p is None or p["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - p["busy_s"] / p["window_s"])
