"""What the per-layer readers of the program's own record share: its
spans and counters (``flappie_tpu_torch.timing``) over the measured
window, which opens at the loop's ``timing.reset()`` and lasts
``ctx.win["window_s"]``.

A program without that record (one older than its spans, or its
``timing`` without ``idle`` and ``counters``) gives None, and so does a
run in which no batch ran on a card (``idle`` is None there).
"""

from __future__ import annotations

from typing import Optional


def _timing():
    from flappie_tpu_torch import timing

    return timing


def program_idle(ctx) -> Optional[dict]:
    """{phase: seconds} of the window with no batch in flight, named by
    the program (``timing.idle``), computed once a run."""
    cache = ctx.__dict__.setdefault("_program", {})
    if "idle" not in cache:
        fn = getattr(_timing(), "idle", None)
        cache["idle"] = None if fn is None else fn(0.0, ctx.win["window_s"])
    return cache["idle"]


def program_counters(ctx) -> Optional[dict]:
    """The counters of the batches packed in the window
    (``timing.counters``)."""
    fn = getattr(_timing(), "counters", None)
    return None if fn is None else fn(0.0, ctx.win["window_s"])
