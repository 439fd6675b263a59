"""The traced stretch of a ``--trace 1`` run: torch.profiler over whole
jobs, with the program's host phases marked in the trace,
reduced to device busy time, kernel time by name, and idle gaps named by
the host phase open across them.

The program brackets its host phases with ``flappie_tpu_torch.timing
.phase(name)``.  While the stretch is traced, that function is wrapped
so that each phase, on any thread, is also kept as a span on the host
clock; one ``record_function`` marker over the stretch ties the host
clock to the profiler's, so the spans and the device's activity share a
timeline.
"""

from __future__ import annotations

import bisect
import contextlib
import re
import time
from types import SimpleNamespace
from typing import Dict, List, Optional, Tuple

WINDOW_MARK = "bench:traced"


@contextlib.contextmanager
def traced():
    """Profile the block (host and device activity) with the program's
    phases marked; yields a holder whose ``.prof`` is the profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from flappie_tpu_torch import timing

    plain = timing.phase
    spans: List[Tuple[float, float, str]] = []

    @contextlib.contextmanager
    def marked(name):
        t0 = time.perf_counter()
        try:
            with plain(name):
                yield
        finally:
            spans.append((t0, time.perf_counter(), name))

    holder = SimpleNamespace(spans=spans)
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
    timing.phase = marked
    try:
        with profile(activities=acts) as prof:
            with record_function(WINDOW_MARK):
                holder.t0 = time.perf_counter()
                yield holder
            if torch.cuda.is_available():
                torch.cuda.synchronize()
    finally:
        timing.phase = plain
    holder.prof = prof


def short_name(name: str) -> str:
    """A kernel's name without its return type, template arguments and
    parameters: ``void cluster_rnn_kernel<...>(...)`` ->
    ``cluster_rnn_kernel``."""
    base = re.sub(r"\(.*$", "", name.replace("(anonymous namespace)::", ""))
    depth, out = 0, []
    for ch in base:
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth -= 1
        elif depth == 0:
            out.append(ch)
    short = "".join(out).strip()
    return short[len("void "):] if short.startswith("void ") else short or name


def reduce(holder) -> Optional[dict]:
    """{busy_s, window_s, device_s: {short name: s}, idle_gaps: {phase:
    s}} of the traced stretch, or None where the device recorded
    nothing."""
    from torch.autograd import DeviceType

    window = None
    device: List[Tuple[float, float, str]] = []
    for e in holder.prof.events():
        t0, t1 = e.time_range.start, e.time_range.end
        if e.device_type == DeviceType.CUDA:
            # the marker is also drawn on the device's timeline: no work
            if e.name != WINDOW_MARK:
                device.append((t0, t1, e.name))
        elif e.name == WINDOW_MARK:
            window = (t0, t1)
    if not device or window is None:
        return None
    # the phases' host-clock spans on the profiler's clock (microseconds)
    phases = [(window[0] + (s0 - holder.t0) * 1e6, window[0] + (s1 - holder.t0) * 1e6, name)
              for s0, s1, name in holder.spans]
    device.sort()
    by_name: Dict[str, float] = {}
    busy, end = 0.0, float("-inf")
    gaps = []
    cursor = window[0]
    for t0, t1, name in device:
        by_name[short_name(name)] = by_name.get(short_name(name), 0.0) + (t1 - t0) * 1e-6
        lo = max(t0, end)
        busy += max(0.0, t1 - lo)
        if t0 > cursor:
            gaps.append((cursor, min(t0, window[1])))
        cursor = max(cursor, t1)
        end = max(end, t1)
    if window[1] > cursor:
        gaps.append((cursor, window[1]))
    idle: Dict[str, float] = {}
    phases.sort()
    starts = [p[0] for p in phases]
    for g0, g1 in gaps:
        if g1 <= g0:
            continue
        mid = 0.5 * (g0 + g1)
        # the innermost phase open at the gap's middle: the latest to start
        name = "outside any phase"
        for k in range(bisect.bisect_right(starts, mid) - 1, -1, -1):
            if phases[k][1] >= mid:
                name = phases[k][2]
                break
        idle[name] = idle.get(name, 0.0) + (g1 - g0) * 1e-6
    return {"busy_s": busy * 1e-6, "window_s": (window[1] - window[0]) * 1e-6,
            "device_s": by_name, "idle_gaps": idle}


def kernel_s(red: Optional[dict], names) -> float:
    """Device seconds of the kernels whose short names, without their
    namespace, are in ``names``."""
    if red is None:
        return 0.0
    return sum(s for k, s in red["device_s"].items() if k.rsplit("::", 1)[-1] in names)


def breakdown(red: Optional[dict]) -> Optional[dict]:
    if red is None:
        return None
    top = sorted(red["device_s"].items(), key=lambda kv: -kv[1])[:10]
    gaps = sorted(red["idle_gaps"].items(), key=lambda kv: -kv[1])[:10]
    return {"device_ops": [[k, v] for k, v in top], "idle_gaps": [[k, v] for k, v in gaps]}
