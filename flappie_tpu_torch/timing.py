"""Per-phase wall-clock accounting and spans for the production pipeline.

The JAX package's timing module, extended.  The pipeline brackets its
phases (fast5 read, preprocess, the wait for a preprocessing wave, pack,
dispatch with its upload and launch, collect wait, collect host, format)
with ``phase(name)``, and ``report()`` returns the accumulated seconds
per phase.  ``maybe_dump()`` writes the report as JSON when
FLAPPIE_TPU_PHASES names a path (or prints to stderr for "stderr") --
the flappie CLI calls it at exit and flappie-serve at server exit, so
any run can account for its host's share of the wall with one env var.

Accumulation is always on: one perf_counter pair per *batch-level*
call, nanoseconds against millisecond phases.  Phases nest (inner
phases also accrue inside outer ones -- e.g. dispatch_upload inside
dispatch) and overlap across threads (preprocessing runs on its own);
the report states wall per phase, not a disjoint partition.

Beyond the JAX module, each ``phase`` call also keeps a span (``Span``:
name, thread, start and end on ``time.perf_counter``, the innermost span
open on the same thread as its parent, the thread's CPU seconds over it,
and the ``job`` and ``batch`` ids in force), in one list of at most
``MAX_SPANS`` (later spans are counted as dropped).  Ids live in a
thread-local context: ``job()`` around one ``basecall_raw_tables`` call,
``batch()`` around one packed batch, ``carry(fn)`` to take them to the
thread that runs ``fn``.  ``count(...)`` adds a batch's counters (rows,
valid rows, slots, owned samples) to the span open on the thread and to
the process's sums.  ``on_device(t0, t1, ...)`` keeps a batch's time in
flight on the card, read from CUDA events at collection and mapped onto
the same clock.  ``idle(t0, t1)`` names the card's idle time by the
phase of the thread that fed it; ``report()`` gains ``phase_cpu_s``,
``device``, ``counters`` and ``spans``.
"""

from __future__ import annotations

import bisect
import itertools
import os
import sys
import threading
import time
from collections import defaultdict
from contextlib import contextmanager
from typing import Dict, List, Optional

_acc: dict = defaultdict(float)
_calls: dict = defaultdict(int)
_cpu: dict = defaultdict(float)
_counts: dict = defaultdict(int)
_t0 = time.perf_counter()
# phases accrue from more than one thread (wave-streamed preprocessing
# brackets its phase on a background thread); += on a dict entry is a
# read-modify-write that can drop an update without this lock
_lock = threading.Lock()

# spans kept in memory (~200 bytes a span, ~0.2 GB at the bound): a 51-s
# window of the main path keeps ~10^4; a long-lived server stops keeping
# at the bound
MAX_SPANS = 1 << 20
ON_DEVICE = "on_device"
OUTSIDE = "outside any phase"
COUNTERS = ("rows", "rows_valid", "slots", "owned")

_spans: list = []
_jobs: list = []
_dropped = [0]
_local = threading.local()  # .state: the thread's _State
_job_ids = itertools.count(1)
_batch_ids = itertools.count(1)


class Span:
    """One phase call (or a batch's time in flight, ``name`` ON_DEVICE,
    with ``device`` set and no thread).  ``t1`` is None while it is open;
    it is kept once it closes."""

    __slots__ = ("name", "thread", "thread_name", "t0", "t1", "parent", "cpu_s", "job",
                 "batch", "counts", "device")

    def __init__(self, name, thread, thread_name, t0, parent, job, batch, device=None):
        self.name, self.thread, self.thread_name = name, thread, thread_name
        self.t0, self.t1, self.parent = t0, None, parent
        self.cpu_s, self.job, self.batch = None, job, batch
        self.counts, self.device = None, device


class _State:
    """A thread's open spans (innermost last), its name and its ids."""

    __slots__ = ("stack", "ident", "name", "job", "batch")

    def __init__(self):
        th = threading.current_thread()
        self.stack, self.ident, self.name = [], th.ident, th.name
        self.job = self.batch = None


def _state() -> _State:
    try:
        return _local.state
    except AttributeError:
        st = _local.state = _State()
        return st


def _keep(rec, into: list) -> None:
    """Append ``rec`` (caller holds ``_lock``) unless the bound is met."""
    if len(_spans) + len(_jobs) < MAX_SPANS:
        into.append(rec)
    else:
        _dropped[0] += 1


@contextmanager
def phase(name: str):
    st = _state()
    stack = st.stack
    c = time.thread_time()
    t = time.perf_counter()
    sp = Span(name, st.ident, st.name, t, stack[-1] if stack else None, st.job, st.batch)
    stack.append(sp)
    try:
        yield
    finally:
        sp.t1 = t1 = time.perf_counter()
        sp.cpu_s = cpu = time.thread_time() - c
        stack.pop()
        with _lock:  # kept as it closes: one lock a call
            _acc[name] += t1 - t
            _calls[name] += 1
            _cpu[name] += cpu
            _keep(sp, _spans)


def add(name: str, seconds: float) -> None:
    with _lock:
        _acc[name] += seconds
        _calls[name] += 1


# -- ids ---------------------------------------------------------------------


def current_ids() -> dict:
    """The ids in force on this thread: {"job": ..., "batch": ...}."""
    st = _state()
    return {"job": st.job, "batch": st.batch}


@contextmanager
def ids(job=None, batch=None):
    """Set this thread's ``job`` and ``batch`` ids inside the block (both:
    an id not given is None there)."""
    st = _state()
    before = st.job, st.batch
    st.job, st.batch = job, batch
    try:
        yield
    finally:
        st.job, st.batch = before


@contextmanager
def job():
    """A new job id in force inside the block (one ``basecall_raw_tables``
    call), its thread and its span of time kept in ``jobs()``."""
    th = threading.current_thread()
    rec = {"job": next(_job_ids), "thread": th.ident, "thread_name": th.name,
           "t0": time.perf_counter(), "t1": None}
    with _lock:
        _keep(rec, _jobs)
    try:
        with ids(job=rec["job"]):
            yield rec["job"]
    finally:
        rec["t1"] = time.perf_counter()


@contextmanager
def batch():
    """A new batch id in force inside the block, under the job in force."""
    b = next(_batch_ids)
    with ids(job=_state().job, batch=b):
        yield b


def carry(fn):
    """``fn`` wrapped to run under the ids in force here, on whichever
    thread later calls it."""
    held = current_ids()

    def run(*args, **kw):
        with ids(**held):
            return fn(*args, **kw)

    return run


def count(**kw) -> None:
    """Add a packed batch's counters (``COUNTERS``) to the span open on
    this thread and to the process's sums."""
    stack = _state().stack
    if stack:
        stack[-1].counts = dict(kw)
    with _lock:
        _counts["batches"] += 1
        for k, v in kw.items():
            _counts[k] += int(v)


def on_device(t0: float, t1: float, device: str, job=None, batch=None) -> None:
    """Keep a batch's time in flight on ``device``, [t0, t1] on
    perf_counter's clock."""
    sp = Span(ON_DEVICE, None, None, t0, None, job, batch, device)
    sp.t1 = t1
    with _lock:
        _keep(sp, _spans)


# -- reading -----------------------------------------------------------------


def spans() -> List[Span]:
    """The spans kept since ``reset()`` (each kept as it closes), in the
    order they opened."""
    with _lock:
        kept = list(_spans)
    return sorted(kept, key=lambda s: (s.t0, -s.t1))  # a parent before its child


def jobs() -> List[dict]:
    """The jobs opened since ``reset()``: {job, thread, thread_name, t0, t1}."""
    with _lock:
        return [dict(j) for j in _jobs]


def counters(t0: float = 0.0, t1: Optional[float] = None) -> dict:
    """The counters of the batches packed in [t0, t1] (seconds since
    ``reset()``; t1 None: now), summed from their spans."""
    a, b = _t0 + t0, (_t0 + t1) if t1 is not None else float("inf")
    out = dict.fromkeys(("batches",) + COUNTERS, 0)
    for sp in spans():
        if sp.counts is not None and a <= sp.t0 <= b:
            out["batches"] += 1
            for k, v in sp.counts.items():
                out[k] = out.get(k, 0) + v
    return out


def _gaps(dev: list, a: float, b: float):
    """The stretches of [a, b] with no batch in flight (``dev``: on_device
    spans by start): (start, end, the batch whose start ends it or None),
    and the seconds in flight."""
    gaps, busy, cursor = [], 0.0, a
    for s in dev:
        if s.t1 <= cursor:
            continue
        if s.t0 > cursor:
            if cursor < b:
                gaps.append((cursor, min(s.t0, b), s.batch))
            cursor = s.t0
        end = min(s.t1, b)
        if end > cursor:
            busy += end - cursor
        cursor = max(cursor, s.t1)
        if cursor >= b:
            break
    if cursor < b:
        gaps.append((cursor, b, None))
    return gaps, busy


class _Thread:
    """One thread's phase spans, ordered by start (a child after its
    parent), for innermost-span lookups."""

    def __init__(self, spans_):
        self.spans = spans_
        self.starts = [s.t0 for s in spans_]
        self.ends = [s.t1 for s in spans_]
        self.reach = list(itertools.accumulate(self.ends, max))

    def split(self, g0: float, g1: float, out: dict) -> None:
        """Add [g0, g1] to ``out`` by the innermost span open at each
        instant (OUTSIDE where none is)."""
        cand = []
        j = bisect.bisect_left(self.starts, g1) - 1
        while j >= 0 and self.reach[j] > g0:
            if self.ends[j] > g0:
                cand.append(j)
            j -= 1
        pts = sorted({g0, g1} | {max(g0, self.starts[j]) for j in cand}
                     | {min(g1, self.ends[j]) for j in cand})
        for lo, hi in zip(pts, pts[1:]):
            mid = 0.5 * (lo + hi)
            # the latest to open of those open at mid is the innermost
            inner = max((j for j in cand if self.starts[j] <= mid < self.ends[j]), default=None)
            name = OUTSIDE if inner is None else self.spans[inner].name
            out[name] = out.get(name, 0.0) + (hi - lo)


def _device_view(t0: float, t1: Optional[float]):
    a, b = _t0 + t0, (_t0 + t1) if t1 is not None else time.perf_counter()
    kept = spans()
    dev = [s for s in kept if s.name == ON_DEVICE]
    if not dev:
        return None
    gaps, busy = _gaps(dev, a, b)
    by_thread: Dict[int, list] = defaultdict(list)
    packer = {}
    for s in kept:
        if s.name == ON_DEVICE:
            continue
        by_thread[s.thread].append(s)
        if s.name == "pack" and s.batch is not None:
            packer.setdefault(s.batch, s.thread)
    threads: Dict[int, _Thread] = {}
    callers = sorted(jobs(), key=lambda j: j["t0"])
    idle_s: dict = {}
    for g0, g1, nxt in gaps:
        th = packer.get(nxt)
        if th is None:  # no next batch: the thread that called basecall_raw_tables
            before = [j for j in callers if j["t0"] <= g1]
            th = (before[-1] if before else callers[0])["thread"] if callers else None
        if th not in by_thread:
            idle_s[OUTSIDE] = idle_s.get(OUTSIDE, 0.0) + (g1 - g0)
            continue
        if th not in threads:
            threads[th] = _Thread(by_thread[th])
        threads[th].split(g0, g1, idle_s)
    return {"in_flight_s": busy, "idle_s": idle_s}


def idle(t0: float = 0.0, t1: Optional[float] = None) -> Optional[dict]:
    """{phase: seconds} of [t0, t1] (seconds since ``reset()``; t1 None:
    now) in which no batch was in flight on any device.  Each gap goes,
    time-weighted, to the innermost spans of the thread that packed the
    batch that ends it (a gap with no next batch: the thread that called
    ``basecall_raw_tables``), OUTSIDE where that thread had none open.
    None where no batch has run on a device since ``reset()``."""
    view = _device_view(t0, t1)
    return None if view is None else view["idle_s"]


def in_flight(t0: float = 0.0, t1: Optional[float] = None) -> Optional[float]:
    """Seconds of [t0, t1] with a batch in flight on some device (None as
    ``idle``)."""
    view = _device_view(t0, t1)
    return None if view is None else view["in_flight_s"]


def reset() -> None:
    global _t0
    with _lock:
        _acc.clear()
        _calls.clear()
        _cpu.clear()
        _counts.clear()
        _spans.clear()
        _jobs.clear()
        _dropped[0] = 0
        _t0 = time.perf_counter()


def report() -> dict:
    total = time.perf_counter() - _t0
    with _lock:  # a background phase may still be accruing at exit
        items = sorted(_acc.items(), key=lambda kv: -kv[1])
        calls = dict(_calls)
        cpu = sorted(_cpu.items(), key=lambda kv: -kv[1])
        counts = dict(_counts)
        kept, dropped = len(_spans), _dropped[0]
    out = {
        "process_wall_s": round(total, 3),
        "phases": {
            k: {"wall_s": round(v, 3), "calls": calls[k]}
            for k, v in items
        },
    }
    accounted = sum(v for k, v in items if not k.startswith("_"))
    out["accounted_s"] = round(accounted, 3)
    # the port's additions
    out["phase_cpu_s"] = {k: round(v, 3) for k, v in cpu}
    view = _device_view(0.0, None)
    out["device"] = None if view is None else {
        "in_flight_s": round(view["in_flight_s"], 3),
        "idle_s": {k: round(v, 3) for k, v in sorted(view["idle_s"].items(),
                                                     key=lambda kv: -kv[1])}}
    out["counters"] = {k: counts.get(k, 0) for k in ("batches",) + COUNTERS}
    out["spans"] = {"kept": kept, "dropped": dropped}
    return out


def maybe_dump() -> None:
    """Write the report if FLAPPIE_TPU_PHASES is set (path or 'stderr')."""
    dest = os.environ.get("FLAPPIE_TPU_PHASES")
    if not dest:
        return
    import json

    rep = report()
    if dest == "stderr":
        print(f"flappie-phases: {json.dumps(rep)}", file=sys.stderr)
    else:
        with open(dest, "w") as fh:
            json.dump(rep, fh, indent=1)
