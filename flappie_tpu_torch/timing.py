"""Per-phase wall-clock accounting for the production pipeline.

A copy of the JAX package's timing module (stdlib only).  The pipeline
brackets its phases (fast5 read, preprocess, pack, dispatch with its
upload and launch, collect wait, collect host, format) with
``phase(name)``, and ``report()`` returns the accumulated seconds per
phase.  ``maybe_dump()`` writes the report as JSON when
FLAPPIE_TPU_PHASES names a path (or prints to stderr for "stderr") --
the flappie CLI calls it at exit and flappie-serve at server exit, so
any run can account for its host's share of the wall with one env var.

Accumulation is always on: one perf_counter pair per *batch-level*
call, nanoseconds against millisecond phases.  Phases nest (inner
phases also accrue inside outer ones -- e.g. dispatch_upload inside
dispatch) and overlap across threads (preprocessing runs on its own);
the report states wall per phase, not a disjoint partition.
"""

from __future__ import annotations

import os
import sys
import threading
import time
from collections import defaultdict
from contextlib import contextmanager

_acc: dict = defaultdict(float)
_calls: dict = defaultdict(int)
_t0 = time.perf_counter()
# phases accrue from more than one thread (wave-streamed preprocessing
# brackets its phase on a background thread); += on a dict entry is a
# read-modify-write that can drop an update without this lock
_lock = threading.Lock()


@contextmanager
def phase(name: str):
    t = time.perf_counter()
    try:
        yield
    finally:
        add(name, time.perf_counter() - t)


def add(name: str, seconds: float) -> None:
    with _lock:
        _acc[name] += seconds
        _calls[name] += 1


def reset() -> None:
    global _t0
    with _lock:
        _acc.clear()
        _calls.clear()
        _t0 = time.perf_counter()


def report() -> dict:
    total = time.perf_counter() - _t0
    with _lock:  # a background phase may still be accruing at exit
        items = sorted(_acc.items(), key=lambda kv: -kv[1])
        calls = dict(_calls)
    out = {
        "process_wall_s": round(total, 3),
        "phases": {
            k: {"wall_s": round(v, 3), "calls": calls[k]}
            for k, v in items
        },
    }
    accounted = sum(v for k, v in items if not k.startswith("_"))
    out["accounted_s"] = round(accounted, 3)
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
