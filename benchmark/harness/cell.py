"""One run of one cell: set-up, the measured window, the traced stretch
(``--trace 1``), the comparison with the reference, the result line.

The mix's ``loop`` names the module that drives the program
(``loops/<loop>.py``: ``Loop`` with ``warm``, ``window``,
``traced_stretch``, ``sample``, ``records``, ``close``); the
configuration's ``reference`` names its family's plain reference
(``reference/<family>.py``: ``make_params``, ``checkpoint``,
``records``).

``run`` takes ``device`` and ``adjust`` for the harness's own tests: on
the CPU it skips the look for a card, and ``adjust(cell)`` may shrink
the cell's traffic and decode sizes so that a test can hold them.
"""

from __future__ import annotations

import gc
import json
import shutil
import sys
import tempfile
import time
from types import SimpleNamespace
from typing import Callable, Optional

from . import check, env, fast5, spec, traffic, yardstick


def family(cell):
    """The configuration's reference module (``reference/<family>.py``)."""
    return spec.module("reference", cell.config["reference"])


def reference_records(cell, inputs, params, idx, device, precision="f32") -> dict:
    """The plain reference's records of reads ``idx``."""
    reads = [(inputs.reads[i].uuid, inputs.reads[i].adc) for i in idx]
    return family(cell).records(cell.config, reads, fast5.CHANNEL, params, device, precision)


def _e2e(cell, win: dict, setup_s: float) -> dict:
    have = dict(win["e2e"], setup_s=setup_s)
    out = {}
    for m in cell.end_to_end:
        if m["name"] not in have:
            raise KeyError(f"the {cell.traffic['loop']} loop does not measure {m['name']}")
        out[m["name"]] = {"value": have[m["name"]], "unit": m["unit"]}
    return out


def prepare(cell, nseed: int, device: str, tmp: str, warm: int):
    """The run's inputs under ``tmp``, its weights, and the warm loop."""
    marks = [("start", time.perf_counter())]
    inputs = traffic.make(cell.traffic, nseed, tmp)
    marks.append(("inputs", time.perf_counter()))
    fam = family(cell)
    params = fam.make_params(cell.config, nseed, device)
    ckpt = fam.checkpoint(params, f"{tmp}/weights/weights.npz")
    marks.append(("weights", time.perf_counter()))
    loop = spec.module("loops", cell.traffic["loop"]).Loop(cell, inputs, ckpt, device, tmp)
    marks.append(("system", time.perf_counter()))
    loop.warm(warm)
    marks.append(("warm", time.perf_counter()))
    print("benchmark: set-up after " + f"{env.process_age_s() - (marks[-1][1] - marks[0][1]):.2f}"
          " s of imports and start: " + ", ".join(
              f"{name} {t - marks[k][1]:.2f} s" for k, (name, t) in enumerate(marks[1:])),
          file=sys.stderr)
    return inputs, params, loop


def run(workload: str, seed: int, seconds: float, trace: bool, device: str = "cuda",
        adjust: Optional[Callable] = None, out=None) -> int:
    out = out or sys.stdout
    cell = spec.load(workload)
    if adjust is not None:
        adjust(cell)
    env.apply(cell.config)
    bad = env.forbidden_loaded()
    if bad:
        print(f"benchmark: forbidden modules loaded at start: {bad}; no result", file=sys.stderr)
        return 4
    import torch

    kind = env.require_cards(cell.chips) if device == "cuda" else "cpu"
    import flappie_tpu_torch  # noqa: F401 - the system under test (pins TF32 off)

    nseed = seed % (1 << 64)
    tmp = tempfile.mkdtemp(prefix="flappie-bench-")
    loop = None
    try:
        inputs, params, loop = prepare(cell, nseed, device, tmp, cell.traffic["warm"])
        if device == "cuda":
            torch.cuda.synchronize()
        setup_s = env.process_age_s()
        win = loop.window(seconds)
        red = None
        traced_reads = []
        if trace:
            from . import profile

            with profile.traced() as holder:
                traced_reads = loop.traced_stretch(cell.traffic["trace"])
            red = profile.reduce(holder)
            del holder
        mem_peak = torch.cuda.max_memory_allocated() if device == "cuda" else 0
        idx = loop.sample(win, nseed)
        got = loop.records(idx)
        loop.close()
        loop = None
        gc.collect()
        if device == "cuda":
            torch.cuda.empty_cache()
        t_ref = time.perf_counter()
        want = reference_records(cell, inputs, params, idx, device)
        numbers = check.compare(got, want)
        ref_s = time.perf_counter() - t_ref
        correct = check.verdict(numbers, cell.limits)
        if trace:
            ctx = SimpleNamespace(cell=cell, win=win, profile=red, kind=kind,
                                  inputs=inputs, traced_reads=traced_reads,
                                  peak=yardstick.peaks(kind))
            metrics = {}
            for m in cell.per_layer:
                v = cell.readers[m["name"]](ctx)
                if v is not None:
                    metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        else:
            metrics = _e2e(cell, win, setup_s)
        bad = env.forbidden_loaded()
        if bad:
            print(f"benchmark: forbidden modules loaded by the end: {bad}; no result",
                  file=sys.stderr)
            return 4
        result = {"correct": bool(correct), "attempted": int(win["attempted"]),
                  "failed": int(win["failed"]), "metrics": metrics,
                  "device": {"platform": "gpu" if device == "cuda" else "cpu", "kind": kind,
                             "count": cell.chips if device == "cuda" else 0,
                             "memory_peak_bytes": int(mem_peak)}}
        if trace and red is not None:
            result["device"]["busy_s"] = red["busy_s"]
            result["device"]["window_s"] = red["window_s"]
            from . import profile

            result["breakdown"] = profile.breakdown(red)
        result["check"] = {k: [numbers[k], cell.limits[k]["limit"]] for k in check.NUMBERS}
        print(f"benchmark: {workload} seed {seed}: {len(idx)} reads compared with the "
              f"reference in {ref_s:.1f} s; set-up {setup_s:.1f} s; window {win['window_s']:.1f} s",
              file=sys.stderr)
        for k in check.NUMBERS:
            print(f"check {k} {numbers[k]!r} limit {cell.limits[k]['limit']!r}", file=sys.stderr)
        sys.stderr.flush()
        print(json.dumps(result), file=out, flush=True)
        return 0
    finally:
        if loop is not None:
            loop.close()
        shutil.rmtree(tmp, ignore_errors=True)
