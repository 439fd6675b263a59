"""The readers of the program's own record (``harness/program_spans.py``
and ``metrics/{batch_idle_share,wave_wait_idle,collect_idle,slot_use}
.offline.py``): the hand-computed value on spans made by hand, None
from a program without the record, a number for ``slot_use`` and None
for the three idle readers in a CPU ``--trace 1`` run, and the traced
stretch's phase wrapper (``harness/profile.py``) still running over the
program's spans."""

import io
import json
from types import SimpleNamespace

import pytest

from benchmark.harness import cell as cell_mod
from benchmark.harness import profile, spec
from benchmark.tests.conftest import shrink

CELLS = ["r941_native.offline", "r941_5mC.offline"]
NEW = ["batch_idle_share.offline", "wave_wait_idle.offline", "collect_idle.offline",
       "slot_use.offline"]


@pytest.fixture
def timing():
    from flappie_tpu_torch import timing

    timing.reset()
    yield timing
    timing.reset()


def _record(timing):
    """A 2-s window: the feeding thread (1) packs batch 1, waits for a
    wave, collects, packs batch 2; batch 1 in flight 0.2-0.6 s, batch 2
    1.4-1.9 s; a pack after the window's close counts for nothing."""
    o = timing._t0

    def span(name, t0, t1, batch=None, counts=None):
        sp = timing.Span(name, 1, "t1", o + t0, None, 1, batch)
        sp.t1, sp.counts = o + t1, counts
        timing._spans.append(sp)

    span("pack", 0.0, 0.2, 1, {"rows": 4, "rows_valid": 3, "slots": 400, "owned": 300})
    span("collect_host", 0.6, 0.9, 1)
    span("wave_wait", 0.9, 1.3)
    span("pack", 1.3, 1.4, 2, {"rows": 2, "rows_valid": 1, "slots": 200, "owned": 50})
    span("pack", 2.5, 2.6, 3, {"rows": 2, "rows_valid": 2, "slots": 200, "owned": 200})
    timing.on_device(o + 0.2, o + 0.6, "cuda:0", 1, 1)
    timing.on_device(o + 1.4, o + 1.9, "cuda:0", 1, 2)
    timing._jobs.append({"job": 1, "thread": 1, "thread_name": "t1", "t0": o, "t1": o + 2.0})


def _ctx():
    return SimpleNamespace(win={"window_s": 2.0})


def test_readers_by_hand(timing):
    _record(timing)
    got = {name: spec.reader(name)(_ctx()) for name in NEW}
    # idle: [0, 0.2] pack, [0.6, 1.4] collect_host 0.3, wave_wait 0.4,
    # pack 0.1; [1.9, 2.0] no span open: 1.1 s of 2
    assert got["batch_idle_share.offline"] == pytest.approx(55.0)
    assert got["wave_wait_idle.offline"] == pytest.approx(20.0)
    assert got["collect_idle.offline"] == pytest.approx(15.0)
    assert got["slot_use.offline"] == pytest.approx(100.0 * 350 / 600)


def test_readers_find_nothing_without_the_record(timing, monkeypatch):
    """The parent's program: ``timing`` with neither ``idle`` nor
    ``counters``."""
    _record(timing)
    monkeypatch.delattr(timing, "idle")
    monkeypatch.delattr(timing, "counters")
    assert [spec.reader(name)(_ctx()) for name in NEW] == [None] * 4


@pytest.mark.parametrize("workload", CELLS)
def test_cpu_traced_run(workload):
    out = io.StringIO()
    assert cell_mod.run(workload, 2 ** 31 + 41, 1.0, True, device="cpu", adjust=shrink,
                        out=out) == 0
    res = json.loads(out.getvalue().strip().splitlines()[-1])
    m = res["metrics"]
    assert 0 < m["slot_use.offline"]["value"] <= 100 and m["slot_use.offline"]["unit"] == "%"
    # no batch in flight on a card: no idle to name
    assert not {"batch_idle_share.offline", "wave_wait_idle.offline",
                "collect_idle.offline"} & set(m)
    assert {"launch_share.offline", "signal_share.offline", "mfu.offline"} <= set(m)


def test_profile_wrapper_runs_over_the_spans(timing):
    plain = timing.phase
    with profile.traced() as holder:
        with timing.batch() as b:
            with timing.phase("pack"):
                with timing.phase("encode_d8"):
                    pass
    assert timing.phase is plain
    assert [name for _, _, name in holder.spans] == ["encode_d8", "pack"]
    kept = {s.name: s for s in timing.spans()}
    assert kept["encode_d8"].parent is kept["pack"] and kept["pack"].batch == b
    assert timing.report()["phases"]["pack"]["calls"] == 1
