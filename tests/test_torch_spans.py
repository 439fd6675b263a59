"""PyTorch port on the CPU: the spans, ids and counters of timing.py.

- a span's parent is the innermost span open on its own thread, and it
  keeps its thread, its times, its CPU seconds and the ids in force;
- each batch's ``pack``, ``dispatch_launch`` and ``collect_host`` spans
  carry its id, once each, also where the upload pool dispatches and
  the collector thread collects (and the mesh's shard threads, a
  dispatch a shard), and the FASTQ bytes stay the same;
- ``reset()`` clears the record, and spans past ``MAX_SPANS`` are
  counted as dropped;
- ``idle`` on hand-made spans: each gap split, time-weighted, over the
  innermost spans of the thread that packed the batch that ends it, the
  last gap given to the job's thread, ``OUTSIDE`` where no span is open;
- a crafted set of reads gives its batches' rows, valid rows, slots and
  owned samples exactly, a chunked read owning its blocks times the
  stride.
"""

from __future__ import annotations

import math
import threading

import numpy as np
import pytest
import torch

from flappie_tpu.cli import flappie as j_flappie

from flappie_tpu_torch import basecall, timing
from flappie_tpu_torch.cli import flappie as p_flappie
from flappie_tpu_torch.parallel.chunking import plan_chunks
from flappie_tpu_torch.signal.fast5 import read_raw, write_single_read_fast5
from flappie_tpu_torch.signal.synthetic import synthetic_adc

from test_torch_e2e import CHUNK_ARGS, _assert_same_output, _run, reads  # noqa: F401 (a fixture)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """As in test_torch_models.py: the CPU path's thousands of tiny
    recurrence steps run faster on one intra-op thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def fresh_record():
    timing.reset()
    yield
    timing.reset()


def test_span_parents_threads_and_ids():
    def side():
        with timing.phase("side"):
            with timing.phase("side_inner"):
                pass

    with timing.job() as job:
        with timing.phase("outer"):
            with timing.batch() as b:
                with timing.phase("inner"):
                    t = threading.Thread(target=timing.carry(side), name="flappie-side")
                    t.start()
                    t.join(timeout=60)
                    assert not t.is_alive()
            with timing.phase("after"):
                pass
    got = {s.name: s for s in timing.spans()}
    assert list(got) == ["outer", "inner", "side", "side_inner", "after"]
    me = threading.current_thread()
    assert got["outer"].parent is None and got["inner"].parent is got["outer"]
    assert got["after"].parent is got["outer"]
    # the other thread's spans nest only in its own
    assert got["side"].parent is None and got["side_inner"].parent is got["side"]
    assert {s.thread_name for s in got.values()} == {me.name, "flappie-side"}
    assert got["side"].thread != me.ident == got["inner"].thread
    assert got["outer"].t0 <= got["inner"].t0 <= got["side"].t0 <= got["side"].t1
    assert got["side"].t1 <= got["inner"].t1 <= got["after"].t0 <= got["outer"].t1
    assert all(s.cpu_s >= 0 for s in got.values())
    # ids: the job over everything; the batch inside its block, carried
    # to the thread that ran under it; none after it
    assert {s.job for s in got.values()} == {job}
    assert [got[n].batch for n in ("outer", "inner", "side", "side_inner", "after")] == [
        None, b, b, b, None]
    assert timing.current_ids() == {"job": None, "batch": None}
    (rec,) = timing.jobs()
    assert rec["job"] == job and rec["thread"] == me.ident and rec["t1"] >= got["outer"].t1


@pytest.mark.parametrize("threads", [False, True], ids=["caller", "pools"])
def test_batch_ids_follow_the_batch(reads, tmp_path, monkeypatch, threads):  # noqa: F811
    """One CLI run (one job): every batch's pack, dispatch_launch and
    collect_host carry its id once each, on the upload pool and the
    collector thread when they are on; the bytes are the JAX CLI's."""
    args = [str(reads), "--device", "cpu", "--chunk-batch", "2", "--batch", "1"] + CHUNK_ARGS
    if threads:
        monkeypatch.setenv("FLAPPIE_TPU_COLLECT_THREAD", "1")
        monkeypatch.setenv("FLAPPIE_TPU_UPLOAD_THREADS", "2")
    monkeypatch.setenv("FLAPPIE_TPU_PREPROCESS_WAVE", "1")
    text = _run(p_flappie.main, args, tmp_path / "port.fq")
    spans = timing.spans()
    (job,) = {j["job"] for j in timing.jobs()}
    packs = [s for s in spans if s.name == "pack"]
    # 2 chunks of read 1 in one batch of 2; reads 0 and 2 one bucket batch each
    assert len(packs) == 3 and len({s.batch for s in packs}) == 3
    for name in ("pack", "dispatch", "dispatch_launch", "launch_network", "launch_decode",
                 "collect_wait", "collect_host"):
        mine = [s for s in spans if s.name == name]
        assert sorted(s.batch for s in mine) == sorted(s.batch for s in packs), name
        assert {s.job for s in mine} == {job}, name
    # dispatch_launch's wall holds its parts
    assert {s.parent.name for s in spans if s.name.startswith("launch_")} == {"dispatch_launch"}
    where: dict = {}  # phase -> the thread names it ran on, pool suffixes cut
    for s in spans:
        where.setdefault(s.name, set()).add(s.thread_name.split("_")[0])
    if threads:
        assert where["dispatch_launch"] == {"flappie-upload"}
        assert where["collect_host"] == {"flappie-collect"}
    else:
        assert where["dispatch_launch"] == where["collect_host"] == where["pack"]
    assert where["preprocess"] == {"flappie-pre"} and where["wave_wait"] == where["pack"]
    assert {s.job for s in spans if s.name in ("fast5_read", "preprocess", "wave_wait")} == {job}
    assert timing.report()["device"] is None  # the CPU: nothing in flight
    theirs = _run(j_flappie.main, [str(reads)] + CHUNK_ARGS, tmp_path / "jax.fq")
    _assert_same_output(text, theirs)


def test_batch_ids_follow_the_shards(reads, tmp_path):  # noqa: F811
    """Under ``--mesh 2`` each shard's dispatch runs on its replica's
    thread under the batch's id; the batch is collected once."""
    args = [str(reads), "--device", "cpu", "--mesh", "2", "--chunk-batch", "2"] + CHUNK_ARGS
    _run(p_flappie.main, args, tmp_path / "mesh.fq")
    spans = timing.spans()
    packs = sorted(s.batch for s in spans if s.name == "pack")
    launches = [s for s in spans if s.name == "dispatch_launch"]
    assert {s.thread_name.split("_")[0] for s in launches} == {"flappie-shard0", "flappie-shard1"}
    assert sorted({s.batch for s in launches}) == packs  # every batch, some on both shards
    assert len(launches) > len(packs)
    assert sorted(s.batch for s in spans if s.name == "collect_host") == packs


def test_reset_and_the_bound(monkeypatch):
    monkeypatch.setattr(timing, "MAX_SPANS", 4)
    for _ in range(6):
        with timing.phase("pack"):
            pass
    assert len(timing.spans()) == 4
    rep = timing.report()
    assert rep["spans"] == {"kept": 4, "dropped": 2}
    assert rep["phases"]["pack"]["calls"] == 6  # the walls keep every call
    timing.reset()
    assert timing.spans() == [] and timing.jobs() == []
    assert timing.report()["spans"] == {"kept": 0, "dropped": 0}


def _hand_made():
    """Thread 1 packs and collects; thread 2 called basecall_raw_tables
    and formats; thread 3 preprocesses.  Batch 1 in flight 0.1-0.4 s,
    batch 2 1.2-1.5 s, of a 2-s record (seconds since reset)."""
    o = timing._t0

    def span(name, thread, t0, t1, batch=None, parent=None, counts=None):
        sp = timing.Span(name, thread, f"t{thread}", o + t0, parent, 1, batch)
        sp.t1, sp.counts = o + t1, counts
        timing._spans.append(sp)
        return sp

    span("pack", 1, 0.0, 0.1, batch=1)
    span("preprocess", 3, 0.4, 1.2)  # another thread: takes no idle
    wait = span("wave_wait", 1, 0.5, 0.9)
    span("inner", 1, 0.6, 0.7, parent=wait)
    span("collect_host", 1, 0.9, 1.0, batch=1)
    span("pack", 1, 1.0, 1.2, batch=2)
    span("format_write", 2, 1.6, 1.8)
    timing.on_device(o + 0.1, o + 0.4, "cuda:0", job=1, batch=1)
    timing.on_device(o + 1.2, o + 1.5, "cuda:0", job=1, batch=2)
    timing._jobs.append({"job": 1, "thread": 2, "thread_name": "t2", "t0": o, "t1": o + 1.9})


def test_idle_named_by_the_feeding_thread():
    assert timing.idle() is None  # no batch on a device yet
    _hand_made()
    idle = timing.idle(0.0, 2.0)
    # [0, 0.1] ends at batch 1: thread 1 in pack; [0.4, 1.2] ends at
    # batch 2: thread 1 in no span 0.1, wave_wait 0.3 around inner 0.1,
    # collect_host 0.1, pack 0.2; [1.5, 2.0] has no next batch: the
    # job's thread 2, format_write 0.2 and no span 0.3
    want = {"pack": 0.3, timing.OUTSIDE: 0.4, "wave_wait": 0.3, "inner": 0.1,
            "collect_host": 0.1, "format_write": 0.2}
    assert idle.keys() == want.keys() and "preprocess" not in idle
    for k, v in want.items():
        assert idle[k] == pytest.approx(v, abs=1e-9), k
    assert sum(idle.values()) == pytest.approx(2.0 - timing.in_flight(0.0, 2.0), abs=1e-9)
    assert timing.in_flight(0.0, 2.0) == pytest.approx(0.6, abs=1e-9)
    # a stretch inside the record is clipped to it
    part = timing.idle(0.45, 1.3)
    assert part[timing.OUTSIDE] == pytest.approx(0.05, abs=1e-9)
    assert sum(part.values()) == pytest.approx(0.75, abs=1e-9)
    assert timing.in_flight(0.45, 1.3) == pytest.approx(0.1, abs=1e-9)


def test_overlapping_batches_count_once():
    o = timing._t0
    for t0, t1 in ((0.1, 0.5), (0.3, 0.6), (0.35, 0.4), (0.8, 0.9)):
        timing.on_device(o + t0, o + t1, "cuda:0")
    assert timing.in_flight(0.0, 1.0) == pytest.approx(0.6, abs=1e-9)
    # no pack and no job: every gap is outside any phase
    assert timing.idle(0.0, 1.0) == {timing.OUTSIDE: pytest.approx(0.4, abs=1e-9)}


SIZES = (1500, 2600, 5000, 7000, 1800)
CHUNK, OVERLAP, CB = 2000, 400, 2


@pytest.fixture(scope="module")
def crafted(tmp_path_factory):
    d = tmp_path_factory.mktemp("crafted")
    rng = np.random.default_rng(11)
    paths = []
    for k, n in enumerate(SIZES):
        paths.append(str(d / f"c{k}.fast5"))
        write_single_read_fast5(paths[-1], synthetic_adc(n, rng), f"crafted-{k}")
    return [read_raw(p) for p in paths]


def test_counters_of_a_crafted_set(crafted):
    caller = basecall.Basecaller("r941_native", device="cpu", chunk=CHUNK, overlap=OVERLAP,
                                 chunk_batch=CB)
    stride = caller.cfg.total_stride
    lengths = [rt.end - rt.start for rt in basecall.preprocess_batch(crafted)]
    long_ = [n for n in lengths if n > CHUNK]
    short = [n for n in lengths if n <= CHUNK]
    assert len(long_) == 3 and len(short) == 2
    chunks = sum(plan_chunks(n, stride, CHUNK, OVERLAP).nchunk for n in long_)
    results = caller.basecall_raw_tables(crafted, max_batch=4)
    assert all(r is not None for r in results)
    rows = math.ceil(chunks / CB) * CB  # the tail keeps the full batch size
    buckets = {basecall.bucket_length(n) for n in short}
    assert buckets == {2048}  # one bucket batch of both short reads
    want = {"batches": math.ceil(chunks / CB) + 1, "rows": rows + 2,
            "rows_valid": chunks + 2, "slots": rows * CHUNK + 2 * 2048,
            "owned": stride * sum(-(-n // stride) for n in long_) + sum(short)}
    assert timing.counters() == want
    assert timing.report()["counters"] == want
    packs = [s for s in timing.spans() if s.name == "pack"]
    assert sum(s.counts["rows_valid"] for s in packs) == want["rows_valid"]
    # one chunked read alone: its rows own its blocks times the stride
    timing.reset()
    caller.basecall_raw_tables([crafted[3]])
    (n,) = [m for m, rt in zip(lengths, crafted) if rt is crafted[3]]
    assert timing.counters()["owned"] == stride * -(-n // stride)
    assert timing.counters()["rows_valid"] == plan_chunks(n, stride, CHUNK, OVERLAP).nchunk
