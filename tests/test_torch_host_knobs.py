"""PyTorch port on the CPU: the host knobs the JAX package honours.

- FLAPPIE_TPU_UPLOAD_THREADS + FLAPPIE_TPU_COLLECT_THREAD: the dispatches
  run on the upload pool (its thread making the Basecaller's device
  current) and the collects on one FIFO thread, under the JAX package's
  phase names; the bytes are the default run's;
- FLAPPIE_TPU_PREPROCESS_WAVE: reads a wave (0: one shot), the same bytes;
- FLAPPIE_TPU_PREWARM=1: one dummy chunk batch on the run's wire and
  group size before the reads, the same bytes; ``auto`` and ``0`` do not
  prewarm; a prewarm failure surfaces from the CLI;
- FLAPPIE_TPU_CHAOS: read_raw fails every read at 1 (as the JAX CLI's)
  and none at 0;
- FLAPPIE_TPU_SCANB_KERNELS: ``off`` runs the plain scans without the
  kernels' wrappers, ``auto`` calls the wrappers (their plain versions on
  the CPU), and ``on`` raises on the CPU;
- ``--mesh 2`` under d8 and a dispatch group of 2 against the JAX CLI's
  ``--mesh 2`` under the same knobs (bytes but the score's last digit, the
  same programs in the ``flappie-mesh:`` summary) and against the port's
  one-device run (byte for byte);
- every FLAPPIE_TPU_* variable the JAX package reads is read by the port
  or listed in README's table of the knobs the port ignores.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import re
import threading

import numpy as np
import pytest
import torch

from flappie_tpu.cli.flappie import main as j_main

from flappie_tpu_torch import basecall, timing
from flappie_tpu_torch.cli import flappie as t_cli
from flappie_tpu_torch.ops import crf as t_crf
from flappie_tpu_torch.ops import crf_bm_cuda
from flappie_tpu_torch.signal.fast5 import write_single_read_fast5
from flappie_tpu_torch.signal.synthetic import synthetic_adc

from test_torch_e2e import CHUNK_ARGS, _assert_same_output

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HOST_KNOBS = ("FLAPPIE_TPU_UPLOAD", "FLAPPIE_TPU_DISPATCH_GROUP", "FLAPPIE_TPU_UPLOAD_THREADS",
              "FLAPPIE_TPU_COLLECT_THREAD", "FLAPPIE_TPU_PREPROCESS_WAVE", "FLAPPIE_TPU_PREWARM",
              "FLAPPIE_TPU_CHAOS", "FLAPPIE_TPU_SCANB_KERNELS")
# 4 rows a chunk batch, so that the long reads make two batches
ARGS = CHUNK_ARGS + ["--chunk-batch", "4"]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def clean_knobs(monkeypatch):
    for k in HOST_KNOBS:
        monkeypatch.delenv(k, raising=False)


# three reads over --chunk 4000 (7 chunks: two batches of 4 rows) and four
# short ones (buckets 2048 and 4096)
SIZES = [9800, 7700, 6200, 3300, 2100, 2500, 3900]


@pytest.fixture(scope="module")
def reads(tmp_path_factory):
    d = tmp_path_factory.mktemp("knob_reads")
    rng = np.random.default_rng(17)
    for k, n in enumerate(SIZES):
        write_single_read_fast5(str(d / f"k{k}.fast5"), synthetic_adc(n, rng, mean_dwell=30.0),
                                f"kread-{k}")
    return d


def _cli(main, args, out, capture=None):
    """(output text, stderr text) of one CLI run; ``capture`` gets the
    port's Basecaller."""
    err = io.StringIO()
    orig = t_cli.make_caller

    def make(a):
        caller = orig(a)
        if capture is not None:
            capture.append(caller)
        return caller

    with contextlib.redirect_stderr(err), _patched(t_cli, "make_caller", make):
        assert main(args + ["-o", str(out)]) == 0
    return out.read_text(), err.getvalue()


@contextlib.contextmanager
def _patched(obj, name, value):
    old = getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield
    finally:
        setattr(obj, name, old)


@pytest.fixture(scope="module")
def default_run(reads, tmp_path_factory):
    out = tmp_path_factory.mktemp("default") / "default.fq"
    callers = []
    text, _ = _cli(t_cli.main, [str(reads), "--device", "cpu"] + ARGS, out, callers)
    assert text.count("@") >= len(SIZES)
    return text, dict(callers[0].dispatch_stats)


def test_default_run_programs(default_run):
    assert default_run[1] == {"_device_basecall_chunk_packed_i16": 2,
                              "_device_basecall_packed_i16": 2}


def test_upload_and_collect_threads(reads, tmp_path, monkeypatch, default_run):
    monkeypatch.setenv("FLAPPIE_TPU_UPLOAD_THREADS", "2")
    monkeypatch.setenv("FLAPPIE_TPU_COLLECT_THREAD", "1")
    threads = {"dispatch": set(), "collect": set()}
    current = threading.local()

    @contextlib.contextmanager
    def fake_on_device(device):  # the host has no card: record the device made current
        before = getattr(current, "device", None)
        current.device = device
        try:
            yield
        finally:
            current.device = before

    orig_dispatch, orig_run = basecall.Basecaller._dispatch, basecall._Pipeline._run

    def dispatch(self, program, buf, G=None, chaos=True):
        threads["dispatch"].add((threading.current_thread().name.split("_")[0],
                                 getattr(current, "device", None) == self.device))
        return orig_dispatch(self, program, buf, G, chaos)

    def run(self, tag, pending):
        threads["collect"].add(threading.current_thread().name.split("_")[0])
        return orig_run(self, tag, pending)

    monkeypatch.setattr(basecall, "_on_device", fake_on_device)
    monkeypatch.setattr(basecall.Basecaller, "_dispatch", dispatch)
    monkeypatch.setattr(basecall._Pipeline, "_run", run)
    timing.reset()
    callers = []
    text, _ = _cli(t_cli.main, [str(reads), "--device", "cpu"] + ARGS, tmp_path / "t.fq", callers)
    assert text == default_run[0]
    assert callers[0].dispatch_stats == default_run[1]
    assert threads["dispatch"] == {("flappie-upload", True)}
    assert threads["collect"] == {"flappie-collect"}
    phases = timing.report()["phases"]
    assert {"upload_wait", "collect_wait", "collect_host"} <= set(phases)
    assert callers[0]._upload_pool is None  # closed by the CLI


@pytest.mark.parametrize("wave", ["0", "1", "3"])
def test_preprocess_waves(reads, tmp_path, monkeypatch, default_run, wave):
    monkeypatch.setenv("FLAPPIE_TPU_PREPROCESS_WAVE", wave)
    calls = []
    orig = basecall.preprocess_batch

    def spy(batch, *a):
        calls.append((len(batch), threading.current_thread().name.split("_")[0]))
        return orig(batch, *a)

    monkeypatch.setattr(basecall, "preprocess_batch", spy)
    text, _ = _cli(t_cli.main, [str(reads), "--device", "cpu"] + ARGS, tmp_path / "w.fq")
    assert text == default_run[0]
    n = int(wave) or len(SIZES)
    assert [k for k, _ in calls] == [min(n, len(SIZES) - i) for i in range(0, len(SIZES), n)]
    assert {t for _, t in calls} == ({"MainThread"} if wave == "0" else {"flappie-pre"})


@pytest.mark.parametrize("setting", ["1", "auto", "0"])
def test_prewarm(reads, tmp_path, monkeypatch, default_run, setting):
    monkeypatch.setenv("FLAPPIE_TPU_PREWARM", setting)
    monkeypatch.setenv("FLAPPIE_TPU_UPLOAD", "d8")
    monkeypatch.setenv("FLAPPIE_TPU_DISPATCH_GROUP", "2")
    callers = []
    text, _ = _cli(t_cli.main, [str(reads), "--device", "cpu"] + ARGS, tmp_path / "p.fq", callers)
    assert text == default_run[0]
    stats = callers[0].dispatch_stats
    # the two chunk batches make one group; the prewarm adds one on its wire
    grouped = stats.get("_device_basecall_chunk_packed_d8_grouped", 0)
    assert grouped == (2 if setting == "1" else 1), stats


def test_prewarm_failure_surfaces(reads, tmp_path, monkeypatch):
    monkeypatch.setenv("FLAPPIE_TPU_PREWARM", "1")

    def broken(self):
        raise RuntimeError("prewarm: injected failure")

    monkeypatch.setattr(basecall.Basecaller, "prewarm_chunked", broken)
    with pytest.raises(RuntimeError, match="prewarm: injected failure"):
        _cli(t_cli.main, [str(reads), "--device", "cpu"] + ARGS, tmp_path / "f.fq")


@pytest.mark.parametrize("p", ["1.0", "0"])
def test_chaos_read_failures_match_jax(reads, tmp_path, monkeypatch, p):
    monkeypatch.setenv("FLAPPIE_TPU_CHAOS", p)
    theirs, j_err = _cli(j_main, [str(reads)] + ARGS, tmp_path / "j.fq")
    ours, t_err = _cli(t_cli.main, [str(reads), "--device", "cpu"] + ARGS, tmp_path / "t.fq")
    nfail = len(SIZES) if p == "1.0" else 0
    assert t_err.count("No basecall returned") == j_err.count("No basecall returned") == nfail
    assert ours.count("kread-") == theirs.count("kread-")
    _assert_same_output(ours, theirs)


def test_scanb_kernels_knob(monkeypatch):
    rng = np.random.default_rng(8)
    trans = torch.from_numpy(rng.normal(0, 2, (3, 40, 40)).astype(np.float32))
    nblocks = torch.tensor([40, 31, 5], dtype=torch.int32)
    wrapped = []  # the kernels' wrappers called (each runs its plain version on the CPU)
    for name in ("fwd_states", "bwd_states", "fwdbwd_states", "viterbi_fwd", "traceback"):
        fn = getattr(crf_bm_cuda, name)
        monkeypatch.setattr(crf_bm_cuda, name,
                            lambda *a, _fn=fn, _name=name: wrapped.append(_name) or _fn(*a))
    want = t_crf.crf_decode_fused(trans, nblocks, 4, False, True)
    assert sorted(wrapped) == ["bwd_states", "fwd_states", "traceback", "viterbi_fwd"]
    wrapped.clear()
    monkeypatch.setenv("FLAPPIE_TPU_SCANB_KERNELS", "off")
    got = t_crf.crf_decode_fused(trans, nblocks, 4, False, True)
    assert wrapped == []  # the plain scans, no wrapper
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    monkeypatch.setenv("FLAPPIE_TPU_SCANB_KERNELS", "on")
    with pytest.raises(ValueError, match="CUDA device"):
        t_crf.crf_decode_fused(trans, nblocks, 4, False, True)


def _mesh_summary(err: str):
    lines = [ln for ln in err.splitlines() if ln.startswith("flappie-mesh: ")]
    return json.loads(lines[-1][len("flappie-mesh: "):])


def test_mesh_under_d8_and_groups_matches_jax(reads, tmp_path, monkeypatch, default_run):
    monkeypatch.setenv("FLAPPIE_TPU_UPLOAD", "d8")
    monkeypatch.setenv("FLAPPIE_TPU_DISPATCH_GROUP", "2")
    args = [str(reads)] + ARGS + ["--mesh", "2"]
    theirs, j_err = _cli(j_main, args, tmp_path / "j.fq")
    ours, t_err = _cli(t_cli.main, args + ["--device", "cpu"], tmp_path / "t.fq")
    assert ours == default_run[0]  # the one-device default run, byte for byte
    _assert_same_output(ours, theirs)
    p_wire, j_wire = _mesh_summary(t_err), _mesh_summary(j_err)
    assert sorted(p_wire) == sorted(j_wire)
    assert "_device_basecall_chunk_packed_d8_grouped[int8]" in p_wire
    for name, ent in p_wire.items():
        assert ent["dispatches"] == j_wire[name]["dispatches"]
        # a bucket batch of one read runs on one device (the port pads no
        # rows); every grouped chunk dispatch spans both
        assert set(ent["devices"]) <= {1, 2}
    assert p_wire["_device_basecall_chunk_packed_d8_grouped[int8]"]["devices"] == [2]


def test_every_jax_knob_is_read_or_listed():
    def names(root):
        found = set()
        for dirpath, _, files in os.walk(os.path.join(ROOT, root)):
            for f in files:
                if f.endswith(".py"):
                    with open(os.path.join(dirpath, f)) as fh:
                        found |= set(re.findall(r"FLAPPIE_TPU_[A-Z0-9_]+", fh.read()))
        return found

    jax_knobs, port_knobs = names("flappie_tpu"), names("flappie_tpu_torch")
    with open(os.path.join(ROOT, "README.md")) as fh:
        ignored = set(re.findall(r"^\| `(FLAPPIE_TPU_[A-Z0-9_]+)` \| ignored", fh.read(),
                                 re.MULTILINE))
    assert len(jax_knobs) >= 20
    missing = sorted(jax_knobs - port_knobs - ignored)
    assert not missing, f"knobs neither read by the port nor listed as ignored: {missing}"
    assert ignored == {"FLAPPIE_TPU_RNN_K", "FLAPPIE_TPU_RNN_DUAL", "FLAPPIE_TPU_CRF_K",
                       "FLAPPIE_TPU_JAX_CACHE"}
    assert not ignored & port_knobs
