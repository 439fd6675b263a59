"""PyTorch port on the CPU: the FLAPPIE_TPU_PHASES phase dump against the
JAX package.

- ``timing.report()`` and ``maybe_dump`` (to a path and to stderr) equal
  the JAX module's on the same calls in every field the two share, but
  for the process wall; the port's own sections (``PORT_SECTIONS``) are
  checked on their own;
- the flappie CLI and flappie-serve dump at exit under
  FLAPPIE_TPU_PHASES the phases the JAX package's own runs of the same
  reads name, but the three the port has no counterpart for (the d8
  wire's encode, the upload threads' and the collector thread's waits),
  and beside them the port's own phases (``PORT_ONLY``); the FASTQ bytes
  do not change with the variable set.
"""

from __future__ import annotations

import io
import json

import pytest
import torch

from flappie_tpu import timing as j_timing
from flappie_tpu.cli import flappie as j_flappie
from flappie_tpu.cli import serve as j_serve

from flappie_tpu_torch import timing as p_timing
from flappie_tpu_torch.cli import flappie as p_flappie
from flappie_tpu_torch.cli import serve as p_serve

from test_torch_e2e import CHUNK_ARGS, _run, reads  # noqa: F401 (reads is a fixture)

# JAX phases without a counterpart in the port: the d8 wire, the upload
# threads and the collector thread
JAX_ONLY = {"encode_d8", "upload_wait", "collect_bound_wait"}
CLI_PHASES = {"fast5_read", "preprocess", "pack", "dispatch", "dispatch_upload",
              "dispatch_launch", "collect_wait", "collect_host", "format_write"}
# the port's phases without a JAX counterpart: the caller's wait for a
# preprocessing wave, and dispatch_launch's parts (the copy-back's only
# on a card)
PORT_ONLY = {"wave_wait", "launch_network", "launch_decode", "launch_copyback"}
# the port's report sections beyond the JAX module's
PORT_SECTIONS = {"phase_cpu_s", "device", "counters", "spans"}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """As in test_torch_models.py: the CPU path's thousands of tiny
    recurrence steps run faster on one intra-op thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _drive(mod):
    mod.reset()
    mod.add("pack", 0.25)
    mod.add("pack", 0.5)
    mod.add("dispatch", 1.5)
    mod.add("_inner", 2.0)  # a leading underscore: left out of accounted_s
    with mod.phase("collect_wait"):
        pass
    rep = mod.report()
    rep["phases"]["collect_wait"]["wall_s"] = 0.0  # a real clock: ~0
    return rep


def test_report_and_dump_match_jax(tmp_path, monkeypatch, capsys):
    ours, theirs = _drive(p_timing), _drive(j_timing)
    assert theirs.keys() == {"process_wall_s", "phases", "accounted_s"}
    assert ours.keys() == theirs.keys() | PORT_SECTIONS
    # add() keeps no span and no CPU time; only the one phase() call does
    assert set(ours["phase_cpu_s"]) == {"collect_wait"}
    assert ours["device"] is None  # no batch ran on a card
    assert ours["counters"] == {"batches": 0, "rows": 0, "rows_valid": 0, "slots": 0, "owned": 0}
    assert ours["spans"] == {"kept": 1, "dropped": 0}
    assert list(ours["phases"]) == list(theirs["phases"]) == [
        "_inner", "dispatch", "pack", "collect_wait"]
    assert ours["phases"] == theirs["phases"]
    assert ours["accounted_s"] == theirs["accounted_s"] == 2.25
    assert ours["phases"]["pack"] == {"wall_s": 0.75, "calls": 2}

    monkeypatch.delenv("FLAPPIE_TPU_PHASES", raising=False)
    p_timing.maybe_dump()  # unset: nothing written
    assert capsys.readouterr().err == ""
    dumps = {}
    for name, mod in (("port", p_timing), ("jax", j_timing)):
        _drive(mod)
        path = tmp_path / f"{name}.json"
        monkeypatch.setenv("FLAPPIE_TPU_PHASES", str(path))
        mod.maybe_dump()
        monkeypatch.setenv("FLAPPIE_TPU_PHASES", "stderr")
        mod.maybe_dump()
        err = capsys.readouterr().err
        assert err.startswith("flappie-phases: {") and err.endswith("}\n")
        dumps[name] = (json.loads(path.read_text()), json.loads(err[len("flappie-phases: "):]))
    for (ours, theirs) in zip(dumps["port"], dumps["jax"]):
        port = {k: ours.pop(k) for k in PORT_SECTIONS}
        assert port["device"] is None and port["spans"] == {"kept": 1, "dropped": 0}
        for rep in (ours, theirs):
            rep.pop("process_wall_s")
            rep["phases"]["collect_wait"]["wall_s"] = 0.0
        assert ours == theirs


def _phases(call, path, monkeypatch, mod) -> dict:
    """The phase dump of ``call()``, from a fresh accounting."""
    mod.reset()
    monkeypatch.setenv("FLAPPIE_TPU_PHASES", str(path))
    assert call() == 0
    monkeypatch.delenv("FLAPPIE_TPU_PHASES")
    return json.loads(path.read_text())


def test_cli_phase_dump_matches_jax_names(reads, tmp_path, monkeypatch):  # noqa: F811
    args = [str(reads)] + CHUNK_ARGS
    theirs = _phases(lambda: j_flappie.main(args + ["-o", str(tmp_path / "jax.fq")]),
                     tmp_path / "jax.json", monkeypatch, j_timing)
    port_args = args + ["--device", "cpu"]
    ours = _phases(lambda: p_flappie.main(port_args + ["-o", str(tmp_path / "port.fq")]),
                   tmp_path / "port.json", monkeypatch, p_timing)
    assert set(ours["phases"]) - PORT_ONLY == set(theirs["phases"]) - JAX_ONLY == CLI_PHASES
    # 3 reads, one wave: no wave_wait; no card: no copy-back
    assert set(ours["phases"]) & PORT_ONLY == {"launch_network", "launch_decode"}
    assert ours["phases"]["fast5_read"]["calls"] == 3  # one a lazy read
    assert ours["phases"]["format_write"]["calls"] == 1
    assert ours["phases"]["dispatch"]["calls"] == ours["phases"]["collect_wait"]["calls"] == 2
    assert ours["phases"]["launch_network"]["calls"] == 2
    assert set(ours["phase_cpu_s"]) == set(ours["phases"])
    assert ours["device"] is None
    assert ours["counters"]["batches"] == 2 and ours["spans"]["dropped"] == 0
    assert 0 < ours["accounted_s"] and 0 < ours["process_wall_s"]
    assert (tmp_path / "port.fq").read_text() == _run(p_flappie.main, port_args,
                                                      tmp_path / "plain.fq")


def test_serve_dumps_phases_at_exit(reads, tmp_path, monkeypatch):  # noqa: F811
    """Two requests through each server's stdin mode: both dump at exit,
    with the same phase names (the server writes no trace file and has
    no format_write phase)."""
    dumps = {}
    for name, serve, mod, extra in (("jax", j_serve, j_timing, []),
                                    ("port", p_serve, p_timing, ["--device", "cpu"])):
        monkeypatch.setattr("sys.stdin", io.StringIO(f"{reads}\n{reads / 'r1.fast5'}\n"))
        argv = ["--output-dir", str(tmp_path / name)] + CHUNK_ARGS + extra
        dumps[name] = _phases(lambda: serve.main(argv), tmp_path / f"{name}.json", monkeypatch,
                              mod)
    assert set(dumps["port"]["phases"]) - PORT_ONLY == set(dumps["jax"]["phases"]) - JAX_ONLY == (
        CLI_PHASES - {"format_write"})
    assert set(dumps["port"]["phases"]) & PORT_ONLY == {"launch_network", "launch_decode"}
    assert PORT_SECTIONS <= set(dumps["port"])
    assert dumps["port"]["phases"]["fast5_read"]["calls"] == 4
