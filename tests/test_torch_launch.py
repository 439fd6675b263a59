"""PyTorch port on the CPU: the multi-process launcher
(``python -m flappie_tpu_torch.parallel.launch``).

- spawn mode, two worker processes, against the one-process port CLI on
  the same flags: the merged FASTQ byte for byte, in input order, and the
  merged trace file's groups, datasets and chunking equal; with
  ``--fast`` and a ``--qcal`` table too, which the workers apply as the
  CLI does (the JAX launcher's worker reads neither);
- ``--rank`` / ``--merge`` mode in this process, with the trace written
  and merged through h5py and, with the port's ``h5py`` patched to None,
  through hdf5_min, on ``--multi`` input under ``--limit`` (the merge
  keeps the first reads in input order, as one process does);
- a missing part file and a missing ``--nproc`` are errors.

The workers run with one intra-op thread, as this file's in-process runs
do (test_torch_models.py).
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

import h5py
import numpy as np
import pytest
import torch

from flappie_tpu_torch.cli.flappie import main as port_main
from flappie_tpu_torch.io import trace_h5
from flappie_tpu_torch.parallel import launch
from flappie_tpu_torch.signal.fast5 import write_single_read_fast5
from flappie_tpu_torch.signal.synthetic import synthetic_adc

from test_torch_e2e import CHUNK_ARGS, _run
from test_torch_serve import write_multi_min

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """``reads/``: five single-read files, two of them longer than --chunk
    4000; ``multi.fast5``: three reads; ``qcal.json``: an isotonic table
    for r941_native that moves the synthetic model's qualities."""
    d = tmp_path_factory.mktemp("launch")
    rng = np.random.default_rng(31)
    (d / "reads").mkdir()
    for k, n in enumerate([3100, 5600, 2800, 6000, 3500]):
        write_single_read_fast5(str(d / "reads" / f"r{k}.fast5"), synthetic_adc(n, rng),
                                f"read-{k}")
    write_multi_min(d / "multi.fast5", [(f"mread-{k}", synthetic_adc(n, rng))
                                        for k, n in enumerate([4300, 2600, 3000])])
    lut = np.clip(np.arange(94) * 3 // 4 + 2, 0, 93)
    (d / "qcal.json").write_text(json.dumps({"models": {"r941_native": {"lut": lut.tolist()}}}))
    return d


def _same_traces(a, b) -> None:
    with h5py.File(a, "r") as x, h5py.File(b, "r") as y:
        assert sorted(x) == sorted(y)
        for g in x:
            for d in ("signal", "trace"):
                np.testing.assert_array_equal(x[g][d][()], y[g][d][()])
                assert (x[g][d].dtype, x[g][d].chunks, x[g][d].compression) == (
                    y[g][d].dtype, y[g][d].chunks, y[g][d].compression)


@pytest.mark.parametrize("flags", ["exact", "fast-qcal"])
def test_spawn_matches_one_process(data, tmp_path, flags):
    extra = [] if flags == "exact" else ["--fast", "--qcal", str(data / "qcal.json")]
    args = [str(data / "reads"), "--device", "cpu"] + CHUNK_ARGS + extra
    single = _run(port_main, args + ["--trace", str(tmp_path / "one.h5")], tmp_path / "one.fq")
    assert single.count("@read-") == 5
    if flags != "exact":  # both flags change the records
        assert single != _run(port_main, [str(data / "reads"), "--device", "cpu"] + CHUNK_ARGS,
                              tmp_path / "exact.fq")
    merged = tmp_path / "merged.fq"
    env = {**os.environ, "OMP_NUM_THREADS": "1", "PYTHONPATH": REPO}
    proc = subprocess.run(
        [sys.executable, "-m", "flappie_tpu_torch.parallel.launch", "--nproc", "2",
         "--partdir", str(tmp_path / "parts"), "--"] + args
        + ["-o", str(merged), "--trace", str(tmp_path / "merged.h5")],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert merged.read_text() == single
    _same_traces(tmp_path / "merged.h5", tmp_path / "one.h5")
    assert not list((tmp_path / "parts").glob("flappie_part*"))
    assert not list(tmp_path.glob("merged.h5.part*"))


@pytest.mark.parametrize("writer", ["h5py", "hdf5_min"])
def test_rank_and_merge_modes(data, tmp_path, monkeypatch, writer):
    """Each worker in turn with --rank, then --merge, on --multi input
    limited to four reads (the multi-read file's three and the first
    single read), against one process on the same flags."""
    if writer == "hdf5_min":
        monkeypatch.setattr(trace_h5, "h5py", None)
    args = [str(data / "multi.fast5"), str(data / "reads"), "--multi", "--limit", "4",
            "--device", "cpu"] + CHUNK_ARGS
    single = _run(port_main, args + ["--trace", str(tmp_path / "one.h5")], tmp_path / "one.fq")
    assert [ln.split()[0] for ln in single.splitlines()[::4]] == [
        "@mread-0", "@mread-1", "@mread-2", "@read-0"]
    out = ["-o", str(tmp_path / "merged.fq"), "--trace", str(tmp_path / "merged.h5")]
    parts = str(tmp_path / "parts")
    for r in (0, 1):
        assert launch.main(["--nproc", "2", "--rank", str(r), "--partdir", parts, "--"]
                           + args + out) == 0
    assert sorted(os.listdir(parts)) == ["flappie_part0.jsonl", "flappie_part1.jsonl"]
    assert os.path.exists(tmp_path / "merged.h5.part1")
    assert launch.main(["--nproc", "2", "--merge", "--partdir", parts, "--"] + args + out) == 0
    assert (tmp_path / "merged.fq").read_text() == single
    _same_traces(tmp_path / "merged.h5", tmp_path / "one.h5")
    assert os.listdir(parts) == [] and not list(tmp_path.glob("merged.h5.part*"))


def test_launcher_errors(tmp_path, capsys):
    assert launch.main(["--nproc", "2", "--merge", "--partdir", str(tmp_path), "--", "x"]) == 1
    assert "missing part file" in capsys.readouterr().err
    assert launch.main(["--", "x"]) == 2
    assert launch.main(["--nproc", "1", "--rank", "0", "--partdir", str(tmp_path), "--",
                        "x", "--model", "nope"]) == 1
