"""PyTorch port end to end on the CPU: the flappie CLI against the JAX
CLI, weights carried across packages, import isolation and the device
rule (cuda unless the CPU is asked for).

Output bytes are equal to the JAX CLI's, except that a FASTA/FASTQ
header's ``normalised_score`` (printed with %f) may differ in its last
digit, the contract the JAX package itself keeps against the C oracle
(tests/test_reference_parity.py): |delta| < 2e-5.
"""

from __future__ import annotations

import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from flappie_tpu.cli.flappie import main as jax_main
from flappie_tpu.models import config as j_config
from flappie_tpu.models import params as j_params

from flappie_tpu_torch.cli.flappie import main as port_main
from flappie_tpu_torch.signal.fast5 import write_single_read_fast5
from flappie_tpu_torch.signal.synthetic import synthetic_adc

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SCORE_RE = re.compile(r'"normalised_score" : (-?[\d.]+|nan)')
# one read longer than --chunk goes through the chunked program
CHUNK_ARGS = ["--chunk", "4000", "--overlap", "800"]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """As in test_torch_models.py: the CPU path's thousands of tiny
    recurrence steps run faster on one intra-op thread when the test
    runner's workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def reads(tmp_path_factory):
    d = tmp_path_factory.mktemp("reads")
    rng = np.random.default_rng(7)
    for k, n in enumerate([3000, 5200, 3600]):
        write_single_read_fast5(str(d / f"r{k}.fast5"), synthetic_adc(n, rng), f"read-{k}")
    return d


def _run(main, args, out):
    assert main(args + ["-o", str(out)]) == 0
    return out.read_text()


def _assert_same_output(ours: str, theirs: str):
    assert _SCORE_RE.sub("X", ours) == _SCORE_RE.sub("X", theirs)
    a = [float(s) for s in _SCORE_RE.findall(ours)]
    b = [float(s) for s in _SCORE_RE.findall(theirs)]
    assert len(a) == len(b)
    assert all(abs(x - y) < 2e-5 for x, y in zip(a, b)), (a, b)


@pytest.mark.parametrize("fmt", ["fastq", "fasta", "sam"])
@pytest.mark.parametrize("mode", [[], ["--viterbi"]])
def test_cli_output_matches_jax_cli(reads, tmp_path, fmt, mode):
    args = [str(reads), "-f", fmt] + CHUNK_ARGS + mode
    theirs = _run(jax_main, args, tmp_path / "jax.out")
    ours = _run(port_main, args + ["--device", "cpu"], tmp_path / "port.out")
    assert all(f"read-{k}" in ours for k in range(3))
    _assert_same_output(ours, theirs)
    if fmt == "sam":
        assert ours == theirs  # no score in SAM: byte for byte


def test_cli_delta_mode_f32_wire_matches_jax_cli(reads, tmp_path):
    """--delta normalises on the host (no med/MAD scalars), so both
    packages take the f32 wire on the chunk and bucket programs."""
    args = [str(reads), "--delta", "1.0", "--reverse"] + CHUNK_ARGS
    theirs = _run(jax_main, args, tmp_path / "jax.fq")
    ours = _run(port_main, args + ["--device", "cpu"], tmp_path / "port.fq")
    _assert_same_output(ours, theirs)


def test_preprocessing_waves_do_not_change_output(reads, tmp_path, monkeypatch):
    from flappie_tpu_torch import basecall

    args = [str(reads), "--device", "cpu"] + CHUNK_ARGS
    whole = _run(port_main, args, tmp_path / "whole.fq")
    monkeypatch.setattr(basecall, "PREPROCESS_WAVE", 1)
    assert _run(port_main, args, tmp_path / "waves.fq") == whole


@pytest.mark.parametrize("knob", ["FLAPPIE_TPU_CHAOS_DISPATCH", "FLAPPIE_TPU_CHAOS_DEVICE"])
def test_injected_faults_drop_only_their_reads(reads, tmp_path, monkeypatch, capsys, knob):
    """Every dispatch failing, or every read corrupted (NaN signal or an
    empty window), drops those reads and the run still completes."""
    monkeypatch.setenv(knob, "1")
    text = _run(port_main, [str(reads), "--device", "cpu"] + CHUNK_ARGS, tmp_path / "o.fq")
    assert text == ""
    err = capsys.readouterr().err
    assert err.count("No basecall returned") == 3
    if knob == "FLAPPIE_TPU_CHAOS_DISPATCH":
        assert "chunk batch failed" in err and "basecall batch failed" in err


def test_checkpoint_weights_cross_packages(reads, tmp_path):
    """JAX params saved with flappie_tpu's save_npz drive both CLIs to
    the same output through --checkpoint."""
    ckpt = tmp_path / "w.npz"
    cfg = j_config.MODELS["r941_native"]
    j_params.save_npz(str(ckpt), j_params.init_synthetic(cfg, seed=99), cfg)
    args = [str(reads), "--checkpoint", str(ckpt)] + CHUNK_ARGS
    theirs = _run(jax_main, args, tmp_path / "jax.fq")
    ours = _run(port_main, args + ["--device", "cpu"], tmp_path / "port.fq")
    _assert_same_output(ours, theirs)
    default = _run(port_main, [str(reads), "--device", "cpu"] + CHUNK_ARGS, tmp_path / "d.fq")
    assert default != ours  # the checkpoint really replaced the weights


def test_cli_fault_isolation_and_refusals(reads, tmp_path, capsys):
    bad = tmp_path / "bad.fast5"
    bad.write_bytes(b"not an hdf5 file")
    text = _run(port_main, [str(reads / "r0.fast5"), str(bad), "--device", "cpu"],
                tmp_path / "o.fq")
    assert text.startswith("@read-0") and text.count("@read-") == 1
    assert f"No basecall returned for {bad}" in capsys.readouterr().err
    # --mesh 2 runs on the CPU; beyond the visible cards it returns 1
    # with the JAX CLI's message (the rest: test_torch_mesh.py)
    assert _run(port_main, [str(reads), "--device", "cpu", "--mesh", "2"] + CHUNK_ARGS,
                tmp_path / "mesh.fq") == _run(port_main, [str(reads), "--device", "cpu"]
                                              + CHUNK_ARGS, tmp_path / "one.fq")
    cards = torch.cuda.device_count()
    n = max(2, cards + 1)
    capsys.readouterr()
    assert port_main([str(reads), "--mesh", str(n)]) == 1
    assert f"--mesh {n} exceeds the {cards} visible devices" in capsys.readouterr().err


ISOLATION = r"""
import importlib, pkgutil, sys
class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "flappie_tpu"):
            raise ImportError(f"blocked: {name}")
sys.meta_path.insert(0, Block())
import flappie_tpu_torch
mods = [m.name for m in pkgutil.walk_packages(flappie_tpu_torch.__path__, "flappie_tpu_torch.")]
for m in mods:
    importlib.import_module(m)
import chip_smoke
assert not [m for m in sys.modules if m.split(".")[0] in ("jax", "flappie_tpu")]
from flappie_tpu_torch.basecall import Basecaller
try:
    Basecaller()
except RuntimeError as exc:
    assert "no CUDA device" in str(exc)
    print("OK", len(mods))
else:
    raise SystemExit("Basecaller() ran without a GPU")
"""


def test_port_imports_nothing_of_jax_and_needs_cuda():
    """Every module of the port (and chip_smoke.py) imports with jax and
    flappie_tpu blocked, and Basecaller() without device='cpu' raises on
    a host without a GPU."""
    env = dict(os.environ, PYTHONPATH=REPO, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, "-c", ISOLATION], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.startswith("OK")
    assert int(proc.stdout.split()[1]) >= 20


def test_chip_smoke_refuses_without_cuda():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, os.path.join(REPO, "chip_smoke.py")], cwd=REPO,
                          env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert proc.stdout == ""
