"""PyTorch port on the CPU: the flappie and runnie CLIs under
FLAPPIE_TPU_CONV_IMPL=fast and pallas against the JAX CLIs under the same
knob (bytes, but a header score's last digit; .run lines as in
tests/test_torch_runnie.py).

JAX's basecall programs are module-level ``jax.jit``s that cache by
config and shape, not by the environment: each run clears JAX's caches
before and after, and a spy proves that both packages took the conv path
the knob names (K10 under ``pallas``).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax

from flappie_tpu.cli.flappie import main as j_flappie_main
from flappie_tpu.cli.runnie import main as j_runnie_main

from flappie_tpu_torch.cli.flappie import main as t_flappie_main
from flappie_tpu_torch.cli.runnie import main as t_runnie_main
from flappie_tpu_torch.models.config import get_model_config
from flappie_tpu_torch.signal.fast5 import write_single_read_fast5
from flappie_tpu_torch.signal.synthetic import synthetic_adc

from test_torch_conv import _Spies
from test_torch_e2e import CHUNK_ARGS, _assert_same_output, _run
from test_torch_runnie import _assert_same_runs


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def fresh_jax():
    """JAX's jitted programs cache by config and shape, not by the conv
    knob: trace them anew under this test's knob, and leave no trace of
    it to later tests."""
    jax.clear_caches()
    yield
    jax.clear_caches()


@pytest.fixture(scope="module")
def reads(tmp_path_factory):
    """Two reads; after the 200:10 trim the second is longer than
    --chunk 4000 and goes through the chunked program."""
    d = tmp_path_factory.mktemp("conv_reads")
    rng = np.random.default_rng(7)
    for k, n in enumerate([3000, 5200]):
        write_single_read_fast5(str(d / f"c{k}.fast5"), synthetic_adc(n, rng), f"cread-{k}")
    return d


@pytest.mark.parametrize("mode", [[], ["--viterbi"]], ids=["fb", "viterbi"])
@pytest.mark.parametrize("impl", ["fast", "pallas"])
def test_flappie_cli_matches_jax_cli_under_conv_impl(reads, tmp_path, impl, mode, monkeypatch,
                                                    fresh_jax):
    spies = _Spies(monkeypatch)
    monkeypatch.setenv("FLAPPIE_TPU_CONV_IMPL", impl)
    args = [str(reads)] + CHUNK_ARGS + mode
    theirs = _run(j_flappie_main, args, tmp_path / "jax.fq")
    ours = _run(t_flappie_main, args + ["--device", "cpu"], tmp_path / "port.fq")
    spies.check(impl, get_model_config("r941_native"))
    assert all(f"cread-{k}" in ours for k in range(2))
    _assert_same_output(ours, theirs)


@pytest.fixture(scope="module")
def rle_reads(tmp_path_factory):
    d = tmp_path_factory.mktemp("conv_rle_reads")
    rng = np.random.default_rng(29)
    for k, n in enumerate([2200, 1500]):
        write_single_read_fast5(str(d / f"q{k}.fast5"), synthetic_adc(n, rng), f"rcread-{k}")
    return d


def test_runnie_cli_matches_jax_cli_under_pallas(rle_reads, tmp_path, monkeypatch, fresh_jax):
    spies = _Spies(monkeypatch)
    monkeypatch.setenv("FLAPPIE_TPU_CONV_IMPL", "pallas")
    theirs = _run(j_runnie_main, [str(rle_reads)], tmp_path / "jax.run")
    ours = _run(t_runnie_main, [str(rle_reads), "--device", "cpu"], tmp_path / "port.run")
    spies.check("pallas", get_model_config("rle_r941_native"))
    assert ours.count("# ") == 2
    _assert_same_runs(ours, theirs)
