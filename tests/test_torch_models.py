"""PyTorch port on the CPU: the other flip-flop models through the
flappie CLI, against the JAX CLI.

- r941_5mC (stride-2 tanh conv, five GRU-mod layers, 5 bases: 10 states
  and 60 parameters per block) in fb FASTQ and --viterbi SAM, synthetic
  weights and a 5mC --checkpoint;
- r941_rna002, r103_native and r941_native with the flags of the golden
  cases rna_delta, r103_fb, ff_trim and ff_temp (tests/goldens/manifest.json).

Every run has one read long enough to be chunked.  Bytes equal the JAX
CLI's, except that a header's ``normalised_score`` may differ in its
last printed digit (|delta| < 2e-5), as in test_torch_e2e.py.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from flappie_tpu.cli.flappie import main as jax_main
from flappie_tpu.models import config as j_config
from flappie_tpu.models import params as j_params

from flappie_tpu_torch.cli.flappie import main as port_main
from flappie_tpu_torch.signal.fast5 import write_single_read_fast5
from flappie_tpu_torch.signal.synthetic import synthetic_adc

from test_torch_e2e import CHUNK_ARGS, _assert_same_output, _run


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The CPU path's recurrences are thousands of tiny steps: with the
    test runner's workers sharing the cores, torch's intra-op thread
    pool spends far longer waiting for its threads than computing (these
    tests ran 10-20x slower beside the other port test files)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def reads(tmp_path_factory):
    """Three reads; after the default 200:10 trim the second is longer
    than --chunk 4000 and goes through the chunked program."""
    d = tmp_path_factory.mktemp("reads")
    rng = np.random.default_rng(17)
    for k, n in enumerate([2900, 5100, 3500]):
        write_single_read_fast5(str(d / f"m{k}.fast5"), synthetic_adc(n, rng), f"mread-{k}")
    return d


def _both(reads, tmp_path, args):
    args = [str(reads)] + args + CHUNK_ARGS
    theirs = _run(jax_main, args, tmp_path / "jax.out")
    ours = _run(port_main, args + ["--device", "cpu"], tmp_path / "port.out")
    assert all(f"mread-{k}" in ours for k in range(3))
    _assert_same_output(ours, theirs)
    return ours, theirs


@pytest.mark.parametrize("args", [["-f", "fastq"], ["-f", "sam", "--viterbi"]],
                         ids=["fb-fastq", "viterbi-sam"])
def test_5mc_cli_matches_jax_cli(reads, tmp_path, args):
    ours, theirs = _both(reads, tmp_path, ["--model", "r941_5mC"] + args)
    seqs = ours.splitlines()[1::4] if "fastq" in args else [
        f[9] for f in (line.split("\t") for line in ours.splitlines()) if len(f) > 9]
    assert any("Z" in s for s in seqs)  # the fifth base reaches the output
    assert set("".join(seqs)) <= set("ACGTZ")
    if "sam" in args:
        assert ours == theirs  # no score in SAM: byte for byte


def test_5mc_checkpoint_cross_packages(reads, tmp_path):
    """A 5mC checkpoint saved by flappie_tpu drives both CLIs to the same
    output; its biases are non-zero, unlike the synthetic default."""
    cfg = j_config.MODELS["r941_5mC"]
    params = j_params.init_synthetic(cfg, seed=5)
    rng = np.random.default_rng(6)
    for layer in params.values():
        layer["b"] = layer["b"] + rng.normal(0, 0.1, layer["b"].shape).astype(np.float32)
    ckpt = tmp_path / "mc5.npz"
    j_params.save_npz(str(ckpt), params, cfg)
    _both(reads, tmp_path, ["--model", "r941_5mC", "--checkpoint", str(ckpt)])


@pytest.mark.parametrize("args", [
    ["--model", "r941_rna002", "--delta", "1.0", "--reverse"],
    ["--model", "r103_native"],
    ["--trim", "60:25", "--segmentation", "150:0.1"],
    ["--temperature", "0.85"],
], ids=["rna_delta", "r103_fb", "ff_trim", "ff_temp"])
def test_lstm_model_flags_match_jax_cli(reads, tmp_path, args):
    _both(reads, tmp_path, args)
