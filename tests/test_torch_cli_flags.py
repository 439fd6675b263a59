"""PyTorch port on the CPU: full reads without chunking (``--chunk 0``)
and the naming flags (``--prefix``, ``--limit``, ``--no-uuid``) of both
port CLIs, against the JAX CLIs.

Under ``--chunk 0`` a read longer than the default chunk (12800 samples
at stride 5) goes whole through a bucket program (bucket 16384 here)
instead of the chunk program.  Bytes equal the JAX CLI's but for the
header score's last digit (test_torch_e2e.py); runnie's ``.run`` lines
but for a shape or scale's last digit (test_torch_runnie.py).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from flappie_tpu.cli.flappie import main as j_main
from flappie_tpu.cli.runnie import main as j_runnie_main

from flappie_tpu_torch import basecall
from flappie_tpu_torch.cli.flappie import main as p_main
from flappie_tpu_torch.cli.runnie import main as p_runnie_main
from flappie_tpu_torch.signal.fast5 import write_single_read_fast5
from flappie_tpu_torch.signal.synthetic import synthetic_adc

from test_torch_e2e import _assert_same_output, _run
from test_torch_runnie import _assert_same_runs

NAMING = ["--prefix", "PFX", "--no-uuid", "--limit", "2"]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """As in test_torch_models.py: the CPU path's thousands of tiny
    recurrence steps run faster on one intra-op thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def reads(tmp_path_factory):
    """u0: 13,500 samples, 13,290 after the 200:10 trim (longer than the
    default chunk); u1 and u2 short.  --limit 2 keeps u0 and u1."""
    d = tmp_path_factory.mktemp("flag_reads")
    rng = np.random.default_rng(37)
    for k, n in enumerate([13_500, 3000, 4100]):
        write_single_read_fast5(str(d / f"u{k}.fast5"), synthetic_adc(n, rng), f"uread-{k}")
    return d


@pytest.mark.parametrize("mode", [[], ["--viterbi"]], ids=["fb", "viterbi"])
def test_unchunked_cli_matches_jax_cli(reads, tmp_path, monkeypatch, mode):
    args = [str(reads), "--chunk", "0"] + NAMING + mode
    theirs = _run(j_main, args, tmp_path / "jax.fq")
    buckets = []

    def spy(program):
        def run(params, buf, *rest):
            buckets.append(buf.shape[1] - 16)  # the int16 wire's 16 tail entries
            return program(params, buf, *rest)
        return run

    monkeypatch.setattr(basecall, "_device_basecall_packed_i16",
                        spy(basecall._device_basecall_packed_i16))
    monkeypatch.setattr(basecall, "_device_basecall_chunk_packed_i16", None)  # never called
    ours = _run(p_main, args + ["--device", "cpu"], tmp_path / "port.fq")
    assert sorted(buckets) == [4096, 16384]
    heads = [line for line in ours.splitlines() if line.startswith("@")]
    assert [h.split()[0] for h in heads] == ["@PFXu0.fast5", "@PFXu1.fast5"]
    _assert_same_output(ours, theirs)


def test_runnie_naming_flags_match_jax(reads, tmp_path):
    """--limit keeps two reads; --prefix and --no-uuid are parsed and, as
    in the reference, never read: the header is always ``# <uuid>``."""
    args = [str(reads)] + NAMING
    theirs = _run(j_runnie_main, args, tmp_path / "jax.run")
    ours = _run(p_runnie_main, args + ["--device", "cpu"], tmp_path / "port.run")
    assert [line for line in ours.splitlines() if line.startswith("#")] == [
        "# uread-0", "# uread-1"]
    _assert_same_runs(ours, theirs)
