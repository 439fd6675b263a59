"""PyTorch port on the CPU: the run-length model (runnie) against the
JAX package, under each FLAPPIE_TPU_CRF_IMPL where the scans matter
(the CRF functions themselves: test_torch_crf_impl.py).

- ``globalnorm_runlengthV2`` and ``rle_transpost`` within 5e-6 (the CPU
  band; rle_transpost's unnormalised posterior also relative 5e-6);
- ``transitions`` of rle_r941_native at full width with JAX's synthetic
  weights carried across within 5e-6, padding inert;
- the C oracle's run-length transition dump (tests/goldens/rle_fb.npz)
  decoded in fb and Viterbi mode gives rle_fb.run and rle_vit.run byte
  for byte, under both settings;
- the runnie CLI (``--device cpu``; fb and ``--viterbi``; the int16 wire
  and, with ``--delta``, the f32 wire) against the JAX runnie CLI: bytes
  equal but for a shape or scale that may differ in its last printed
  digit (|delta| <= 2e-5; base and dwell always equal);
- decode_runnie (default, ``--rlc``, ``--threads 2``) byte for byte
  against the JAX one on the same .run.
"""

from __future__ import annotations

import io
import os
import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from flappie_tpu.cli.decode_runnie import main as j_decode_main
from flappie_tpu.cli.runnie import main as j_runnie_main
from flappie_tpu.decode import runlength as j_rl
from flappie_tpu.models import config as j_config
from flappie_tpu.models.params import init_synthetic
from flappie_tpu.ops import heads as j_heads

from flappie_tpu_torch.cli.decode_runnie import main as t_decode_main
from flappie_tpu_torch.cli.runnie import main as t_runnie_main
from flappie_tpu_torch.decode import runlength as t_rl
from flappie_tpu_torch.io.run_format import write_run_record
from flappie_tpu_torch.models import config as t_config
from flappie_tpu_torch.ops import heads as t_heads
from flappie_tpu_torch.signal.fast5 import write_single_read_fast5
from flappie_tpu_torch.signal.synthetic import synthetic_adc

from test_torch_crf_impl import IMPLS, impl  # noqa: F401 (impl is a fixture)
from test_torch_decode import _check_ignore_padding, _check_transitions, _nonzero_biases
from test_torch_e2e import _run

GOLDENS = os.path.join(os.path.dirname(__file__), "goldens")
GOLDEN_UUID = "0f776a08-0000-4000-8000-000000000001"


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """As in test_torch_models.py: the CPU path's thousands of tiny scan
    and recurrence steps run far slower on torch's intra-op pool when the
    test runner's workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("impl", IMPLS, indirect=True)
def test_runlength_head_and_transpost_match_jax(impl):
    rng = np.random.default_rng(23)
    B, T, H = 3, 50, 16
    x = rng.normal(size=(B, T, H)).astype(np.float32)
    W = (rng.normal(size=(H, 40)) / 4).astype(np.float32)
    b = rng.normal(0, 0.5, size=40).astype(np.float32)
    nblocks = np.array([50, 31, 0], np.int32)
    want = np.asarray(j_heads.globalnorm_runlengthV2(
        jnp.asarray(x), jnp.asarray(W), jnp.asarray(b), 0.9, jnp.asarray(nblocks), 4))
    got = t_heads.globalnorm_runlengthV2(torch.from_numpy(x), torch.from_numpy(W),
                                         torch.from_numpy(b), 0.9, torch.from_numpy(nblocks), 4)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=5e-6)
    assert not got[2].any() and not got[1, 31:].any()  # padded blocks zeroed
    want_tp = np.asarray(j_rl.rle_transpost(jnp.asarray(want), jnp.asarray(nblocks), 4))
    got_tp = t_rl.rle_transpost(got, torch.from_numpy(nblocks), 4).numpy()
    for r in range(B):
        n = int(nblocks[r])
        np.testing.assert_allclose(got_tp[r, :n], want_tp[r, :n], rtol=5e-6, atol=5e-6)


@pytest.mark.parametrize("part", ["match_jax", "padding_inert"])
def test_rle_transitions_full_width(part):
    """rle_r941_native at its published width (3 convs stride 5, 5
    LSTM(256), the runlengthV2 head) with JAX's init_synthetic weights
    carried across by params_to_torch."""
    jcfg, tcfg = j_config.MODELS["rle_r941_native"], t_config.MODELS["rle_r941_native"]
    assert (tcfg.head, tcfg.out_dim, tcfg.rnns[0].size) == ("runlengthV2", 40, 256)
    if part == "match_jax":
        _check_transitions(jcfg, tcfg, _nonzero_biases(init_synthetic(jcfg, seed=31), 32),
                           return_norm=False)
    else:
        _check_ignore_padding(jcfg, tcfg)


def _golden_run(mode):
    trans = np.load(os.path.join(GOLDENS, "rle_fb.npz"))["trans"]
    nblk = trans.shape[0]
    buf = np.zeros((1, -(-nblk // 256) * 256, trans.shape[1]), np.float32)
    buf[0, :nblk] = trans
    mat, nb = torch.from_numpy(buf), torch.tensor([nblk])
    if mode == "fb":
        mat = t_rl.rle_transpost(mat, nb, 4)
    _, path = t_rl.rle_viterbi(mat, nb, 4)
    sio = io.StringIO()
    write_run_record(sio, GOLDEN_UUID, t_rl.runs_from_path(mat[0].numpy(), path[0].numpy(),
                                                           nblk, 4))
    return sio.getvalue()


@pytest.mark.parametrize("impl", IMPLS, indirect=True)
@pytest.mark.parametrize("mode", ["fb", "vit"])
def test_rle_goldens_byte_for_byte(impl, mode):
    with open(os.path.join(GOLDENS, f"rle_{mode}.run")) as fh:
        gold = fh.read()
    assert _golden_run(mode) == gold


def test_runlength_host_helpers_match_jax():
    """dwmean, runlengths_mean and runlength_to_basecall on the golden
    Viterbi path and weights."""
    trans = np.load(os.path.join(GOLDENS, "rle_fb.npz"))["trans"][:300]
    _, path = t_rl.rle_viterbi(torch.from_numpy(trans[None]), torch.tensor([300]), 4)
    path = np.where(path[0].numpy() < 4, path[0].numpy(), -1)
    runs = t_rl.runlengths_mean(trans, path)
    np.testing.assert_array_equal(runs, j_rl.runlengths_mean(trans, path))
    assert t_rl.runlength_to_basecall(path, runs) == j_rl.runlength_to_basecall(path, runs)
    assert t_rl.dwmean(1.3, 2.5) == j_rl.dwmean(1.3, 2.5)


@pytest.fixture(scope="module")
def reads(tmp_path_factory):
    """Two short reads (one bucket, one program) and a third that trims
    away to nothing (no basecall)."""
    d = tmp_path_factory.mktemp("rle_reads")
    rng = np.random.default_rng(29)
    for k, n in enumerate([2200, 1500, 150]):
        write_single_read_fast5(str(d / f"q{k}.fast5"), synthetic_adc(n, rng), f"rread-{k}")
    return d


_RUN_LINE = re.compile(r"^([ACGT])\t(-?[\d.]+)\t(-?[\d.]+)\t(\d+)$")


def _assert_same_runs(ours: str, theirs: str):
    a, b = ours.splitlines(), theirs.splitlines()
    assert len(a) == len(b)
    for x, y in zip(a, b):
        if x == y:
            continue
        mx, my = _RUN_LINE.match(x), _RUN_LINE.match(y)
        assert mx and my, (x, y)
        assert (mx.group(1), mx.group(4)) == (my.group(1), my.group(4))
        for g in (2, 3):
            assert abs(float(mx.group(g)) - float(my.group(g))) <= 2e-5, (x, y)


@pytest.mark.parametrize("wire", [[], ["--delta", "1.0"]], ids=["i16", "f32"])
@pytest.mark.parametrize("mode", [[], ["--viterbi"]], ids=["fb", "viterbi"])
def test_runnie_cli_matches_jax_cli(reads, tmp_path, mode, wire, capsys):
    args = [str(reads)] + mode + wire
    theirs = _run(j_runnie_main, args, tmp_path / "jax.run")
    ours = _run(t_runnie_main, args + ["--device", "cpu"], tmp_path / "port.run")
    assert ours.count("# ") == 2 and "rread-0" in ours and "rread-1" in ours
    assert "No basecall returned" in capsys.readouterr().err
    _assert_same_runs(ours, theirs)


@pytest.mark.parametrize("args", [[], ["--rlc"], ["--threads", "2"]],
                         ids=["default", "rlc", "threads2"])
def test_decode_runnie_matches_jax(tmp_path, args, capsys):
    run = tmp_path / "gold.run"
    run.write_text(open(os.path.join(GOLDENS, "rle_fb.run")).read()
                   + "# empty-read\n" + _golden_run("vit").replace(GOLDEN_UUID, "second"))
    assert j_decode_main(args + [str(run)]) == 0
    theirs = capsys.readouterr()
    assert t_decode_main(args + [str(run)]) == 0
    ours = capsys.readouterr()
    assert ours.out == theirs.out and ours.out.count(">") == 2
    assert ours.err == theirs.err == "No basecall returned for empty-read\n"


def test_runnie_cli_refuses_fast(reads, tmp_path, capsys):
    """--fast was refused until the bf16 stream was ported; it now runs
    (its records are held in test_torch_fast.py): one record a called
    read, the read that trims away reported as without a basecall, as
    in the exact run."""
    out = tmp_path / "fast.run"
    assert t_runnie_main([str(reads), "--fast", "--device", "cpu", "-o", str(out)]) == 0
    text = out.read_text()
    assert text.count("# rread-") == 2 and "rread-2" not in text
    assert "No basecall returned" in capsys.readouterr().err
