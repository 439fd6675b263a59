"""``--fast``, the bf16 stream, on the CPU against the JAX package.

The port's plain bf16 layers (ops/rnn_cuda.py: x and iW rounded to bf16,
the affine in f32 rounded to a bf16 xa, the steps in f32, the stored
output rounded) against JAX's fused Pallas kernels in interpret mode
under FLAPPIE_TPU_RNN_STREAM=bf16, on the same seeded numpy inputs:

- at IN=32, H=16 bit-equal;
- at IN=256, H=64 within 2^-7 (one bf16 ulp of |h| in [0.5, 1)) with at
  least 99.5% of elements bit-equal: the f32 affine sums its IN products
  in another order before the bf16 rounding, which can land one ulp
  apart.

The slice as a whole: ``transitions(..., stream=torch.bfloat16)`` against
JAX's ``transitions(..., rnn_impl="pallas")`` under the stream, r941_native
narrowed (convs of at most 8 channels, 5 LSTM layers of 16), within 5e-2
absolute: the rounding of five layers' outputs reaches the head.  Then
``--fast`` on the port's three CLIs (records equal to the stream's through
the library; no environment variable written), a stack that is not fused
running f32 under it, K12 refusing bf16 (the training path takes it:
test_torch_fast_train.py), and the precision knobs (ops/precision.py).
"""

from __future__ import annotations

import glob
import importlib
import io
import os
import sys
from dataclasses import replace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from flappie_tpu.models import config as j_config
from flappie_tpu.models import network as j_net
from flappie_tpu.ops import rnn_pallas

from flappie_tpu_torch.basecall import Basecaller
from flappie_tpu_torch.cli import flappie as t_flappie
from flappie_tpu_torch.cli import runnie as t_runnie
from flappie_tpu_torch.cli import serve as t_serve
from flappie_tpu_torch.io.fastx import format_read
from flappie_tpu_torch.models import config as t_config
from flappie_tpu_torch.models import network as t_net
from flappie_tpu_torch.models.params import init_synthetic, params_to_torch
from flappie_tpu_torch.ops import precision, rnn_cuda
from flappie_tpu_torch.signal.fast5 import read_raw, write_single_read_fast5
from flappie_tpu_torch.signal.synthetic import synthetic_adc
from flappie_tpu_torch.weights import sloika as t_sloika

from test_torch_e2e import CHUNK_ARGS, _run
from test_torch_sloika import write_sloika_pickle

BF16 = torch.bfloat16


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """As in test_torch_models.py: the CPU path's thousands of tiny
    recurrence steps run faster on one intra-op thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def fresh_jax():
    """JAX's programs cache by shape, not by the stream's environment
    variable: trace them anew under this test's stream, and leave no
    trace of it to later tests."""
    jax.clear_caches()
    yield
    jax.clear_caches()


# -- the layers ---------------------------------------------------------------


def _layer_inputs(kind, T, B, IN, H, seed):
    """x [T, B, IN], iW, b, sW, lengths [B] (T, 0, 1 and random), the
    GRU-mod candidate bias far from zero."""
    rng = np.random.default_rng(seed)
    g = 4 if kind == "lstm" else 3
    x = rng.standard_normal((T, B, IN)).astype(np.float32)
    iW = (rng.standard_normal((IN, g * H)) / np.sqrt(IN)).astype(np.float32)
    b = (rng.standard_normal(g * H) * 0.2).astype(np.float32)
    if kind == "grumod":
        b[2 * H :] += 0.75
    sW = (rng.standard_normal((H, g * H)) / np.sqrt(H)).astype(np.float32)
    lengths = np.concatenate([[T, 0, 1], rng.integers(2, T, B - 3)]).astype(np.int32)
    return x, iW, b, sW, lengths


@pytest.mark.parametrize("IN,H,exact", [(32, 16, True), (256, 64, False)])
@pytest.mark.parametrize("backward", [False, True])
@pytest.mark.parametrize("kind", ["lstm", "grumod"])
def test_bf16_layer_matches_jax(kind, backward, IN, H, exact, monkeypatch, fresh_jax):
    x, iW, b, sW, lengths = _layer_inputs(kind, 24, 5, IN, H, seed=IN + H + len(kind))
    j_fn = {"lstm": rnn_pallas.lstm_layer_tm, "grumod": rnn_pallas.grumod_layer_tm}[kind]
    monkeypatch.setenv("FLAPPIE_TPU_RNN_STREAM", "bf16")
    want = j_fn(*(jnp.asarray(a) for a in (x, iW, b, sW)), interpret=True, backward=backward,
                lengths=jnp.asarray(lengths))
    monkeypatch.delenv("FLAPPIE_TPU_RNN_STREAM")
    assert want.dtype == jnp.bfloat16
    want = np.asarray(want.astype(jnp.float32))
    t_fn = {"lstm": rnn_cuda.lstm_layer_tm, "grumod": rnn_cuda.grumod_layer_tm}[kind]
    got = t_fn(torch.from_numpy(x).to(BF16), *(torch.from_numpy(a) for a in (iW, b, sW)),
               backward, torch.from_numpy(lengths))
    assert got.dtype == BF16 and got.shape == (24, 5, H)
    got = got.float().numpy()
    if exact:
        np.testing.assert_array_equal(got, want)
    else:
        d = np.abs(got - want)
        assert d.max() <= 2.0 ** -7
        assert (d == 0).mean() >= 0.995


@pytest.mark.parametrize("kind", ["lstm", "grumod"])
def test_bf16_layers_take_iw_in_either_dtype(kind):
    """iW may arrive in f32 (rounded by the wrapper, as the JAX package
    casts it outside its kernel) or bf16: the same output; the bf16
    wrapper refuses an f32 x."""
    x, iW, b, sW, lengths = (torch.from_numpy(a) for a in _layer_inputs(kind, 9, 4, 12, 16, 3))
    fn = {"lstm": rnn_cuda.lstm_layer_tm, "grumod": rnn_cuda.grumod_layer_tm}[kind]
    twin = {"lstm": rnn_cuda.lstm_layer_tm_bf16, "grumod": rnn_cuda.grumod_layer_tm_bf16}[kind]
    a = fn(x.to(BF16), iW, b, sW, True, lengths)
    assert torch.equal(a, fn(x.to(BF16), iW.to(BF16), b, sW, True, lengths))
    assert torch.equal(a, twin(x.to(BF16), iW, b, sW, True, lengths))
    with pytest.raises(ValueError, match="must be bfloat16"):
        twin(x, iW, b, sW, True, lengths)


# -- the slice ------------------------------------------------------------------


def _narrow(mod):
    """r941_native at a small width: convs 1 -> 4 -> 8 -> 8 (stride 5), five
    LSTM layers of 16, the flip-flop head."""
    cfg = mod.MODELS["r941_native"]
    c0, c1, c2 = cfg.convs
    return replace(cfg, convs=(c0, replace(c1, out_ch=8), replace(c2, in_ch=8, out_ch=8)),
                   rnns=tuple(replace(r, size=16) for r in cfg.rnns))


def _signal(B, T, seed):
    return np.random.default_rng(seed).normal(0, 1, (B, T)).astype(np.float32)


def test_transitions_bf16_match_jax(monkeypatch, fresh_jax):
    jcfg, tcfg = _narrow(j_config), _narrow(t_config)
    params = init_synthetic(tcfg, seed=5)
    sig = _signal(3, 600, seed=6)
    lengths = np.array([600, 411, 37], np.int32)
    monkeypatch.setenv("FLAPPIE_TPU_RNN_STREAM", "bf16")
    want, nb_j = j_net.transitions(params, jcfg, jnp.asarray(sig), jnp.asarray(lengths),
                                   rnn_impl="pallas")
    monkeypatch.delenv("FLAPPIE_TPU_RNN_STREAM")
    tp = params_to_torch(params, "cpu")
    got, nb_t = t_net.transitions(tp, tcfg, torch.from_numpy(sig), torch.from_numpy(lengths),
                                  stream=BF16)
    np.testing.assert_array_equal(nb_t.numpy(), np.asarray(nb_j))
    assert got.dtype == torch.float32 and got.shape == want.shape == (3, 120, tcfg.out_dim)
    err = np.abs(got.numpy() - np.asarray(want)).max()
    print(f"transitions bf16 stream, port vs JAX: max |delta| {err:.3e}")
    assert err <= 5e-2
    # the stream changes the result (the f32 stack is another function)
    exact, _ = t_net.transitions(tp, tcfg, torch.from_numpy(sig), torch.from_numpy(lengths),
                                 stream=torch.float32)
    assert not torch.equal(exact, got)
    # stream=None reads FLAPPIE_TPU_RNN_STREAM at call time; the iW that
    # stream_params rounds once give the same transitions
    monkeypatch.setenv("FLAPPIE_TPU_RNN_STREAM", "bf16")
    env, _ = t_net.transitions(t_net.stream_params(tp, tcfg, BF16), tcfg, torch.from_numpy(sig),
                               torch.from_numpy(lengths))
    assert torch.equal(env, got)


def test_training_and_the_layer_by_layer_recurrence_refuse_bf16():
    """K12 keeps f32 and refuses the stream, as the JAX package's
    layer-by-layer stack ignores it.  K8 and train=True, which refused it
    until training under the stream was ported, now take it: K8-bf16's
    plain twin gives bf16 h and c, train=True finite transitions
    (held to the JAX package in test_torch_fast_train.py)."""
    x = torch.zeros(4, 2, 8, dtype=BF16)
    iW, b, sW = torch.zeros(8, 64), torch.zeros(64), torch.zeros(16, 64)
    h, c = rnn_cuda.lstm_layer_tm_train(x, iW, b, sW)
    assert h.dtype == c.dtype == BF16 and h.shape == c.shape == (4, 2, 16)
    with pytest.raises(ValueError, match="K12.*takes float32"):
        rnn_cuda.lstm_seq_cuda(torch.zeros(2, 4, 64, dtype=BF16), sW)
    with pytest.raises(ValueError, match="K12.*takes float32"):
        rnn_cuda.grumod_seq_cuda(torch.zeros(2, 4, 48, dtype=BF16), torch.zeros(16, 48))
    cfg = _narrow(t_config)
    params = params_to_torch(init_synthetic(cfg, seed=1), "cpu")
    trans, _ = t_net.transitions(params, cfg, torch.zeros(1, 100),
                                 torch.tensor([100], dtype=torch.int32), train=True, stream=BF16)
    assert trans.dtype == torch.float32 and torch.isfinite(trans).all()


# -- the CLIs -------------------------------------------------------------------


@pytest.fixture(scope="module")
def reads(tmp_path_factory):
    """Two reads; after the 200:10 trim the second is longer than
    --chunk 4000 and goes through the chunked program."""
    d = tmp_path_factory.mktemp("fast_reads")
    rng = np.random.default_rng(41)
    for k, n in enumerate([3000, 5200]):
        write_single_read_fast5(str(d / f"f{k}.fast5"), synthetic_adc(n, rng), f"fread-{k}")
    return d


@pytest.fixture(scope="module")
def fast_cli(reads, tmp_path_factory):
    """The flappie CLI's --fast FASTQ on the CPU, and the environment
    before and after the run."""
    before = dict(os.environ)
    text = _run(t_flappie.main, [str(reads), "--fast", "--device", "cpu"] + CHUNK_ARGS,
                tmp_path_factory.mktemp("fast_cli") / "fast.fastq")
    return text, before, dict(os.environ)


def _layer_dtypes(monkeypatch) -> list:
    """The x dtype of every plain layer call from here on."""
    seen = []
    for name in ("lstm_layer_tm_plain", "grumod_layer_tm_plain"):
        def spy(x_tm, *args, _orig=getattr(rnn_cuda, name), **kw):
            seen.append(x_tm.dtype)
            return _orig(x_tm, *args, **kw)

        monkeypatch.setattr(rnn_cuda, name, spy)
    return seen


def test_flappie_fast_is_the_bf16_basecaller(reads, fast_cli, monkeypatch):
    """--fast's records are Basecaller(stream=torch.bfloat16)'s, every
    layer of both programs (bucket and chunk) on bf16, and the CLI writes
    no environment variable."""
    text, before, after = fast_cli
    assert after == before and "FLAPPIE_TPU_RNN_STREAM" not in after
    seen = _layer_dtypes(monkeypatch)
    caller = Basecaller(device="cpu", stream=BF16, chunk=4000, overlap=800)
    files = sorted(glob.glob(str(reads / "*.fast5")))
    results = caller.basecall_raw_tables([read_raw(f, scale_to_pA=True) for f in files])
    assert seen == [BF16] * 10  # 5 layers x (one bucket program + one chunk program)
    want = "".join(format_read("fastq", r.uuid, os.path.basename(f), True, "", r)
                   for f, r in zip(files, results))
    assert text == want and text.count("@fread-") == 2


def test_serve_fast_matches_the_cli(reads, fast_cli, capsys, monkeypatch):
    """flappie-serve --fast answers a request with the CLI's --fast
    records."""
    capsys.readouterr()
    monkeypatch.setattr(sys, "stdin", io.StringIO(f"{reads}\n"))
    before = dict(os.environ)
    assert t_serve.main(["--fast", "--device", "cpu"] + CHUNK_ARGS) == 0
    out, err = capsys.readouterr()
    assert dict(os.environ) == before
    assert out == fast_cli[0]
    assert f"flappie-serve: done {reads} reads=2 called=2" in err


def test_runnie_fast_is_the_bf16_stream(reads, tmp_path, monkeypatch):
    """runnie --fast: every layer on bf16, the .run records those of the
    stream set through FLAPPIE_TPU_RNN_STREAM, no environment written."""
    before = dict(os.environ)
    seen = _layer_dtypes(monkeypatch)
    fast = _run(t_runnie.main, [str(reads), "--fast", "--device", "cpu"], tmp_path / "fast.run")
    assert dict(os.environ) == before
    assert seen and set(seen) == {BF16}
    monkeypatch.setenv("FLAPPIE_TPU_RNN_STREAM", "bf16")
    assert _run(t_runnie.main, [str(reads), "--device", "cpu"], tmp_path / "env.run") == fast
    assert fast.count("# fread-") == 2


@pytest.mark.parametrize("flavour,rnn_impl", [("flipflop_gru", "auto"),
                                              ("flipflop_grumod", "scan")])
def test_unfused_stacks_run_f32_under_the_stream(tmp_path, flavour, rnn_impl, monkeypatch):
    """A stack that is not fused (the sloika residual GRUs; any stack under
    rnn_impl="scan") ignores the stream, as the JAX package's does: the
    f32 records, no bf16 layer."""
    cfg, params = t_sloika.convert_sloika_pickle(
        write_sloika_pickle(tmp_path / "m.pkl", flavour, seed=3), flavour)
    rng = np.random.default_rng(43)
    raws = []
    for k, n in enumerate([900, 2700]):
        path = str(tmp_path / f"s{k}.fast5")
        write_single_read_fast5(path, synthetic_adc(n, rng), f"sread-{k}")
        raws.append(path)
    seen = _layer_dtypes(monkeypatch)
    kw = dict(model=cfg, params=params, rnn_impl=rnn_impl, device="cpu", chunk=1500,
              overlap=300, chunk_batch=4)
    fast = Basecaller(stream=BF16, **kw).basecall_raw_tables([read_raw(p) for p in raws])
    exact = Basecaller(stream=torch.float32, **kw).basecall_raw_tables([read_raw(p) for p in raws])
    assert BF16 not in seen
    for a, b in zip(fast, exact):
        assert (a.basecall, a.quality, a.score) == (b.basecall, b.quality, b.score)


# -- the precision policy ---------------------------------------------------------


@pytest.fixture
def saved_levels():
    saved = precision._ff_level, precision._rnn_level
    yield
    precision._ff_level, precision._rnn_level = saved


def test_precision_levels_resolve_to_f32_and_default_raises_on_the_card(saved_levels):
    """high and highest are true f32 on the CPU, default too; on a CUDA
    device (a device object: no card is needed to ask) highest is true
    f32, ff high too, rnn high the three-pass level "bf16x3" (ported after
    the one-pass products), and default, which raised until the one-pass
    products were ported, resolves to the one-pass level "bf16".  A level
    that is not one of the three raises."""
    cuda = torch.device("cuda")
    for get, set_ in ((precision.ff_precision, precision.set_ff_precision),
                      (precision.rnn_precision, precision.set_rnn_precision)):
        for level in ("high", "HIGHEST", "Default"):
            set_(level)
            assert get() == get("cpu") == get(torch.device("cpu")) == "highest"
        for level in ("high", "highest"):
            set_(level)
            three = get is precision.rnn_precision and level == "high"
            assert get(cuda) == ("bf16x3" if three else "highest")
        set_("default")
        assert get(cuda) == get("cuda:0") == "bf16"
        with pytest.raises(ValueError, match="precision must be one of"):
            set_("bf16")
    precision._rnn_level = None  # unset: HIGHEST off the TPU
    assert precision.rnn_precision("cuda") == "highest"


def test_precision_knobs_read_at_import(monkeypatch):
    monkeypatch.setenv("FLAPPIE_TPU_MATMUL_PRECISION", "Default")
    monkeypatch.setenv("FLAPPIE_TPU_RNN_PRECISION", "highest")
    try:
        importlib.reload(precision)
        assert (precision._ff_level, precision._rnn_level) == ("default", "highest")
        assert precision.ff_precision("cuda") == "bf16"
        assert precision.ff_precision("cpu") == precision.rnn_precision("cuda") == "highest"
        monkeypatch.setenv("FLAPPIE_TPU_RNN_PRECISION", "fast")
        with pytest.raises(ValueError, match="FLAPPIE_TPU_RNN_PRECISION"):
            importlib.reload(precision)
    finally:
        monkeypatch.delenv("FLAPPIE_TPU_MATMUL_PRECISION")
        monkeypatch.delenv("FLAPPIE_TPU_RNN_PRECISION")
        importlib.reload(precision)
    assert (precision._ff_level, precision._rnn_level) == ("high", None)


def test_stream_dtype(monkeypatch):
    monkeypatch.delenv("FLAPPIE_TPU_RNN_STREAM", raising=False)
    assert precision.stream_dtype() == precision.check_stream(None) == torch.float32
    for name, dtype in (("f32", torch.float32), ("BF16", BF16)):
        monkeypatch.setenv("FLAPPIE_TPU_RNN_STREAM", name)
        assert precision.stream_dtype() == dtype
    monkeypatch.setenv("FLAPPIE_TPU_RNN_STREAM", "fp16")
    with pytest.raises(ValueError, match="FLAPPIE_TPU_RNN_STREAM"):
        precision.stream_dtype()
    with pytest.raises(ValueError, match="stream must be"):
        precision.check_stream(torch.float16)
    with pytest.raises(ValueError, match="stream must be"):
        Basecaller(device="cpu", stream=torch.float16)


def test_transitions_resolve_the_levels_for_the_signals_device(monkeypatch):
    """The feed-forward products of transitions (the convs, the head's
    affine) ask the level for the device their tensors are on, the
    signal's: the CPU, where every level is true f32, so ``default``
    gives the bytes of the unset levels.  (The layers ask the rnn level
    only on a CUDA device: on the CPU they run their plain versions.)"""
    cfg = _narrow(t_config)
    params = params_to_torch(init_synthetic(cfg, seed=2), "cpu")
    args = (params, cfg, torch.randn(2, 50), torch.tensor([50, 31], dtype=torch.int32))
    want, _ = t_net.transitions(*args, stream=torch.float32)
    asked = []
    real = precision.ff_precision
    monkeypatch.setattr(precision, "ff_precision", lambda d=None: asked.append(d) or real(d))
    saved = precision._ff_level, precision._rnn_level
    try:
        precision.set_ff_precision("default")
        precision.set_rnn_precision("default")
        got, _ = t_net.transitions(*args, stream=torch.float32)
    finally:
        precision._ff_level, precision._rnn_level = saved
    assert asked and set(asked) == {torch.device("cpu")}
    assert torch.equal(got, want)
