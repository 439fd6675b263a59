"""Rnn precision ``high`` (the three-pass step product) on the CPU.

- The plain three-pass twins of K1, K8 and K7 (ops/rnn_cuda.py with
  ``rdot="bf16x3"``: h and sW split into bf16 high parts and remainders,
  ``(h_hi.sW_hi + h_hi.sW_lo) + h_lo.sW_hi`` in f32) against the JAX
  package's fused Pallas kernels in interpret mode at
  ``set_rnn_precision("high")``, which run ``_dot_bf16x3`` on the CPU
  (rnn_pallas.py:505-507 turn HIGH into "high3" on every backend), on both
  streams and in both directions, at IN=32, H=16 and IN=256, H=64.  Both
  sum the same exact products of each pass in f32 in other orders, and a
  flip of h_hi is carried by h_lo, so on the f32 stream every element
  agrees within TWIN_TOL = 1e-5 absolute (read: below 1e-6); under the
  bf16 stream the stored outputs within one bf16 ulp (2^-8 of
  max(1, |value|)) and at least 99% of them bit-equal.
- The three-pass product (``_step_dot``) against a float64 reference of
  hi.hi + hi.lo + lo.hi on crafted inputs whose bf16 remainders are large
  (within f32 rounding, 2^-22 relative), and apart from both the exact
  product (by the dropped lo.lo term) and the one-pass product.
- On the CPU rnn ``high`` keeps the bytes of ``highest``: the port's
  transitions on both streams, the JAX package's ``rnn_impl="scan"``
  transitions (its CPU CLI's), and the port's CLI on both streams.
- The level's resolution (``"bf16x3"`` only for an explicit rnn ``high``
  on a CUDA device; ff and grad ``high``, unset and ``highest`` true f32)
  and the dispatch to the three-pass C entries (csrc/lstm_h3.cu,
  grumod_h3.cu) with every block affine, a CUDA device faked by a
  recording C entry: the wrappers' counters, the entry names and flags.

Torch runs on one thread here, as in test_torch_models.py.
"""

from __future__ import annotations

import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from flappie_tpu.models import network as j_net
from flappie_tpu.models.params import init_synthetic as j_init
from flappie_tpu.ops import precision as j_precision
from flappie_tpu.ops import rnn_pallas

from flappie_tpu_torch.cli import flappie as t_flappie
from flappie_tpu_torch.models import network as t_net
from flappie_tpu_torch.models.params import params_to_torch
from flappie_tpu_torch.ops import cuda_build, precision, rnn_cuda
from flappie_tpu_torch.signal.fast5 import write_single_read_fast5
from flappie_tpu_torch.signal.synthetic import synthetic_adc

from test_torch_decode import _small_cfgs
from test_torch_e2e import _run

BF16 = torch.bfloat16
TWIN_TOL = 1e-5  # f32 stream: each pass's exact products summed in another order
KINDS = {"lstm": (rnn_pallas.lstm_layer_tm, rnn_cuda.lstm_layer_tm_plain),
         "lstm_train": (rnn_pallas.lstm_layer_tm_train, rnn_cuda.lstm_layer_tm_train_plain),
         "grumod": (rnn_pallas.grumod_layer_tm, rnn_cuda.grumod_layer_tm_plain)}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def saved_levels():
    """Both packages' import-time levels restored after the test, and
    JAX's programs traced anew around it."""
    saved = precision._ff_level, precision._rnn_level
    j_saved = j_precision._ff_precision, j_precision._rnn_precision
    jax.clear_caches()
    yield
    precision._ff_level, precision._rnn_level = saved
    j_precision._ff_precision, j_precision._rnn_precision = j_saved
    jax.clear_caches()


def _layer_inputs(kind, T, B, IN, H, seed):
    """x [T, B, IN], iW, b, sW, lengths [B] (T, 0, 1 and random), the
    LSTM's forget bias and GRU-mod's candidate bias off zero."""
    rng = np.random.default_rng(seed)
    g = 3 if kind == "grumod" else 4
    x = rng.standard_normal((T, B, IN)).astype(np.float32)
    iW = (rng.standard_normal((IN, g * H)) / np.sqrt(IN)).astype(np.float32)
    b = (rng.standard_normal(g * H) * 0.2).astype(np.float32)
    if g == 4:
        b[H : 2 * H] += 1.0
    else:
        b[2 * H :] += 0.75
    sW = (rng.standard_normal((H, g * H)) / np.sqrt(H)).astype(np.float32)
    lengths = np.concatenate([[T, 0, 1], rng.integers(2, T, B - 3)]).astype(np.int32)
    return x, iW, b, sW, lengths


# -- the plain three-pass twins against JAX's interpret kernels ------------------


@pytest.mark.parametrize("IN,H", [(32, 16), (256, 64)])
@pytest.mark.parametrize("backward", [False, True])
@pytest.mark.parametrize("stream", ["f32", "bf16"])
@pytest.mark.parametrize("kind", ["lstm", "lstm_train", "grumod"])
def test_three_pass_twins_match_jax(kind, stream, backward, IN, H, saved_levels, monkeypatch):
    x, iW, b, sW, lengths = _layer_inputs(kind, 24, 5, IN, H, seed=IN + H + len(kind) + backward)
    j_fn, plain = KINDS[kind]
    if stream == "bf16":
        monkeypatch.setenv("FLAPPIE_TPU_RNN_STREAM", "bf16")
    j_precision.set_rnn_precision("high")
    want = j_fn(*(jnp.asarray(a) for a in (x, iW, b, sW)), interpret=True, backward=backward,
                lengths=jnp.asarray(lengths))
    monkeypatch.delenv("FLAPPIE_TPU_RNN_STREAM", raising=False)
    want = want if kind == "lstm_train" else (want,)
    tx = torch.from_numpy(x).to(BF16 if stream == "bf16" else torch.float32)
    args = (tx, *(torch.from_numpy(a) for a in (iW, b, sW)), backward, torch.from_numpy(lengths))
    got = plain(*args, rdot="bf16x3")
    got = got if kind == "lstm_train" else (got,)
    for g, w in zip(got, want):
        w = np.asarray(w.astype(jnp.float32))
        assert g.dtype == tx.dtype and g.shape == (24, 5, H)
        d = np.abs(g.float().numpy() - w)
        if stream == "f32":
            assert d.max() <= TWIN_TOL, d.max()
        else:
            assert (d <= 2.0 ** -8 * np.maximum(1.0, np.abs(w))).all(), d.max()
            assert (d == 0).mean() >= 0.99
    # the three passes are another function than one pass and (where the
    # outputs are not rounded to bf16) the f32 step
    for rdot in ("highest", "bf16") if stream == "f32" else ("bf16",):
        other = plain(*args, rdot=rdot)
        assert not torch.equal(other[0] if kind == "lstm_train" else other, got[0])


# -- the three-pass product on crafted inputs ---------------------------------------


def _crafted(rng, n=7, k=256, m=24):
    """h = hi + lo exactly, hi bf16 in [0.5, 1) and lo a positive bf16
    remainder of 3/8 to 1/2 of hi's ulp; sW = a (1 + 3 2^-9) for powers of
    two a of one sign a column, whose bf16 remainder is -a 2^-9: so the
    lo.lo terms of a column add up."""
    hi = rng.integers(128, 256, (n, k)) / 256.0
    h = (hi + rng.integers(96, 128, (n, k)) * 2.0 ** -16).astype(np.float32)
    a = 2.0 ** rng.integers(-9, -6, (k, m)) * rng.choice([-1, 1], (1, m))
    sW = (a * (1 + 3 * 2.0 ** -9)).astype(np.float32)
    return h, sW


def test_step_dot_is_the_three_pass_product():
    h, sW = _crafted(np.random.default_rng(5))
    w, dot = rnn_cuda._step_dot(torch.from_numpy(sW), "bf16x3")
    got = dot(torch.from_numpy(h), w).double().numpy()
    h_hi, h_lo = (t.double().numpy() for t in precision.split_bf16(torch.from_numpy(h)))
    w_hi, w_lo = (t.double().numpy() for t in precision.split_bf16(torch.from_numpy(sW)))
    assert np.array_equal(w, w_hi.astype(np.float32))
    assert np.array_equal(w_hi + w_lo, sW) and np.array_equal(h_hi + h_lo, h)  # exact splits
    want = h_hi @ w_hi + h_hi @ w_lo + h_lo @ w_hi
    scale = np.abs(h_hi) @ np.abs(w_hi)
    assert (np.abs(got - want) <= 2.0 ** -22 * scale).all()
    # apart from the exact product by the dropped lo.lo term, and from one pass
    exact = h.astype(np.float64) @ sW.astype(np.float64)
    lolo = h_lo @ w_lo
    assert np.allclose(exact - want, lolo, rtol=0, atol=2.0 ** -22 * scale.max())
    assert (np.abs(lolo) >= 2.0 ** -19 * scale).all()
    assert np.abs(got - exact).max() >= 8 * np.abs(got - want).max()
    one = rnn_cuda._step_dot(torch.from_numpy(sW), "bf16")
    one = one[1](torch.from_numpy(h), one[0]).double().numpy()
    assert np.abs(one - want).max() >= 100 * np.abs(got - want).max()


def test_levels_are_checked():
    x, iW, b, sW, lengths = (torch.from_numpy(a) for a in _layer_inputs("lstm", 4, 3, 8, 16, 1))
    with pytest.raises(ValueError, match="ff must be one of"):
        rnn_cuda.lstm_layer_tm_plain(x, iW, b, sW, ff="bf16x3")
    with pytest.raises(ValueError, match="rdot must be one of"):
        rnn_cuda.grumod_layer_tm_plain(x, iW[:, :48], b[:48], sW[:, :48], rdot="high")


# -- on the CPU, high keeps the bytes of highest -------------------------------------


def _inputs(model):
    jcfg, tcfg = _small_cfgs(hid=16, model=model, nrnn=2)
    params = j_init(jcfg, seed=4)
    rng = np.random.default_rng(8)
    signal = rng.normal(0, 1, (3, 300)).astype(np.float32)
    lengths = np.array([300, 217, 64], np.int32)
    return jcfg, tcfg, params, signal, lengths


@pytest.mark.parametrize("model", ["r941_native", "r941_5mC"])
def test_high_on_the_cpu_keeps_the_transitions(model, saved_levels):
    """The port's transitions on both streams and the JAX package's
    layer-by-layer ones (its CPU CLI's rnn_impl="scan") at rnn high are
    the bytes of highest."""
    jcfg, tcfg, params, signal, lengths = _inputs(model)
    tp = params_to_torch(params, "cpu")
    sig, lens = torch.from_numpy(signal), torch.from_numpy(lengths)

    def both():
        port = [t_net.transitions(tp, tcfg, sig, lens, stream=dt)[0] for dt in (torch.float32,
                                                                                BF16)]
        jax.clear_caches()
        j = j_net.transitions(params, jcfg, jnp.asarray(signal), jnp.asarray(lengths),
                              rnn_impl="scan")[0]
        return port, np.asarray(j)

    precision.set_rnn_precision("highest")
    j_precision.set_rnn_precision("highest")
    want, j_want = both()
    precision.set_rnn_precision("high")
    j_precision.set_rnn_precision("high")
    assert precision.rnn_precision("cpu") == precision.rnn_precision() == "highest"
    got, j_got = both()
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    np.testing.assert_array_equal(j_got, j_want)


@pytest.fixture(scope="module")
def one_read(tmp_path_factory):
    d = tmp_path_factory.mktemp("high_reads")
    write_single_read_fast5(str(d / "h0.fast5"), synthetic_adc(2600, np.random.default_rng(3)),
                            "hread-0")
    return d


@pytest.mark.parametrize("fast", [[], ["--fast"]])
def test_high_on_the_cpu_keeps_the_cli_bytes(one_read, fast, tmp_path, saved_levels):
    args = [str(one_read), "--device", "cpu"] + fast
    precision.set_rnn_precision("highest")
    want = _run(t_flappie.main, args, tmp_path / "highest.fastq")
    precision.set_rnn_precision("high")
    got = _run(t_flappie.main, args, tmp_path / "high.fastq")
    assert got == want and got.count("@hread-0") == 1


# -- the level's resolution and the dispatch, a CUDA device faked ---------------------


def test_rnn_high_resolves_to_three_passes_on_the_card_only(saved_levels, monkeypatch):
    cuda = torch.device("cuda")
    for level, on_card in (("high", "bf16x3"), ("HIGH", "bf16x3"), ("highest", "highest"),
                           ("default", "bf16")):
        precision.set_rnn_precision(level)
        assert precision.rnn_precision(cuda) == precision.rnn_precision("cuda:0") == on_card
        assert precision.rnn_precision() == precision.rnn_precision("cpu") == "highest"
    precision._rnn_level = None  # unset: the port's parity tier on every device
    assert precision.rnn_precision(cuda) == "highest"
    precision.set_ff_precision("high")
    assert precision.ff_precision(cuda) == "highest"
    monkeypatch.setenv("FLAPPIE_TPU_GRAD_PRECISION", "high")
    assert precision.grad_precision(cuda) == "highest"
    assert precision.THREE_PASS == "bf16x3"


@pytest.fixture
def fake_card(monkeypatch):
    """Every layer wrapper takes a CPU tensor for a card's, and every C
    entry is a recorder that leaves its outputs as torch.empty gave them:
    returns the list of (source, entry, int arguments after backward)."""
    calls = []

    def entry(source, name, argtypes):
        def fn(*args):
            calls.append((source, name, [a for a in args if isinstance(a, int)]))
            return 0
        return types.SimpleNamespace(), fn

    monkeypatch.setattr(rnn_cuda, "_device", lambda what, x: True)
    monkeypatch.setattr(rnn_cuda, "_entry", entry)
    monkeypatch.setattr(cuda_build, "stream_of", lambda t: None)
    real = precision.rnn_precision
    monkeypatch.setattr(precision, "rnn_precision", lambda device=None: real("cuda"))
    monkeypatch.setattr(precision, "ff_precision",
                        lambda device=None: precision._resolve(precision._ff_level, "cuda"))
    return calls


@pytest.mark.parametrize("kind,source,train", [("lstm_layer_tm", "lstm", False),
                                               ("lstm_layer_tm_train", "lstm", True),
                                               ("grumod_layer_tm", "grumod", False)])
def test_high_dispatches_to_the_three_pass_entries(kind, source, train, fake_card,
                                                   saved_levels):
    """At rnn high on the card each dispatcher runs its ``*_h3`` wrapper:
    one launch of flappie_<cell>_h3_layer[_train] with the block affine
    the stream and the ff level name (0 f32, 1 one pass, 2 bf16), counted
    on the wrapper (f32 x) or its ``*_bf16_h3`` counter (bf16 x) and on the
    affine's counter; unset and highest keep the f32 entries."""
    gates = 3 if source == "grumod" else 4
    x, iW, b, sW, lengths = (torch.from_numpy(a) for a in _layer_inputs(
        "grumod" if gates == 3 else "lstm", 6, 4, 8, 16, 2))
    disp, h3 = getattr(rnn_cuda, kind), getattr(rnn_cuda, kind + "_h3")
    h3_bf16 = getattr(rnn_cuda, kind + "_bf16_h3")
    counters = (disp, h3, h3_bf16, rnn_cuda.affine_f32, rnn_cuda.affine_bf16_f32,
                rnn_cuda.affine_bf16)

    def launch(xs):
        before = [c.launches for c in counters]
        out = disp(xs, iW, b, sW, True, lengths)
        assert isinstance(out, tuple) == train
        return [c.launches - n for c, n in zip(counters, before)]

    train_sfx = "_train" if train else ""
    precision.set_rnn_precision("high")
    for ff, xs, affine, counts in (("high", x, 0, [0, 1, 0, 1, 0, 0]),
                                   ("default", x, 1, [0, 1, 0, 0, 1, 0]),
                                   ("high", x.to(BF16), 2, [0, 0, 1, 0, 0, 1])):
        precision.set_ff_precision(ff)
        fake_card.clear()
        assert launch(xs) == counts
        (src, name, ints), = fake_card
        assert (src, name) == (f"{source}_h3", f"flappie_{source}_h3_layer{train_sfx}")
        assert ints == [6, 4, 8, 16, 1, affine]
    precision.set_ff_precision("high")
    for level in ("highest", None):
        precision._rnn_level = level
        fake_card.clear()
        assert launch(x) == [1, 0, 0, 1, 0, 0]
        assert fake_card[0][:2] == (source, f"flappie_{source}_layer{train_sfx}")


@pytest.mark.parametrize("kind", ["lstm_layer_tm_h3", "lstm_layer_tm_train_h3",
                                  "grumod_layer_tm_h3"])
def test_h3_wrappers_run_their_plain_twins_on_the_cpu(kind):
    """Off the card a three-pass wrapper called directly runs its plain
    twin at rdot three passes (the affine true f32), on either stream,
    and counts nothing."""
    base = kind[: -len("_h3")]
    x, iW, b, sW, lengths = (torch.from_numpy(a) for a in _layer_inputs(
        "grumod" if base.startswith("grumod") else "lstm", 10, 4, 8, 16, 3))
    fn, plain = getattr(rnn_cuda, kind), getattr(rnn_cuda, base + "_plain")
    before = fn.launches
    for xs in (x, x.to(BF16)):
        got = fn(xs, iW, b, sW, True, lengths)
        want = plain(xs, iW, b, sW, True, lengths, rdot="bf16x3")
        for g, w in zip(*(t if isinstance(t, tuple) else (t,) for t in (got, want))):
            assert torch.equal(g, w)
    assert fn.launches == before
