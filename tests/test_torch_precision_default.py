"""Precision ``default`` (the one-pass bf16 products) on the CPU.

- On the CPU each of the three knobs at ``default``
  (FLAPPIE_TPU_MATMUL_PRECISION, FLAPPIE_TPU_RNN_PRECISION,
  FLAPPIE_TPU_GRAD_PRECISION) gives the bytes it gives unset, as the JAX
  package's CPU backend, which ignores precision, does too: transitions
  under both streams, and the training gradients.
- The plain twins of the one-pass kernels (ops/rnn_cuda.py with
  ``rdot="bf16"`` and ``ff="bf16"``; ``affine_bf16_f32_plain``) against a
  reference built here in JAX: a ``lax.scan`` that rounds each product's
  operands with ``astype(jnp.bfloat16)`` and dots them with
  ``preferred_element_type=float32``, which is what the MXU's single pass
  computes.  Both sum exact products in f32, in other orders, so at
  least 95% of the elements agree within 1e-5 absolute over 24 steps and
  every element within 2e-3: where the two f32 sums of an h straddle a
  bf16 rounding boundary, the next product reads h one bf16 ulp apart
  (2^-8 relative), and the state carries that forward (seen in one case
  of the 24: 3% of its elements, at most 6.3e-4).  Under the bf16
  stream the outputs are compared within one bf16 ulp, the affine alone
  within 1e-5.
- The products outside the kernels at the one-pass level (ops/rnn.py
  ``affine``, the convs of ops/conv.py, the adjoint of ops/rnn_vjp.py),
  with the level forced for the CPU: the affine and the convs against
  products of bf16-rounded operands (bit-equal: the same torch calls on
  the same rounded operands), the adjoint's gradients within 2e-2 of
  their max |value| of the f32 adjoint's and not equal to them.

Torch runs on one thread here, as in test_torch_models.py.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax import lax

from flappie_tpu.models import network as j_net
from flappie_tpu.models.params import init_synthetic as j_init
from flappie_tpu.ops import precision as j_precision

from flappie_tpu_torch.models import network as t_net
from flappie_tpu_torch.models.params import params_to_torch
from flappie_tpu_torch.ops import conv as t_conv
from flappie_tpu_torch.ops import precision, rnn_cuda, rnn_vjp
from flappie_tpu_torch.ops import rnn as t_rnn
from flappie_tpu_torch.train import trainer as t_trainer

from test_torch_decode import _small_cfgs

BF16 = torch.bfloat16


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


def _set_default(knob: str, monkeypatch) -> None:
    """``knob`` at ``default`` in both packages."""
    if knob == "matmul":
        precision.set_ff_precision("default")
        j_precision.set_ff_precision("default")
    elif knob == "rnn":
        precision.set_rnn_precision("default")
        j_precision.set_rnn_precision("default")
    else:
        monkeypatch.setenv("FLAPPIE_TPU_GRAD_PRECISION", "default")


# -- default on the CPU: the bytes of the unset levels ------------------------------


def _inputs(model="r941_native"):
    jcfg, tcfg = _small_cfgs(hid=16, model=model, nrnn=2)
    params = j_init(jcfg, seed=4)
    rng = np.random.default_rng(8)
    signal = rng.normal(0, 1, (3, 300)).astype(np.float32)
    lengths = np.array([300, 217, 64], np.int32)
    return jcfg, tcfg, params, signal, lengths


def _port_transitions(tcfg, params, signal, lengths, stream):
    tp = params_to_torch(params, "cpu")
    out, _ = t_net.transitions(tp, tcfg, torch.from_numpy(signal), torch.from_numpy(lengths),
                               stream=stream)
    return out.numpy()


def _jax_transitions(jcfg, params, signal, lengths):
    out, _ = j_net.transitions(params, jcfg, jnp.asarray(signal), jnp.asarray(lengths),
                               rnn_impl="pallas")
    return np.asarray(out)


@pytest.mark.parametrize("stream", ["f32", "bf16"])
@pytest.mark.parametrize("knob", ["matmul", "rnn"])
@pytest.mark.parametrize("model", ["r941_native", "r941_5mC"])
def test_default_on_the_cpu_keeps_the_bytes(model, knob, stream, saved_levels, monkeypatch):
    jcfg, tcfg, params, signal, lengths = _inputs(model)
    monkeypatch.setenv("FLAPPIE_TPU_RNN_K", "4")
    if stream == "bf16":
        monkeypatch.setenv("FLAPPIE_TPU_RNN_STREAM", "bf16")
    dt = BF16 if stream == "bf16" else torch.float32
    want = _port_transitions(tcfg, params, signal, lengths, dt)
    j_want = _jax_transitions(jcfg, params, signal, lengths)
    jax.clear_caches()
    _set_default(knob, monkeypatch)
    assert precision.ff_precision("cpu") == precision.rnn_precision("cpu") == "highest"
    np.testing.assert_array_equal(_port_transitions(tcfg, params, signal, lengths, dt), want)
    np.testing.assert_array_equal(_jax_transitions(jcfg, params, signal, lengths), j_want)


@pytest.mark.parametrize("stream", ["f32", "bf16"])
@pytest.mark.parametrize("knob", ["matmul", "rnn", "grad"])
def test_default_on_the_cpu_keeps_the_gradient_bytes(knob, stream, saved_levels, monkeypatch):
    """The training step's loss and gradients (the port's nll_loss) under
    each knob at default: the bytes of the unset knobs."""
    _, tcfg, params, signal, lengths = _inputs()
    path = np.random.default_rng(2).integers(0, 4, (3, 61)).astype(np.int32)
    dt = BF16 if stream == "bf16" else torch.float32

    def grads():
        tp, _ = t_trainer.make_train_step(tcfg)[1](params, device="cpu")
        loss = t_trainer.nll_loss(tp, tcfg, *(torch.from_numpy(a) for a in (signal, lengths,
                                                                             path)), stream=dt)
        leaves = [t for _, t in t_trainer.tree_leaves(tp)]
        return [loss.detach()] + list(torch.autograd.grad(loss, leaves))

    want = grads()
    _set_default(knob, monkeypatch)
    assert precision.grad_precision("cpu") == "highest"
    for g, w in zip(grads(), want):
        assert torch.equal(g, w)


def test_grad_precision_levels(monkeypatch):
    monkeypatch.delenv("FLAPPIE_TPU_GRAD_PRECISION", raising=False)
    assert precision.grad_precision() == precision.grad_precision("cuda") == "highest"
    for level, on_card in (("HIGH", "highest"), ("highest", "highest"), ("Default", "bf16")):
        monkeypatch.setenv("FLAPPIE_TPU_GRAD_PRECISION", level)
        assert precision.grad_precision("cpu") == "highest"
        assert precision.grad_precision(torch.device("cuda")) == on_card
    monkeypatch.setenv("FLAPPIE_TPU_GRAD_PRECISION", "bf16")
    with pytest.raises(ValueError, match="FLAPPIE_TPU_GRAD_PRECISION"):
        precision.grad_precision()


# -- the plain twins of the one-pass kernels against a lax.scan reference --------------


def _layer_inputs(kind, T, B, IN, H, seed):
    rng = np.random.default_rng(seed)
    g = 4 if kind == "lstm" else 3
    lengths = np.concatenate([[T, 0, 1], rng.integers(2, T, B - 3)]).astype(np.int32)
    x = rng.standard_normal((T, B, IN)).astype(np.float32)
    iW = (rng.standard_normal((IN, g * H)) / np.sqrt(IN)).astype(np.float32)
    b = (rng.standard_normal(g * H) * 0.2).astype(np.float32)
    if kind == "lstm":
        b[H : 2 * H] += 1.0
    else:
        b[2 * H :] += 0.75
    sW = (rng.standard_normal((H, g * H)) / np.sqrt(H)).astype(np.float32)
    return x, iW, b, sW, lengths


def _one_pass_dot(a, w):
    """The MXU's single pass: operands rounded to bf16, f32 sums."""
    return jnp.dot(a.astype(jnp.bfloat16), w.astype(jnp.bfloat16),
                   preferred_element_type=jnp.float32)


def _exact_dot(a, w):
    return jnp.dot(a, w, precision=lax.Precision.HIGHEST, preferred_element_type=jnp.float32)


def reference_layer(kind, x, iW, b, sW, lengths, backward, rdot, ff, stream):
    """The fused layer as a lax.scan, each product at its level: the bf16
    stream rounds the affine to a bf16 xa; h and c carried in f32, the
    outputs 0 and the carry frozen at t >= length.  Returns (h, c) in f32
    (c None for GRU-mod)."""
    T, B, _ = x.shape
    H = sW.shape[0]
    x, iW, b, sW = (jnp.asarray(a) for a in (x, iW, b, sW))
    if stream == "bf16":
        xa = (_one_pass_dot(x, iW) + b).astype(jnp.bfloat16).astype(jnp.float32)
    else:
        xa = (_one_pass_dot if ff == "bf16" else _exact_dot)(x, iW) + b
    rd = _one_pass_dot if rdot == "bf16" else _exact_dot
    ts = jnp.arange(T)[::-1] if backward else jnp.arange(T)
    lens = jnp.asarray(lengths)[:, None]

    def step(carry, t):
        h, c = carry
        v = rd(h, sW)
        if kind == "lstm":
            xF = xa[t] + v
            u, f = jax.nn.sigmoid(xF[:, :H]), jax.nn.sigmoid(xF[:, H : 2 * H])
            g, o = jnp.tanh(xF[:, 2 * H : 3 * H]), jax.nn.sigmoid(xF[:, 3 * H :])
            c2 = f * c + u * g
            h2 = o * jnp.tanh(c2)
        else:
            z = jax.nn.sigmoid(xa[t, :, :H] + v[:, :H])
            r = jax.nn.sigmoid(xa[t, :, H : 2 * H] + v[:, H : 2 * H])
            hbar = jnp.tanh(r * v[:, 2 * H :] + xa[t, :, 2 * H :])
            h2, c2 = z * h + (1 - z) * hbar, c
        valid = t < lens
        return ((jnp.where(valid, h2, h), jnp.where(valid, c2, c)),
                (jnp.where(valid, h2, 0.0), jnp.where(valid, c2, 0.0)))

    zero = jnp.zeros((B, H), jnp.float32)
    _, (hs, cs) = lax.scan(step, (zero, zero), ts)
    order = jnp.argsort(ts)
    hs, cs = hs[order], cs[order]
    if stream == "bf16":
        hs, cs = (a.astype(jnp.bfloat16).astype(jnp.float32) for a in (hs, cs))
    return np.asarray(hs), (np.asarray(cs) if kind == "lstm" else None)


TWIN_TOL = 1e-5  # f32 sums of exact products in another order
FLIP_TOL = 2e-3  # an h one bf16 ulp apart where the sums straddle a rounding boundary


def _close(got, want, atol, rtol=0.0):
    """Every element within FLIP_TOL (or the bf16 band), and 95% within
    ``atol``."""
    d = np.abs(got - want)
    assert (d <= max(atol, FLIP_TOL) + rtol * np.abs(want)).all(), d.max()
    assert (d <= atol + rtol * np.abs(want)).mean() >= 0.95


@pytest.mark.parametrize("backward", [False, True])
@pytest.mark.parametrize("rdot,ff,stream", [("bf16", "highest", "f32"), ("bf16", "bf16", "f32"),
                                            ("highest", "bf16", "f32"), ("bf16", "highest", "bf16")])
@pytest.mark.parametrize("kind", ["lstm", "lstm_train", "grumod"])
def test_one_pass_plain_twins_match_the_reference(kind, rdot, ff, stream, backward):
    base = "lstm" if kind.startswith("lstm") else "grumod"
    x, iW, b, sW, lengths = _layer_inputs(base, 24, 5, 32, 16, seed=len(kind) + backward)
    want_h, want_c = reference_layer(base, x, iW, b, sW, lengths, backward, rdot, ff, stream)
    tx, tiW, tb, tsW = (torch.from_numpy(a) for a in (x, iW, b, sW))
    if stream == "bf16":
        tx = tx.to(BF16)
    plain = {"lstm": rnn_cuda.lstm_layer_tm_plain, "lstm_train": rnn_cuda.lstm_layer_tm_train_plain,
             "grumod": rnn_cuda.grumod_layer_tm_plain}[kind]
    got = plain(tx, tiW, tb, tsW, backward, torch.from_numpy(lengths), rdot=rdot, ff=ff)
    got_h, got_c = got if kind == "lstm_train" else (got, None)
    assert got_h.dtype == tx.dtype
    atol = TWIN_TOL if stream == "f32" else 2.0 ** -7  # bf16 out: one ulp of |h| < 1
    _close(got_h.float().numpy(), want_h, atol)
    if got_c is not None:
        _close(got_c.float().numpy(), want_c, atol, 2.0 ** -7 if stream == "bf16" else 0.0)
    # the one-pass products are another function than the exact ones
    exact = plain(tx, tiW, tb, tsW, backward, torch.from_numpy(lengths))
    exact = exact[0] if kind == "lstm_train" else exact
    assert not torch.equal(exact, got_h)


@pytest.mark.parametrize("kind", ["lstm", "lstm_train", "grumod"])
def test_p1_wrappers_run_their_plain_twins_on_the_cpu(kind, saved_levels):
    """On the CPU the rnn-``default`` wrappers run their plain twins
    (rdot one pass, the affine true f32 at either ff level, the CPU's;
    none launched, on the f32 or the bf16-stream counter), and the
    dispatchers never reach them, whatever the levels say: the CPU is
    true f32."""
    base = "lstm" if kind.startswith("lstm") else "grumod"
    x, iW, b, sW, lengths = (torch.from_numpy(a) for a in _layer_inputs(base, 10, 4, 8, 16, 3))
    p1 = {"lstm": rnn_cuda.lstm_layer_tm_p1, "lstm_train": rnn_cuda.lstm_layer_tm_train_p1,
          "grumod": rnn_cuda.grumod_layer_tm_p1}[kind]
    plain = {"lstm": rnn_cuda.lstm_layer_tm_plain, "lstm_train": rnn_cuda.lstm_layer_tm_train_plain,
             "grumod": rnn_cuda.grumod_layer_tm_plain}[kind]
    disp = {"lstm": rnn_cuda.lstm_layer_tm, "lstm_train": rnn_cuda.lstm_layer_tm_train,
            "grumod": rnn_cuda.grumod_layer_tm}[kind]
    p1_bf16 = getattr(rnn_cuda, p1.__name__[:-3] + "_bf16_p1")
    before = p1.launches, p1_bf16.launches
    want = plain(x, iW, b, sW, True, lengths, rdot="bf16")
    for ff in ("high", "default"):
        precision.set_ff_precision(ff)
        got = p1(x, iW, b, sW, True, lengths)
        for g, w in zip(*(t if kind == "lstm_train" else (t,) for t in (got, want))):
            assert torch.equal(g, w)
    got = p1(x.to(BF16), iW, b, sW, True, lengths)
    want = plain(x.to(BF16), iW, b, sW, True, lengths, rdot="bf16")
    for g, w in zip(*(t if kind == "lstm_train" else (t,) for t in (got, want))):
        assert torch.equal(g, w)
    assert (p1.launches, p1_bf16.launches) == before
    precision.set_ff_precision("high")
    exact = disp(x, iW, b, sW, True, lengths)
    precision.set_rnn_precision("default")
    precision.set_ff_precision("default")
    again = disp(x, iW, b, sW, True, lengths)
    for g, w in zip(*(t if kind == "lstm_train" else (t,) for t in (again, exact))):
        assert torch.equal(g, w)
    with pytest.raises(ValueError, match="rdot must be"):
        plain(x, iW, b, sW, rdot="default")


def test_affine_bf16_f32_plain_matches_the_one_pass_dot():
    rng = np.random.default_rng(9)
    x = rng.standard_normal((37, 24)).astype(np.float32)
    iW = rng.standard_normal((24, 40)).astype(np.float32)
    b = rng.standard_normal(40).astype(np.float32)
    want = np.asarray(_one_pass_dot(jnp.asarray(x), jnp.asarray(iW)) + b)
    got = rnn_cuda.affine_bf16_f32(*(torch.from_numpy(a) for a in (x, iW, b)))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TWIN_TOL)
    assert rnn_cuda.affine_bf16_f32.launches == 0
    # the bf16-output affine is the same sum rounded once
    assert torch.equal(rnn_cuda.affine_bf16_plain(*(torch.from_numpy(a) for a in (x, iW, b))),
                       got.to(BF16))


# -- the products outside the kernels at the one-pass level -----------------------


@pytest.fixture
def one_pass_on_cpu(monkeypatch):
    """Every level resolved to one pass, the CPU's included: exercises
    the code that runs at ``default`` on a CUDA device."""
    for name in ("ff_precision", "grad_precision"):
        monkeypatch.setattr(precision, name, lambda device=None: precision.ONE_PASS)


def test_affine_and_convs_round_their_operands(one_pass_on_cpu):
    rng = np.random.default_rng(12)
    r = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32))  # noqa: E731
    x, W, b = r(3, 50, 8), r(8, 12), r(12)
    op = precision.one_pass
    assert torch.equal(t_rnn.affine(x, W, b), t_rnn.rows_matmul(op(x), op(W)) + b)
    xc, Wc, bc = r(2, 4, 40), r(5, 4, 6), r(6)
    got = t_conv.conv1d_same_ct(xc, Wc, bc)
    xp = torch.nn.functional.pad(op(xc), (2, 2))
    xs = torch.stack([xp[:, :, k : k + 40] for k in range(5)])
    assert torch.equal(got, torch.einsum("kbct,kco->bot", xs, op(Wc)) + bc[None, :, None])
    xb = r(2, 40, 4)
    got = t_conv._conv_math(xb, Wc, bc, 5)
    want = torch.nn.functional.conv1d(torch.nn.functional.pad(op(xb).transpose(1, 2), (2, 2)),
                                      op(Wc).permute(2, 1, 0), stride=5).transpose(1, 2) + bc
    assert torch.equal(got, want)
    lengths = torch.tensor([40, 23], dtype=torch.int32)
    strided = t_conv.conv1d_strided_ct(xc, Wc, bc, 5, lengths)
    assert strided.shape == (2, 8, 6) and not torch.equal(
        strided, t_conv.conv1d_same(xc.transpose(1, 2), Wc, bc, 5, lengths))


@pytest.mark.parametrize("kind", ["lstm", "grumod"])
def test_adjoint_at_one_pass_stays_near_f32(kind, monkeypatch):
    x, iW, b, sW, lengths = _layer_inputs(kind, 16, 5, 16, 16, seed=21)
    cot = torch.from_numpy(np.random.default_rng(22).standard_normal((16, 5, 16)).astype(
        np.float32))
    fn = {"lstm": rnn_vjp.lstm_layer_tm_ad, "grumod": rnn_vjp.grumod_layer_tm_ad}[kind]

    def grads():
        args = [torch.from_numpy(a).requires_grad_() for a in (x, iW, b, sW)]
        out = fn(*args, backward=True, lengths=torch.from_numpy(lengths))
        return torch.autograd.grad((out * cot).sum(), args)

    exact = grads()
    monkeypatch.setattr(precision, "grad_precision", lambda device=None: precision.ONE_PASS)
    got = grads()
    for g, w in zip(got, exact):
        assert (g - w).abs().max() <= 2e-2 * w.abs().max()
    assert not all(torch.equal(g, w) for g, w in zip(got, exact))
