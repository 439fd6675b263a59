"""Training under the bf16 stream on the CPU against the JAX package.

The same numpy-seeded inputs go through both packages, JAX under
FLAPPIE_TPU_RNN_STREAM=bf16 (its Pallas kernels in interpret mode, time
blocks of 4 steps) and the port with ``stream=torch.bfloat16``:

- K8-bf16's plain twin (``lstm_layer_tm_train`` on a bf16 x: x and iW
  rounded, the affine rounded to a bf16 xa, f32 steps, h and c stored in
  bf16) against ``rnn_pallas.lstm_layer_tm_train(..., interpret=True)``,
  both directions, ragged lengths including 0: at IN=32, H=16 h and c
  bit-equal, as test_torch_fast.py's K1-bf16 test is there; at IN=256,
  H=64 h within 2^-7 and c within 2^-7 max(1, |c|) (one bf16 ulp of the
  value: the f32 affine sums its IN products in another order before
  the bf16 rounding), at least 99.5% of elements bit-equal;
- the layer gradients (ops/rnn_vjp.py under the stream) against
  ``jax.grad`` through ``rnn_vjp.lstm_layer_tm_ad`` / ``grumod_layer_tm_ad``
  for an f32 x (the first layer: rounded inside, dx f32) and a bf16 x
  (later layers: dx bf16), iW f32 with an f32 diW: every f32 gradient
  within 1e-3 of its max |value|, the bf16 dx within 2^-8 of its max
  |value| (one bf16 rounding of f32 sums taken in another order);
- ``nll_loss`` under the stream against ``j_trainer.nll_loss(...,
  rnn_impl="pallas")`` on small r941_native and r941_5mC graphs: the loss
  within 1e-5 relative, every gradient within 1e-3 of its max |value|;
- ``make_train_step``'s stream, the f32 parameters it trains, and the
  CTC loss keeping the f32 stream (JAX's CTC runs its scan recurrence,
  which ignores the stream).

Torch runs on one thread here, as in test_torch_models.py.
"""

from __future__ import annotations

import copy

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from flappie_tpu.models.params import init_synthetic as j_init
from flappie_tpu.ops import rnn_pallas as j_rnn_pal
from flappie_tpu.ops import rnn_vjp as j_vjp
from flappie_tpu.train import trainer as j_trainer

from flappie_tpu_torch.models import network as t_net
from flappie_tpu_torch.ops import rnn_cuda, rnn_vjp
from flappie_tpu_torch.train import ctc as t_ctc
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
def jax_stream(monkeypatch):
    """FLAPPIE_TPU_RNN_STREAM=bf16 and 4-step time blocks for the JAX
    kernels, traced anew (JAX caches its programs by shape, not by the
    environment) and leaving no trace to later tests."""
    jax.clear_caches()
    monkeypatch.setenv("FLAPPIE_TPU_RNN_K", "4")
    monkeypatch.setenv("FLAPPIE_TPU_RNN_STREAM", "bf16")
    yield
    monkeypatch.delenv("FLAPPIE_TPU_RNN_STREAM")
    jax.clear_caches()


def _layer_inputs(kind, T, B, IN, H, seed):
    """x [T, B, IN] (zero past ragged lengths T, 0, 1, ...), iW, b, sW,
    lengths [B], a cotangent [T, B, H]; the LSTM forget bias at 1, so c
    grows past 1."""
    rng = np.random.default_rng(seed)
    g = 4 if kind == "lstm" else 3
    lengths = np.concatenate([[T, 0, 1], rng.integers(2, T, B - 3)]).astype(np.int32)
    x = rng.standard_normal((T, B, IN)).astype(np.float32)
    x *= np.arange(T)[:, None, None] < lengths[None, :, None]
    iW = (rng.standard_normal((IN, g * H)) / np.sqrt(IN)).astype(np.float32)
    b = (rng.standard_normal(g * H) * 0.2).astype(np.float32)
    if kind == "lstm":
        b[H : 2 * H] += 1.0
    else:
        b[2 * H :] += 0.75
    sW = (rng.standard_normal((H, g * H)) / np.sqrt(H)).astype(np.float32)
    cot = rng.standard_normal((T, B, H)).astype(np.float32)
    return x, iW, b, sW, lengths, cot


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _f32(a):
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


# -- K8-bf16 --------------------------------------------------------------------


@pytest.mark.parametrize("IN,H,exact", [(32, 16, True), (256, 64, False)])
@pytest.mark.parametrize("backward", [False, True])
def test_k8_bf16_plain_matches_jax(backward, IN, H, exact, jax_stream):
    x, iW, b, sW, lengths, _ = _layer_inputs("lstm", 24, 5, IN, H, seed=IN + H)
    want_h, want_c = j_rnn_pal.lstm_layer_tm_train(
        *(jnp.asarray(a) for a in (x, iW, b, sW)), interpret=True, backward=backward,
        lengths=jnp.asarray(lengths))
    assert want_h.dtype == want_c.dtype == jnp.bfloat16
    before = rnn_cuda.lstm_layer_tm_train_bf16.launches
    xt, iWt, bt, sWt = _t(x, iW, b, sW)
    h, c = rnn_cuda.lstm_layer_tm_train(xt.to(BF16), iWt, bt, sWt, backward,
                                        torch.from_numpy(lengths))
    assert rnn_cuda.lstm_layer_tm_train_bf16.launches == before  # CPU: the plain version
    assert h.dtype == c.dtype == BF16 and h.shape == c.shape == (24, 5, H)
    # h is K1-bf16's h bit for bit
    assert torch.equal(h, rnn_cuda.lstm_layer_tm(xt.to(BF16), iWt, bt, sWt, backward,
                                                 torch.from_numpy(lengths)))
    got_h, got_c = h.float().numpy(), c.float().numpy()
    wh, wc = _f32(want_h), _f32(want_c)
    assert np.abs(wc).max() > 1.0  # the cell state leaves the range of h
    if exact:
        np.testing.assert_array_equal(got_h, wh)
        np.testing.assert_array_equal(got_c, wc)
    else:
        dh, dc = np.abs(got_h - wh), np.abs(got_c - wc)
        assert dh.max() <= 2.0 ** -7
        assert (dc <= 2.0 ** -7 * np.maximum(1.0, np.abs(wc))).all()
        assert (dh == 0).mean() >= 0.995 and (dc == 0).mean() >= 0.995


# -- the layer gradients ---------------------------------------------------------


def _rel(got, want) -> float:
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


@pytest.mark.parametrize("backward", [False, True])
@pytest.mark.parametrize("x_dtype", ["f32", "bf16"])
@pytest.mark.parametrize("kind", ["lstm", "grumod"])
def test_layer_grads_under_the_stream_match_jax(kind, x_dtype, backward, jax_stream):
    x, iW, b, sW, lengths, cot = _layer_inputs(kind, 12, 5, 16, 16, seed=3 + backward)
    jfn = {"lstm": j_vjp.lstm_layer_tm_ad, "grumod": j_vjp.grumod_layer_tm_ad}[kind]
    jx = jnp.asarray(x).astype(jnp.bfloat16) if x_dtype == "bf16" else jnp.asarray(x)

    def j_loss(x, iW, b, sW):
        out = jfn(x, iW, b, sW, backward=backward, lengths=jnp.asarray(lengths))
        return jnp.sum(out.astype(jnp.float32) * cot)

    want_v, want_g = jax.value_and_grad(j_loss, argnums=(0, 1, 2, 3))(
        jx, *(jnp.asarray(a) for a in (iW, b, sW)))
    assert want_g[0].dtype == jx.dtype and want_g[1].dtype == jnp.float32
    tx, tiW, tb, tsW = _t(x, iW, b, sW)
    if x_dtype == "bf16":
        tx = tx.to(BF16)
    args = [a.requires_grad_() for a in (tx, tiW, tb, tsW)]
    tfn = {"lstm": rnn_vjp.lstm_layer_tm_ad, "grumod": rnn_vjp.grumod_layer_tm_ad}[kind]
    out = tfn(*args, backward=backward, lengths=torch.from_numpy(lengths), stream=BF16)
    assert out.dtype == BF16
    v = (out.float() * torch.from_numpy(cot)).sum()
    got = torch.autograd.grad(v, args)
    assert got[0].dtype == tx.dtype and got[1].dtype == torch.float32
    assert abs(v.item() - float(want_v)) <= 1e-5 * abs(float(want_v))
    for name, g, w in zip(("dx", "diW", "db", "dsW"), got, want_g):
        band = 2.0 ** -8 if (name == "dx" and x_dtype == "bf16") else 1e-3
        err = _rel(g.float().numpy(), _f32(w))
        assert err <= band, f"{kind} {name}: {err} > {band}"


# -- the loss --------------------------------------------------------------------


def _nll_inputs(model):
    jcfg, tcfg = _small_cfgs(hid=16, model=model, nrnn=2)
    params = j_init(jcfg, seed=1)
    signal, _, path = j_trainer.synthetic_batch(jcfg, B=3, T=200, seed=5)
    lengths = np.array([200, 153, 61], np.int32)
    return jcfg, tcfg, params, signal, lengths, path


@pytest.mark.parametrize("model", ["r941_native", "r941_5mC"])
def test_nll_loss_under_the_stream_matches_jax(model, jax_stream):
    jcfg, tcfg, params, signal, lengths, path = _nll_inputs(model)
    want_v, want_g = jax.value_and_grad(
        lambda p: j_trainer.nll_loss(p, jcfg, jnp.asarray(signal), jnp.asarray(lengths),
                                     jnp.asarray(path), rnn_impl="pallas"))(
        jax.tree.map(jnp.asarray, params))
    tparams, _ = t_trainer.make_train_step(tcfg)[1](params, device="cpu")
    # stream=None reads FLAPPIE_TPU_RNN_STREAM (set here), as JAX does
    v = t_trainer.nll_loss(tparams, tcfg, *_t(signal, lengths, path))
    leaves = t_trainer.tree_leaves(tparams)
    got = torch.autograd.grad(v, [t for _, t in leaves])
    assert abs(v.item() - float(want_v)) <= 1e-5 * abs(float(want_v))
    for (key, t), g in zip(leaves, got):
        layer, k = key[2:-2].split("']['")
        assert t.dtype == g.dtype == torch.float32
        err = _rel(g.numpy(), np.asarray(want_g[layer][k]))
        assert err <= 1e-3, f"{key}: {err}"
    # the stream is another function: the f32 loss differs
    exact = t_trainer.nll_loss(tparams, tcfg, *_t(signal, lengths, path), stream=torch.float32)
    assert exact.item() != v.item()


def test_train_step_takes_the_stream_and_trains_f32_params(monkeypatch):
    """make_train_step(stream=bf16) runs the stream whatever the
    environment says; its Adam step updates the f32 parameters (never a
    pre-rounded iW); the CTC loss keeps the f32 stream under the
    environment's bf16."""
    _, tcfg, params, signal, lengths, path = _nll_inputs("r941_native")
    monkeypatch.delenv("FLAPPIE_TPU_RNN_STREAM", raising=False)
    losses = []
    for stream, env in ((BF16, None), (None, "bf16"), (torch.float32, None)):
        if env:
            monkeypatch.setenv("FLAPPIE_TPU_RNN_STREAM", env)
        step, init = t_trainer.make_train_step(tcfg, lr=1e-3, stream=stream)
        # a copy: the CPU tensors share the numpy arrays, which Adam updates
        p, opt = init(copy.deepcopy(params), device="cpu")
        before = p["rnn0"]["iW"].detach().clone()
        losses.append(step(p, opt, *_t(signal, lengths, path)).item())
        assert p["rnn0"]["iW"].dtype == torch.float32
        assert not torch.equal(p["rnn0"]["iW"], before)
        monkeypatch.delenv("FLAPPIE_TPU_RNN_STREAM", raising=False)
    assert losses[0] == losses[1] != losses[2]

    tp, _ = t_trainer.make_train_step(tcfg)[1](params, device="cpu")
    targets = np.random.default_rng(3).integers(0, 4, size=(3, 10))
    tlen = np.array([10, 7, 3])
    batch = (*_t(signal, lengths), torch.from_numpy(t_ctc.flipflop_encode(targets, tlen, 4)),
             torch.from_numpy(tlen))
    exact = t_ctc.ctc_loss(tp, tcfg, *batch).item()
    monkeypatch.setenv("FLAPPIE_TPU_RNN_STREAM", "bf16")
    assert t_ctc.ctc_loss(tp, tcfg, *batch).item() == exact
    seen = []
    real = t_net.rnn_stack_tm
    monkeypatch.setattr(t_net, "rnn_stack_tm",
                        lambda *a, **k: seen.append(a[-1]) or real(*a, **k))
    t_ctc.ctc_loss(tp, tcfg, *batch)
    assert seen == [torch.float32]
