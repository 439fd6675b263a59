"""PyTorch port on the CPU: the channels-major conv path with K10 and the
layer-by-layer recurrent path with K12, against the JAX package.

- ``conv1d_same_ct`` / ``conv1d_strided_ct`` (ops/conv.py) against JAX's,
  ragged lengths, w19 at strides 5 and 2: atol/rtol 1e-5;
- K10's plain version (ops/conv_cuda.py ``conv12_fused_plain``) against
  ``_conv12_pallas`` in interpret mode and ``_conv12_xla``: atol 5e-6;
  the autograd Function's gradients against ``jax.grad`` of JAX's
  ``conv12_fused``: 1e-5 of max |grad|;
- ``conv_stack`` under each FLAPPIE_TPU_CONV_IMPL against JAX's under the
  same knob (shrunk r941_native and r941_5mC): 1e-5;
- ``transitions(rnn_impl="scan")`` against JAX's: 5e-6 (the CPU band);
- a training step under ``pallas`` against the default conv: 1e-5.

A spy proves which conv path each package took (``_Spies``); the CLIs
under the conv knobs are in tests/test_torch_conv_cli.py.  On the CPU
the port's wrappers run their plain versions; K10 and K12 themselves
are held to them on the card by tests/test_torch_cuda.py and
chip_smoke.py.
"""

from __future__ import annotations

from dataclasses import replace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import flappie_tpu.ops.conv as j_conv
import flappie_tpu.ops.conv_pallas as j_conv_pal
from flappie_tpu.models import network as j_net
from flappie_tpu.models.params import init_synthetic

from flappie_tpu_torch.models import network as t_net
from flappie_tpu_torch.models.params import params_to_torch
from flappie_tpu_torch.ops import conv as t_conv
from flappie_tpu_torch.ops import conv_cuda
from flappie_tpu_torch.train import trainer as t_trainer

from test_torch_decode import _small_cfgs

IMPLS = ("xla", "fast", "pallas")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The CPU recurrences are thousands of tiny steps: one intra-op
    thread keeps them from waiting on a pool the test workers share."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def rnd(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _tail_zeroed(x, lengths):
    """Zero x [B, C, T] at t >= lengths[b]."""
    return x * (np.arange(x.shape[-1])[None, None, :] < lengths[:, None, None])


CT_LENGTHS = np.array([400, 77, 3, 251], np.int32)


@pytest.mark.parametrize("cin,cout", [(1, 4), (4, 16)])
def test_conv1d_same_ct_matches_jax(cin, cout):
    rng = np.random.default_rng(cin)
    xc = _tail_zeroed(rnd(rng, 4, cin, 400), CT_LENGTHS).astype(np.float32)
    W, b = rnd(rng, 5, cin, cout, scale=0.4), rnd(rng, cout, scale=0.1)
    want = np.asarray(j_conv.conv1d_same_ct(jnp.asarray(xc), jnp.asarray(W), jnp.asarray(b)))
    got = t_conv.conv1d_same_ct(*(torch.from_numpy(a) for a in (xc, W, b))).numpy()
    assert got.shape == want.shape == (4, cout, 400)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("cin,stride", [(16, 5), (1, 2)], ids=["w19s5", "w19s2"])
def test_conv1d_strided_ct_matches_jax(cin, stride):
    """The reference right-edge rewrite applies at both (19 % s != 0)."""
    rng = np.random.default_rng(10 + stride)
    xc = _tail_zeroed(rnd(rng, 4, cin, 400), CT_LENGTHS).astype(np.float32)
    W, b = rnd(rng, 19, cin, 24, scale=0.2), rnd(rng, 24, scale=0.1)
    want = np.asarray(j_conv.conv1d_strided_ct(jnp.asarray(xc), jnp.asarray(W), jnp.asarray(b),
                                               stride, jnp.asarray(CT_LENGTHS)))
    got = t_conv.conv1d_strided_ct(*(torch.from_numpy(a) for a in (xc, W, b)), stride,
                                   torch.from_numpy(CT_LENGTHS)).numpy()
    assert got.shape == want.shape == (4, -(-400 // stride), 24)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    # ... and the port's channels-major conv equals its own batch-major one
    same = t_conv.conv1d_same(torch.from_numpy(xc).transpose(1, 2), torch.from_numpy(W),
                              torch.from_numpy(b), stride, torch.from_numpy(CT_LENGTHS))
    np.testing.assert_allclose(got, same.numpy(), rtol=1e-5, atol=1e-5)


def _conv12_inputs():
    """tests/test_chunked.py:215's shapes: B=8, T=512, ragged lengths."""
    rng = np.random.default_rng(0)
    lengths = np.array([512, 400, 77, 3, 512, 256, 100, 511], np.int32)
    x = _tail_zeroed(rnd(rng, 8, 1, 512), lengths)[:, 0].astype(np.float32)
    return (x, rnd(rng, 5, 1, 4, scale=0.5), rnd(rng, 4, scale=0.1),
            rnd(rng, 5, 4, 16, scale=0.3), rnd(rng, 16, scale=0.1), lengths)


@pytest.mark.parametrize("want_fn", ["pallas_interpret", "xla"])
def test_conv12_plain_matches_jax(want_fn):
    args = _conv12_inputs()
    jargs = [jnp.asarray(a) for a in args]
    if want_fn == "xla":
        want = np.asarray(j_conv_pal._conv12_xla(*jargs))
    else:
        want = np.asarray(j_conv_pal._conv12_pallas(*jargs, interpret=True))
    targs = [torch.from_numpy(a) for a in args]
    before = conv_cuda.conv12_fused.launches
    got = conv_cuda.conv12_fused(*targs)
    assert conv_cuda.conv12_fused.launches == before  # CPU tensors: plain version
    assert got.shape == want.shape == (8, 16, 512)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=5e-6)
    np.testing.assert_array_equal(got.numpy(), conv_cuda.conv12_fused_plain(*targs).numpy())
    assert not got[3, :, 3:].any() and not got[2, :, 77:].any()  # both layers masked


def test_conv12_grads_match_jax():
    args = _conv12_inputs()
    cot = rnd(np.random.default_rng(9), 8, 16, 512)
    jl = jnp.asarray(args[5])

    def j_loss(x, W1, b1, W2, b2):
        return jnp.sum(j_conv_pal.conv12_fused(x, W1, b1, W2, b2, jl) * jnp.asarray(cot))

    want = jax.grad(j_loss, argnums=(0, 1, 2, 3, 4))(*(jnp.asarray(a) for a in args[:5]))
    ins = [torch.from_numpy(a).requires_grad_() for a in args[:5]]
    y = conv_cuda.conv12_fused(*ins, torch.from_numpy(args[5]))
    got = torch.autograd.grad((y * torch.from_numpy(cot)).sum(), ins)
    for name, g, w in zip(("x", "W1", "b1", "W2", "b2"), got, want):
        w = np.asarray(w)
        assert g.shape == w.shape
        assert np.abs(g.numpy() - w).max() <= 1e-5 * np.abs(w).max(), name


def test_conv12_checks_shapes_and_devices():
    x, W1, b1, W2, b2, lengths = (torch.from_numpy(a) for a in _conv12_inputs())
    with pytest.raises(ValueError):
        conv_cuda.conv12_fused(x, W1.reshape(5, 4), b1, W2, b2, lengths)
    with pytest.raises(ValueError):
        conv_cuda.conv12_fused(x[:, None], W1, b1, W2, b2, lengths)
    with pytest.raises(ValueError):
        conv_cuda.conv12_fused(x.double(), W1, b1, W2, b2, lengths)
    meta = [t.to("meta") for t in (x, W1, b1, W2, b2, lengths)]
    with pytest.raises(ValueError):
        conv_cuda.conv12_fused(*meta)


class _Spies:
    """Counts, in both packages, calls of K10's functions and of the
    strided channels-major conv (which only the fast/pallas stacks use)."""

    def __init__(self, monkeypatch):
        self.n = dict.fromkeys(("j_k10", "j_ct", "t_k10", "t_ct"), 0)
        for key, mod, name in (("j_k10", j_conv_pal, "_conv12_pallas"),
                               ("j_ct", j_conv, "conv1d_strided_ct"),
                               ("t_k10", conv_cuda, "conv12_fused_plain"),
                               ("t_ct", t_net, "conv1d_strided_ct")):
            monkeypatch.setattr(mod, name, self._wrap(key, getattr(mod, name)))

    def _wrap(self, key, fn):
        def spy(*a, **k):
            self.n[key] += 1
            return fn(*a, **k)
        return spy

    def check(self, impl, cfg):
        """Both packages took the same conv path, the one ``impl`` names."""
        fused = impl == "pallas" and cfg.convs[0].out_ch == 4
        strided_ct = impl != "xla"
        assert (self.n["j_k10"] > 0) == (self.n["t_k10"] > 0) == fused, self.n
        assert (self.n["j_ct"] > 0) == (self.n["t_ct"] > 0) == strided_ct, self.n


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("model", ["r941_native", "r941_5mC"])
def test_conv_stack_matches_jax_under_each_impl(model, impl, monkeypatch):
    """r941_native takes K10 under pallas; r941_5mC (one stride-2 conv)
    the channels-major strided conv under fast and pallas, never K10."""
    jcfg, tcfg = _small_cfgs(hid=24, model=model, nrnn=1)
    params = init_synthetic(jcfg, seed=7)
    rng = np.random.default_rng(3)
    lengths = np.array([1024, 997, 512], np.int32)
    x = _tail_zeroed(rnd(rng, 3, 1, 1024), lengths).transpose(0, 2, 1).astype(np.float32)
    spies = _Spies(monkeypatch)
    monkeypatch.setenv("FLAPPIE_TPU_CONV_IMPL", impl)
    y_j, nb_j = j_net.conv_stack(params, jcfg, jnp.asarray(x), jnp.asarray(lengths))
    y_t, nb_t = t_net.conv_stack(params_to_torch(params, "cpu"), tcfg, torch.from_numpy(x),
                                 torch.from_numpy(lengths))
    spies.check(impl, tcfg)
    np.testing.assert_array_equal(nb_t.numpy(), np.asarray(nb_j))
    assert y_t.shape == y_j.shape
    np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), rtol=1e-5, atol=1e-5)


def _residual(cfgs):
    return [replace(c, rnns=tuple(replace(r, residual=True) for r in c.rnns)) for c in cfgs]


@pytest.mark.parametrize("model", ["r941_native", "r941_5mC", "rle_r941_native", "residual",
                                   "r941_native+crf_pallas", "rle_r941_native+crf_pallas"])
def test_scan_transitions_match_jax(model, monkeypatch):
    """transitions(rnn_impl="scan"): the layer-by-layer stack (K12's
    plain versions on the CPU) against JAX's at ragged lengths; the
    residual graph takes this path under rnn_impl="auto" too, the others
    the fused stack, within the same band.  Under "+crf_pallas"
    (FLAPPIE_TPU_CRF_IMPL=pallas) JAX's head still runs its scan
    partition while the port's follows the knob (K11's plain version):
    the same band."""
    model, _, knob = model.partition("+")
    if knob:
        monkeypatch.setenv("FLAPPIE_TPU_CRF_IMPL", "pallas")
    if model == "residual":
        jcfg, tcfg = _residual(_small_cfgs(hid=16, model="r941_native", nrnn=2))
    else:
        jcfg, tcfg = _small_cfgs(hid=16, model=model, nrnn=2)
    params = init_synthetic(jcfg, seed=11)
    rng = np.random.default_rng(5)
    lengths = np.array([400, 317, 33, 0], np.int32)
    sig = rnd(rng, 4, 400)
    want, nb_j = j_net.transitions(params, jcfg, jnp.asarray(sig), jnp.asarray(lengths),
                                   rnn_impl="scan")
    tp = params_to_torch(params, "cpu")
    ts, tl = torch.from_numpy(sig), torch.from_numpy(lengths)
    got, nb_t = t_net.transitions(tp, tcfg, ts, tl, rnn_impl="scan")
    np.testing.assert_array_equal(nb_t.numpy(), np.asarray(nb_j))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=5e-6)
    assert t_net.fused(tcfg) == (model != "residual")
    auto = t_net.transitions(tp, tcfg, ts, tl)[0]
    if model == "residual":  # the same layer-by-layer stack
        assert torch.equal(auto, got)
    else:
        np.testing.assert_allclose(got.numpy(), auto.numpy(), rtol=0, atol=5e-6)


def test_transitions_refuses_other_rnn_impls():
    _, tcfg = _small_cfgs(hid=16, nrnn=1)
    tp = params_to_torch(init_synthetic(_small_cfgs(hid=16, nrnn=1)[0], seed=1), "cpu")
    sig, lengths = torch.zeros(1, 100), torch.tensor([100], dtype=torch.int32)
    for impl in ("pallas", "train", "fused"):
        with pytest.raises(ValueError):
            t_net.transitions(tp, tcfg, sig, lengths, rnn_impl=impl)
    with pytest.raises(ValueError):
        t_net.transitions(tp, tcfg, sig, lengths, train=True, rnn_impl="scan")
    unknown = replace(tcfg, rnns=(replace(tcfg.rnns[0], kind="rnn"),))
    with pytest.raises(ValueError, match="unknown rnn kind"):
        t_net.transitions(tp, unknown, sig, lengths, rnn_impl="scan")


def test_train_step_under_pallas_matches_default_conv(monkeypatch):
    """One CPU training step through K10's autograd Function: the loss
    within 1e-5 relative and every gradient within 1e-5 of its max |value|
    of the default conv's step, on the same batch and weights."""
    jcfg, tcfg = _small_cfgs(hid=16, model="r941_native", nrnn=2)
    params = init_synthetic(jcfg, seed=3)
    signal, _, path = t_trainer.synthetic_batch(tcfg, B=3, T=300, seed=4)
    batch = (torch.from_numpy(signal), torch.tensor([300, 211, 57], dtype=torch.int32),
             torch.from_numpy(path))
    spies = _Spies(monkeypatch)
    out = {}
    for impl in ("auto", "pallas"):
        monkeypatch.setenv("FLAPPIE_TPU_CONV_IMPL", impl)
        step, init = t_trainer.make_train_step(tcfg, lr=1e-3)
        # a copy: on the CPU the tensors share the numpy arrays' memory,
        # and the step updates them in place
        tparams, opt = init({k: {n: v.copy() for n, v in d.items()} for k, d in params.items()},
                            device="cpu")
        loss = t_trainer.nll_loss(tparams, tcfg, *batch)
        leaves = t_trainer.tree_leaves(tparams)
        grads = torch.autograd.grad(loss, [t for _, t in leaves])
        assert np.isfinite(step(tparams, opt, *batch).item())
        out[impl] = loss.item(), grads
    # the loss's forward and its recompute in backward, then the step's two
    assert spies.n["t_k10"] == 4, spies.n
    (l0, g0), (l1, g1) = out["auto"], out["pallas"]
    assert abs(l1 - l0) <= 1e-5 * abs(l0), (l0, l1)
    for a, b in zip(g1, g0):
        assert (a - b).abs().max().item() <= 1e-5 * b.abs().max().item()
