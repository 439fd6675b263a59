"""PyTorch port on the CPU: the training path against the JAX package.

The same numpy-seeded inputs go through both packages:

- K8's plain twin (the LSTM layer that also returns its cell state)
  against the Pallas train kernel in interpret mode: h and c within 1e-5;
- the recompute-gates adjoint (ops/rnn_vjp.py) against ``jax.grad`` of
  the JAX package's custom VJP, rtol 2e-4, atol 2e-5 (the band of
  tests/test_train.py), and ``torch.autograd.gradcheck`` in float64 of
  both autograd Functions on the CPU path;
- the partition Function against ``jax.grad`` of the scan partition;
- ``nll_loss`` and the CTC loss, value and gradients, rtol 5e-4 and atol
  5e-5 (float32 sums over a whole network in another order);
- the data pipeline's arrays equal; one Adam update against
  ``optax.adam`` within 1e-7; train-state npz files that resume bit for
  bit across the two packages and in the port; CTC convergence on a tiny
  synthetic teacher, as tests/test_train.py requires of the JAX package.

Torch runs on one thread here, as in test_torch_models.py: the CPU
path's recurrences are thousands of tiny steps.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from flappie_tpu.models import config as j_config
from flappie_tpu.models.params import init_synthetic as j_init
from flappie_tpu.ops import crf as j_crf
from flappie_tpu.ops import rnn_pallas as j_rnn_pal
from flappie_tpu.ops import rnn_vjp as j_vjp
from flappie_tpu.train import ctc as j_ctc
from flappie_tpu.train import data as j_data
from flappie_tpu.train import trainer as j_trainer

from flappie_tpu_torch.models import config as t_config
from flappie_tpu_torch.models.params import init_synthetic, params_to_torch
from flappie_tpu_torch.ops import crf_bm_cuda, rnn_cuda, rnn_vjp
from flappie_tpu_torch.ops.crf import crf_partition_ad
from flappie_tpu_torch.train import ctc as t_ctc
from flappie_tpu_torch.train import data as t_data
from flappie_tpu_torch.train import trainer as t_trainer

from test_torch_decode import _small_cfgs


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def rnd(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def tiny_cfgs():
    """tests/test_train.py's tiny model, in both packages."""
    return [mod.ModelConfig(
        name="tiny", description="tiny test model",
        convs=(mod.ConvSpec(winlen=9, in_ch=1, out_ch=16, stride=2, activation="tanh"),),
        rnns=(mod.RnnSpec("lstm", 16, backward=True), mod.RnnSpec("lstm", 16, backward=False)),
        head="flipflop", nbase=4) for mod in (j_config, t_config)]


def _layer_inputs(kind, seed=0):
    rng = np.random.default_rng(seed)
    T, B, IN, H = 12, 4, 8, 8
    G = {"lstm": 4, "grumod": 3}[kind] * H
    lengths = np.array([12, 9, 0, 5], np.int32)
    x = rnd(rng, T, B, IN) * (np.arange(T)[:, None, None] < lengths[None, :, None])
    return (x, rnd(rng, IN, G, scale=0.3), rnd(rng, G, scale=0.1), rnd(rng, H, G, scale=0.3),
            lengths, rnd(rng, T, B, H))


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


# -- K8 and the layer adjoint ------------------------------------------------


@pytest.mark.parametrize("backward", [False, True])
def test_k8_plain_matches_pallas_train_kernel(backward, monkeypatch):
    monkeypatch.setenv("FLAPPIE_TPU_RNN_K", "4")
    x, iW, b, sW, lengths, _ = _layer_inputs("lstm")
    want_h, want_c = j_rnn_pal.lstm_layer_tm_train(
        *(jnp.asarray(a) for a in (x, iW, b, sW)), interpret=True, backward=backward,
        lengths=jnp.asarray(lengths))
    before = rnn_cuda.lstm_layer_tm_train.launches
    h, c = rnn_cuda.lstm_layer_tm_train(*_t(x, iW, b, sW), backward=backward,
                                        lengths=torch.from_numpy(lengths))
    assert rnn_cuda.lstm_layer_tm_train.launches == before  # CPU tensors: plain version
    np.testing.assert_allclose(h.numpy(), np.asarray(want_h), rtol=0, atol=1e-5)
    np.testing.assert_allclose(c.numpy(), np.asarray(want_c), rtol=0, atol=1e-5)
    assert torch.equal(h, rnn_cuda.lstm_layer_tm(*_t(x, iW, b, sW), backward=backward,
                                                 lengths=torch.from_numpy(lengths)))


@pytest.mark.parametrize("backward", [False, True])
@pytest.mark.parametrize("kind", ["lstm", "grumod"])
def test_layer_grads_match_jax_custom_vjp(kind, backward, monkeypatch):
    monkeypatch.setenv("FLAPPIE_TPU_RNN_K", "4")
    x, iW, b, sW, lengths, cot = _layer_inputs(kind, seed=1 + backward)
    jl = jnp.asarray(lengths)

    def j_loss(x, iW, b, sW):
        return jnp.sum(j_vjp.recurrent_layer_ad((kind, backward), x, iW, b, sW, jl) * cot)

    want_v, want_g = jax.value_and_grad(j_loss, argnums=(0, 1, 2, 3))(
        *(jnp.asarray(a) for a in (x, iW, b, sW)))
    args = [a.requires_grad_() for a in _t(x, iW, b, sW)]
    fn = {"lstm": rnn_vjp.lstm_layer_tm_ad, "grumod": rnn_vjp.grumod_layer_tm_ad}[kind]
    v = (fn(*args, backward=backward, lengths=torch.from_numpy(lengths)) * torch.from_numpy(cot)).sum()
    got = torch.autograd.grad(v, args)
    np.testing.assert_allclose(v.item(), float(want_v), rtol=1e-5, atol=1e-5)
    for name, g, w in zip(("dx", "diW", "db", "dsW"), got, want_g):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=2e-4, atol=2e-5, err_msg=name)


@pytest.mark.parametrize("case", ["lstm-fwd", "lstm-bwd", "grumod-fwd", "grumod-bwd",
                                  "partition-4", "partition-5"])
def test_functions_pass_gradcheck(case):
    rng = np.random.default_rng(7)
    what, arg = case.split("-")
    if what == "partition":
        nbase = int(arg)
        trans = torch.from_numpy(rng.standard_normal((3, 6, 2 * nbase * (nbase + 1))))
        nblocks = torch.tensor([6, 3, 0])
        assert torch.autograd.gradcheck(lambda t: crf_partition_ad(t, nblocks, nbase),
                                        (trans.requires_grad_(),))
        return
    T, B, IN, H = 5, 3, 3, 4
    G = {"lstm": 4, "grumod": 3}[what] * H
    lengths = torch.tensor([5, 2, 0], dtype=torch.int32)
    x = rng.standard_normal((T, B, IN)) * (np.arange(T)[:, None, None] < lengths.numpy()[None, :, None])
    args = [torch.from_numpy(a).requires_grad_() for a in (
        x, rng.standard_normal((IN, G)) * 0.5, rng.standard_normal(G) * 0.2,
        rng.standard_normal((H, G)) * 0.5)]
    fn = {"lstm": rnn_vjp.lstm_layer_tm_ad, "grumod": rnn_vjp.grumod_layer_tm_ad}[what]
    assert torch.autograd.gradcheck(
        lambda *a: fn(*a, backward=arg == "bwd", lengths=lengths), args)


@pytest.mark.parametrize("nbase", [4, 5])
def test_partition_grads_match_jax_scan(nbase):
    rng = np.random.default_rng(nbase)
    trans = rnd(rng, 4, 20, 2 * nbase * (nbase + 1), scale=2.0)
    nblocks = np.array([20, 13, 0, 1], np.int32)
    g = rnd(rng, 4)
    want_v, want_g = jax.value_and_grad(lambda t: jnp.sum(
        j_crf.crf_partition(t, jnp.asarray(nblocks), nbase, impl="scan") * g))(jnp.asarray(trans))
    t = torch.from_numpy(trans).requires_grad_()
    before = crf_bm_cuda.sum_states.launches
    v = (crf_partition_ad(t, torch.from_numpy(nblocks), nbase) * torch.from_numpy(g)).sum()
    (got,) = torch.autograd.grad(v, [t])
    assert crf_bm_cuda.sum_states.launches == before
    np.testing.assert_allclose(v.item(), float(want_v), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want_g), rtol=2e-4, atol=2e-5)


# -- losses ------------------------------------------------------------------


def _loss_grads_match(j_loss, t_loss, jparams, tparams):
    want_v, want_g = jax.value_and_grad(j_loss)(jax.tree.map(jnp.asarray, jparams))
    v = t_loss(tparams)
    leaves = t_trainer.tree_leaves(tparams)
    got = torch.autograd.grad(v, [t for _, t in leaves])
    np.testing.assert_allclose(v.item(), float(want_v), rtol=5e-4, atol=5e-5)
    for (key, _), g in zip(leaves, got):
        layer, k = key[2:-2].split("']['")
        np.testing.assert_allclose(g.numpy(), np.asarray(want_g[layer][k]), rtol=5e-4, atol=5e-5,
                                   err_msg=key)


@pytest.mark.parametrize("model", ["r941_native", "r941_5mC"])
def test_nll_loss_matches_jax(model):
    """A small r941_native graph (stride-5 conv with the reference's
    right-edge rewrite, LSTM) and a small r941_5mC graph (GRU-mod, 5
    bases), ragged lengths."""
    jcfg, tcfg = _small_cfgs(hid=16, model=model, nrnn=2)
    params = j_init(jcfg, seed=1)
    signal, _, path = j_trainer.synthetic_batch(jcfg, B=3, T=200, seed=5)
    lengths = np.array([200, 153, 61], np.int32)
    tparams, _ = t_trainer.make_train_step(tcfg)[1](params, device="cpu")
    _loss_grads_match(
        lambda p: j_trainer.nll_loss(p, jcfg, jnp.asarray(signal), jnp.asarray(lengths),
                                     jnp.asarray(path), rnn_impl="scan"),
        lambda p: t_trainer.nll_loss(p, tcfg, *_t(signal, lengths, path)),
        params, tparams)


@pytest.mark.parametrize("case", ["encode", "nll"])
def test_ctc_matches_jax(case):
    rng = np.random.default_rng(11)
    targets = rng.integers(0, 4, size=(5, 14))
    targets[0, 3:7] = 2  # runs of one base alternate flip and flop
    tlen = np.array([14, 9, 1, 12, 5])
    states = t_ctc.flipflop_encode(targets, tlen, 4)
    np.testing.assert_array_equal(states, j_ctc.flipflop_encode(targets, tlen, 4))
    if case == "encode":
        return
    trans = rnd(rng, 5, 30, 40, scale=2.0)
    nblocks = np.array([30, 22, 7, 30, 11], np.int32)

    def j_loss(t):
        return jnp.sum(j_ctc.flipflop_ctc_nll(t, jnp.asarray(nblocks), jnp.asarray(states),
                                              jnp.asarray(tlen.astype(np.int32)), 4))

    want_v, want_g = jax.value_and_grad(j_loss)(jnp.asarray(trans))
    t = torch.from_numpy(trans).requires_grad_()
    v = t_ctc.flipflop_ctc_nll(t, torch.from_numpy(nblocks), torch.from_numpy(states),
                               torch.from_numpy(tlen), 4).sum()
    (got,) = torch.autograd.grad(v, [t])
    np.testing.assert_allclose(v.item(), float(want_v), rtol=5e-4, atol=5e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want_g), rtol=5e-4, atol=5e-5)


# -- data --------------------------------------------------------------------


@pytest.mark.parametrize("what", ["path_to_bases", "chunk_examples", "batches",
                                  "teacher_dataset"])
def test_data_matches_jax(what):
    jcfg, tcfg = tiny_cfgs()
    rng = np.random.default_rng(3)
    if what == "path_to_bases":
        path = rng.integers(0, 8, size=60).astype(np.int32)
        for n in (1, 17, 60):
            np.testing.assert_array_equal(t_data.path_to_bases(path, n, 4),
                                          j_data.path_to_bases(path, n, 4))
        return
    if what == "teacher_dataset":
        teacher = j_init(jcfg, seed=1)
        want = j_data.teacher_dataset(jcfg, jax.tree.map(jnp.asarray, teacher),
                                      n_reads=4, read_len=512, chunk=256, seed=0)
        got = t_data.teacher_dataset(tcfg, teacher, n_reads=4, read_len=512, chunk=256,
                                     seed=0, device="cpu")
    else:
        signal = rng.normal(size=2000).astype(np.float32)
        path = rng.integers(0, 8, size=1001).astype(np.int32)
        want = j_data.chunk_examples(signal, path, 2, 256, 4)
        got = t_data.chunk_examples(signal, path, 2, 256, 4)
    assert len(got) == len(want) > 0
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.signal, b.signal)
        np.testing.assert_array_equal(a.bases, b.bases)
    if what == "batches":
        got_b = list(t_data.batches(got, 256, batch=3, nbase=4, seed=0, epochs=2))
        want_b = list(j_data.batches(want, 256, batch=3, nbase=4, seed=0, epochs=2))
        assert len(got_b) == len(want_b) == 2 * -(-len(got) // 3)
        for gb, wb in zip(got_b, want_b):
            for a, b in zip(gb, wb):
                assert a.dtype == b.dtype
                np.testing.assert_array_equal(a, b)


# -- optimiser and train state -------------------------------------------------


def test_adam_update_matches_optax():
    rng = np.random.default_rng(4)
    # weights of the size the models hold, so that one float32 ulp of a
    # weight is far below the 1e-7 band and the band tests the update
    params = {"a": {"W": rnd(rng, 5, 3, scale=0.1)}, "b": {"b": rnd(rng, 7, scale=0.1)}}
    grads = [{"a": {"W": rnd(rng, 5, 3)}, "b": {"b": rnd(rng, 7, scale=1e-3)}} for _ in range(3)]
    opt = optax.adam(1e-3)
    jp = jax.tree.map(jnp.asarray, params)
    js = opt.init(jp)
    tp = params_to_torch(params, "cpu")
    topt = t_trainer.adam(tp, lr=1e-3)
    for g in grads:
        upd, js = opt.update(jax.tree.map(jnp.asarray, g), js, jp)
        jp = optax.apply_updates(jp, upd)
        for layer in g:
            for k in g[layer]:
                tp[layer][k].grad = torch.from_numpy(g[layer][k])
        topt.step()
    for layer in params:
        for k in params[layer]:
            np.testing.assert_allclose(tp[layer][k].detach().numpy(), np.asarray(jp[layer][k]),
                                       rtol=0, atol=1e-7)


def _jax_steps(cfg, params, opt_state, n, batch):
    step, _ = j_trainer.make_train_step(cfg, optax.adam(1e-3))
    for _ in range(n):
        params, opt_state, _ = step(params, opt_state, *(jnp.asarray(a) for a in batch))
    return params, opt_state


def _port_state(cfg, seed=99):
    return t_trainer.make_train_step(cfg, lr=1e-3)[1](init_synthetic(cfg, seed=seed),
                                                     device="cpu")


def _npz(path):
    with np.load(path) as z:
        return dict(z)


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax", "r941_native_keys"])
def test_train_state_crosses_packages(direction, tmp_path):
    """The same npz resumes in either package bit for bit; its keys are
    the JAX package's (71 for r941_native)."""
    if direction == "r941_native_keys":
        jcfg, tcfg = (m.MODELS["r941_native"] for m in (j_config, t_config))
        jp = j_init(jcfg, seed=0)
        j_trainer.save_train_state(str(tmp_path / "j.npz"), jp, optax.adam(1e-4).init(jp), 0)
        tp, topt = t_trainer.make_train_step(tcfg)[1](init_synthetic(tcfg, seed=0), device="cpu")
        t_trainer.save_train_state(str(tmp_path / "t.npz"), tp, topt, 0)
        want, got = _npz(tmp_path / "j.npz"), _npz(tmp_path / "t.npz")
        assert sorted(got) == sorted(want) and len(got) == 71
        for k in want:
            assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        return
    jcfg, tcfg = tiny_cfgs()
    batch = j_trainer.synthetic_batch(jcfg, B=2, T=128, seed=3)
    ckpt = str(tmp_path / "state.npz")
    if direction == "jax_to_port":
        jp = jax.tree.map(jnp.asarray, j_init(jcfg, seed=0))
        jp, js = _jax_steps(jcfg, jp, optax.adam(1e-3).init(jp), 2, batch)
        j_trainer.save_train_state(ckpt, jp, js, step=2)
        tp, topt = _port_state(tcfg)
        _, _, step = t_trainer.load_train_state(ckpt, tp, topt)
        t_trainer.save_train_state(str(tmp_path / "again.npz"), tp, topt, step)
        want, got = _npz(ckpt), _npz(tmp_path / "again.npz")
    else:
        tp, topt = _port_state(tcfg, seed=0)
        train_step = t_trainer.make_train_step(tcfg, lr=1e-3)[0]
        for _ in range(2):
            train_step(tp, topt, *_t(*batch))
        t_trainer.save_train_state(ckpt, tp, topt, step=2)
        jt = jax.tree.map(jnp.asarray, j_init(jcfg, seed=99))
        jp, js, step = j_trainer.load_train_state(ckpt, jt, optax.adam(1e-3).init(jt))
        j_trainer.save_train_state(str(tmp_path / "again.npz"), jp, js, step)
        want, got = _npz(ckpt), _npz(tmp_path / "again.npz")
    assert step == 2 and sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_resume_continues_bitwise(tmp_path):
    """Save after 2 steps, load into fresh templates, 3 more steps: the
    same bits as 5 uninterrupted steps."""
    _, tcfg = tiny_cfgs()
    batch = _t(*j_trainer.synthetic_batch(tcfg, B=2, T=128, seed=3))
    train_step = t_trainer.make_train_step(tcfg, lr=1e-3)[0]
    ref, ref_opt = _port_state(tcfg, seed=0)
    for _ in range(5):
        train_step(ref, ref_opt, *batch)
    p, opt = _port_state(tcfg, seed=0)
    for _ in range(2):
        train_step(p, opt, *batch)
    ckpt = str(tmp_path / "state.npz")
    t_trainer.save_train_state(ckpt, p, opt, step=2)
    p2, opt2 = _port_state(tcfg, seed=99)
    _, _, step = t_trainer.load_train_state(ckpt, p2, opt2)
    assert step == 2
    for _ in range(3):
        train_step(p2, opt2, *batch)
    t_trainer.save_train_state(str(tmp_path / "a.npz"), ref, ref_opt, 5)
    t_trainer.save_train_state(str(tmp_path / "b.npz"), p2, opt2, 5)
    a, b = _npz(tmp_path / "a.npz"), _npz(tmp_path / "b.npz")
    assert sorted(a) == sorted(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_train_state_shape_mismatch_rejected(tmp_path):
    _, tcfg = tiny_cfgs()
    p, opt = _port_state(tcfg, seed=0)
    ckpt = str(tmp_path / "state.npz")
    t_trainer.save_train_state(ckpt, p, opt, step=0)
    other = t_config.ModelConfig(name="tiny2", description="", convs=tcfg.convs,
                                 rnns=(t_config.RnnSpec("lstm", 32, backward=True),),
                                 head="flipflop", nbase=4)
    wrong, wrong_opt = _port_state(other, seed=0)
    before = {k: t.detach().clone() for k, t in t_trainer.tree_leaves(wrong)}
    with pytest.raises((ValueError, KeyError)):
        t_trainer.load_train_state(ckpt, wrong, wrong_opt)
    for k, t in t_trainer.tree_leaves(wrong):
        assert torch.equal(t, before[k])


# -- convergence and devices ---------------------------------------------------


def test_ctc_converges_on_synthetic_teacher():
    """The JAX package's rule (tests/test_train.py): a student trained
    with the CTC loss on a tiny teacher's Viterbi labels drops its mean
    NLL by more than 40% within 40 steps."""
    _, cfg = tiny_cfgs()
    exs = t_data.teacher_dataset(cfg, init_synthetic(cfg, seed=1), n_reads=6, read_len=512,
                                 chunk=256, seed=0, device="cpu")
    assert len(exs) >= 10
    train_step, init = t_ctc.make_ctc_train_step(cfg, lr=3e-3)
    p, opt = init(init_synthetic(cfg, seed=2), device="cpu")
    losses = []
    for batch in t_data.batches(exs, 256, batch=8, nbase=cfg.nbase, seed=0, epochs=30):
        losses.append(float(train_step(p, opt, *_t(*batch))))
        if len(losses) >= 40:
            break
    first, last = np.mean(losses[:3]), np.mean(losses[-3:])
    assert np.isfinite(losses).all()
    assert last < 0.6 * first, f"CTC did not converge: {first:.4f} -> {last:.4f}"


@pytest.mark.parametrize("entry", ["init", "teacher_dataset"])
def test_training_entry_points_need_cuda_unless_cpu(entry):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    _, cfg = tiny_cfgs()
    weights = init_synthetic(cfg, seed=0)
    if entry == "init":
        call = lambda **kw: t_trainer.make_train_step(cfg)[1](weights, **kw)  # noqa: E731
    else:
        call = lambda **kw: t_data.teacher_dataset(cfg, weights, 2, 256, 128, **kw)  # noqa: E731
    with pytest.raises(RuntimeError, match="no CUDA device"):
        call()
    assert call(device="cpu")
