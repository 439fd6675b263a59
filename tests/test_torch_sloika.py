"""PyTorch port on the CPU: the sloika-era graphs, the V1 run-length head
and its decode, against the JAX package.

- ``gru_seq`` / ``gru_relu_seq`` (ops/rnn.py), the residual GRU stack and
  ``transitions`` of the three sloika flavours (weights/sloika.py:
  ``flipflop_gru``, ``flipflop_grumod``, ``runlength``) under
  ``rnn_impl="auto"`` and ``"scan"``: within 5e-6 (the CPU band of the
  other graphs' tests: matmuls summed in another order), the transitions
  within 5e-6 + 1e-6 * |value| (the residual GRU's states grow to |x| ~ 8
  layer by layer, and its flip-flop weights, up to ~10 where a float32
  ulp is ~1e-6, differ by up to 5.7e-6: six ulps);
- ``globalnorm_runlength`` (ops/heads.py) within 5e-6;
- ``rle_v1_viterbi`` on the tie-injected case of tests/test_runnie.py:
  paths bit-equal, scores within 1e-5; ``rle_v1_posterior`` within rtol
  1e-5 / atol 1e-4; each under both CRF impls (the plain versions of K3-K6
  and of K11 on the CPU);
- the plain versions of the CRF kernels on the V1 chain (S = 4) against
  the JAX package's Pallas kernels in interpret mode: sum scans within
  rtol 1e-5, Viterbi and traceback bit-equal;
- ``Basecaller(model=cfg, params=params, device="cpu")`` on converted
  ``flipflop_gru`` and ``flipflop_grumod`` checkpoints: sequences and
  qualities equal to the JAX Basecaller's, the score per block (the
  CLIs' normalised_score) within 2e-5, as in tests/test_torch_e2e.py.

The sloika pickles are built as tests/test_sloika.py builds them: a
sloika-shaped object graph of classes in a throwaway module, pickled,
the module deleted before loading, so that the permissive unpickler's
stub path is what every conversion takes.
"""

from __future__ import annotations

import pickle
import sys
import types
from dataclasses import asdict

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from flappie_tpu import basecall as j_bc
from flappie_tpu.decode import runlength as j_rl
from flappie_tpu.models import network as j_net
from flappie_tpu.ops import crf_bm as j_bm
from flappie_tpu.ops import crf_bm_pallas as j_pal
from flappie_tpu.ops import crf_pallas as j_bt_pal
from flappie_tpu.ops import heads as j_heads
from flappie_tpu.ops import rnn as j_rnn
from flappie_tpu.signal.fast5 import read_raw as j_read_raw
from flappie_tpu.weights import sloika as j_sloika

from flappie_tpu_torch import basecall as t_bc
from flappie_tpu_torch.decode import runlength as t_rl
from flappie_tpu_torch.models import network as t_net
from flappie_tpu_torch.models.params import params_to_torch
from flappie_tpu_torch.ops import crf_bm_cuda, crf_cuda
from flappie_tpu_torch.ops import heads as t_heads
from flappie_tpu_torch.ops import rnn as t_rnn
from flappie_tpu_torch.ops.crf_bm import _dense_tm
from flappie_tpu_torch.signal.fast5 import read_raw as t_read_raw
from flappie_tpu_torch.signal.fast5 import write_single_read_fast5
from flappie_tpu_torch.signal.synthetic import synthetic_adc
from flappie_tpu_torch.weights import sloika as t_sloika

H = 16  # hidden size == nfilter (the residual graph adds the layer input)
FLAVOURS = ("flipflop_gru", "flipflop_grumod", "runlength")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """As in tests/test_torch_models.py: thousands of tiny recurrence
    steps run faster on one intra-op thread beside the other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# -- sloika pickles (the scheme of tests/test_sloika.py) ---------------------


def _fake_module():
    mod = types.ModuleType("sloika_fake_layers_torch")

    class Shared:
        """theano-shared-like: value buried inside container state."""

        def __init__(self, v):
            self.container = {"storage": [np.asarray(v, np.float32)]}

    class Layer:
        pass

    for cls in (Shared, Layer):
        cls.__module__ = mod.__name__
        cls.__qualname__ = cls.__name__
    mod.Shared = Shared
    mod.Layer = Layer
    return mod


def _layer(mod, **attrs):
    obj = mod.Layer()
    obj.__dict__.update(attrs)
    return obj


def _wrap(mod, inner, levels):
    for _ in range(levels):
        inner = _layer(mod, sublayers=[inner])
    return inner


def _build_network(mod, rng, flavour, winlen, stride, version):
    S = mod.Shared
    conv = _layer(mod, W=S(rng.normal(0, 0.5, (H, 1, winlen))),
                  b=S(rng.normal(0, 0.1, (H,))), stride=stride)
    layers = [conv]
    for i in range(5):
        if flavour == "flipflop_gru":
            gru = _layer(mod, iW=S(rng.normal(0, 0.3, (3 * H, H))),
                         sW=S(rng.normal(0, 0.3, (2 * H, H))),
                         sW2=S(rng.normal(0, 0.3, (H, H))),
                         b=S(rng.normal(0, 0.1, (3 * H,))))
            # backward layers: Reverse(Residual(gru)); forward: Residual(gru)
            layers.append(_wrap(mod, gru, 2 if i % 2 == 0 else 1))
        else:
            gru = _layer(mod, iW=S(rng.normal(0, 0.3, (3 * H, H))),
                         sW=S(rng.normal(0, 0.3, (3 * H, H))),
                         b=S(rng.normal(0, 0.1, (3 * H,))))
            layers.append(_wrap(mod, gru, 1 if i % 2 == 0 else 0))
    out = 16 if flavour == "runlength" else 40
    layers.append(_layer(mod, W=S(rng.normal(0, 0.2, (out, H))),
                         b=S(rng.normal(0, 0.1, (out,)))))
    return _layer(mod, version=version, sublayers=layers)


def write_sloika_pickle(path, flavour, seed=0, winlen=5, stride=2, version=(2, 0)):
    """A stub-forcing sloika pickle of ``flavour`` at ``path``."""
    mod = _fake_module()
    sys.modules[mod.__name__] = mod
    try:
        net = _build_network(mod, np.random.default_rng(seed), flavour, winlen, stride, version)
        with open(path, "wb") as fh:
            pickle.dump(net, fh, protocol=2)
    finally:
        del sys.modules[mod.__name__]
    return path


def _converted(tmp_path, flavour, seed=0):
    """(JAX config, port config, params) of one pickle converted by both
    packages; the params are equal."""
    path = write_sloika_pickle(tmp_path / f"{flavour}.pkl", flavour, seed)
    jcfg, jp = j_sloika.convert_sloika_pickle(path, flavour)
    tcfg, tp = t_sloika.convert_sloika_pickle(path, flavour)
    assert (tcfg.head, tcfg.nbase, tcfg.name) == (jcfg.head, jcfg.nbase, jcfg.name)
    assert [asdict(r) for r in tcfg.rnns] == [asdict(r) for r in jcfg.rnns]
    assert [asdict(c) for c in tcfg.convs] == [asdict(c) for c in jcfg.convs]
    for layer in jp:
        for k in jp[layer]:
            np.testing.assert_array_equal(tp[layer][k], jp[layer][k])
    return jcfg, tcfg, tp


def _signal(B, T, seed):
    rng = np.random.default_rng(seed)
    return rng.normal(0, 1, (B, T)).astype(np.float32)


# -- recurrent layers and graphs ---------------------------------------------


@pytest.mark.parametrize("kind", ["gru", "gru_relu"])
def test_gru_seqs_match_jax(kind):
    rng = np.random.default_rng(3)
    B, T = 3, 40
    xa = rng.normal(0, 1, (B, T, 3 * H)).astype(np.float32)
    sW = rng.normal(0, H ** -0.5, (H, 2 * H)).astype(np.float32)
    sW2 = rng.normal(0, H ** -0.5, (H, H)).astype(np.float32)
    j_fn = {"gru": j_rnn.gru_seq, "gru_relu": j_rnn.gru_relu_seq}[kind]
    t_fn = {"gru": t_rnn.gru_seq, "gru_relu": t_rnn.gru_relu_seq}[kind]
    want = np.asarray(j_fn(jnp.asarray(xa), jnp.asarray(sW), jnp.asarray(sW2)))
    got = t_fn(*(torch.from_numpy(a) for a in (xa, sW, sW2))).numpy()
    assert got.shape == (B, T, H)
    np.testing.assert_allclose(got, want, rtol=0, atol=5e-6)


def test_residual_gru_stack_matches_jax(tmp_path):
    """conv_stack then rnn_stack of the flipflop_gru graph: five residual
    2-matrix GRUs, backward and forward in turn, over ragged reads."""
    jcfg, tcfg, params = _converted(tmp_path, "flipflop_gru", seed=4)
    sig = _signal(3, 300, seed=5)[..., None]
    lengths = np.array([300, 211, 9], np.int32)
    jp = {k: {n: jnp.asarray(v) for n, v in d.items()} for k, d in params.items()}
    y, nb = j_net.conv_stack(jp, jcfg, jnp.asarray(sig), jnp.asarray(lengths))
    want = np.asarray(j_net.rnn_stack(jp, jcfg, y, nb, rnn_impl="scan"))
    tp = params_to_torch(params, "cpu")
    ty, tnb = t_net.conv_stack(tp, tcfg, torch.from_numpy(sig), torch.from_numpy(lengths))
    np.testing.assert_array_equal(tnb.numpy(), np.asarray(nb))
    got = t_net.rnn_stack(tp, tcfg, ty, tnb).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=5e-6)


@pytest.mark.parametrize("rnn_impl", ["auto", "scan"])
@pytest.mark.parametrize("flavour", FLAVOURS)
def test_transitions_match_jax(tmp_path, flavour, rnn_impl):
    """Each flavour's transitions within 5e-6 of JAX's (its CPU path is
    the layer-by-layer stack under either impl); under ``auto`` the
    port runs the fused stack for flipflop_grumod and runlength (K7's
    plain version here) and the layer-by-layer one for the residual
    GRUs."""
    jcfg, tcfg, params = _converted(tmp_path, flavour, seed=6)
    assert t_net.fused(tcfg) == (flavour != "flipflop_gru")
    sig = _signal(3, 600, seed=7)
    lengths = np.array([600, 411, 37], np.int32)
    want, nb_j = j_net.transitions(params, jcfg, jnp.asarray(sig), jnp.asarray(lengths),
                                   rnn_impl="scan")
    got, nb_t = t_net.transitions(params_to_torch(params, "cpu"), tcfg, torch.from_numpy(sig),
                                  torch.from_numpy(lengths), rnn_impl=rnn_impl)
    np.testing.assert_array_equal(nb_t.numpy(), np.asarray(nb_j))
    assert got.shape == want.shape == (3, 300, tcfg.out_dim)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=5e-6)


def test_train_refuses_the_layer_by_layer_stack(tmp_path):
    """Training runs the fused layers (their adjoints): a residual GRU
    graph raises rather than differentiating a plain loop."""
    _, tcfg, params = _converted(tmp_path, "flipflop_gru", seed=8)
    with pytest.raises(ValueError, match="fused"):
        t_net.transitions(params_to_torch(params, "cpu"), tcfg, torch.zeros(1, 100),
                          torch.tensor([100], dtype=torch.int32), train=True)


@pytest.mark.parametrize("temperature", [1.0, 1.3])
def test_globalnorm_runlength_matches_jax(temperature):
    rng = np.random.default_rng(9)
    B, T, nbase = 3, 50, 4
    x = rng.normal(0, 1, (B, T, H)).astype(np.float32)
    W = rng.normal(0, 0.4, (H, 4 * nbase)).astype(np.float32)
    b = rng.normal(0, 0.1, (4 * nbase,)).astype(np.float32)
    nblocks = np.array([T, 31, 0], np.int32)
    want = np.asarray(j_heads.globalnorm_runlength(
        jnp.asarray(x), jnp.asarray(W), jnp.asarray(b), temperature, jnp.asarray(nblocks), nbase))
    got = t_heads.globalnorm_runlength(*(torch.from_numpy(a) for a in (x, W, b)), temperature,
                                       torch.from_numpy(nblocks), nbase).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=5e-6)


# -- V1 decode ---------------------------------------------------------------


def _v1_tie_case():
    """tests/test_runnie.py's V1 Viterbi case: exact ties injected."""
    rng = np.random.default_rng(7)
    B, T, nbase = 3, 23, 4
    params = rng.normal(0, 2, size=(B, T, 4 * nbase)).astype(np.float32)
    params[:, 5, 2 * nbase :] = 0.0
    params[:, 6, :] = params[:, 5, :]
    return params, np.array([T, 17, 1], np.int32)


@pytest.mark.parametrize("impl", ["scanb", "pallas"])
def test_rle_v1_viterbi_matches_jax(impl, monkeypatch):
    params, nblocks = _v1_tie_case()
    score_j, path_j = (np.asarray(a) for a in j_rl.rle_v1_viterbi(
        jnp.asarray(params), jnp.asarray(nblocks), 4))
    monkeypatch.setenv("FLAPPIE_TPU_CRF_IMPL", impl)
    score_t, path_t = t_rl.rle_v1_viterbi(torch.from_numpy(params), torch.from_numpy(nblocks), 4)
    assert path_t.dtype == torch.int32
    np.testing.assert_array_equal(path_t.numpy(), path_j)
    np.testing.assert_allclose(score_t.numpy(), score_j, rtol=0, atol=1e-5)


@pytest.mark.parametrize("impl", ["scanb", "pallas"])
def test_rle_v1_posterior_matches_jax(impl, monkeypatch):
    rng = np.random.default_rng(11)
    params = rng.normal(0, 1.5, size=(3, 19, 16)).astype(np.float32)
    nblocks = np.array([19, 12, 0], np.int32)
    want = np.asarray(j_rl.rle_v1_posterior(jnp.asarray(params), jnp.asarray(nblocks), 4))
    monkeypatch.setenv("FLAPPIE_TPU_CRF_IMPL", impl)
    got = t_rl.rle_v1_posterior(torch.from_numpy(params), torch.from_numpy(nblocks), 4).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)


def test_rle_v1_index_matches_jax_and_is_kept():
    j_idx, t_idx = j_rl.rle_v1_index(4), t_rl.rle_v1_index(4)
    for a, b in zip(j_idx, t_idx):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert t_rl.rle_v1_index(4) is t_idx  # cached: its device tables are built once
    np.testing.assert_array_equal(t_rl.runlengths_unit(np.array([2, -1, 0, -1, 3])),
                                  j_rl.runlengths_unit(np.array([2, -1, 0, -1, 3])))


def _v1_dense(T, B, seed, dyadic):
    """The V1 chain's batch-minor dense blocks [T, 4, 4, B] (equal in both
    packages) and valid flags, with exact repeats to probe tie order."""
    idx = t_rl.rle_v1_index(4)
    rng = np.random.default_rng(seed)
    trans = rng.normal(0, 2, size=(B, T, idx.nparam)).astype(np.float32)
    if dyadic:
        trans = np.round(trans * 8.0) / 8.0
    trans[:, 9] = trans[:, 8]
    trans[:, :, 12] = trans[:, :, 8]  # a stay equal to a move
    nblocks = np.minimum(np.array([T, 60, 1, T, 33, 0, 2, 17, T], np.int32)[:B], T)
    tvalid = np.arange(T)[:, None] < nblocks[None, :]
    dense = np.array(j_bm._dense_tm(jnp.asarray(trans).transpose(1, 2, 0),
                                    j_rl.rle_v1_index(4)))
    t_dense = _dense_tm(torch.from_numpy(np.ascontiguousarray(trans.transpose(1, 2, 0))), idx)
    np.testing.assert_array_equal(t_dense.numpy(), dense)
    return idx, dense, tvalid


@pytest.mark.parametrize("backward", [False, True])
def test_v1_sum_scans_plain_match_pallas(backward, monkeypatch):
    """K3/K4's plain versions at S = 4 against fwd_states_pallas /
    bwd_states_pallas in interpret mode (9 reads: more than one chain warp
    of the S = 4 kernels)."""
    _, dense, tvalid = _v1_dense(75, 9, seed=12, dyadic=False)
    monkeypatch.setattr(j_pal, "TIME_BLOCK", 8)
    fn = j_pal.bwd_states_pallas if backward else j_pal.fwd_states_pallas
    want = np.asarray(fn(jnp.asarray(dense), jnp.asarray(tvalid), interpret=True))
    got = crf_bm_cuda.sum_states(torch.from_numpy(dense), torch.from_numpy(tvalid),
                                 backward).numpy()
    assert got.shape == want.shape == (76, 4, 9)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_v1_viterbi_and_traceback_plain_match_pallas(monkeypatch):
    """K5's and K6's plain versions at S = 4 bit-equal to
    viterbi_fwd_pallas and traceback_pallas in interpret mode."""
    idx, dense, tvalid = _v1_dense(75, 9, seed=13, dyadic=True)
    monkeypatch.setattr(j_pal, "TIME_BLOCK", 8)
    a_want, bp_want = (np.array(v) for v in j_pal.viterbi_fwd_pallas(
        jnp.asarray(dense), jnp.asarray(tvalid), idx.tie_rank, interpret=True))
    a_got, bp_got = crf_bm_cuda.viterbi_fwd(torch.from_numpy(dense), torch.from_numpy(tvalid),
                                            idx.tie_rank)
    np.testing.assert_array_equal(a_got.numpy(), a_want)
    np.testing.assert_array_equal(bp_got.numpy(), bp_want)
    last = np.argmax(a_want, axis=0).astype(np.int32)
    want = np.asarray(j_pal.traceback_pallas(jnp.asarray(bp_want), jnp.asarray(tvalid),
                                             jnp.asarray(last), interpret=True))
    got = crf_bm_cuda.traceback(bp_got, torch.from_numpy(tvalid), torch.from_numpy(last))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("transposed", [False, True])
def test_v1_bt_fwd_scan_plain_matches_pallas(transposed, monkeypatch):
    """K11's forward scan's plain version at S = 4 against
    fwd_scan_pallas in interpret mode, also on the backward pass's input
    (the transposed, time-reversed blocks)."""
    _, dense, tvalid = _v1_dense(75, 9, seed=14, dyadic=False)
    bt = np.ascontiguousarray(dense.transpose(0, 3, 1, 2))  # [T, B, S, S]
    if transposed:
        bt, tvalid = np.ascontiguousarray(bt[::-1].swapaxes(-1, -2)), tvalid[::-1].copy()
    monkeypatch.setattr(j_bt_pal, "TIME_BLOCK", 8)
    want = np.asarray(j_bt_pal.fwd_scan_pallas(jnp.asarray(bt), jnp.asarray(tvalid),
                                               interpret=True))
    got = crf_cuda.fwd_scan(torch.from_numpy(bt), torch.from_numpy(tvalid)).numpy()
    assert got.shape == want.shape == (75, 9, 4)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


# -- the basecaller on converted checkpoints ---------------------------------


@pytest.fixture(scope="module")
def sloika_reads(tmp_path_factory):
    """Four reads; after the 200:10 trim two are longer than the 1500
    samples of --chunk and go through the chunked program."""
    d = tmp_path_factory.mktemp("sloika_reads")
    rng = np.random.default_rng(21)
    paths = []
    for k, n in enumerate([900, 2700, 1300, 3000]):
        p = str(d / f"s{k}.fast5")
        write_single_read_fast5(p, synthetic_adc(n, rng), f"sread-{k}")
        paths.append(p)
    return paths


@pytest.mark.parametrize("flavour,rnn_impl", [("flipflop_gru", "auto"),
                                              ("flipflop_grumod", "auto"),
                                              ("flipflop_grumod", "scan")])
def test_basecaller_on_sloika_checkpoint_matches_jax(tmp_path, sloika_reads, flavour, rnn_impl):
    """sloika2npz's checkpoint, load_sloika_npz, then each package's
    Basecaller(model=cfg, params=params) in fb mode with the chunked
    program on two reads: sequences and qualities equal, scores per block
    within 2e-5 (the last printed digit of normalised_score)."""
    from flappie_tpu_torch.cli.convert import main as t_convert

    pkl = write_sloika_pickle(tmp_path / "m.pkl", flavour, seed=2)
    npz = tmp_path / "m.npz"
    assert t_convert(["sloika2npz", str(pkl), str(npz), "--flavour", flavour]) == 0
    jcfg, jparams = j_sloika.load_sloika_npz(str(npz))
    tcfg, tparams = t_sloika.load_sloika_npz(str(npz))
    kw = dict(chunk=1500, overlap=300, chunk_batch=4)
    theirs = j_bc.Basecaller(model=jcfg, params=jparams, **kw).basecall_raw_tables(
        [j_read_raw(p) for p in sloika_reads])
    caller = t_bc.Basecaller(model=tcfg, params=tparams, rnn_impl=rnn_impl, device="cpu", **kw)
    ours = caller.basecall_raw_tables([t_read_raw(p) for p in sloika_reads])
    assert len(ours) == len(theirs) == 4
    for a, b in zip(ours, theirs):
        assert a.basecall == b.basecall and len(a.basecall) > 0
        assert a.quality == b.quality
        assert (a.nblock, a.nsample, a.trim_start, a.trim_end) == (
            b.nblock, b.nsample, b.trim_start, b.trim_end)
        # the score as the CLIs print it, normalised by the blocks
        assert abs(a.score / a.nblock - b.score / b.nblock) < 2e-5, (a.score, b.score)


def test_basecaller_refuses_the_v1_head(tmp_path):
    """As the JAX package's, the basecaller decodes flip-flop heads: a V1
    run-length checkpoint runs through transitions and rle_v1_*."""
    _, tcfg, params = _converted(tmp_path, "runlength", seed=1)
    with pytest.raises(NotImplementedError, match="rle_v1_viterbi"):
        t_bc.Basecaller(model=tcfg, params=params, device="cpu")


def test_index_tables_built_in_a_basecall_take_autograd(tmp_path, sloika_reads, monkeypatch):
    """The CRF index tables are kept a device for the process: those a
    basecall builds (under inference mode) are plain tensors, so a later
    differentiable dense_from_params or _dense_tm saves them for backward."""
    from flappie_tpu_torch.ops import crf as t_crf

    monkeypatch.setattr(t_crf, "_TABLES", {})
    _, tcfg, params = _converted(tmp_path, "flipflop_grumod", seed=3)
    caller = t_bc.Basecaller(model=tcfg, params=params, device="cpu", chunk=1500, overlap=300,
                             chunk_batch=4)
    assert len(caller.basecall_raw_tables([t_read_raw(sloika_reads[0])])) == 1
    idx = t_crf.flipflop_index(4)
    tables = t_crf.index_tables(idx, "cpu")
    assert t_crf._TABLES and not any(t.is_inference() for t in tables)
    gen = torch.Generator().manual_seed(5)
    trans = torch.randn(6, 3, idx.nparam, generator=gen, requires_grad=True)
    loss = (t_crf.dense_from_params(trans, idx).exp().sum()
            + _dense_tm(trans.permute(0, 2, 1), idx).exp().sum())
    loss.backward()
    assert trans.grad is not None and torch.isfinite(trans.grad).all()
