"""PyTorch port: the kernels' plain versions against the TPU kernels.

Each CUDA kernel of the port (K1 fused LSTM, K7 fused GRU-mod, K3/K4
CRF sum scan, K9 the two fused, K5 Viterbi, K6 traceback, and the
batch-major K11 forward scan, Viterbi and traceback) has a plain PyTorch
version beside its wrapper,
which the wrapper runs for CPU tensors.  Here those plain versions are
held to the JAX package's Pallas kernels, run in interpret mode on the
CPU as the JAX package's own tests run them, and to its scan paths:

- K1 and K7 within 5e-6 (the CPU transition band);
- sum scans (K3/K4, K9, K11's forward) within rtol 1e-5 (reassociation
  of an 8-term sum);
- Viterbi bit-equal on dyadic inputs (adds and compares only);
- traceback exact (K11's Viterbi and traceback also on the V1
  run-length chain, S = 4; K3-K6 at S = 4 in tests/test_torch_sloika.py);
- K12 (the recurrences alone over a computed affine) within 1e-6.

The kernels themselves only run on a GPU: tests/test_torch_cuda.py
holds them to these plain versions on the card (and skips without one),
and chip_smoke.py does so at production shapes.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from flappie_tpu.ops import crf_bm as j_bm
from flappie_tpu.ops import crf_bm_pallas as j_pal
from flappie_tpu.ops import crf_pallas as j_bt_pal
from flappie_tpu.ops import rnn as j_rnn
from flappie_tpu.ops import rnn_pallas as j_rnn_pal
from flappie_tpu.decode.runlength import rle_v1_index
from flappie_tpu.ops.crf import flipflop_index, rle_index
from flappie_tpu.ops.masking import reverse_sequence

from flappie_tpu_torch.ops import crf_bm_cuda, crf_cuda, rnn_cuda
from flappie_tpu_torch.ops import rnn as t_rnn
from flappie_tpu_torch.ops.crf_bm import _dense_tm


def rnd(*shape, scale=1.0, seed=0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


LSTM_CASE = dict(B=5, T=37, IN=12, H=16, lengths=np.array([37, 29, 0, 5, 33], np.int32))


def _lstm_inputs(seed=0):
    c = LSTM_CASE
    x = rnd(c["B"], c["T"], c["IN"], seed=seed)
    x = x * (np.arange(c["T"])[None, :, None] < c["lengths"][:, None, None])
    return (x, rnd(c["IN"], 4 * c["H"], scale=0.3, seed=seed + 1),
            rnd(4 * c["H"], scale=0.2, seed=seed + 2), rnd(c["H"], 4 * c["H"], scale=0.3, seed=seed + 3))


def _plain_lstm(x, iW, b, sW, backward, lengths):
    x_tm = torch.from_numpy(np.ascontiguousarray(x.transpose(1, 0, 2)))
    before = rnn_cuda.lstm_layer_tm.launches
    out = rnn_cuda.lstm_layer_tm(x_tm, torch.from_numpy(iW), torch.from_numpy(b),
                                 torch.from_numpy(sW), backward=backward,
                                 lengths=torch.from_numpy(lengths))
    assert rnn_cuda.lstm_layer_tm.launches == before  # CPU tensors: plain version
    return out.numpy()


@pytest.mark.parametrize("backward", [False, True])
def test_lstm_plain_matches_fused_pallas_kernel(backward, monkeypatch):
    x, iW, b, sW = _lstm_inputs()
    lengths = LSTM_CASE["lengths"]
    # small time block: interpret mode unrolls K steps into the traced
    # graph, and compile time dominates at the default K
    monkeypatch.setenv("FLAPPIE_TPU_RNN_K", "4")
    want = np.asarray(j_rnn_pal.lstm_layer_tm(
        jnp.asarray(x.transpose(1, 0, 2)), jnp.asarray(iW), jnp.asarray(b), jnp.asarray(sW),
        interpret=True, backward=backward, lengths=jnp.asarray(lengths)))
    got = _plain_lstm(x, iW, b, sW, backward, lengths)
    np.testing.assert_allclose(got, want, rtol=0, atol=5e-6)


@pytest.mark.parametrize("backward", [False, True])
def test_lstm_plain_matches_jax_scan_path(backward):
    """The JAX scan path: affine, reverse per read for backward layers,
    lax.scan LSTM, reverse back, zero the tail."""
    x, iW, b, sW = _lstm_inputs(seed=10)
    lengths = LSTM_CASE["lengths"]
    jl = jnp.asarray(lengths)
    xa = j_rnn.affine(jnp.asarray(x), jnp.asarray(iW), jnp.asarray(b))
    if backward:
        xa = reverse_sequence(xa, jl)
    y = j_rnn.lstm_seq(xa, jnp.asarray(sW))
    if backward:
        y = reverse_sequence(y, jl)
    want = np.asarray(y) * (np.arange(LSTM_CASE["T"])[None, :, None] < lengths[:, None, None])
    got = _plain_lstm(x, iW, b, sW, backward, lengths).transpose(1, 0, 2)
    np.testing.assert_allclose(got, want, rtol=0, atol=5e-6)


GRU_CASE = dict(B=6, T=37, IN=12, H=16, lengths=np.array([37, 29, 0, 5, 33, 12], np.int32))


def _grumod_inputs(seed=0):
    """x (zero past each length), iW, b, sW.  The candidate third of b is
    pushed well away from zero: a kernel that summed xa_h into the
    recurrent product (tanh(r*(v_h + xa_h)) instead of tanh(r*v_h +
    xa_h)) would then miss by far more than the tolerance."""
    c = GRU_CASE
    H = c["H"]
    x = rnd(c["B"], c["T"], c["IN"], seed=seed)
    x = x * (np.arange(c["T"])[None, :, None] < c["lengths"][:, None, None])
    b = rnd(3 * H, scale=0.2, seed=seed + 2)
    b[2 * H :] += 0.75
    return (x, rnd(c["IN"], 3 * H, scale=0.3, seed=seed + 1), b,
            rnd(H, 3 * H, scale=0.3, seed=seed + 3))


def _plain_grumod(x, iW, b, sW, backward, lengths):
    x_tm = torch.from_numpy(np.ascontiguousarray(x.transpose(1, 0, 2)))
    before = rnn_cuda.grumod_layer_tm.launches
    out = rnn_cuda.grumod_layer_tm(x_tm, torch.from_numpy(iW), torch.from_numpy(b),
                                   torch.from_numpy(sW), backward=backward,
                                   lengths=torch.from_numpy(lengths))
    assert rnn_cuda.grumod_layer_tm.launches == before  # CPU tensors: plain version
    return out.numpy()


@pytest.mark.parametrize("dual", ["off", "on"])
@pytest.mark.parametrize("backward", [False, True])
def test_grumod_plain_matches_fused_pallas_kernel(backward, dual, monkeypatch):
    """K7's plain version against _grumod_fused_kernel and (dual=on) its
    two-chain twin _grumod_fused_dual_kernel, in interpret mode."""
    x, iW, b, sW = _grumod_inputs()
    lengths = GRU_CASE["lengths"]
    monkeypatch.setenv("FLAPPIE_TPU_RNN_K", "4")
    monkeypatch.setenv("FLAPPIE_TPU_RNN_DUAL", dual)
    want = np.asarray(j_rnn_pal.grumod_layer_tm(
        jnp.asarray(x.transpose(1, 0, 2)), jnp.asarray(iW), jnp.asarray(b), jnp.asarray(sW),
        interpret=True, backward=backward, lengths=jnp.asarray(lengths)))
    got = _plain_grumod(x, iW, b, sW, backward, lengths)
    np.testing.assert_allclose(got, want, rtol=0, atol=5e-6)


@pytest.mark.parametrize("backward", [False, True])
def test_grumod_plain_matches_jax_scan_path(backward):
    """The JAX scan path: affine, reverse per read for backward layers,
    lax.scan GRU-mod, reverse back, zero the tail."""
    x, iW, b, sW = _grumod_inputs(seed=20)
    lengths = GRU_CASE["lengths"]
    jl = jnp.asarray(lengths)
    xa = j_rnn.affine(jnp.asarray(x), jnp.asarray(iW), jnp.asarray(b))
    if backward:
        xa = reverse_sequence(xa, jl)
    y = j_rnn.grumod_seq(xa, jnp.asarray(sW))
    if backward:
        y = reverse_sequence(y, jl)
    want = np.asarray(y) * (np.arange(GRU_CASE["T"])[None, :, None] < lengths[:, None, None])
    got = _plain_grumod(x, iW, b, sW, backward, lengths).transpose(1, 0, 2)
    np.testing.assert_allclose(got, want, rtol=0, atol=5e-6)


def test_grumod_candidate_input_stays_out_of_recurrent_product():
    """The trap K7 must avoid, shown on the plain version: summing xa_h
    into v (as K1 seeds every gate) gives another function, by far more
    than the tolerance, on these inputs."""
    x, iW, b, sW = (torch.from_numpy(a) for a in _grumod_inputs(seed=30))
    H = GRU_CASE["H"]
    xa = x @ iW + b
    h = torch.zeros(GRU_CASE["B"], H)
    good = bad = h
    for t in range(GRU_CASE["T"]):
        good = t_rnn.grumod_step(xa[:, t], good, sW)
        v = bad @ sW
        z = torch.sigmoid(xa[:, t, :H] + v[:, :H])
        r = torch.sigmoid(xa[:, t, H : 2 * H] + v[:, H : 2 * H])
        bad = z * bad + (1 - z) * torch.tanh(r * (v[:, 2 * H :] + xa[:, t, 2 * H :]))
    assert (good - bad).abs().max().item() > 1e-2


def _scan_inputs(T, B, seed, dyadic=False):
    idx = flipflop_index(4)
    rng = np.random.default_rng(seed)
    trans = rng.normal(0, 2, size=(B, T, idx.nparam)).astype(np.float32)
    if dyadic:
        trans = np.round(trans * 8.0) / 8.0
    if T > 9:
        trans[:, 9] = trans[:, 8]  # exact repeats to probe tie order
    nblocks = np.minimum(np.array([T, 60, 1, T, 33, 0, 2, 17], np.int32)[:B], T)
    tvalid = np.arange(T)[:, None] < nblocks[None, :]
    dense = np.array(j_bm._dense_tm(jnp.asarray(trans).transpose(1, 2, 0), idx))
    t_dense = _dense_tm(torch.from_numpy(np.ascontiguousarray(trans.transpose(1, 2, 0))), idx)
    np.testing.assert_array_equal(t_dense.numpy(), dense)
    return idx, dense, tvalid, nblocks


@pytest.mark.parametrize("backward", [False, True])
def test_sum_scan_plain_matches_pallas(backward, monkeypatch):
    idx, dense, tvalid, _ = _scan_inputs(75, 8, seed=5)
    monkeypatch.setattr(j_pal, "TIME_BLOCK", 8)
    fn = j_pal.bwd_states_pallas if backward else j_pal.fwd_states_pallas
    want = np.asarray(fn(jnp.asarray(dense), jnp.asarray(tvalid), interpret=True))
    t_fn = crf_bm_cuda.bwd_states if backward else crf_bm_cuda.fwd_states
    got = t_fn(torch.from_numpy(dense), torch.from_numpy(tvalid)).numpy()
    assert got.shape == want.shape == (76, 8, 8)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


# the batch-minor kernels' ragged edges: one read, a partly filled warp of
# the CUDA kernels (R = 4 reads at S=8), a single step
EDGE_SHAPES = [(1, 1), (1, 3), (33, 1), (33, 3)]


@pytest.mark.parametrize("T,B", EDGE_SHAPES)
@pytest.mark.parametrize("backward", [False, True])
def test_sum_scan_plain_matches_pallas_at_edges(T, B, backward, monkeypatch):
    _, dense, tvalid, _ = _scan_inputs(T, B, seed=10 + T + B)
    monkeypatch.setattr(j_pal, "TIME_BLOCK", 8)
    fn = j_pal.bwd_states_pallas if backward else j_pal.fwd_states_pallas
    want = np.asarray(fn(jnp.asarray(dense), jnp.asarray(tvalid), interpret=True))
    got = crf_bm_cuda.sum_states_plain(torch.from_numpy(dense), torch.from_numpy(tvalid),
                                       backward).numpy()
    assert got.shape == want.shape == (T + 1, 8, B)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("T,B", EDGE_SHAPES)
def test_viterbi_plain_bit_equal_to_pallas_at_edges(T, B, monkeypatch):
    idx, dense, tvalid, _ = _scan_inputs(T, B, seed=20 + T + B, dyadic=True)
    monkeypatch.setattr(j_pal, "TIME_BLOCK", 8)
    a_want, bp_want = (np.array(v) for v in j_pal.viterbi_fwd_pallas(
        jnp.asarray(dense), jnp.asarray(tvalid), idx.tie_rank, interpret=True))
    a_got, bp_got = crf_bm_cuda.viterbi_fwd_plain(torch.from_numpy(dense),
                                                  torch.from_numpy(tvalid), idx.tie_rank)
    np.testing.assert_array_equal(a_got.numpy(), a_want)
    np.testing.assert_array_equal(bp_got.numpy(), bp_want)


def test_sum_scan_plain_matches_jax_scan():
    _, dense, tvalid, _ = _scan_inputs(120, 8, seed=6)
    for backward, j_fn in ((False, j_bm._fwd_states_tm), (True, j_bm._bwd_states_tm)):
        want = np.asarray(j_fn(jnp.asarray(dense), jnp.asarray(tvalid)))
        got = crf_bm_cuda.sum_states(torch.from_numpy(dense), torch.from_numpy(tvalid),
                                     backward).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_viterbi_plain_bit_equal_to_pallas_on_dyadic(monkeypatch):
    idx, dense, tvalid, _ = _scan_inputs(75, 8, seed=7, dyadic=True)
    monkeypatch.setattr(j_pal, "TIME_BLOCK", 8)
    a_want, bp_want = (np.array(v) for v in j_pal.viterbi_fwd_pallas(
        jnp.asarray(dense), jnp.asarray(tvalid), idx.tie_rank, interpret=True))
    a_got, bp_got = crf_bm_cuda.viterbi_fwd(torch.from_numpy(dense),
                                            torch.from_numpy(tvalid), idx.tie_rank)
    np.testing.assert_array_equal(a_got.numpy(), a_want)
    np.testing.assert_array_equal(bp_got.numpy(), bp_want)


def test_traceback_plain_exact(monkeypatch):
    idx, dense, tvalid, _ = _scan_inputs(75, 8, seed=8, dyadic=True)
    monkeypatch.setattr(j_pal, "TIME_BLOCK", 8)
    alpha, bps = (np.array(v) for v in j_pal.viterbi_fwd_pallas(
        jnp.asarray(dense), jnp.asarray(tvalid), idx.tie_rank, interpret=True))
    last = np.argmax(alpha, axis=0).astype(np.int32)
    want = np.asarray(j_pal.traceback_pallas(jnp.asarray(bps), jnp.asarray(tvalid),
                                             jnp.asarray(last), interpret=True))
    got = crf_bm_cuda.traceback(torch.from_numpy(bps), torch.from_numpy(tvalid),
                                torch.from_numpy(last)).numpy()
    np.testing.assert_array_equal(got, want)


def test_fused_fb_plain_matches_pallas(monkeypatch):
    """K9's plain version against fwdbwd_states_pallas (rtol 1e-5)."""
    _, dense, tvalid, _ = _scan_inputs(75, 8, seed=9)
    monkeypatch.setattr(j_pal, "TIME_BLOCK", 8)
    want = [np.asarray(v) for v in j_pal.fwdbwd_states_pallas(
        jnp.asarray(dense), jnp.asarray(tvalid), interpret=True)]
    d, v = torch.from_numpy(dense), torch.from_numpy(tvalid)
    before = crf_bm_cuda.fwdbwd_states.launches
    got = crf_bm_cuda.fwdbwd_states(d, v)
    assert crf_bm_cuda.fwdbwd_states.launches == before  # CPU tensors: plain version
    for g, w in zip(got, want):
        assert g.shape == w.shape == (76, 8, 8)
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-5, atol=1e-5)


def _bt_inputs(idx, T, B, seed, dyadic=False):
    """Batch-major dense blocks [T, B, S, S] and valid [T, B] for K11,
    with repeated blocks and exact repeats inside a block to probe ties."""
    rng = np.random.default_rng(seed)
    trans = rng.normal(0, 2, size=(T, B, idx.nparam)).astype(np.float32)
    if dyadic:
        trans = np.round(trans * 8.0) / 8.0
    trans[:, :, 9] = trans[:, :, 8]
    trans[10:20] = trans[0]  # repeated blocks
    dense = np.where(idx.allowed, trans[..., np.maximum(idx.param_idx, 0)], -3.0e38)
    nblocks = np.minimum(np.array([T, 60, 1, T, 33, 0, 2, 17], np.int32)[:B], T)
    return dense.astype(np.float32), np.arange(T)[:, None] < nblocks[None, :]


@pytest.mark.parametrize("nbase", [4, 5])
def test_bt_fwd_scan_plain_matches_pallas(nbase, monkeypatch):
    dense, valid = _bt_inputs(flipflop_index(nbase), 75, 8, seed=40 + nbase)
    monkeypatch.setattr(j_bt_pal, "TIME_BLOCK", 8)
    want = np.asarray(j_bt_pal.fwd_scan_pallas(jnp.asarray(dense), jnp.asarray(valid),
                                               interpret=True))
    before = crf_cuda.fwd_scan.launches
    got = crf_cuda.fwd_scan(torch.from_numpy(dense), torch.from_numpy(valid)).numpy()
    assert crf_cuda.fwd_scan.launches == before
    assert got.shape == want.shape == (75, 8, 2 * nbase)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("kind", ["flipflop", "rle", "v1"])
def test_bt_viterbi_plain_bit_equal_to_pallas_on_dyadic(kind, monkeypatch):
    idx = {"flipflop": flipflop_index, "rle": rle_index, "v1": rle_v1_index}[kind](4)
    dense, valid = _bt_inputs(idx, 75, 8, seed=44, dyadic=True)
    monkeypatch.setattr(j_bt_pal, "TIME_BLOCK", 8)
    a_want, bp_want = (np.array(v) for v in j_bt_pal.viterbi_scan_pallas(
        jnp.asarray(dense), jnp.asarray(valid), tie_rank=idx.tie_rank, interpret=True))
    a_got, bp_got = crf_cuda.viterbi_scan(torch.from_numpy(dense), torch.from_numpy(valid),
                                          idx.tie_rank)
    assert bp_got.dtype == torch.int8 and bp_want.dtype == np.int8
    np.testing.assert_array_equal(a_got.numpy(), a_want)
    np.testing.assert_array_equal(bp_got.numpy(), bp_want)


@pytest.mark.parametrize("kind", ["flipflop", "rle", "v1"])
def test_bt_traceback_plain_exact(kind, monkeypatch):
    idx = {"flipflop": flipflop_index, "rle": rle_index, "v1": rle_v1_index}[kind](4)
    dense, valid = _bt_inputs(idx, 75, 8, seed=45, dyadic=True)
    monkeypatch.setattr(j_bt_pal, "TIME_BLOCK", 8)
    alphas, bps = (np.array(v) for v in j_bt_pal.viterbi_scan_pallas(
        jnp.asarray(dense), jnp.asarray(valid), tie_rank=idx.tie_rank, interpret=True))
    last = np.argmax(alphas[-1], axis=-1).astype(np.int32)
    bp_rev, valid_rev = np.ascontiguousarray(bps[::-1]), np.ascontiguousarray(valid[::-1])
    want = np.asarray(j_bt_pal.traceback_pallas(jnp.asarray(bp_rev), jnp.asarray(valid_rev),
                                                jnp.asarray(last), interpret=True))
    got = crf_cuda.traceback_bt(torch.from_numpy(bp_rev), torch.from_numpy(valid_rev),
                                torch.from_numpy(last)).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("T", [32, 29])
@pytest.mark.parametrize("kind", ["lstm", "grumod"])
def test_seq_plain_matches_pallas_recurrence(kind, T):
    """K12's wrappers on CPU tensors (their plain versions, ops/rnn.py
    lstm_seq / grumod_seq) against lstm_seq_pallas / grumod_seq_pallas in
    interpret mode, at tests/test_ops.py:277's shapes (T=29 takes the JAX
    kernel's K=1 time block)."""
    B, H = 3, 16
    gates = 4 if kind == "lstm" else 3
    xa = rnd(B, T, gates * H, seed=50)
    sW = rnd(H, gates * H, scale=0.3, seed=51)
    j_fn = {"lstm": j_rnn_pal.lstm_seq_pallas, "grumod": j_rnn_pal.grumod_seq_pallas}[kind]
    want = np.asarray(j_fn(jnp.asarray(xa), jnp.asarray(sW), interpret=True))
    t_fn = {"lstm": rnn_cuda.lstm_seq_cuda, "grumod": rnn_cuda.grumod_seq_cuda}[kind]
    before = t_fn.launches
    got = t_fn(torch.from_numpy(xa), torch.from_numpy(sW))
    assert t_fn.launches == before  # CPU tensors: plain version
    assert got.shape == want.shape == (B, T, H)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)


def test_seq_wrappers_refuse_other_devices_and_shapes():
    for fn, G in ((rnn_cuda.lstm_seq_cuda, 64), (rnn_cuda.grumod_seq_cuda, 48)):
        with pytest.raises(ValueError):
            fn(torch.empty(2, 5, G, device="meta"), torch.empty(16, G, device="meta"))
    # shapes are checked before any launch: gate width, then H % 16 and
    # H <= 256 (the cluster recurrence's limit)
    for xa, sW in ((torch.empty(2, 5, 68), torch.empty(16, 64)),
                   (torch.empty(2, 5, 80), torch.empty(20, 80)),
                   (torch.empty(2, 5, 2048), torch.empty(512, 2048))):
        with pytest.raises(ValueError):
            rnn_cuda._launch_seq("lstm_seq_cuda", "lstm", "flappie_lstm_seq", 4, xa, sW)


def test_wrappers_refuse_other_devices():
    """No quiet fallback: a tensor on neither the CPU nor a CUDA device
    raises instead of taking the plain version."""
    meta = torch.empty(3, 2, 4, device="meta")
    with pytest.raises(ValueError):
        rnn_cuda.lstm_layer_tm(meta, torch.empty(4, 16, device="meta"),
                               torch.empty(16, device="meta"), torch.empty(4, 16, device="meta"))
    with pytest.raises(ValueError):
        crf_bm_cuda.fwd_states(torch.empty(3, 8, 8, 2, device="meta"),
                               torch.empty(3, 2, dtype=torch.bool, device="meta"))
    with pytest.raises(ValueError):
        crf_bm_cuda.traceback(torch.empty(3, 8, 2, dtype=torch.int32, device="meta"),
                              torch.empty(3, 2, dtype=torch.bool, device="meta"),
                              torch.empty(2, dtype=torch.int32, device="meta"))


def test_grumod_wrapper_refuses_other_devices():
    meta = torch.empty(3, 2, 4, device="meta")
    with pytest.raises(ValueError):
        rnn_cuda.grumod_layer_tm(meta, torch.empty(4, 48, device="meta"),
                                 torch.empty(48, device="meta"), torch.empty(16, 48, device="meta"))


def test_crf_wrappers_of_this_slice_refuse_other_devices():
    dense = torch.empty(3, 8, 8, 2, device="meta")
    valid = torch.empty(3, 2, dtype=torch.bool, device="meta")
    with pytest.raises(ValueError):
        crf_bm_cuda.fwdbwd_states(dense, valid)
    bt_dense = torch.empty(3, 2, 8, 8, device="meta")
    with pytest.raises(ValueError):
        crf_cuda.fwd_scan(bt_dense, valid)
    with pytest.raises(ValueError):
        crf_cuda.viterbi_scan(bt_dense, valid, np.zeros((8, 8), np.int32))
    with pytest.raises(ValueError):
        crf_cuda.traceback_bt(torch.empty(3, 2, 8, dtype=torch.int8, device="meta"), valid,
                              torch.empty(2, dtype=torch.int32, device="meta"))


# (M, K, N) of the block affines: the CPU widths, K and N off the 8- and
# 4-element grids, one row
AFFINE_CASES = [(37, 12, 64), (5, 8, 48), (1, 16, 40), (29, 7, 13)]


@pytest.mark.parametrize("M, K, N", AFFINE_CASES)
def test_affine_f32_plain_matches_ff_dot(M, K, N):
    """The f32 affine's wrapper on CPU tensors (its plain version, x . iW +
    b) against the TPU kernels' _ff_dot(x, iW, highest) + b
    (rnn_pallas.py:244) within 1e-6; no launch counted."""
    x, iW, b = rnd(M, K, seed=60), rnd(K, N, scale=0.3, seed=61), rnd(N, scale=0.2, seed=62)
    want = np.asarray(j_rnn_pal._ff_dot(jnp.asarray(x), jnp.asarray(iW), "highest")
                      + jnp.asarray(b))
    before = rnn_cuda.affine_f32.launches
    got = rnn_cuda.affine_f32(*(torch.from_numpy(a) for a in (x, iW, b)))
    assert rnn_cuda.affine_f32.launches == before
    assert got.dtype == torch.float32 and got.shape == (M, N)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("M, K, N", AFFINE_CASES)
def test_affine_bf16_plain_matches_ff_dot(M, K, N):
    """The bf16 affine's wrapper on CPU tensors against the stream's
    affine in the TPU kernels (bf16 x and iW, _ff_dot with f32
    accumulation, + b, one cast to bf16; rnn_pallas.py:243-245): within
    one bf16 ulp (the f32 sums' order); no launch counted on either path."""
    x, iW, b = rnd(M, K, seed=63), rnd(K, N, scale=0.3, seed=64), rnd(N, scale=0.2, seed=65)
    xb, wb = jnp.asarray(x, jnp.bfloat16), jnp.asarray(iW, jnp.bfloat16)
    want = np.asarray((j_rnn_pal._ff_dot(xb, wb, "highest") + jnp.asarray(b))
                      .astype(jnp.bfloat16).astype(jnp.float32))
    before = (rnn_cuda.affine_bf16.launches, rnn_cuda.affine_bf16_wmma.launches)
    got = rnn_cuda.affine_bf16(torch.from_numpy(x).bfloat16(), torch.from_numpy(iW).bfloat16(),
                               torch.from_numpy(b))
    assert (rnn_cuda.affine_bf16.launches, rnn_cuda.affine_bf16_wmma.launches) == before
    assert got.dtype == torch.bfloat16 and got.shape == (M, N)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=2.0 ** -7, atol=1e-6)


def test_affine_wrappers_refuse_other_devices():
    meta = torch.empty(4, 8, device="meta")
    for fn, dt in ((rnn_cuda.affine_f32, torch.float32), (rnn_cuda.affine_bf16, torch.bfloat16)):
        with pytest.raises(ValueError):
            fn(meta.to(dt), torch.empty(8, 16, device="meta", dtype=dt),
               torch.empty(16, device="meta"))
