"""PyTorch port: plain ops against the JAX package on the CPU.

Same inputs (numpy, seeded) through both packages.  Tolerances: 1e-6
for elementwise ops, convs and affines (float32 ulps of a different
summation order); 5e-6 for the recurrence (the CPU transition band);
rtol 1e-5 for the CRF sum semiring (reassociation).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from flappie_tpu.ops import activations as j_act
from flappie_tpu.ops import conv as j_conv
from flappie_tpu.ops import crf as j_crf
from flappie_tpu.ops import heads as j_heads
from flappie_tpu.ops import masking as j_mask
from flappie_tpu.ops import rnn as j_rnn
from flappie_tpu.decode.seq import phred_chars

from flappie_tpu_torch.ops import activations as t_act
from flappie_tpu_torch.ops import conv as t_conv
from flappie_tpu_torch.ops import crf as t_crf
from flappie_tpu_torch.ops import heads as t_heads
from flappie_tpu_torch.ops import masking as t_mask
from flappie_tpu_torch.ops import rnn as t_rnn


def rnd(*shape, scale=1.0, seed=0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def T(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("name", ["swish", "tanh", "elu"])
def test_activations(name):
    x = rnd(1000, scale=4.0)
    want = np.asarray(j_act.ACTIVATIONS[name](jnp.asarray(x)))
    got = t_act.ACTIVATIONS[name](T(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_masking_ops_exact():
    x = rnd(4, 23, 3, seed=1)
    lengths = np.array([23, 0, 7, 1], np.int32)
    jl, tl = jnp.asarray(lengths), T(lengths)
    for jf, tf in ((j_mask.mask_tail, t_mask.mask_tail),
                   (j_mask.reverse_sequence, t_mask.reverse_sequence)):
        np.testing.assert_array_equal(tf(T(x), tl).numpy(), np.asarray(jf(jnp.asarray(x), jl)))


@pytest.mark.parametrize("winlen,stride,cin,cout", [
    (5, 1, 1, 4), (5, 1, 4, 16), (19, 5, 16, 8), (19, 2, 1, 6), (7, 3, 2, 3),
])
def test_conv1d_same_with_edge_fix(winlen, stride, cin, cout):
    B, Tn = 5, 97
    x = rnd(B, Tn, cin, seed=winlen + stride)
    lengths = np.array([97, 60, winlen, winlen - 1, 33], np.int32)
    x = x * (np.arange(Tn)[None, :, None] < lengths[:, None, None])
    W = rnd(winlen, cin, cout, scale=0.3, seed=2)
    b = rnd(cout, scale=0.1, seed=3)
    want = np.asarray(j_conv.conv1d_same(jnp.asarray(x), jnp.asarray(W), jnp.asarray(b),
                                         stride, jnp.asarray(lengths)))
    got = t_conv.conv1d_same(T(x), T(W), T(b), stride, T(lengths)).numpy()
    assert got.shape == want.shape == (B, -(-Tn // stride), cout)
    # each output sums winlen*cin products in another order: 1e-6 for
    # the shallow convs, widening with depth (the 19x16 strided conv's
    # 304-term sums sit ~6e-6 from a float64 oracle in BOTH packages)
    tol = 1e-6 * max(1.0, winlen * cin / 16)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)


def test_conv_edge_fix_matches_oracle_tapmap():
    """The edge fix on its own against the executable C spec."""
    import oracle

    x = rnd(41, 3, seed=9)
    W = rnd(19, 3, 2, scale=0.3, seed=4)
    b = rnd(2, scale=0.1, seed=5)
    want = oracle.conv_same(x.astype(np.float64), W.astype(np.float64),
                            b.astype(np.float64), 5)
    got = t_conv.conv1d_same(T(x[None]), T(W), T(b), 5, torch.tensor([41]))[0].numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_affine_and_lstm_seq():
    B, Tn, IN, H = 3, 40, 12, 16
    x, W, b = rnd(B, Tn, IN), rnd(IN, 4 * H, scale=0.3, seed=1), rnd(4 * H, scale=0.2, seed=2)
    sW = rnd(H, 4 * H, scale=0.3, seed=3)
    xa_j = j_rnn.affine(jnp.asarray(x), jnp.asarray(W), jnp.asarray(b))
    xa_t = t_rnn.affine(T(x), T(W), T(b))
    np.testing.assert_allclose(xa_t.numpy(), np.asarray(xa_j), rtol=1e-6, atol=1e-6)
    want = np.asarray(j_rnn.lstm_seq(xa_j, jnp.asarray(sW)))
    got = t_rnn.lstm_seq(T(np.asarray(xa_j)), T(sW)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=5e-6)


def test_grumod_seq():
    """Non-zero candidate bias: the input term enters after the r gate."""
    B, Tn, IN, H = 3, 40, 12, 16
    x, W = rnd(B, Tn, IN, seed=4), rnd(IN, 3 * H, scale=0.3, seed=5)
    b = rnd(3 * H, scale=0.2, seed=6) + np.repeat(np.float32([0.0, 0.0, 0.75]), H)
    sW = rnd(H, 3 * H, scale=0.3, seed=7)
    xa_j = j_rnn.affine(jnp.asarray(x), jnp.asarray(W), jnp.asarray(b))
    want = np.asarray(j_rnn.grumod_seq(xa_j, jnp.asarray(sW)))
    got = t_rnn.grumod_seq(T(np.asarray(xa_j)), T(sW)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=5e-6)


def test_flipflop_index_equal():
    for nbase in (4, 5):
        a, b = j_crf.flipflop_index(nbase), t_crf.flipflop_index(nbase)
        for fa, fb in zip(a, b):
            np.testing.assert_array_equal(np.asarray(fa), np.asarray(fb))
    assert t_crf.NEG_BIG == j_crf.NEG_BIG and t_crf.RANK_BIG == j_crf.RANK_BIG


def test_crf_forward_and_partition():
    B, Tn = 4, 150
    trans = rnd(B, Tn, 40, scale=2.0, seed=6)
    nblocks = np.array([150, 97, 1, 0], np.int32)
    a_j, z_j = j_crf.crf_forward(jnp.asarray(trans), jnp.asarray(nblocks), 4)
    a_t, z_t = t_crf.crf_forward(T(trans), T(nblocks), 4)
    np.testing.assert_allclose(a_t.numpy(), np.asarray(a_j), rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(z_t.numpy(), np.asarray(z_j), rtol=1e-5)
    np.testing.assert_allclose(t_crf.crf_partition(T(trans), T(nblocks), 4).numpy(),
                               np.asarray(z_j), rtol=1e-5)


@pytest.mark.parametrize("return_norm", [False, True])
def test_globalnorm_flipflop(return_norm):
    B, Tn, H = 3, 80, 16
    x = rnd(B, Tn, H, seed=7)
    W, b = rnd(H, 40, scale=0.4, seed=8), rnd(40, scale=0.1, seed=9)
    nblocks = np.array([80, 41, 0], np.int32)
    args_j = (jnp.asarray(x), jnp.asarray(W), jnp.asarray(b), 0.85, jnp.asarray(nblocks), 4)
    args_t = (T(x), T(W), T(b), 0.85, T(nblocks), 4)
    want = j_heads.globalnorm_flipflop(*args_j, return_norm=return_norm)
    got = t_heads.globalnorm_flipflop(*args_t, return_norm=return_norm)
    if not return_norm:
        want, got = (want,), (got,)
    for w, g in zip(want, got):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=2e-6)


def test_phred_from_qpath_matches_host_formula():
    """Device phred bytes == decode.seq's host formula (the reference's
    qscoref/phredf) over the JAX package's own dense sweep, and == the
    JAX device version there and near the clipping edge at q = 0."""
    rng = np.random.default_rng(7)
    q = np.concatenate([
        rng.uniform(-30, 0, 300000),
        np.linspace(-25, 0, 300000),
    ]).astype(np.float32)
    got = t_crf.phred_from_qpath(T(q)).numpy()
    np.testing.assert_array_equal(got, phred_chars(np.exp(q, dtype=np.float32)))
    np.testing.assert_array_equal(got, np.asarray(j_crf.phred_from_qpath(jnp.asarray(q))))
    edge = np.concatenate([[0.0, -1e-7], -np.geomspace(1e-6, 1e-3, 20001)]).astype(np.float32)
    # near p = 1, log1p(-p) turns one ulp of exp (torch's CPU exp and
    # XLA's differ by one ulp at a few points) into a byte: |delta| <= 1
    # at no more than 2 of these 20003 adversarial points
    d = (t_crf.phred_from_qpath(T(edge)).numpy().astype(int)
         - np.asarray(j_crf.phred_from_qpath(jnp.asarray(edge))).astype(int))
    assert np.abs(d).max() <= 1 and np.count_nonzero(d) <= 2
    assert t_crf.phred_from_qpath(torch.tensor([float("nan")])).item() == 33
