"""PyTorch port on the card: each CUDA kernel against its plain version.

Marked ``cuda``: needs a CUDA device and skips without one (the kernels
have no CPU mode; their plain versions are held to the JAX package in
test_torch_kernels_plain.py).  Imports nothing of JAX; on a GPU machine
without JAX, skip tests/conftest.py (which sets JAX up):

    python -m pytest tests/test_torch_cuda.py --noconftest -q

Tolerances: K1, K7 and K8 max |delta| <= 1e-4 (FMA contraction and
another summation order over H products per step, compounding over T
steps), K8's h bit-equal to K1's; their shapes cover every rows-a-cluster
instantiation of the cluster recurrence (B = 1, 3, 5: R=1; 19, 24: R=2;
33: R=4; 100: R=8; 150: R=12; 240: R=16; 257: R=20, its last cluster
holding 17 rows), rows of length 0 and T, both directions; sum scans (K3/K4, K9, K11's forward)
rtol 1e-5 (reassociation), K9 bit-equal to K3/K4; Viterbi and traceback
(K5, K6 and K11's) bit-equal, the tracebacks also at the edges of their
plan (one step a segment, a round's span and one more), at T=2560, B=256
and at runnie's T=13,108, B=24, on uniformly random backpointers and on
Viterbi's; K3/K4, K5, K6 and K11 also on the V1 run-length chain (S = 4,
8 reads a warp: the 16-byte copy path at B % 4 == 0, the 4-byte one
elsewhere), and every wrapper refuses a state count it is not compiled
for (K9: S = 4).  One runnie program (rle_r941_native at
full width) on the card against the same program on the CPU: the path
equal, the selected shape and scale within 1e-4.  The training path's autograd
Functions (ops/rnn_vjp.py, ``crf_partition_ad``) against autograd
through the plain versions on the card: every gradient within 1e-3 of
its max |value|.  K10 (fused conv 1->4->16) within 1e-5 of its plain
version and zero past every length at the edges of each channel-group
plan's tile, below the halo and with T % 4 != 0, its autograd Function's
gradients within 1e-5 of max |grad|, its grid held to ``_conv12_plan``;
K12 (the recurrences alone, batch-major) within 1e-4.  The bf16 stream
(--fast): the tensor-core bf16 affine within one bf16 ulp of its plain
version (f32 product, one rounding; the sums differ in order only),
except where the f32 sum cancels to below the error of summing its K
products in another order (K 2^-23 sum_k |x_k w_k|), which one bf16 ulp
of the near-zero result cannot hold; at K and N off the 8-element grid
(its wmma path), rows off the 128-row tile, M = 1 and runnie's M too, each
launch on its path's counter; the f32 affine within f32 reassociation of
torch.matmul + b with TF32 off (K 2^-23 sum_k |x_k w_k| + 2^-23 |value|)
at the same shapes, counted once a f32 layer; both plans held to
``_affine_plan``;
K1-bf16 and K7-bf16 within 1e-2 of their plain versions (one bf16 ulp of
an output of |h| <= 1 is 2^-8; an ulp of xa moves a step's gates by
about as much, and the state carries it) at every rows-a-cluster
instantiation, bf16 out, and their cluster plan (variant 3) the f32
layers'.  K8-bf16: h within 1e-2 and c within 1e-2 max(1, |c|) of its
plain version, h bit-equal to K1-bf16's.  Precision ``default``: the
one-pass recurrences (csrc/lstm_p1.cu, grumod_p1.cu) within 1e-2
max(1, |value|) of their plain twins, with a mean within 1e-4 and a
mean over the first 16 steps within 1.5e-5 on both streams (both sum exact
products in f32 in other orders; an h whose two sums straddle a bf16
rounding boundary is read one bf16 ulp apart by the next product, and
the state carries it), while the f32-step kernel lies at least 4.5e-5 from
the twin over those steps; the LSTM's and GRU-mod's (the tensor-core step,
csrc/cluster_rnn_mma.cuh) at every rows a cluster on both streams and
directions, K8-default's h bit-equal to K1-default's, h (and c) in the
same band (GRU-mod's over at least 128 rows: a smaller B runs a batch of
that many, B rows a launch) and the f32-step kernel outside it as above;
the one-pass affine's f32 output within f32 reassociation of its plain
version; the
dispatchers' counters at each level; the new plans (bf16 sW slices)
against ``info_plan``; the training path under the stream against the
same Function on the CPU within 1e-2 of max |grad| (the adjoint reads
bf16 h and c that kernel and plain version may give one bf16 ulp
apart), and at FLAPPIE_TPU_GRAD_PRECISION=default within 5e-2 of the
f32 adjoint's but not equal to it.  Rnn precision ``high`` on the card:
the three-pass recurrences (csrc/lstm_h3.cu, grumod_h3.cu) within 1e-4 of
their plain twins on the f32 stream (1e-2 max(1, |value|) on the bf16
stream: one bf16 ulp of a stored output) and within 1e-5 over the first 16
steps, the one-pass kernel at least 3e-5 from the twin there, at every
rows a cluster, K8-high3's h bit-equal to K1-high3's; the dispatchers at
rnn high; their plans against ``info_plan``.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from flappie_tpu_torch.ops import conv_cuda, crf_bm_cuda, crf_cuda, rnn_cuda, rnn_vjp
from flappie_tpu_torch.ops import rnn as t_rnn
from flappie_tpu_torch.ops.crf import (crf_partition_ad, dense_from_params, flipflop_index, lse,
                                       rle_index)
from flappie_tpu_torch.ops.crf_bm import _dense_tm
from flappie_tpu_torch.decode.runlength import rle_v1_index
from flappie_tpu_torch.ops.crf_bm_cuda import TB_BUDGET, _tb_plan, _tb_slots, _tb_words
from flappie_tpu_torch.ops.crf_cuda import _tb_bt_plan, _tb_bt_words

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the port's kernels run only on the GPU")
    return torch.device("cuda")


def _rnd(gen, *shape, scale=1.0):
    return torch.randn(*shape, generator=gen) * scale


# (B, T, IN, H) of the recurrent layers: one batch for each rows-a-cluster
# instantiation (ops/rnn_cuda.py _cluster_plan) at full width
LAYER_SHAPES = [(5, 37, 12, 16), (19, 64, 256, 256), (1, 40, 256, 256), (3, 40, 256, 256),
                (24, 40, 256, 256), (33, 40, 256, 256), (100, 40, 256, 256),
                (150, 40, 256, 256), (240, 40, 256, 256), (257, 40, 256, 256)]


def _lengths(gen, B, T):
    """Ragged lengths with row 0 full and, when there are two rows or
    more, the last empty."""
    lengths = torch.randint(0, T + 1, (B,), generator=gen, dtype=torch.int32)
    lengths[0] = T
    if B > 1:
        lengths[-1] = 0
    return lengths


@pytest.mark.parametrize("B,T,IN,H", LAYER_SHAPES)
@pytest.mark.parametrize("backward", [False, True])
def test_lstm_kernel_matches_plain(cuda, B, T, IN, H, backward):
    gen = torch.Generator().manual_seed(B * T + H)
    lengths = _lengths(gen, B, T)
    x = _rnd(gen, T, B, IN) * (torch.arange(T)[:, None] < lengths[None, :])[..., None]
    args = [t.to(cuda) for t in (x, _rnd(gen, IN, 4 * H, scale=IN ** -0.5),
                                 _rnd(gen, 4 * H, scale=0.2), _rnd(gen, H, 4 * H, scale=H ** -0.5))]
    lengths = lengths.to(cuda)
    before = rnn_cuda.lstm_layer_tm.launches
    got = rnn_cuda.lstm_layer_tm(*args, backward=backward, lengths=lengths)
    assert rnn_cuda.lstm_layer_tm.launches == before + 1
    want = rnn_cuda.lstm_layer_tm_plain(*args, backward=backward, lengths=lengths)
    torch.cuda.synchronize()
    assert (got - want).abs().max().item() <= 1e-4


@pytest.mark.parametrize("B,T,IN,H", LAYER_SHAPES)
@pytest.mark.parametrize("backward", [False, True])
def test_grumod_kernel_matches_plain(cuda, B, T, IN, H, backward):
    """K7; the candidate third of the bias is far from zero, so summing
    xa_h into the recurrent product would show."""
    gen = torch.Generator().manual_seed(B * T + H + 1)
    lengths = _lengths(gen, B, T)
    x = _rnd(gen, T, B, IN) * (torch.arange(T)[:, None] < lengths[None, :])[..., None]
    b = _rnd(gen, 3 * H, scale=0.2)
    b[2 * H :] += 0.75
    args = [t.to(cuda) for t in (x, _rnd(gen, IN, 3 * H, scale=IN ** -0.5), b,
                                 _rnd(gen, H, 3 * H, scale=H ** -0.5))]
    lengths = lengths.to(cuda)
    before = rnn_cuda.grumod_layer_tm.launches
    got = rnn_cuda.grumod_layer_tm(*args, backward=backward, lengths=lengths)
    assert rnn_cuda.grumod_layer_tm.launches == before + 1
    want = rnn_cuda.grumod_layer_tm_plain(*args, backward=backward, lengths=lengths)
    torch.cuda.synchronize()
    assert (got - want).abs().max().item() <= 1e-4


# (nbase, B, T) of the batch-minor scans: warps of R = 32 // S reads (4 at
# S=8, 3 at S=10) partly filled (B = 1, 3, 5, 257) or full (24, 40: at S=8
# the 16-byte copy path), T at 1, at a ring tile's edge (KT - 1, KT, KT + 1
# = 7, 8, 9) and at the ring's length + 1 (RING * KT + 1 = 33); ops/crf_bm_cuda.py
# _scan_plan
SCAN_SHAPES = [(4, 40, 75), (5, 7, 33), (4, 1, 1), (4, 3, 7), (4, 5, 8), (4, 24, 9),
               (4, 257, 33), (5, 1, 9), (5, 3, 1), (5, 5, 8), (5, 24, 7), (5, 257, 33)]
# ... and of the V1 chain (S = 4, R = 8 reads a warp): a partly filled warp
# with B % 4 == 0 (4, 12: the 16-byte path's zero-filled second copy of a
# run) and B % 4 != 0 (1, 5, 257: the 4-byte path), full warps (24, 256)
V1_SCAN_SHAPES = [pytest.param("v1", B, T, id=f"v1-{B}-{T}")
                  for B, T in ((1, 1), (4, 7), (5, 8), (12, 9), (24, 33), (257, 33),
                               (256, 75))]


def _chain_index(nbase):
    """The chain of a scan case: flip-flop over nbase bases, or the V1
    run-length chain."""
    return rle_v1_index(4) if nbase == "v1" else flipflop_index(nbase)


def _nblocks(gen, B, T):
    """Ragged block counts: the last read empty, read 0 full."""
    nblocks = torch.randint(0, T + 1, (B,), generator=gen)
    nblocks[-1] = 0
    nblocks[0] = T
    return nblocks


@pytest.mark.parametrize("nbase,B,T", SCAN_SHAPES + V1_SCAN_SHAPES)
def test_crf_kernels_match_plain(cuda, nbase, B, T):
    idx = _chain_index(nbase)
    gen = torch.Generator().manual_seed(T)
    trans = torch.round(_rnd(gen, T, idx.nparam, B, scale=2.0) * 8.0) / 8.0  # dyadic
    nblocks = _nblocks(gen, B, T)
    d = _dense_tm(trans.to(cuda), idx)
    v = (torch.arange(T)[:, None] < nblocks[None, :]).to(cuda)
    for backward in (False, True):
        got = crf_bm_cuda.sum_states(d, v, backward)
        want = crf_bm_cuda.sum_states_plain(d, v, backward)
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    a, bp = crf_bm_cuda.viterbi_fwd(d, v, idx.tie_rank)
    a0, bp0 = crf_bm_cuda.viterbi_fwd_plain(d, v, idx.tie_rank)
    assert torch.equal(a, a0) and torch.equal(bp, bp0)
    last = a.argmax(dim=0).to(torch.int32)
    assert torch.equal(crf_bm_cuda.traceback(bp, v, last),
                       crf_bm_cuda.traceback_plain(bp, v, last))


@pytest.mark.parametrize("nbase,B,T", SCAN_SHAPES)
def test_fused_fb_kernel_matches_plain_and_split(cuda, nbase, B, T):
    """K9 within rtol 1e-5 of its plain version, bit-equal to K3/K4."""
    idx = flipflop_index(nbase)
    gen = torch.Generator().manual_seed(T + 1)
    trans = _rnd(gen, T, idx.nparam, B, scale=2.0)
    nblocks = _nblocks(gen, B, T)
    d = _dense_tm(trans.to(cuda), idx)
    v = (torch.arange(T)[:, None] < nblocks[None, :]).to(cuda)
    before = crf_bm_cuda.fwdbwd_states.launches
    got = crf_bm_cuda.fwdbwd_states(d, v)
    assert crf_bm_cuda.fwdbwd_states.launches == before + 1
    want = crf_bm_cuda.fwdbwd_states_plain(d, v)
    for g, w, backward in zip(got, want, (False, True)):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-5)
        assert torch.equal(g, crf_bm_cuda.sum_states(d, v, backward))


# (kind, nbase, B, T) of K11: chain warps of R = 32 // S reads (4 at S=8, 3
# at S=10) partly filled (B = 1, 3, 5, 31, 33, 257) or full (24), T at 1 and
# at a ring tile's edge (KT - 1, KT + 1 = 7, 9), and the production length
# 2560; ops/crf_cuda.py _bt_plan
BT_SHAPES = ([("flipflop", 4, 40, 75), ("rle", 4, 37, 70), ("flipflop", 5, 7, 33)]
             + [(kind, nbase, B, T) for kind, nbase in (("rle", 4), ("flipflop", 5))
                for B in (1, 3, 5, 24, 31, 33, 257) for T in (1, 7, 9)]
             + [("rle", 4, 24, 2560), ("rle", 4, 257, 2560), ("flipflop", 4, 31, 2560),
                ("flipflop", 5, 33, 2560)]
             # the V1 chain: R = 8 reads a warp, one 16-byte copy a producer lane
             # a step, zero-filled past B
             + [("v1", 4, B, T) for B in (1, 5, 8, 9, 33) for T in (1, 7, 9)]
             + [("v1", 4, 256, 2560), ("v1", 4, 257, 75)])


@pytest.mark.parametrize("kind,nbase,B,T", BT_SHAPES)
def test_bt_kernels_match_plain(cuda, kind, nbase, B, T):
    """K11: forward scan rtol 1e-5 (also over the backward pass's input,
    the transposed, time-reversed blocks), Viterbi (alphas and int8
    backpointers) and traceback bit-equal, on dyadic weights."""
    idx = {"flipflop": flipflop_index, "rle": rle_index, "v1": rle_v1_index}[kind](nbase)
    gen = torch.Generator().manual_seed(T + 2)
    trans = torch.round(_rnd(gen, T, B, idx.nparam, scale=2.0) * 8.0) / 8.0
    nblocks = torch.randint(0, T + 1, (B,), generator=gen)
    nblocks[-1] = 0
    nblocks[0] = T  # so that B=1 holds a full read
    d = dense_from_params(trans.to(cuda), idx)  # [T, B, S, S]
    v = (torch.arange(T)[:, None] < nblocks[None, :]).to(cuda)
    n, n1, n2 = [f.launches for f in (crf_cuda.fwd_scan, crf_cuda.viterbi_scan,
                                      crf_cuda.traceback_bt)]
    torch.testing.assert_close(crf_cuda.fwd_scan(d, v), crf_cuda.fwd_scan_plain(d, v),
                               rtol=1e-5, atol=1e-5)
    rev = d.flip(0).transpose(-1, -2)
    torch.testing.assert_close(crf_cuda.fwd_scan(rev, v.flip(0)),
                               crf_cuda.fwd_scan_plain(rev, v.flip(0)), rtol=1e-5, atol=1e-5)
    a, bp = crf_cuda.viterbi_scan(d, v, idx.tie_rank)
    a0, bp0 = crf_cuda.viterbi_scan_plain(d, v, idx.tie_rank)
    assert bp.dtype == torch.int8 and torch.equal(a, a0) and torch.equal(bp, bp0)
    last = a[-1].argmax(dim=-1).to(torch.int32)
    bp_rev, v_rev = bp.flip(0), v.flip(0)
    assert torch.equal(crf_cuda.traceback_bt(bp_rev, v_rev, last),
                       crf_cuda.traceback_bt_plain(bp_rev, v_rev, last))
    assert [f.launches for f in (crf_cuda.fwd_scan, crf_cuda.viterbi_scan,
                                 crf_cuda.traceback_bt)] == [n + 2, n1 + 1, n2 + 1]


@pytest.mark.parametrize("impl", ["scanb", "pallas"])
@pytest.mark.parametrize("viterbi_only", [False, True])
def test_runnie_program_matches_cpu(cuda, monkeypatch, impl, viterbi_only):
    """One runnie program at full width (rle_r941_native, synthetic
    weights) on the card and on the CPU: the path equal, the selected
    shape and scale within 1e-4, nblocks equal."""
    from flappie_tpu_torch.cli.runnie import _device_runnie
    from flappie_tpu_torch.models.config import get_model_config
    from flappie_tpu_torch.models.params import init_synthetic, params_to_torch

    monkeypatch.setenv("FLAPPIE_TPU_CRF_IMPL", impl)
    cfg = get_model_config("rle_r941_native")
    params = init_synthetic(cfg, seed=0)
    rng = np.random.default_rng(5)
    sig = rng.normal(size=(3, 2048)).astype(np.float32)
    lengths = np.array([2048, 1500, 333], np.int32)
    outs = []
    for dev in ("cpu", cuda):
        with torch.inference_mode():
            got = _device_runnie(params_to_torch(params, dev), torch.from_numpy(sig).to(dev),
                                 torch.from_numpy(lengths).to(dev), cfg, 1.0, viterbi_only)
        outs.append([t.cpu() for t in got])
    (nb0, _, p0, sh0, sc0), (nb1, _, p1, sh1, sc1) = outs
    assert torch.equal(nb0, nb1)
    for r in range(3):
        n = int(nb0[r])
        assert torch.equal(p0[r, :n], p1[r, :n])
        torch.testing.assert_close(sh1[r, :n], sh0[r, :n], rtol=0, atol=1e-4)
        torch.testing.assert_close(sc1[r, :n], sc0[r, :n], rtol=0, atol=1e-4)


@pytest.mark.parametrize("B,T,IN,H", LAYER_SHAPES)
@pytest.mark.parametrize("backward", [False, True])
def test_lstm_train_kernel_matches_plain_and_k1(cuda, B, T, IN, H, backward):
    """K8: h and c against the plain version; h bit-equal to K1's."""
    gen = torch.Generator().manual_seed(B * T + H + 2)
    lengths = _lengths(gen, B, T)
    x = _rnd(gen, T, B, IN) * (torch.arange(T)[:, None] < lengths[None, :])[..., None]
    args = [t.to(cuda) for t in (x, _rnd(gen, IN, 4 * H, scale=IN ** -0.5),
                                 _rnd(gen, 4 * H, scale=0.2), _rnd(gen, H, 4 * H, scale=H ** -0.5))]
    lengths = lengths.to(cuda)
    before = rnn_cuda.lstm_layer_tm_train.launches
    h, c = rnn_cuda.lstm_layer_tm_train(*args, backward=backward, lengths=lengths)
    assert rnn_cuda.lstm_layer_tm_train.launches == before + 1
    want_h, want_c = rnn_cuda.lstm_layer_tm_train_plain(*args, backward=backward, lengths=lengths)
    h1 = rnn_cuda.lstm_layer_tm(*args, backward=backward, lengths=lengths)
    torch.cuda.synchronize()
    assert (h - want_h).abs().max().item() <= 1e-4
    assert (c - want_c).abs().max().item() <= 1e-4
    assert torch.equal(h, h1)


def _grads_close(got, want):
    for g, w in zip(got, want):
        assert (g - w).abs().max().item() <= 1e-3 * w.abs().max().item()


@pytest.mark.parametrize("backward", [False, True])
@pytest.mark.parametrize("kind", ["lstm", "grumod"])
def test_layer_function_matches_plain_autograd(cuda, kind, backward):
    B, T, IN, H = 7, 48, 32, 32
    G = {"lstm": 4, "grumod": 3}[kind] * H
    gen = torch.Generator().manual_seed(T + G + backward)
    lengths = _lengths(gen, B, T)
    x = _rnd(gen, T, B, IN) * (torch.arange(T)[:, None] < lengths[None, :])[..., None]
    args = [t.to(cuda).requires_grad_() for t in (
        x, _rnd(gen, IN, G, scale=IN ** -0.5), _rnd(gen, G, scale=0.2),
        _rnd(gen, H, G, scale=H ** -0.5))]
    cot = _rnd(gen, T, B, H).to(cuda)
    lengths = lengths.to(cuda)
    ad = {"lstm": rnn_vjp.lstm_layer_tm_ad, "grumod": rnn_vjp.grumod_layer_tm_ad}[kind]
    plain = {"lstm": rnn_cuda.lstm_layer_tm_plain, "grumod": rnn_cuda.grumod_layer_tm_plain}[kind]
    got = torch.autograd.grad((ad(*args, backward, lengths) * cot).sum(), args)
    want = torch.autograd.grad((plain(*args, backward, lengths) * cot).sum(), args)
    _grads_close(got, want)


@pytest.mark.parametrize("nbase", [4, 5])
def test_partition_function_matches_plain_autograd(cuda, nbase):
    idx = flipflop_index(nbase)
    B, T = 9, 70
    gen = torch.Generator().manual_seed(nbase)
    trans = (_rnd(gen, B, T, idx.nparam, scale=2.0)).to(cuda).requires_grad_()
    nblocks = torch.randint(0, T + 1, (B,), generator=gen)
    nblocks[0], nblocks[-1] = T, 0
    nblocks = nblocks.to(cuda)
    g = _rnd(gen, B).to(cuda)
    before = crf_bm_cuda.sum_states.launches
    (got,) = torch.autograd.grad((crf_partition_ad(trans, nblocks, nbase) * g).sum(), [trans])
    assert crf_bm_cuda.sum_states.launches == before + 2  # K3 forward, K4 backward
    tvalid = torch.arange(T, device=cuda)[:, None] < nblocks[None, :]
    alphas = crf_bm_cuda.sum_states_plain(_dense_tm(trans.permute(1, 2, 0), idx), tvalid, False)
    final = alphas.gather(0, nblocks[None, None, :].expand(1, idx.nstate, B))[0]
    (want,) = torch.autograd.grad((lse(final, 0) * g).sum(), [trans])
    _grads_close([got], [want])


# (B, T) of K10 (ops/conv_cuda.py _conv12_plan on an H100's 132 SMs): T
# below the halo (1, 3, 7); one short of, at and one past a tile of the
# 4-group plan (128 samples: the small batches, and B=200 at T=511, 513,
# more items than CTAs) and of the 1-group plan (512: B=300 at T=1023,
# 1024, B=256 at 1025, and T=2560, more items than CTAs); T % 4 != 0
# (direct stores); B=1
CONV12_SHAPES = [(3, 300), (8, 2049), (2, 1), (3, 3), (4, 7), (1, 128), (1, 129), (5, 127),
                 (1, 4097), (6, 2047), (200, 511), (200, 513), (300, 1023), (300, 1024),
                 (256, 1025), (300, 2560)]


def _conv12_lengths(gen, B: int, T: int):
    """Ragged lengths in [0, T] with, in order as B allows, T, 0, 3 and one
    that ends inside a thread's 4-sample register tile (4k + 2)."""
    lengths = torch.randint(0, T + 1, (B,), generator=gen, dtype=torch.int32)
    for i, v in enumerate((T, 0, 3, 4 * (T // 8) + 2)[:B]):
        lengths[i] = min(v, T)
    return lengths


@pytest.mark.parametrize("B,T", CONV12_SHAPES)
def test_conv12_kernel_matches_plain(cuda, B, T):
    """K10 with lengths 0, 3, T and one inside a register tile among them;
    tiles wholly past a read's end and the ragged last tile write zeros;
    the gradients of its autograd Function match the plain chain's."""
    gen = torch.Generator().manual_seed(B + T)
    lengths = _conv12_lengths(gen, B, T)
    x = _rnd(gen, B, T) * (torch.arange(T)[None, :] < lengths[:, None])
    args = [t.to(cuda) for t in (x, _rnd(gen, 5, 1, 4, scale=0.5), _rnd(gen, 4, scale=0.1),
                                 _rnd(gen, 5, 4, 16, scale=0.3), _rnd(gen, 16, scale=0.1),
                                 lengths)]
    before = conv_cuda.conv12_fused.launches
    got = conv_cuda.conv12_fused(*args)
    assert conv_cuda.conv12_fused.launches == before + 1
    want = conv_cuda.conv12_fused_plain(*args)
    torch.cuda.synchronize()
    assert (got - want).abs().max().item() <= 1e-5
    past = torch.arange(T, device=cuda)[None, None, :] >= args[5][:, None, None]
    assert not torch.where(past, got, 0.0).any()

    ins = [a.clone().requires_grad_() for a in args[:5]]
    cot = torch.randn(got.shape, generator=torch.Generator(device=cuda).manual_seed(1),
                      device=cuda)
    g_k = torch.autograd.grad((conv_cuda.conv12_fused(*ins, args[5]) * cot).sum(), ins)
    g_p = torch.autograd.grad((conv_cuda.conv12_fused_plain(*ins, args[5]) * cot).sum(), ins)
    for a, b in zip(g_k, g_p):
        assert (a - b).abs().max().item() <= 1e-5 * b.abs().max().item()


def test_conv12_info_matches_plan(cuda):
    """K10's grid on the C side is ops/conv_cuda.py's _conv12_plan, and the
    edge shapes above reach each channel-group plan."""
    groups = set()
    for B, T in CONV12_SHAPES + [(256, 12800), (24, 65_536), (32, 2560)]:
        info = conv_cuda.conv12_info(B, T)
        per_sm = {1: info["per_sm_g1"], 4: info["per_sm_g4"]}
        plan = conv_cuda._conv12_plan(B, T, per_sm, info["sms"])
        assert tuple(info[k] for k in conv_cuda.INFO[:6]) + (info["smem"],) == plan
        groups.add(info["groups"])
    assert groups == {1, 4}


@pytest.mark.parametrize("B,T,H", [(3, 29, 16), (19, 64, 256), (1, 40, 256), (24, 40, 256),
                                   (33, 40, 256), (100, 40, 256), (150, 40, 256),
                                   (240, 40, 256), (257, 40, 256)])
@pytest.mark.parametrize("kind", ["lstm", "grumod"])
def test_seq_kernel_matches_plain(cuda, kind, B, T, H):
    """K12: batch-major, forward, no mask, against ops/rnn.py's scan."""
    gates = 4 if kind == "lstm" else 3
    gen = torch.Generator().manual_seed(B * T + H + gates)
    xa = (_rnd(gen, B, T, gates * H) * 0.5).to(cuda)
    sW = _rnd(gen, H, gates * H, scale=H ** -0.5).to(cuda)
    fn = {"lstm": rnn_cuda.lstm_seq_cuda, "grumod": rnn_cuda.grumod_seq_cuda}[kind]
    plain = {"lstm": t_rnn.lstm_seq, "grumod": t_rnn.grumod_seq}[kind]
    before = fn.launches
    got = fn(xa, sW)
    assert fn.launches == before + 1
    want = plain(xa, sW)
    torch.cuda.synchronize()
    assert got.shape == (B, T, H)
    assert (got - want).abs().max().item() <= 1e-4


@pytest.mark.parametrize("S", [8, 10, 4])
def test_scan_info_matches_plan(cuda, S):
    """The chain scans' grid on the C side is ops/crf_bm_cuda.py's
    _scan_plan."""
    for B in (1, 3, 5, 24, 256, 257):
        assert tuple(crf_bm_cuda.scan_info(S, B).values()) == crf_bm_cuda._scan_plan(S, B)


def test_bt_kernels_take_a_view_off_the_16_byte_grid(cuda):
    """K11's 16-byte copies need the dense input on a 16-byte boundary: a
    contiguous view that starts 4 bytes off it gives the same outputs."""
    idx = rle_index(4)
    gen = torch.Generator().manual_seed(11)
    T, B = 19, 5
    d = dense_from_params(_rnd(gen, T, B, idx.nparam, scale=2.0).to(cuda), idx)
    v = (torch.arange(T)[:, None] < torch.tensor([T, 3, 0, 19, 7])[None, :]).to(cuda)
    buf = torch.empty(d.numel() + 1, device=cuda)
    off = buf[1:].view_as(d)
    off.copy_(d)
    assert off.data_ptr() % 16 != 0
    assert torch.equal(crf_cuda.fwd_scan(off, v), crf_cuda.fwd_scan(d, v))
    for got, want in zip(crf_cuda.viterbi_scan(off, v, idx.tie_rank),
                         crf_cuda.viterbi_scan(d, v, idx.tie_rank)):
        assert torch.equal(got, want)


@pytest.mark.parametrize("S", [8, 10, 4])
def test_bt_info_matches_plan(cuda, S):
    """K11's chain scans' grid on the C side is ops/crf_cuda.py's
    _bt_plan."""
    for B in (1, 3, 5, 24, 256, 257):
        assert tuple(crf_cuda.bt_info(S, B).values()) == crf_cuda._bt_plan(S, B)


def _tb_lengths(S, B, words):
    """Walk lengths at the edges of a traceback's plan (ops/crf_bm_cuda.py
    _tb_plan) for B reads: 1 step, one step a segment (C * W steps) less
    one and plus one, a round's most steps and one more (two rounds)."""
    _, W, C, *_ = _tb_plan(1, S, B, words)
    span = C * W * (TB_BUDGET // (W * (4 * words + 4 * _tb_slots(S) + 32)))
    return [1, C * W - 1, C * W + 1, span, span + 1]


# (S, B, T) of the tracebacks: each kernel's plan edges at B = 1, 3, 257
# (partly filled warps; 257 also a cluster of fewer CTAs), the production
# length 2560 at B=256 and runnie's heaviest program (T=13,108, B=24)
TB_SHAPES = sorted({(S, B, T) for S in (8, 10, 4) for B in (1, 3, 257)
                    for words in (_tb_words(S), _tb_bt_words(S)) for T in _tb_lengths(S, B, words)}
                   | {(8, 256, 2560), (10, 256, 2560), (8, 24, 13108), (4, 256, 2560)})


@pytest.mark.parametrize("S,B,T", TB_SHAPES)
def test_tracebacks_match_plain(cuda, S, B, T):
    """K6 and K11's traceback bit-equal to their plain walks on uniformly
    random backpointers (paths that rarely merge) and on K5's Viterbi
    backpointers, ragged nblocks with 0 and T; K11's states are K6's path
    reversed."""
    gen = torch.Generator().manual_seed(S * T + B)
    nblocks = torch.randint(0, T + 1, (B,), generator=gen)
    nblocks[0] = T
    if B > 1:
        nblocks[-1] = 0
    v = (torch.arange(T)[:, None] < nblocks[None, :]).to(cuda)
    idx = rle_v1_index(4) if S == 4 else flipflop_index(S // 2)
    d = _dense_tm(_rnd(gen, T, idx.nparam, B, scale=2.0).to(cuda), idx)
    alpha, vit = crf_bm_cuda.viterbi_fwd(d, v, idx.tie_rank)
    cases = [(torch.randint(0, S, (T, S, B), generator=gen, dtype=torch.int32).to(cuda),
              torch.randint(0, S, (B,), generator=gen, dtype=torch.int32).to(cuda)),
             (vit, alpha.argmax(dim=0).to(torch.int32))]
    for bp, last in cases:
        n6, n11 = crf_bm_cuda.traceback.launches, crf_cuda.traceback_bt.launches
        path = crf_bm_cuda.traceback(bp, v, last)
        assert torch.equal(path, crf_bm_cuda.traceback_plain(bp, v, last))
        bp_rev, v_rev = bp.permute(0, 2, 1).flip(0).to(torch.int8), v.flip(0)
        states = crf_cuda.traceback_bt(bp_rev, v_rev, last)
        assert torch.equal(states, crf_cuda.traceback_bt_plain(bp_rev, v_rev, last))
        assert torch.equal(states, path[:T].flip(0))
        assert (crf_bm_cuda.traceback.launches, crf_cuda.traceback_bt.launches) == (n6 + 1, n11 + 1)


def test_traceback_takes_a_view_off_the_4_byte_grid(cuda):
    """K11's traceback copies aligned 4-byte words: int8 backpointers that
    start 1 byte off the grid give the same states."""
    gen = torch.Generator().manual_seed(12)
    T, B, S = 37, 5, 10
    bp = torch.randint(0, S, (T, B, S), generator=gen, dtype=torch.int8).to(cuda)
    v = (torch.arange(T)[:, None] < torch.tensor([T, 3, 0, 19, 7])[None, :]).to(cuda)
    last = torch.randint(0, S, (B,), generator=gen, dtype=torch.int32).to(cuda)
    buf = torch.empty(bp.numel() + 1, dtype=torch.int8, device=cuda)
    off = buf[1:].view_as(bp)
    off.copy_(bp)
    assert off.data_ptr() % 4 != 0
    assert torch.equal(crf_cuda.traceback_bt(off, v, last), crf_cuda.traceback_bt(bp, v, last))


@pytest.mark.parametrize("S", [8, 10, 4])
def test_traceback_info_matches_plan(cuda, S):
    """The tracebacks' grids on the C side are ops/crf_bm_cuda.py's
    _tb_plan (K6) and ops/crf_cuda.py's _tb_bt_plan (K11), and at the
    main path's shapes every cluster is resident at once."""
    for T, B in ((1, 1), (75, 40), (2560, 256), (13108, 24), (4609, 257), (0, 3)):
        k6 = crf_bm_cuda.traceback_info(T, S, B)
        k11 = crf_cuda.traceback_bt_info(T, S, B)
        assert tuple(k6.values())[:6] == _tb_plan(T, S, B)
        assert tuple(k11.values())[:6] == _tb_bt_plan(T, S, B)
        if (T, B) in ((2560, 256), (13108, 24)):
            for info in (k6, k11):
                assert info["max_active_clusters"] >= info["ctas"] // info["C"]


def test_kernels_refuse_other_state_counts(cuda):
    """Each wrapper raises for a state count its kernel is not compiled
    for (S = 6 everywhere, S = 4 for K9): nothing runs the plain version
    in its place."""
    T, B = 5, 3
    v = torch.ones(T, B, dtype=torch.bool, device=cuda)
    for S in (6, 4):
        d = torch.zeros(T, S, S, B, device=cuda)
        with pytest.raises(ValueError, match="compiled for S"):
            crf_bm_cuda.fwdbwd_states(d, v)
        if S == 4:
            continue
        rank = torch.zeros(S, S, dtype=torch.int32)
        with pytest.raises(ValueError, match="compiled for S"):
            crf_bm_cuda.sum_states(d, v)
        with pytest.raises(ValueError, match="compiled for S"):
            crf_bm_cuda.viterbi_fwd(d, v, rank)
        with pytest.raises(ValueError, match="compiled for S"):
            crf_bm_cuda.traceback(torch.zeros(T, S, B, dtype=torch.int32, device=cuda), v,
                                  torch.zeros(B, dtype=torch.int32, device=cuda))
        bt = d.permute(0, 3, 1, 2).contiguous()
        with pytest.raises(ValueError, match="compiled for S"):
            crf_cuda.fwd_scan(bt, v)
        with pytest.raises(ValueError, match="compiled for S"):
            crf_cuda.viterbi_scan(bt, v, rank)


def bf16_ulps(got, want):
    """Elementwise distance in bf16 ulps: the bit patterns mapped onto
    an ordered integer line (+0 and -0 both 0)."""
    def ordered(t):
        i = t.view(torch.int16).to(torch.int32)
        return torch.where(i < 0, -(i & 0x7FFF), i)

    return (ordered(got) - ordered(want)).abs()


# (M, K, N) of both affines: the CPU-test widths (K = 8-32), K and N off
# the 8-element grid (the bf16 affine's wmma path), rows off the 128-row
# tile, M = 1, a layer's shape at N = 4H and 3H, and runnie's heaviest
# program (13,108 x 24 rows)
AFFINE_SHAPES = [(37, 8, 64), (300, 12, 40), (129, 32, 48), (1000, 96, 1024),
                 (4096, 256, 768), (5000, 256, 1024), (1, 256, 1024), (13_108 * 24, 256, 1024),
                 (2000, 256, 768)]


def _path_launches():
    return rnn_cuda.affine_bf16.launches, rnn_cuda.affine_bf16_wmma.launches


@pytest.mark.parametrize("M,K,N", AFFINE_SHAPES)
def test_affine_bf16_kernel_matches_plain(cuda, M, K, N):
    """The bf16 affine on its path's counter: wgmma where K and N are
    multiples of 8 (every model shape), wmma off that grid."""
    gen = torch.Generator().manual_seed(M + K + N)
    x = _rnd(gen, M, K).to(torch.bfloat16).to(cuda)
    iW = _rnd(gen, K, N, scale=K ** -0.5).to(torch.bfloat16).to(cuda)
    b = _rnd(gen, N, scale=0.2).to(cuda)
    before = _path_launches()
    got = rnn_cuda.affine_bf16(x, iW, b)
    wgmma = K % 8 == 0 and N % 8 == 0
    assert _path_launches() == (before[0] + wgmma, before[1] + (not wgmma))
    want = rnn_cuda.affine_bf16_plain(x, iW, b)
    torch.cuda.synchronize()
    assert got.dtype == torch.bfloat16 and got.shape == (M, N)
    noise = (x.float().abs() @ iW.float().abs()) * (K * 2.0 ** -23)
    delta = (got.float() - want.float()).abs()
    assert ((bf16_ulps(got, want) <= 1) | (delta <= noise)).all()


@pytest.mark.parametrize("M,K,N", AFFINE_SHAPES)
def test_affine_f32_kernel_matches_plain(cuda, M, K, N):
    """The f32 affine within f32 reassociation of torch.matmul + b, TF32
    off: K 2^-23 sum_k |x_k w_k| for the K products summed in another
    order, plus 2^-23 |value| for the bias added to another sum."""
    gen = torch.Generator().manual_seed(M + K + N + 1)
    x, iW, b = (t.to(cuda) for t in (_rnd(gen, M, K), _rnd(gen, K, N, scale=K ** -0.5),
                                      _rnd(gen, N, scale=0.2)))
    before = rnn_cuda.affine_f32.launches
    got = rnn_cuda.affine_f32(x, iW, b)
    assert rnn_cuda.affine_f32.launches == before + 1
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        want = rnn_cuda.affine_f32_plain(x, iW, b)
        noise = (x.abs() @ iW.abs()) * (K * 2.0 ** -23) + want.abs() * 2.0 ** -23
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.cuda.synchronize()
    assert got.dtype == torch.float32 and got.shape == (M, N)
    assert ((got - want).abs() <= noise).all()


@pytest.mark.parametrize("kind", ["lstm", "lstm_train", "grumod"])
def test_f32_layers_count_their_affine(cuda, kind):
    """Each f32 layer launch counts one f32 affine, and no bf16 one."""
    gates = 3 if kind == "grumod" else 4
    gen = torch.Generator().manual_seed(11)
    T, B, IN, H = 9, 3, 256, 256
    args = [t.to(cuda) for t in (_rnd(gen, T, B, IN), _rnd(gen, IN, gates * H, scale=IN ** -0.5),
                                 _rnd(gen, gates * H, scale=0.2),
                                 _rnd(gen, H, gates * H, scale=H ** -0.5))]
    fn = {"lstm": rnn_cuda.lstm_layer_tm, "lstm_train": rnn_cuda.lstm_layer_tm_train,
          "grumod": rnn_cuda.grumod_layer_tm}[kind]
    before = (rnn_cuda.affine_f32.launches, *_path_launches())
    fn(*args)
    assert (rnn_cuda.affine_f32.launches, *_path_launches()) == (before[0] + 1, *before[1:])


# (M, K, N) at which the C side's affine plans are held to _affine_plan
AFFINE_INFO_SHAPES = AFFINE_SHAPES + [(655_360, 256, 1024), (655_360, 256, 768),
                                      (64, 512, 256), (640, 64, 256 * 140)]


@pytest.mark.parametrize("M,K,N", AFFINE_INFO_SHAPES)
@pytest.mark.parametrize("bf16", [False, True])
def test_affine_info_matches_plan(cuda, M, K, N, bf16):
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    assert rnn_cuda.affine_info(M, N, K, bf16) == rnn_cuda._affine_plan(M, N, K, bf16, sms)


def _bf16_layer_args(cuda, gen, kind, B, T, IN, H):
    gates = 4 if kind == "lstm" else 3
    lengths = _lengths(gen, B, T)
    x = _rnd(gen, T, B, IN) * (torch.arange(T)[:, None] < lengths[None, :])[..., None]
    b = _rnd(gen, gates * H, scale=0.2)
    if kind == "grumod":
        b[2 * H :] += 0.75
    args = [x.to(torch.bfloat16), _rnd(gen, IN, gates * H, scale=IN ** -0.5), b,
            _rnd(gen, H, gates * H, scale=H ** -0.5)]
    return [t.to(cuda) for t in args], lengths.to(cuda)


@pytest.mark.parametrize("B,T,IN,H", LAYER_SHAPES)
@pytest.mark.parametrize("backward", [False, True])
@pytest.mark.parametrize("kind", ["lstm", "grumod"])
def test_bf16_layer_kernel_matches_plain(cuda, kind, B, T, IN, H, backward):
    """K1-bf16 / K7-bf16 through lstm_layer_tm / grumod_layer_tm on a bf16
    x: its own counter (and its affine's path's: wgmma at IN = 256, wmma
    at IN = 12), none of the f32 layer's or the f32 affine's."""
    gen = torch.Generator().manual_seed(B * T + H + 7)
    args, lengths = _bf16_layer_args(cuda, gen, kind, B, T, IN, H)
    fn = {"lstm": rnn_cuda.lstm_layer_tm, "grumod": rnn_cuda.grumod_layer_tm}[kind]
    counter = {"lstm": rnn_cuda.lstm_layer_tm_bf16, "grumod": rnn_cuda.grumod_layer_tm_bf16}[kind]
    before = (fn.launches, counter.launches, rnn_cuda.affine_f32.launches, *_path_launches())
    got = fn(*args, backward=backward, lengths=lengths)
    wgmma = IN % 8 == 0
    assert (fn.launches, counter.launches, rnn_cuda.affine_f32.launches, *_path_launches()) == (
        before[0], before[1] + 1, before[2], before[3] + wgmma, before[4] + (not wgmma))
    plain = {"lstm": rnn_cuda.lstm_layer_tm_plain, "grumod": rnn_cuda.grumod_layer_tm_plain}
    want = plain[kind](*args, backward=backward, lengths=lengths)
    torch.cuda.synchronize()
    assert got.dtype == want.dtype == torch.bfloat16
    assert (got.float() - want.float()).abs().max().item() <= 1e-2
    dead = (torch.arange(T, device=cuda)[:, None] >= lengths[None, :])
    assert not got.float()[dead].any()


@pytest.mark.parametrize("kind,twin", [("lstm_layer_bf16", "lstm_layer"),
                                       ("grumod_layer_bf16", "grumod_layer")])
def test_bf16_layer_cluster_info_is_the_f32_layers(cuda, kind, twin):
    """Variant 3 of the C side's cluster_info: xa never enters shared
    memory, so the plan (and the clusters the card holds) is K1's / K7's."""
    for B in (1, 16, 32, 100, 150, 240, 256):
        assert rnn_cuda.cluster_info(kind, B) == rnn_cuda.cluster_info(twin, B)


@pytest.mark.parametrize("B,T,IN,H", LAYER_SHAPES)
@pytest.mark.parametrize("backward", [False, True])
def test_k8_bf16_kernel_matches_plain_and_k1_bf16(cuda, B, T, IN, H, backward):
    """K8-bf16 through lstm_layer_tm_train on a bf16 x: its own counter,
    h and c in bf16 within the bf16 band of the plain version (h 1e-2, c
    1e-2 max(1, |c|)), h bit-equal to K1-bf16's."""
    gen = torch.Generator().manual_seed(B * T + H + 9)
    args, lengths = _bf16_layer_args(cuda, gen, "lstm", B, T, IN, H)
    before = (rnn_cuda.lstm_layer_tm_train.launches, rnn_cuda.lstm_layer_tm_train_bf16.launches)
    h, c = rnn_cuda.lstm_layer_tm_train(*args, backward=backward, lengths=lengths)
    assert (rnn_cuda.lstm_layer_tm_train.launches,
            rnn_cuda.lstm_layer_tm_train_bf16.launches) == (before[0], before[1] + 1)
    want_h, want_c = rnn_cuda.lstm_layer_tm_train_plain(*args, backward=backward, lengths=lengths)
    h1 = rnn_cuda.lstm_layer_tm(*args, backward=backward, lengths=lengths)
    torch.cuda.synchronize()
    assert h.dtype == c.dtype == torch.bfloat16
    assert (h.float() - want_h.float()).abs().max().item() <= 1e-2
    dc = (c.float() - want_c.float()).abs()
    assert (dc <= 1e-2 * want_c.float().abs().clamp(min=1.0)).all()
    assert torch.equal(h, h1)


@pytest.fixture
def levels():
    """Sets the import-time precision levels for one test and restores
    them after it."""
    from flappie_tpu_torch.ops import precision

    saved = precision._ff_level, precision._rnn_level
    yield precision
    precision._ff_level, precision._rnn_level = saved


# the one-pass layers: a shape for a few rows-a-cluster instantiations
P1_SHAPES = [(5, 37, 12, 16), (24, 40, 256, 256), (100, 40, 256, 256), (257, 40, 256, 256)]
# chip_smoke.py's band of the one-pass layers against their plain twins:
# max, mean, and the mean over the first P1_STEPS steps each row walks
P1_MAX, P1_MEAN, P1_STEPS, P1_EARLY = 1e-2, 1e-4, 16, 1.5e-5


def _p1_distance(got, want, lengths, backward):
    """(max |delta| / max(1, max |want|), mean |delta|, mean |delta| over
    the first P1_STEPS steps each row walks)."""
    T = want.shape[0]
    t = torch.arange(T, device=want.device)[:, None]
    s = (lengths[None, :] - 1 - t) if backward else t
    early = ((s >= 0) & (s < P1_STEPS) & (t < lengths[None, :]))[..., None]
    d = (got.float() - want.float()).abs()
    scale = max(1.0, want.float().abs().max().item())
    return (d.max().item() / scale, d.mean().item(),
            (d * early).sum().item() / (early.sum().item() * d.shape[-1]))


@pytest.mark.parametrize("B,T,IN,H", P1_SHAPES)
@pytest.mark.parametrize("stream,ff", [("f32", "highest"), ("f32", "bf16"), ("bf16", None)])
@pytest.mark.parametrize("kind", ["lstm", "lstm_train", "grumod"])
def test_one_pass_layer_kernels_match_plain(cuda, kind, stream, ff, B, T, IN, H, levels):
    """The rnn-``default`` recurrences (csrc/lstm_p1.cu, grumod_p1.cu)
    through their wrappers, the f32 stream's affine at ``ff`` (``"bf16"``:
    FLAPPIE_TPU_MATMUL_PRECISION=default), against their plain twins
    (rdot one pass, the same affine): within 1e-2, a mean within 1e-4 and
    a mean over the first 16 steps within P1_EARLY on both streams.  Both sum exact products in f32 in other
    orders; where an h's two sums straddle a bf16 rounding boundary the
    next product reads it one bf16 ulp apart, and the state carries that
    (the bf16 stream's band, as K1-bf16's).  The same layer's f32-step
    kernel on the same inputs (a kernel that did not round h or sW) lies
    at least 3 P1_EARLY from the twin over the first steps.  Each launch
    counts on the wrapper (f32 stream) or its ``*_bf16_p1`` counter."""
    base = "grumod" if kind == "grumod" else "lstm"
    gen = torch.Generator().manual_seed(B * T + H + len(kind))
    args, lengths = _bf16_layer_args(cuda, gen, base, B, T, IN, H)
    if stream == "f32":
        args[0] = args[0].float()
    name = {"lstm": "lstm_layer_tm", "lstm_train": "lstm_layer_tm_train",
            "grumod": "grumod_layer_tm"}[kind]
    p1, f32 = getattr(rnn_cuda, name + "_p1"), getattr(rnn_cuda, name)
    plain = getattr(rnn_cuda, name + "_plain")
    counter = getattr(rnn_cuda, name + "_bf16_p1") if stream == "bf16" else p1
    levels.set_ff_precision("default" if ff == "bf16" else "high")
    before = counter.launches, p1.launches + getattr(rnn_cuda, name + "_bf16_p1").launches
    got = p1(*args, True, lengths)
    assert (counter.launches, p1.launches + getattr(rnn_cuda, name + "_bf16_p1").launches) == (
        before[0] + 1, before[1] + 1)
    control = f32(*args, True, lengths)
    want = plain(*args, True, lengths, rdot="bf16", ff=ff or "highest")
    torch.cuda.synchronize()
    for g, c, w in zip(*(t if kind == "lstm_train" else (t,) for t in (got, control, want))):
        assert g.dtype == args[0].dtype
        dmax, dmean, dearly = _p1_distance(g, w, lengths, True)
        assert dmax <= P1_MAX and dmean <= P1_MEAN and dearly <= P1_EARLY
        assert _p1_distance(c, w, lengths, True)[2] >= 3 * P1_EARLY


@pytest.mark.parametrize("B,T,IN,H", LAYER_SHAPES)
@pytest.mark.parametrize("backward", [False, True])
@pytest.mark.parametrize("stream", ["f32", "bf16"])
def test_one_pass_lstm_k8_is_k1_at_every_r(cuda, stream, B, T, IN, H, backward, levels):
    """The LSTM's tensor-core one-pass step (csrc/cluster_rnn_mma.cuh) at
    every rows a cluster (R = 1 ... 20 over its three n-tile
    instantiations), on each stream (the f32 stream's
    affine f32): K8-default's h bit-equal to K1-default's (one summation
    order for every R and WANT_C), h and c inside the P1 band of the plain
    twin, and the layer's f32-step kernel on the same inputs at least 3
    P1_EARLY from the twin's h over the first steps."""
    gen = torch.Generator().manual_seed(B * T + H + 11)
    args, lengths = _bf16_layer_args(cuda, gen, "lstm", B, T, IN, H)
    if stream == "f32":
        args[0] = args[0].float()
    levels.set_ff_precision("high")
    h1 = rnn_cuda.lstm_layer_tm_p1(*args, backward, lengths)
    h8, c8 = rnn_cuda.lstm_layer_tm_train_p1(*args, backward, lengths)
    control = rnn_cuda.lstm_layer_tm(*args, backward, lengths)
    want_h, want_c = rnn_cuda.lstm_layer_tm_train_plain(*args, backward, lengths, rdot="bf16")
    torch.cuda.synchronize()
    assert h8.dtype == c8.dtype == args[0].dtype
    assert torch.equal(h1, h8)
    for got, want in ((h8, want_h), (c8, want_c)):
        dmax, dmean, dearly = _p1_distance(got, want, lengths, backward)
        assert dmax <= P1_MAX and dmean <= P1_MEAN and dearly <= P1_EARLY
    assert _p1_distance(control, want_h, lengths, backward)[2] >= 3 * P1_EARLY


# rows the P1 band is held over at every R: the band's means are over rows
# (it was read at 256), and a sound kernel agrees with its twin to f32
# rounding until an h's two sums straddle a bf16 rounding boundary, after
# which that row's walk diverges; over one row such a flip within the
# first 16 steps is common (GRU-mod's more than the LSTM's: p1_band.py,
# PERF.md), so a smaller B runs a batch of at least this many rows, B rows
# a launch (the instantiation B picks)
P1_POOL_ROWS = 128


@pytest.mark.parametrize("B,T,IN,H", LAYER_SHAPES)
@pytest.mark.parametrize("backward", [False, True])
@pytest.mark.parametrize("stream", ["f32", "bf16"])
def test_one_pass_grumod_at_every_r(cuda, stream, B, T, IN, H, backward, levels):
    """GRU-mod's tensor-core one-pass step (K7-default, csrc/grumod_p1.cu
    on csrc/cluster_rnn_mma.cuh at three gates) at every rows a cluster
    (R = 1 ... 20 over its three n-tile instantiations), on each stream
    (the f32 stream's affine f32), through its wrapper, B rows a launch,
    each counted on it or on its ``*_bf16_p1`` counter: h inside the P1
    band of the plain twin over at least P1_POOL_ROWS rows, and the
    layer's f32-step kernel on the same inputs at least 3 P1_EARLY from
    the twin over the first steps."""
    gen = torch.Generator().manual_seed(B * T + H + 13)
    rows = -(-P1_POOL_ROWS // B) * B
    args, lengths = _bf16_layer_args(cuda, gen, "grumod", rows, T, IN, H)
    if stream == "f32":
        args[0] = args[0].float()
    x, rest = args[0], args[1:]
    levels.set_ff_precision("high")
    counter = (rnn_cuda.grumod_layer_tm_bf16_p1 if stream == "bf16"
               else rnn_cuda.grumod_layer_tm_p1)
    before = counter.launches
    got = torch.cat([rnn_cuda.grumod_layer_tm_p1(x[:, i:i + B].contiguous(), *rest, backward,
                                                 lengths[i:i + B].contiguous())
                     for i in range(0, rows, B)], dim=1)
    assert counter.launches == before + rows // B
    control = rnn_cuda.grumod_layer_tm(*args, backward, lengths)
    want = rnn_cuda.grumod_layer_tm_plain(*args, backward, lengths, rdot="bf16")
    torch.cuda.synchronize()
    assert got.dtype == x.dtype and got.shape == (T, rows, H)
    dmax, dmean, dearly = _p1_distance(got, want, lengths, backward)
    assert dmax <= P1_MAX and dmean <= P1_MEAN and dearly <= P1_EARLY
    assert _p1_distance(control, want, lengths, backward)[2] >= 3 * P1_EARLY


@pytest.mark.parametrize("kind", ["lstm", "lstm_train", "grumod"])
def test_default_levels_dispatch_to_their_kernels(cuda, kind, levels):
    """At FLAPPIE_TPU_MATMUL_PRECISION=default alone an f32 layer runs
    the one-pass affine (counted on affine_bf16_f32, not affine_f32) and
    its f32 recurrence, within 1e-4 of the plain version at ff one pass;
    at FLAPPIE_TPU_RNN_PRECISION=default too, its rnn-default wrapper."""
    base = "grumod" if kind == "grumod" else "lstm"
    gen = torch.Generator().manual_seed(31 + len(kind))
    args, lengths = _bf16_layer_args(cuda, gen, base, 33, 40, 256, 256)
    args[0] = args[0].float()
    fn = {"lstm": rnn_cuda.lstm_layer_tm, "lstm_train": rnn_cuda.lstm_layer_tm_train,
          "grumod": rnn_cuda.grumod_layer_tm}[kind]
    p1 = {"lstm": rnn_cuda.lstm_layer_tm_p1, "lstm_train": rnn_cuda.lstm_layer_tm_train_p1,
          "grumod": rnn_cuda.grumod_layer_tm_p1}[kind]
    plain = {"lstm": rnn_cuda.lstm_layer_tm_plain, "lstm_train": rnn_cuda.lstm_layer_tm_train_plain,
             "grumod": rnn_cuda.grumod_layer_tm_plain}[kind]

    def counts():
        return (fn.launches, p1.launches, rnn_cuda.affine_f32.launches,
                rnn_cuda.affine_bf16_f32.launches)

    levels.set_ff_precision("default")
    before = counts()
    got = fn(*args, True, lengths)
    assert counts() == (before[0] + 1, before[1], before[2], before[3] + 1)
    want = plain(*args, True, lengths, ff="bf16")
    torch.cuda.synchronize()
    for g, w in zip(*(t if kind == "lstm_train" else (t,) for t in (got, want))):
        assert (g - w).abs().max().item() <= 1e-4
    levels.set_rnn_precision("default")
    before = counts()
    fn(*args, True, lengths)
    assert counts() == (before[0], before[1] + 1, before[2], before[3] + 1)


@pytest.mark.parametrize("M,K,N", AFFINE_SHAPES)
def test_affine_bf16_f32_kernel_matches_plain(cuda, M, K, N):
    """The one-pass affine's f32 output (both bf16 paths) within f32
    reassociation of its plain version: the same exact products, summed
    in another order."""
    gen = torch.Generator().manual_seed(M + K + N + 2)
    x = _rnd(gen, M, K).to(torch.bfloat16).to(cuda)
    iW = _rnd(gen, K, N, scale=K ** -0.5).to(torch.bfloat16).to(cuda)
    b = _rnd(gen, N, scale=0.2).to(cuda)
    before = (rnn_cuda.affine_bf16_f32.launches, *_path_launches())
    got = rnn_cuda.affine_bf16_f32(x, iW, b)
    assert (rnn_cuda.affine_bf16_f32.launches, *_path_launches()) == (before[0] + 1, *before[1:])
    want = rnn_cuda.affine_bf16_f32_plain(x, iW, b)
    torch.cuda.synchronize()
    assert got.dtype == torch.float32 and got.shape == (M, N)
    noise = (x.float().abs() @ iW.float().abs()) * (K * 2.0 ** -23) + want.abs() * 2.0 ** -23
    assert ((got - want).abs() <= noise).all()


@pytest.mark.parametrize("kind", ["lstm_layer_train_bf16", "lstm_layer_p1", "lstm_layer_train_p1",
                                  "lstm_layer_bf16_p1", "lstm_layer_train_bf16_p1",
                                  "grumod_layer_p1", "grumod_layer_bf16_p1", "lstm_layer_h3",
                                  "lstm_layer_train_h3", "lstm_layer_bf16_h3",
                                  "lstm_layer_train_bf16_h3", "grumod_layer_h3",
                                  "grumod_layer_bf16_h3"])
def test_new_cluster_info_matches_plan(cuda, kind):
    """K8-bf16's, the one-pass and the three-pass recurrences' plans from
    the C side (the tensor-core steps') against ``info_plan``."""
    for B in (1, 16, 32, 100, 150, 240, 256):
        info = rnn_cuda.cluster_info(kind, B)
        assert (info["R"], info["clusters"], info["smem"]) == rnn_cuda.info_plan(kind, B)
        assert info["max_active_clusters"] >= 1


@pytest.mark.parametrize("x_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind", ["lstm", "grumod"])
def test_layer_function_under_the_stream_and_grad_default(cuda, kind, x_dtype, monkeypatch):
    """The training path under the bf16 stream on the card (K8-bf16 or
    K7-bf16 forward, the adjoint backward) against the same Function on
    the CPU (the plain forward, held to the JAX package's custom VJP in
    test_torch_fast_train.py): every gradient within 1e-2 of its max
    |value|, dx in x's dtype (the adjoint reads the forward's bf16 h and
    c, which kernel and plain version may give one bf16 ulp apart); at
    FLAPPIE_TPU_GRAD_PRECISION=default the one-pass adjoint within 5e-2 of
    the f32 adjoint's and more than 1e-6 of its max |grad| from it on some
    gradient (the env var reached the adjoint)."""
    B, T, IN, H = 7, 48, 32, 32
    G = {"lstm": 4, "grumod": 3}[kind] * H
    gen = torch.Generator().manual_seed(T + G + 5)
    lengths = _lengths(gen, B, T)
    x = _rnd(gen, T, B, IN) * (torch.arange(T)[:, None] < lengths[None, :])[..., None]
    leaves = [x.to(x_dtype), _rnd(gen, IN, G, scale=IN ** -0.5), _rnd(gen, G, scale=0.2),
              _rnd(gen, H, G, scale=H ** -0.5)]
    cot = _rnd(gen, T, B, H)
    ad = {"lstm": rnn_vjp.lstm_layer_tm_ad, "grumod": rnn_vjp.grumod_layer_tm_ad}[kind]

    def grads(device):
        args = [t.to(device).requires_grad_() for t in leaves]
        out = ad(*args, True, lengths.to(device), stream=torch.bfloat16)
        assert out.dtype == torch.bfloat16
        return [g.cpu() for g in torch.autograd.grad((out.float() * cot.to(device)).sum(), args)]

    got, want = grads(cuda), grads("cpu")
    assert got[0].dtype == x_dtype and got[1].dtype == torch.float32
    for g, w in zip(got, want):
        assert (g.float() - w.float()).abs().max().item() <= 1e-2 * w.float().abs().max().item()
    monkeypatch.setenv("FLAPPIE_TPU_GRAD_PRECISION", "default")
    moved = 0.0
    for g, w in zip(grads(cuda), got):
        d = (g.float() - w.float()).abs().max().item() / w.float().abs().max().item()
        assert d <= 5e-2
        moved = max(moved, d)
    assert moved > 1e-6  # the env var reached the adjoint's products


# chip_smoke.py's band of the three-pass layers (rnn ``high`` on the card)
# against their plain twins: max |delta| on the f32 stream (absolute) and
# on the bf16 stream (of max(1, |value|)), and the mean over the first
# P1_STEPS steps each row walks, where the one-pass kernel lies at least
# 3 H3_EARLY from the twin
H3_MAX, H3_MAX_BF16, H3_EARLY = 1e-4, 1e-2, 1e-5
H3_NAMES = {"lstm": "lstm_layer_tm", "lstm_train": "lstm_layer_tm_train",
            "grumod": "grumod_layer_tm"}


def _h3_close(got, want, control, lengths, backward):
    """got inside the H3 band of want, and control (None: none) outside it
    by 3x over the first steps."""
    dmax, _, dearly = _p1_distance(got, want, lengths, backward)
    if got.dtype == torch.float32:
        assert (got - want).abs().max().item() <= H3_MAX
    else:
        assert dmax <= H3_MAX_BF16
    assert dearly <= H3_EARLY
    if control is not None:
        assert _p1_distance(control, want, lengths, backward)[2] >= 3 * H3_EARLY


@pytest.mark.parametrize("B,T,IN,H", P1_SHAPES)
@pytest.mark.parametrize("stream,ff", [("f32", "highest"), ("f32", "bf16"), ("bf16", None)])
@pytest.mark.parametrize("kind", ["lstm", "lstm_train", "grumod"])
def test_three_pass_layer_kernels_match_plain(cuda, kind, stream, ff, B, T, IN, H, levels):
    """The rnn-``high`` recurrences (csrc/lstm_h3.cu, grumod_h3.cu: the
    three-pass step on the tensor cores) through their wrappers, the f32
    stream's affine at ``ff``, against their plain twins (rdot three
    passes, the same affine) inside the H3 band, the one-pass kernel on
    the same inputs outside it; each launch counts on the wrapper (f32
    stream) or its ``*_bf16_h3`` counter."""
    base = "grumod" if kind == "grumod" else "lstm"
    gen = torch.Generator().manual_seed(B * T + H + len(kind) + 3)
    args, lengths = _bf16_layer_args(cuda, gen, base, B, T, IN, H)
    if stream == "f32":
        args[0] = args[0].float()
    name = H3_NAMES[kind]
    h3, p1 = getattr(rnn_cuda, name + "_h3"), getattr(rnn_cuda, name + "_p1")
    plain = getattr(rnn_cuda, name + "_plain")
    counter = getattr(rnn_cuda, name + "_bf16_h3") if stream == "bf16" else h3
    levels.set_ff_precision("default" if ff == "bf16" else "high")
    before = counter.launches
    got = h3(*args, True, lengths)
    assert counter.launches == before + 1
    control = p1(*args, True, lengths)
    want = plain(*args, True, lengths, rdot="bf16x3", ff=ff or "highest")
    torch.cuda.synchronize()
    for g, c, w in zip(*(t if kind == "lstm_train" else (t,) for t in (got, control, want))):
        assert g.dtype == args[0].dtype
        _h3_close(g, w, c, lengths, True)


@pytest.mark.parametrize("B,T,IN,H", LAYER_SHAPES)
@pytest.mark.parametrize("backward", [False, True])
@pytest.mark.parametrize("stream", ["f32", "bf16"])
@pytest.mark.parametrize("cell", ["lstm", "grumod"])
def test_three_pass_step_at_every_r(cuda, cell, stream, B, T, IN, H, backward, levels):
    """The three-pass tensor-core step at every rows a cluster (R = 1 ...
    20 over its three n-tile instantiations), on each stream (the f32
    stream's affine f32): K8-high3's h bit-equal to K1-high3's, h (and c)
    inside the H3 band of the plain twin, the one-pass kernel outside."""
    gen = torch.Generator().manual_seed(B * T + H + 17)
    args, lengths = _bf16_layer_args(cuda, gen, cell, B, T, IN, H)
    if stream == "f32":
        args[0] = args[0].float()
    levels.set_ff_precision("high")
    if cell == "grumod":
        got = rnn_cuda.grumod_layer_tm_h3(*args, backward, lengths)
        control = rnn_cuda.grumod_layer_tm_p1(*args, backward, lengths)
        want = rnn_cuda.grumod_layer_tm_plain(*args, backward, lengths, rdot="bf16x3")
        pairs = ((got, want),)
    else:
        h1 = rnn_cuda.lstm_layer_tm_h3(*args, backward, lengths)
        h8, c8 = rnn_cuda.lstm_layer_tm_train_h3(*args, backward, lengths)
        control = rnn_cuda.lstm_layer_tm_p1(*args, backward, lengths)
        want_h, want_c = rnn_cuda.lstm_layer_tm_train_plain(*args, backward, lengths,
                                                            rdot="bf16x3")
        torch.cuda.synchronize()
        assert torch.equal(h1, h8)
        pairs = ((h8, want_h), (c8, want_c))
    torch.cuda.synchronize()
    for i, (got, want) in enumerate(pairs):
        assert got.dtype == args[0].dtype
        _h3_close(got, want, control if i == 0 else None, lengths, backward)


@pytest.mark.parametrize("kind", ["lstm", "lstm_train", "grumod"])
def test_high_level_dispatches_to_its_kernels(cuda, kind, levels):
    """At FLAPPIE_TPU_RNN_PRECISION=high on the card each dispatcher runs
    its rnn-high wrapper (counted there and on the affine's counter, the
    f32 layer's not), within the H3 band of the plain twin; ff high stays
    the f32 affine."""
    base = "grumod" if kind == "grumod" else "lstm"
    gen = torch.Generator().manual_seed(37 + len(kind))
    args, lengths = _bf16_layer_args(cuda, gen, base, 33, 40, 256, 256)
    args[0] = args[0].float()
    name = H3_NAMES[kind]
    fn, h3 = getattr(rnn_cuda, name), getattr(rnn_cuda, name + "_h3")

    def counts():
        return fn.launches, h3.launches, rnn_cuda.affine_f32.launches

    levels.set_ff_precision("high")
    levels.set_rnn_precision("high")
    before = counts()
    got = fn(*args, True, lengths)
    assert counts() == (before[0], before[1] + 1, before[2] + 1)
    want = getattr(rnn_cuda, name + "_plain")(*args, True, lengths, rdot="bf16x3")
    torch.cuda.synchronize()
    for g, w in zip(*(t if kind == "lstm_train" else (t,) for t in (got, want))):
        assert (g - w).abs().max().item() <= H3_MAX
    levels.set_rnn_precision("highest")
    before = counts()
    fn(*args, True, lengths)
    assert counts() == (before[0] + 1, before[1], before[2] + 1)


def _packed_i16(gen, B, W, chunk):
    """One i16-wire batch of B rows of W samples of synthetic ADC (ragged,
    the first full; chunk rows own their whole range)."""
    from flappie_tpu_torch.basecall import pack_chunk_inputs_i16
    from flappie_tpu_torch.signal.synthetic import synthetic_adc

    rng = np.random.default_rng(int(torch.randint(0, 2 ** 31, (1,), generator=gen)))
    lengths = rng.integers(W // 4, W + 1, B).astype(np.int32)
    lengths[0] = W
    adc = np.zeros((B, W), np.int16)
    for j, n in enumerate(lengths):
        adc[j, :n] = synthetic_adc(int(n), rng, mean_dwell=30.0)
    scal = np.tile(np.array([16.0, 0.17, 80.0, 11.0], np.float32), (B, 1))
    z = np.zeros(B, np.int32)
    qlo, qhi = (np.ones(B, np.int32), lengths // 5) if chunk else (z, z)
    return pack_chunk_inputs_i16(adc, lengths, qlo, qhi, scal)


@pytest.mark.parametrize("entry", ["dispatch_packed_chunk_i16", "dispatch_packed_batch_d8_grouped"])
def test_packed_entry_is_its_program(cuda, entry):
    """The Basecaller's public entries on the card (r941_native at full
    width, synthetic weights): a chunk entry's bytes are its private
    program's on the same buffer, a grouped full-read entry's the
    concatenation of that program's single batches, byte for byte; each
    launches K1 five times a batch."""
    from flappie_tpu_torch import basecall as bc

    gen = torch.Generator().manual_seed(len(entry))
    caller = bc.Basecaller(compute_trace=False, device=cuda)
    grouped = entry.endswith("_grouped")
    G = 3 if grouped else 1
    bufs = [_packed_i16(gen, 16, 4096 if grouped else 2560, not grouped) for _ in range(G)]
    if grouped:
        bufs = [bc.encode_d8(b) for b in bufs]
        assert all(b is not None for b in bufs)
    single = getattr(bc, "_device_basecall_packed_d8" if grouped
                     else "_device_basecall_chunk_packed_i16")
    with torch.inference_mode():
        want = np.concatenate([single(caller.params, torch.from_numpy(b).to(cuda), caller.cfg, 1.0,
                                      False, False).cpu().numpy() for b in bufs])
    before = rnn_cuda.lstm_layer_tm.launches
    args = (np.concatenate(bufs), G) if grouped else (bufs[0],)
    got = np.asarray(getattr(caller, entry)(*args))
    assert rnn_cuda.lstm_layer_tm.launches == before + 5 * G
    np.testing.assert_array_equal(got, want)
