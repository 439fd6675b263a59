"""PyTorch port on the card: each CUDA kernel against its plain version.

Marked ``cuda``: needs a CUDA device and skips without one (the kernels
have no CPU mode; their plain versions are held to the JAX package in
test_torch_kernels_plain.py).  Imports nothing of JAX; on a GPU machine
without JAX, skip tests/conftest.py (which sets JAX up):

    python -m pytest tests/test_torch_cuda.py --noconftest -q

Tolerances: K1 and K7 max |delta| <= 1e-4 (FMA contraction and another
summation order over H products per step, compounding over T steps);
sum scans rtol 1e-5 (reassociation); Viterbi and traceback bit-equal.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from flappie_tpu_torch.ops import crf_bm_cuda, rnn_cuda
from flappie_tpu_torch.ops.crf import flipflop_index
from flappie_tpu_torch.ops.crf_bm import _dense_tm

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the port's kernels run only on the GPU")
    return torch.device("cuda")


def _rnd(gen, *shape, scale=1.0):
    return torch.randn(*shape, generator=gen) * scale


@pytest.mark.parametrize("B,T,IN,H", [(5, 37, 12, 16), (19, 64, 256, 256)])
@pytest.mark.parametrize("backward", [False, True])
def test_lstm_kernel_matches_plain(cuda, B, T, IN, H, backward):
    gen = torch.Generator().manual_seed(B * T + H)
    lengths = torch.randint(0, T + 1, (B,), generator=gen, dtype=torch.int32)
    lengths[0], lengths[-1] = T, 0
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


@pytest.mark.parametrize("B,T,IN,H", [(5, 37, 12, 16), (19, 64, 256, 256)])
@pytest.mark.parametrize("backward", [False, True])
def test_grumod_kernel_matches_plain(cuda, B, T, IN, H, backward):
    """K7; the candidate third of the bias is far from zero, so summing
    xa_h into the recurrent product would show."""
    gen = torch.Generator().manual_seed(B * T + H + 1)
    lengths = torch.randint(0, T + 1, (B,), generator=gen, dtype=torch.int32)
    lengths[0], lengths[-1] = T, 0
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


@pytest.mark.parametrize("nbase,B,T", [(4, 40, 75), (5, 7, 33)])
def test_crf_kernels_match_plain(cuda, nbase, B, T):
    idx = flipflop_index(nbase)
    gen = torch.Generator().manual_seed(T)
    trans = torch.round(_rnd(gen, T, idx.nparam, B, scale=2.0) * 8.0) / 8.0  # dyadic
    nblocks = torch.randint(0, T + 1, (B,), generator=gen)
    nblocks[0], nblocks[-1] = T, 0
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
