"""Recurrent layers as plain time loops (counterpart of
flappie_tpu/ops/rnn.py).

LSTM semantics match the reference step (src/layers.c:979-1026): per
step ``xF = xAffine_t + h sW``; gate order in xF is [update, forget,
candidate, output]; no peepholes; zero initial state;
``c = sigma(f)*c + sigma(u)*tanh(g)``; ``h = sigma(o)*tanh(c)``.

GRU-mod (src/layers.c:664-715): ``v = h sW`` (3H, gate order [z, r,
hbar]); ``z = sigma(x_t[:H] + v[:H])``, ``r = sigma(x_t[H:2H] +
v[H:2H])``, ``hbar = tanh(r * v[2H:] + x_t[2H:])``, ``h' = z*h +
(1-z)*hbar``.  The candidate's input term is added after the multiply
by r, never summed into v.

sloika GRU (src/layers.c:513-568) and its ReLU variant (:718-874): the
2-matrix GRU of the sloika-era flip-flop graph.  ``zr = sigma(x_t[:2H]
+ h sW)`` (sW [H, 2H], gate order [z, r]), ``hbar = tanh(x_t[2H:] + (r
* h) sW2)`` (ReLU for ``gru_relu``), ``h' = z*h + (1-z)*hbar``: r
multiplies h before the candidate's product, not after it as in
GRU-mod.

These scan forward over batch-major [B, T, ...] tensors.  The network
runs LSTM and GRU-mod layers through the fused time-major kernels in
rnn_cuda.py, which handle direction and lengths inside the kernel.
``gru_seq`` and ``gru_relu_seq`` are plain PyTorch on every device: the
JAX package has no Pallas kernel for them (its ``gru_seq`` is a
``lax.scan``), so this time loop is their formulation, as the scan is
the JAX package's.
"""

from __future__ import annotations

import torch

from . import precision


def rows_matmul(x, W):
    """x [..., K] @ W [K, N] as one [rows, K] x [K, N] product, with one
    row computed as two equal rows.  torch.matmul takes other BLAS paths,
    whose sums run in another order, for one row (the vector product) and
    for a 3-D x whose size-1 batch dimension has an odd stride, so a
    read's bits would depend on how many reads share its batch."""
    rows = x.reshape(-1, x.shape[-1])
    if rows.shape[0] == 1:
        return (torch.cat([rows, rows]) @ W)[:1].reshape(*x.shape[:-1], W.shape[-1])
    return (rows @ W).reshape(*x.shape[:-1], W.shape[-1])


def affine(x, W, b):
    """[..., in] x [in, K] + [K] -> [..., K] in float32, at the
    feed-forward level for x's device (ops/precision.py; flappie_tpu/ops/
    rnn.py:50): ``default`` on a CUDA device rounds x and W to bf16 and
    sums the exact products in f32 (TF32 is off)."""
    if precision.ff_precision(x.device) == precision.ONE_PASS:
        x, W = precision.one_pass(x), precision.one_pass(W)
    return rows_matmul(x, W) + b


def lstm_step(xa_t, h, c, sW, dot=rows_matmul):
    """One LSTM step: returns (h', c'); ``dot`` computes h . sW."""
    H = h.shape[-1]
    xF = xa_t + dot(h, sW)
    u = torch.sigmoid(xF[:, :H])
    f = torch.sigmoid(xF[:, H : 2 * H])
    g = torch.tanh(xF[:, 2 * H : 3 * H])
    o = torch.sigmoid(xF[:, 3 * H :])
    c = f * c + u * g
    h = o * torch.tanh(c)
    return h, c


def lstm_seq(xaffine, sW):
    """xaffine: [B, T, 4H] (= x iW + b), sW: [H, 4H] -> [B, T, H]."""
    B, T, H4 = xaffine.shape
    H = H4 // 4
    h = xaffine.new_zeros(B, H)
    c = xaffine.new_zeros(B, H)
    ys = []
    for t in range(T):
        h, c = lstm_step(xaffine[:, t], h, c, sW)
        ys.append(h)
    return torch.stack(ys, dim=1)


def grumod_step(xa_t, h, sW, dot=rows_matmul):
    """One GRU-mod step: returns h'; ``dot`` computes h . sW."""
    H = h.shape[-1]
    v = dot(h, sW)
    z = torch.sigmoid(xa_t[:, :H] + v[:, :H])
    r = torch.sigmoid(xa_t[:, H : 2 * H] + v[:, H : 2 * H])
    hbar = torch.tanh(r * v[:, 2 * H :] + xa_t[:, 2 * H :])
    return z * h + (1 - z) * hbar


def grumod_seq(xaffine, sW):
    """xaffine: [B, T, 3H] (= x iW + b), sW: [H, 3H] -> [B, T, H]."""
    B, T, H3 = xaffine.shape
    h = xaffine.new_zeros(B, H3 // 3)
    ys = []
    for t in range(T):
        h = grumod_step(xaffine[:, t], h, sW)
        ys.append(h)
    return torch.stack(ys, dim=1)



def gru_step(xa_t, h, sW, sW2, candidate=torch.tanh):
    """One sloika GRU step (``candidate=torch.relu``: the ReLU variant):
    returns h'."""
    H = h.shape[-1]
    zr = torch.sigmoid(xa_t[:, : 2 * H] + rows_matmul(h, sW))
    z, r = zr[:, :H], zr[:, H:]
    hbar = candidate(xa_t[:, 2 * H :] + rows_matmul(r * h, sW2))
    return z * h + (1 - z) * hbar


def _gru2_seq(xaffine, sW, sW2, candidate):
    B, T, H3 = xaffine.shape
    h = xaffine.new_zeros(B, H3 // 3)
    ys = []
    for t in range(T):
        h = gru_step(xaffine[:, t], h, sW, sW2, candidate)
        ys.append(h)
    return torch.stack(ys, dim=1)


def gru_seq(xaffine, sW, sW2):
    """sloika 2-matrix GRU (src/layers.c:513-568).

    xaffine: [B, T, 3H], sW: [H, 2H] (z,r gates), sW2: [H, H]
    (candidate, applied to r*h) -> [B, T, H].
    """
    return _gru2_seq(xaffine, sW, sW2, torch.tanh)


def gru_relu_seq(xaffine, sW, sW2):
    """sloika GRU with ReLU candidate (src/layers.c:718-874)."""
    return _gru2_seq(xaffine, sW, sW2, torch.relu)
