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

These scan forward over batch-major [B, T, ...] tensors; the network
itself runs the fused time-major layer in rnn_cuda.py, which handles
direction and lengths inside the kernel.
"""

from __future__ import annotations

import torch


def affine(x, W, b):
    """[..., in] x [in, K] + [K] -> [..., K] in float32."""
    return torch.matmul(x, W) + b


def lstm_step(xa_t, h, c, sW):
    """One LSTM step: returns (h', c')."""
    H = h.shape[-1]
    xF = xa_t + h @ sW
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


def grumod_step(xa_t, h, sW):
    """One GRU-mod step: returns h'."""
    H = h.shape[-1]
    v = h @ sW
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
