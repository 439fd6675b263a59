"""Recurrent layers as plain time loops (counterpart of
flappie_tpu/ops/rnn.py).

LSTM semantics match the reference step (src/layers.c:979-1026): per
step ``xF = xAffine_t + h sW``; gate order in xF is [update, forget,
candidate, output]; no peepholes; zero initial state;
``c = sigma(f)*c + sigma(u)*tanh(g)``; ``h = sigma(o)*tanh(c)``.

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
