"""Differentiable fused recurrent layers (the training path).

Counterpart of flappie_tpu/ops/rnn_vjp.py: a ``torch.autograd.Function``
around the fused layers of ops/rnn_cuda.py.

- **forward** runs the fused layer: for LSTM the training variant K8
  (``lstm_layer_tm_train``), which also writes the carried cell state;
  for GRU-mod K7 itself, since everything its adjoint needs can be
  rebuilt from the hidden sequence;
- **backward** is the recompute-gates adjoint of ``_bwd``: per-read time
  reversal of the saved sequences for backward layers, the input affine
  recomputed as ``x @ iW + b``, ``h_prev``/``c_prev`` shifted in with a
  zero row, a reverse time loop over the carried cotangents, then dsW,
  diW, db and dx as batched products (dx reversed back).

The adjoint is plain tensor code on every device, as the JAX adjoint is
a ``lax.scan`` and not a Pallas kernel, and it is true f32 (the JAX
package's bf16x3 gradient tier is TPU-only).  One difference in form,
none in math: the gate pre-activations depend only on the saved
sequences, so they are recomputed for all steps at once, before the
loop (``xa + h_prev @ sW`` as one product), together with every factor
of the gate derivatives.  The loop then carries only the cotangents:
for LSTM (dh, dc) with one [B, 4H] x [4H, H] product a step, for GRU-mod
dh with one [B, 3H] x [3H, H] product.  Invalid steps (t >= length)
freeze the carried cotangents and add nothing to any gradient.
"""

from __future__ import annotations

import torch

from . import rnn_cuda
from .masking import reverse_sequence_tm


def _lstm_adjoint(xa, h_prev, c_prev, dy, valid, sW):
    """Reverse loop emitting dxF [T, B, 4H] (= dxa = dv for LSTM)."""
    T, B, H = h_prev.shape
    xF = xa + torch.matmul(h_prev, sW)
    u = torch.sigmoid(xF[..., :H])
    f = torch.sigmoid(xF[..., H : 2 * H])
    g = torch.tanh(xF[..., 2 * H : 3 * H])
    o = torch.sigmoid(xF[..., 3 * H :])
    tc = torch.tanh(f * c_prev + u * g)
    # dxF = [du, df, dg] * sigma'/tanh' = dct * a_c, and do * sigma'(o) = dh2 * a_o
    a_c = torch.stack([g * u * (1.0 - u), c_prev * f * (1.0 - f), u * (1.0 - g * g)], dim=2)
    a_o = tc * o * (1.0 - o)
    k_c = o * (1.0 - tc * tc)  # dct = v * dc + dh2 * k_c
    inv = 1.0 - valid
    sWT = sW.T
    dxF = xa.new_empty(T, B, 4 * H)
    dh = xa.new_zeros(B, H)
    dc = xa.new_zeros(B, H)
    for t in range(T - 1, -1, -1):
        dh2 = (dh + dy[t]) * valid[t]
        dct = torch.addcmul(valid[t] * dc, dh2, k_c[t])
        torch.mul(dct[:, None, :], a_c[t], out=dxF[t, :, : 3 * H].view(B, 3, H))
        torch.mul(dh2, a_o[t], out=dxF[t, :, 3 * H :])
        dh = torch.addmm(inv[t] * dh, dxF[t], sWT)
        dc = torch.addcmul(inv[t] * dc, f[t], dct)
    return dxF, dxF


def _grumod_adjoint(xa, h_prev, _c_prev, dy, valid, sW):
    """Reverse loop emitting (dxa, dv), both [T, B, 3H]; they differ in
    the candidate third: dv_h = dpre_hbar * r, dxa_h = dpre_hbar."""
    T, B, H = h_prev.shape
    vm = torch.matmul(h_prev, sW)
    z = torch.sigmoid(xa[..., :H] + vm[..., :H])
    r = torch.sigmoid(xa[..., H : 2 * H] + vm[..., H : 2 * H])
    hbar = torch.tanh(r * vm[..., 2 * H :] + xa[..., 2 * H :])
    # every pre-activation cotangent is dh2 times a factor of the saved state
    p_h = (1.0 - z) * (1.0 - hbar * hbar)  # dpre_hbar = dh2 * p_h
    p_z = (h_prev - hbar) * z * (1.0 - z)  # dpre_z
    p_r = p_h * vm[..., 2 * H :] * r * (1.0 - r)  # dpre_r
    a_v = torch.stack([p_z, p_r, p_h * r], dim=2)
    inv = 1.0 - valid
    sWT = sW.T
    dv = xa.new_empty(T, B, 3 * H)
    dh2_seq = xa.new_empty(T, B, H)
    dh = xa.new_zeros(B, H)
    for t in range(T - 1, -1, -1):
        dh2 = torch.mul(dh + dy[t], valid[t], out=dh2_seq[t])
        torch.mul(dh2[:, None, :], a_v[t], out=dv[t].view(B, 3, H))
        dh = torch.addmm(torch.addcmul(inv[t] * dh, z[t], dh2), dv[t], sWT)
    dxa = torch.cat([dv[..., : 2 * H], dh2_seq * p_h], dim=-1)
    return dxa, dv


def _backward(kind, backward, x, iW, b, sW, lengths, h, c, dy):
    T, B, IN = x.shape
    H = sW.shape[0]
    lens = lengths.to(device=x.device, dtype=torch.int64)
    dy = dy.to(x.dtype)
    if backward:
        # per-read time reversal turns the end-anchored recurrence into
        # the start-anchored form the adjoint loop walks; padded tails
        # (zeros) stay in place
        x, h, dy = (reverse_sequence_tm(t, lens) for t in (x, h, dy))
        if c is not None:
            c = reverse_sequence_tm(c, lens)
    xa = torch.addmm(b, x.reshape(T * B, IN), iW).reshape(T, B, iW.shape[1])
    zrow = x.new_zeros(1, B, H)
    h_prev = torch.cat([zrow, h])[:T]
    c_prev = torch.cat([zrow, c])[:T] if c is not None else None
    valid = (torch.arange(T, device=x.device)[:, None] < lens[None, :]).to(x.dtype)[..., None]
    adjoint = _lstm_adjoint if kind == "lstm" else _grumod_adjoint
    dxa, dv = adjoint(xa, h_prev, c_prev, dy, valid, sW)
    G = dxa.shape[-1]
    dxa2, dv2 = dxa.reshape(T * B, G), dv.reshape(T * B, G)
    dsW = h_prev.reshape(T * B, H).T @ dv2
    diW = x.reshape(T * B, IN).T @ dxa2
    db = dxa2.sum(dim=0)
    dx = (dxa2 @ iW.T).reshape(T, B, IN)
    if backward:
        dx = reverse_sequence_tm(dx, lens)
    return dx, diW, db, dsW


class FusedRecurrentLayer(torch.autograd.Function):
    """``apply(kind, backward, x_tm, iW, b, sW, lengths)`` -> h [T, B, H];
    kind is "lstm" or "grumod", lengths [B] int32 (not differentiated)."""

    @staticmethod
    def forward(ctx, kind, backward, x_tm, iW, b, sW, lengths):
        if kind == "lstm":
            h, c = rnn_cuda.lstm_layer_tm_train(x_tm, iW, b, sW, backward, lengths)
        elif kind == "grumod":
            h, c = rnn_cuda.grumod_layer_tm(x_tm, iW, b, sW, backward, lengths), None
        else:
            raise ValueError(f"unknown recurrent kind {kind!r}")
        ctx.kind, ctx.backward = kind, bool(backward)
        ctx.save_for_backward(x_tm, iW, b, sW, lengths, h, c)
        return h

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dy):
        x, iW, b, sW, lengths, h, c = ctx.saved_tensors
        dx, diW, db, dsW = _backward(ctx.kind, ctx.backward, x, iW, b, sW, lengths, h, c, dy)
        return None, None, dx, diW, db, dsW, None


def _apply(kind, x_tm, iW, b, sW, backward, lengths):
    if lengths is None:
        lengths = torch.full((x_tm.shape[1],), x_tm.shape[0], dtype=torch.int32,
                             device=x_tm.device)
    return FusedRecurrentLayer.apply(kind, bool(backward), x_tm, iW, b, sW, lengths)


def lstm_layer_tm_ad(x_tm, iW, b, sW, backward: bool = False, lengths=None):
    """Differentiable ``rnn_cuda.lstm_layer_tm``: K8 forward, adjoint backward."""
    return _apply("lstm", x_tm, iW, b, sW, backward, lengths)


def grumod_layer_tm_ad(x_tm, iW, b, sW, backward: bool = False, lengths=None):
    """Differentiable ``rnn_cuda.grumod_layer_tm``: K7 forward, adjoint backward."""
    return _apply("grumod", x_tm, iW, b, sW, backward, lengths)
