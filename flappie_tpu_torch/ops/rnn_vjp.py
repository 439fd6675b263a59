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
a ``lax.scan`` and not a Pallas kernel.  Its products run at
FLAPPIE_TPU_GRAD_PRECISION (ops/precision.py ``grad_precision``, read at
call time; JAX's ``_grad_precision``): true f32 by default and on the
CPU, and at ``default`` on a CUDA device one bf16 pass (both operands of
every product rounded to bf16, f32 sums).  One difference in form, none
in math: the gate pre-activations depend only on the saved sequences, so
they are recomputed for all steps at once, before the loop (``xa +
h_prev @ sW`` as one product), together with every factor of the gate
derivatives.  The loop then carries only the cotangents: for LSTM (dh,
dc) with one [B, 4H] x [4H, H] product a step, for GRU-mod dh with one
[B, 3H] x [3H, H] product.  Invalid steps (t >= length) freeze the
carried cotangents and add nothing to any gradient.

The bf16 stream (``stream=torch.bfloat16``, or a bf16 x): the forward
rounds x and iW to bf16 inside the layer (K8-bf16 or K7-bf16, or the
rnn-``default`` variants), as the JAX package's ``_run_fused:514-516``
does, and returns bf16 h (and c).  The residuals are the caller's x and
iW, not the rounded ones: the adjoint recomputes xa from x widened to f32
and the f32 iW (JAX's ``_bwd:195-203``), so its xa differs from the
forward's bf16 xa on purpose; the saved h and c are widened to f32.  dx
comes back in x's dtype (f32 for a first layer fed f32, bf16 after), diW
in iW's.
"""

from __future__ import annotations

import torch

from . import precision, rnn_cuda
from .masking import reverse_sequence_tm


def _ident(t):
    return t


def _lstm_adjoint(xa, h_prev, c_prev, dy, valid, sW, rnd=_ident):
    """Reverse loop emitting dxF [T, B, 4H] (= dxa = dv for LSTM); ``rnd``
    rounds the operands of each product (identity: true f32)."""
    T, B, H = h_prev.shape
    xF = xa + torch.matmul(rnd(h_prev), rnd(sW))
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
    sWT = rnd(sW).T
    dxF = xa.new_empty(T, B, 4 * H)
    dh = xa.new_zeros(B, H)
    dc = xa.new_zeros(B, H)
    for t in range(T - 1, -1, -1):
        dh2 = (dh + dy[t]) * valid[t]
        dct = torch.addcmul(valid[t] * dc, dh2, k_c[t])
        torch.mul(dct[:, None, :], a_c[t], out=dxF[t, :, : 3 * H].view(B, 3, H))
        torch.mul(dh2, a_o[t], out=dxF[t, :, 3 * H :])
        dh = torch.addmm(inv[t] * dh, rnd(dxF[t]), sWT)
        dc = torch.addcmul(inv[t] * dc, f[t], dct)
    return dxF, dxF


def _grumod_adjoint(xa, h_prev, _c_prev, dy, valid, sW, rnd=_ident):
    """Reverse loop emitting (dxa, dv), both [T, B, 3H]; they differ in
    the candidate third: dv_h = dpre_hbar * r, dxa_h = dpre_hbar."""
    T, B, H = h_prev.shape
    vm = torch.matmul(rnd(h_prev), rnd(sW))
    z = torch.sigmoid(xa[..., :H] + vm[..., :H])
    r = torch.sigmoid(xa[..., H : 2 * H] + vm[..., H : 2 * H])
    hbar = torch.tanh(r * vm[..., 2 * H :] + xa[..., 2 * H :])
    # every pre-activation cotangent is dh2 times a factor of the saved state
    p_h = (1.0 - z) * (1.0 - hbar * hbar)  # dpre_hbar = dh2 * p_h
    p_z = (h_prev - hbar) * z * (1.0 - z)  # dpre_z
    p_r = p_h * vm[..., 2 * H :] * r * (1.0 - r)  # dpre_r
    a_v = torch.stack([p_z, p_r, p_h * r], dim=2)
    inv = 1.0 - valid
    sWT = rnd(sW).T
    dv = xa.new_empty(T, B, 3 * H)
    dh2_seq = xa.new_empty(T, B, H)
    dh = xa.new_zeros(B, H)
    for t in range(T - 1, -1, -1):
        dh2 = torch.mul(dh + dy[t], valid[t], out=dh2_seq[t])
        torch.mul(dh2[:, None, :], a_v[t], out=dv[t].view(B, 3, H))
        dh = torch.addmm(torch.addcmul(inv[t] * dh, z[t], dh2), rnd(dv[t]), sWT)
    dxa = torch.cat([dv[..., : 2 * H], dh2_seq * p_h], dim=-1)
    return dxa, dv


def _backward(kind, backward, x, iW, b, sW, lengths, h, c, dy):
    """(dx, diW, db, dsW) of one layer from its residuals: x and iW as the
    caller gave them, h and c as the forward stored them (bf16 under the
    stream), widened to f32 here (flappie_tpu/ops/rnn_vjp.py:173-238)."""
    T, B, IN = x.shape
    H = sW.shape[0]
    # the working dtype: bf16 residuals widen to f32 (float64 stays, for
    # gradcheck)
    wt = torch.float32 if x.dtype == torch.bfloat16 else x.dtype
    rnd = (precision.one_pass if precision.grad_precision(x.device) == precision.ONE_PASS
           else _ident)
    lens = lengths.to(device=x.device, dtype=torch.int64)
    x32, iW32, dy, h = x.to(wt), iW.to(wt), dy.to(wt), h.to(wt)
    c = c.to(wt) if c is not None else None
    if backward:
        # per-read time reversal turns the end-anchored recurrence into
        # the start-anchored form the adjoint loop walks; padded tails
        # (zeros) stay in place
        x32, h, dy = (reverse_sequence_tm(t, lens) for t in (x32, h, dy))
        if c is not None:
            c = reverse_sequence_tm(c, lens)
    xa = torch.addmm(b, rnd(x32.reshape(T * B, IN)), rnd(iW32)).reshape(T, B, iW.shape[1])
    zrow = x32.new_zeros(1, B, H)
    h_prev = torch.cat([zrow, h])[:T]
    c_prev = torch.cat([zrow, c])[:T] if c is not None else None
    valid = (torch.arange(T, device=x.device)[:, None] < lens[None, :]).to(wt)[..., None]
    adjoint = _lstm_adjoint if kind == "lstm" else _grumod_adjoint
    dxa, dv = adjoint(xa, h_prev, c_prev, dy, valid, sW, rnd)
    G = dxa.shape[-1]
    dxa2, dv2 = rnd(dxa.reshape(T * B, G)), rnd(dv.reshape(T * B, G))
    dsW = rnd(h_prev.reshape(T * B, H)).T @ dv2
    diW = rnd(x32.reshape(T * B, IN)).T @ dxa2
    db = dxa.reshape(T * B, G).sum(dim=0)
    dx = (dxa2 @ rnd(iW32).T).reshape(T, B, IN)
    if backward:
        dx = reverse_sequence_tm(dx, lens)
    return dx.to(x.dtype), diW.to(iW.dtype), db.to(b.dtype), dsW.to(sW.dtype)


class FusedRecurrentLayer(torch.autograd.Function):
    """``apply(kind, backward, stream, x_tm, iW, b, sW, lengths)`` -> h
    [T, B, H]; kind is "lstm" or "grumod", stream the layer's stream dtype
    (an f32 x under the bf16 stream is rounded inside), lengths [B] int32
    (not differentiated)."""

    @staticmethod
    def forward(ctx, kind, backward, stream, x_tm, iW, b, sW, lengths):
        xs = x_tm.to(stream)
        if kind == "lstm":
            h, c = rnn_cuda.lstm_layer_tm_train(xs, iW, b, sW, backward, lengths)
        elif kind == "grumod":
            h, c = rnn_cuda.grumod_layer_tm(xs, iW, b, sW, backward, lengths), None
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
        return None, None, None, dx, diW, db, dsW, None


def _apply(kind, x_tm, iW, b, sW, backward, lengths, stream):
    if lengths is None:
        lengths = torch.full((x_tm.shape[1],), x_tm.shape[0], dtype=torch.int32,
                             device=x_tm.device)
    stream = x_tm.dtype if stream is None else precision.check_stream(stream)
    return FusedRecurrentLayer.apply(kind, bool(backward), stream, x_tm, iW, b, sW, lengths)


def lstm_layer_tm_ad(x_tm, iW, b, sW, backward: bool = False, lengths=None, stream=None):
    """Differentiable ``rnn_cuda.lstm_layer_tm``: K8 forward (K8-bf16
    under the bf16 stream; ``stream`` None: x's dtype), adjoint backward."""
    return _apply("lstm", x_tm, iW, b, sW, backward, lengths, stream)


def grumod_layer_tm_ad(x_tm, iW, b, sW, backward: bool = False, lengths=None, stream=None):
    """Differentiable ``rnn_cuda.grumod_layer_tm``: K7 forward (K7-bf16
    under the bf16 stream), adjoint backward."""
    return _apply("grumod", x_tm, iW, b, sW, backward, lengths, stream)
