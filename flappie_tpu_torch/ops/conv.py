"""Same-padded strided 1-D convolution with reference edge semantics.

Counterpart of flappie_tpu/ops/conv.py (``conv1d_same``,
``_ref_edge_fix`` and the channels-major ``conv1d_same_ct`` /
``conv1d_strided_ct`` of the ``fast``/``pallas`` conv stacks).  The
body of ``conv1d_same`` is one library convolution
(``F.conv1d``; the JAX package uses plain ``lax.conv`` here too), with
``ncol_out = ceil(T / stride)`` and the reference's asymmetric padding
``padL = (winlen-1)//2``, ``padR = winlen//2``.

Right-edge quirk (replicated for parity, src/layers.c:189-276): when
``winlen % stride != 0`` the reference's body sgemm leaves the last
window(s) to its right-edge loop, which anchors them at ``n - winlen +
1 + w`` with the *leading* taps, and the final column(s) may receive
only the bias.  The executable specification is
tests/oracle.py:conv_tapmap; here the standard conv's last few columns
are rewritten per read to match.  Reads shorter than ``winlen`` keep
the mathematical same-conv (the reference's own arithmetic underflows
there).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import precision


def _operands(x, W):
    """x and W at the feed-forward level for x's device (ops/precision.py;
    flappie_tpu/ops/conv.py:47, :153, :187): ``default`` on a CUDA device
    rounds both to bf16, whose products the f32 convolution sums exactly
    (TF32 is off); otherwise as they are."""
    if precision.ff_precision(x.device) == precision.ONE_PASS:
        return precision.one_pass(x), precision.one_pass(W)
    return x, W


def _conv_math(x, W, b, stride: int):
    """x [B, T, Cin], W [winlen, Cin, Cout] -> [B, ceil(T/stride), Cout].
    A one-row x is convolved as two equal rows: at one row oneDNN's
    convolution takes another path, whose sums run in another order, and
    a read's bits would depend on how many reads share its batch."""
    if x.shape[0] == 1:
        return _conv_math(torch.cat([x, x]), W, b, stride)[:1]
    x, W = _operands(x, W)
    winlen = W.shape[0]
    padL = (winlen - 1) // 2
    padR = winlen // 2
    xc = F.pad(x.transpose(1, 2), (padL, padR))
    out = F.conv1d(xc, W.permute(2, 1, 0), stride=stride)
    return out.transpose(1, 2) + b


def _ref_edge_fix(out, x, W, b, stride: int, lengths):
    """Rewrite the last few output columns of each read to match the
    reference right-edge behaviour (see module docstring).  Every step
    is a tensor op, so nothing waits for the device."""
    winlen = W.shape[0]
    s = stride
    padL = (winlen - 1) // 2
    padR = winlen // 2
    ncolsL = -(-padL // s)
    shift = ncolsL * s - padL
    nstepC = -(-winlen // s)
    nstepX = s * nstepC
    B, T, _ = x.shape
    Tout = out.shape[1]
    Q = nstepC + 2  # all deviations live in the last <= nstepC+1 cols
    dev = x.device

    n = lengths.to(torch.int64)  # [B] valid input cols
    ncolC = -((-n) // s)
    maxcol = (n - shift) // nstepX
    rem = (n - shift) % nstepX
    colR0 = ncolsL + nstepC * (maxcol - 1) + rem // s + 1
    startR = s - (padL + n - winlen) % s - 1

    q = torch.arange(Q, device=dev)
    c = ncolC[:, None] - 1 - q[None, :]  # [B, Q]

    # body-sgemm coverage test for col c
    r = (c - ncolsL) % nstepC
    k = (c - ncolsL) // nstepC
    kmax = (n[:, None] - shift - s * r) // nstepX
    covered = (c < ncolsL) | (k < kmax)  # left-edge cols are exact too

    # right-edge loop membership and value
    m = c - colR0[:, None]
    wo = startR[:, None] + m * s
    in_right = (m >= 0) & (wo < padR)
    start = n[:, None] - winlen + 1 + wo  # [B, Q] anchor of leading taps
    j = torch.arange(winlen, device=dev)
    idx = start[:, :, None] + j  # [B, Q, w]
    tapmask = (
        (j[None, None, :] < winlen - 1 - wo[:, :, None])
        & (idx >= 0)
        & (idx < n[:, None, None])
    )
    bidx = torch.arange(B, device=dev)
    xwin = x[bidx[:, None, None], idx.clamp(0, T - 1)]  # [B, Q, w, C]
    xwin = xwin * tapmask[..., None].to(x.dtype)
    val_right = b + torch.einsum("bqwc,wco->bqo", xwin, W)

    # existing (standard-conv) values at the candidate columns
    existing = out[bidx[:, None], c.clamp(0, Tout - 1)]  # [B, Q, Cout]
    bias_only = b.expand_as(existing).to(out.dtype)
    new = torch.where(
        covered[..., None],
        existing,
        torch.where(in_right[..., None], val_right.to(out.dtype), bias_only),
    )
    new = torch.where((n[:, None] >= winlen)[..., None], new, existing)

    # scatter back; invalid cols (c < 0) land in a spare column that is
    # cut off again (the JAX version drops out-of-bounds writes)
    padded = torch.cat([out, out.new_zeros(B, 1, out.shape[2])], dim=1)
    target = torch.where(c >= 0, c, torch.full_like(c, Tout))
    padded[bidx[:, None], target] = new
    return padded[:, :Tout]


def conv1d_same_ct(xc, W, b):
    """Stride-1 same-conv in channels-major [B, C, T] layout (counterpart
    of flappie_tpu/ops/conv.py:128): the winlen shifted slices stacked
    and contracted over (k, c) in one product.

    xc: [B, C_in, T]; W: [winlen, C_in, C_out]; returns [B, C_out, T].
    The (k, c) sum runs in another order than ``conv1d_same``'s (float32
    ulps); that path stays the parity reference.
    """
    winlen = W.shape[0]
    T = xc.shape[-1]
    xc, W = _operands(xc, W)
    xp = F.pad(xc, ((winlen - 1) // 2, winlen // 2))
    xs = torch.stack([xp[:, :, k : k + T] for k in range(winlen)])  # [k, B, C, T]
    return torch.einsum("kbct,kco->bot", xs, W) + b[None, :, None]


def conv1d_strided_ct(xc, W, b, stride: int, lengths):
    """Strided conv from channels-major [B, C_in, T] input to the
    recurrent stack's [B, ceil(T/stride), C_out] (counterpart of
    flappie_tpu/ops/conv.py:158): one strided im2col, one product, then
    the reference right edge (``_ref_edge_fix`` on a time-major view)."""
    winlen = W.shape[0]
    B, _, T = xc.shape
    Tout = -(-T // stride)
    # pad so every strided window slice is in bounds (the extra zeros
    # beyond T + padR sit in columns the edge fix rewrites)
    xp = F.pad(xc, ((winlen - 1) // 2, winlen // 2 + (stride * Tout - T) + stride))
    cols = torch.stack([xp[:, :, k : k + stride * Tout : stride]
                        for k in range(winlen)])  # [k, B, C, Tout]
    out = torch.einsum("kbct,kco->bto", *_operands(cols, W)) + b
    if stride > 1 and winlen % stride != 0:
        if lengths is None:
            lengths = torch.full((B,), T, dtype=torch.int32, device=xc.device)
        out = _ref_edge_fix(out, xc.transpose(1, 2), W, b, stride, lengths)
    return out


def conv1d_same(x, W, b, stride: int, lengths=None):
    """x: [B, T, C_in], W: [winlen, C_in, C_out], b: [C_out].

    ``lengths`` ([B] int32 valid input cols; defaults to T) is needed
    for the reference-exact right edge when winlen % stride != 0.

    Returns [B, ceil(T/stride), C_out].
    """
    winlen = W.shape[0]
    out = _conv_math(x, W, b, stride)
    if stride > 1 and winlen % stride != 0:
        if lengths is None:
            lengths = torch.full((x.shape[0],), x.shape[1], dtype=torch.int32,
                                 device=x.device)
        out = _ref_edge_fix(out, x, W, b, stride, lengths)
    return out
