"""Globally-normalised flip-flop head (counterpart of
flappie_tpu/ops/heads.py:34 ``globalnorm_flipflop``).

Reference globalnorm_flipflop (src/layers.c:1082-1106):
``C = tanh(W^T x + b) * 5 / temperature`` then subtract ``logZ /
nblocks`` (per read) from every parameter; the temperature scales
*after* the tanh.  The other heads (run-length V1/V2) are not ported yet.

With ``train=True`` the logZ is ``crf_partition_ad`` (K3 forward, K4
backward), the differentiable path of the training losses.
"""

from __future__ import annotations

import torch

from .crf import crf_forward, crf_partition_ad, lse
from .masking import mask_tail
from .rnn import affine


def _safe_n(nblocks, dtype):
    """Per-read block count as a divisor; zero-length (padded) rows use 1
    to keep their lane NaN-free - their output is masked to zero anyway."""
    return torch.clamp(nblocks, min=1).to(dtype)


def globalnorm_flipflop(x, W, b, temperature, nblocks, nbase: int,
                        return_norm: bool = False, train: bool = False):
    """x: [B, T, H] -> trans [B, T, nparam], logZ-normalised per read.

    Padded blocks are zeroed on output.  With ``return_norm`` also
    returns the per-read shift (logZ/nblocks) and the per-block
    partition increments inc[t] = lse(alpha[t+1]) - lse(alpha[t]) (zero
    on padded blocks), which stitch the full-read logZ across chunks.
    """
    C = torch.tanh(affine(x, W, b)) * (5.0 / temperature)
    if train:
        if return_norm:
            raise ValueError("globalnorm_flipflop: return_norm is for inference, not train")
        logZ = crf_partition_ad(C, nblocks, nbase) / _safe_n(nblocks, C.dtype)
        return mask_tail(C - logZ[:, None, None], nblocks)
    alphas, logZ = crf_forward(C, nblocks, nbase)
    if return_norm:
        l = lse(alphas, -1)  # [B, T+1]
        incs = l[:, 1:] - l[:, :-1]
        shift = logZ / _safe_n(nblocks, C.dtype)
        return mask_tail(C - shift[:, None, None], nblocks), shift, incs
    logZ = logZ / _safe_n(nblocks, C.dtype)
    return mask_tail(C - logZ[:, None, None], nblocks)
