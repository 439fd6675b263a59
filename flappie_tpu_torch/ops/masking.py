"""Variable-length batching utilities (counterpart of
flappie_tpu/ops/masking.py).

Batches are left-aligned and zero-padded; ``lengths`` [B] int32 gives
each row's valid steps.  Padding meets the network in the convolutions
(zero tail = the reference's same-padding), the backward recurrences
(reversed per read, so padding never flows into valid outputs) and the
CRF scans (masked per block).
"""

from __future__ import annotations

import torch


def length_mask(lengths, T: int, dtype=torch.float32):
    """[B] lengths -> [B, T, 1] mask of 1.0 for t < length."""
    t = torch.arange(T, device=lengths.device)[None, :]
    return (t < lengths[:, None]).to(dtype)[..., None]


def mask_tail(x, lengths):
    """Zero x[b, t, :] for t >= lengths[b].  x: [B, T, C]."""
    return x * length_mask(lengths, x.shape[1], x.dtype)


def reverse_sequence(x, lengths):
    """Reverse each sequence's first ``lengths[b]`` steps; tail unmoved.

    x: [B, T, C], lengths: [B] int32.  An involution on the valid region.
    """
    T = x.shape[1]
    t = torch.arange(T, device=x.device)[None, :]
    L = lengths[:, None].to(torch.int64)
    idx = torch.where(t < L, L - 1 - t, t)
    return torch.gather(x, 1, idx[:, :, None].expand(-1, -1, x.shape[2]))


def mask_tail_tm(x_tm, lengths):
    """Time-major mask_tail: zero x[t, b, :] for t >= lengths[b]."""
    T = x_tm.shape[0]
    m = (torch.arange(T, device=x_tm.device)[:, None]
         < lengths[None, :].to(x_tm.device)).to(x_tm.dtype)
    return x_tm * m[:, :, None]


def reverse_sequence_tm(x_tm, lengths):
    """Time-major reverse_sequence: x [T, B, C]."""
    T = x_tm.shape[0]
    t = torch.arange(T, device=x_tm.device)[:, None]
    L = lengths[None, :].to(device=x_tm.device, dtype=torch.int64)
    idx = torch.where(t < L, L - 1 - t, t)
    return torch.gather(x_tm, 0, idx[:, :, None].expand(-1, -1, x_tm.shape[2]))
