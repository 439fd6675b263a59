"""Globally-normalised output heads (counterpart of
flappie_tpu/ops/heads.py).

- flip-flop (``globalnorm_flipflop``, reference globalnorm_flipflop,
  src/layers.c:1082-1106): ``C = tanh(W^T x + b) * 5 / temperature``
  then subtract ``logZ / nblocks`` (per read) from every parameter; the
  temperature scales *after* the tanh.  With ``train=True`` the logZ is
  ``crf_partition_ad`` (K3 forward, K4 backward), the differentiable
  path of the training losses.
- run-length V2 (``globalnorm_runlengthV2``, reference
  globalnorm_runlengthV2, src/layers.c:1306-1359): shape = 1 +
  softplus, scale = 1e-8 + softplus, transitions = 5*tanh/temperature,
  global normalisation over the transition block only.
- run-length V1 (``globalnorm_runlength``, reference globalnorm_runlength,
  src/layers.c:1176-1238): as V2 but scale = 1e-1 + softplus and 2*nbase
  transition weights (move into each base, stay in each base),
  normalised over the V1 chain (``_runlength_v1_partition``).

The flip-flop and V2 partitions run on the CRF kernels that ops/crf.py's
FLAPPIE_TPU_CRF_IMPL selects (K3, or K11's forward scan).  The V1
partition is a plain time loop over [B, nbase] states, as the JAX
package's is a ``lax.scan``: JAX has no Pallas kernel for it.
"""

from __future__ import annotations

import torch

from .activations import softplus
from .crf import crf_forward, crf_partition, crf_partition_ad, lse, rle_index
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


def globalnorm_runlengthV2(x, W, b, temperature, nblocks, nbase: int):
    """x: [B, T, H] -> params [B, T, 2*nbase + 2*nbase^2]: per block nbase
    shapes, nbase scales, then the 2*nbase^2 transitions, logZ-normalised
    per read over the transition block only.  Padded blocks are zeroed."""
    raw = affine(x, W, b)
    nrun = 2 * nbase
    shape = 1.0 + softplus(raw[..., :nbase])
    scale = 1e-8 + softplus(raw[..., nbase:nrun])
    trans = torch.tanh(raw[..., nrun:]) * (5.0 / temperature)
    logZ = crf_partition(trans, nblocks, 0, idx=rle_index(nbase)) / _safe_n(nblocks, raw.dtype)
    out = torch.cat([shape, scale, trans - logZ[:, None, None]], dim=-1)
    return mask_tail(out, nblocks)


def globalnorm_runlength(x, W, b, temperature, nblocks, nbase: int):
    """V1 run-length head: x [B, T, H] -> [B, T, 4*nbase], per block
    nbase shapes, nbase scales, nbase move and nbase stay weights, the
    last two logZ-normalised per read over the V1 chain: move into any
    other base (the weight independent of the origin), or stay in the
    same base (src/layers.c:1127-1174).  Padded blocks are zeroed."""
    raw = affine(x, W, b)
    shape = 1.0 + softplus(raw[..., :nbase])
    scale = 1e-1 + softplus(raw[..., nbase : 2 * nbase])
    move = torch.tanh(raw[..., 2 * nbase : 3 * nbase]) * (5.0 / temperature)
    stay = torch.tanh(raw[..., 3 * nbase :]) * (5.0 / temperature)
    logZ = _runlength_v1_partition(move, stay, nblocks) / _safe_n(nblocks, raw.dtype)
    out = torch.cat([shape, scale, move - logZ[:, None, None], stay - logZ[:, None, None]],
                    dim=-1)
    return mask_tail(out, nblocks)


def _logaddexp(a, b):
    """jnp.logaddexp's formula: max + log1p(exp(-|a - b|))."""
    mx = torch.maximum(a, b)
    return mx + torch.log1p(torch.exp(-torch.abs(a - b)))


def _runlength_v1_partition(move, stay, nblocks):
    """Forward log-partition [B] of the V1 run-length chain
    (src/layers.c:1127-1174): nbase states, alpha_0 = 0, then each valid
    block curr[b1] = lse_{b2 != b1}(prev[b2]) + move[b1], combined by
    logaddexp with prev[b1] + stay[b1]; padded blocks leave alpha as it
    is.  The exclusive lse is total + log1p(-exp(alpha - total)), the
    ratio clipped at 1 - 1e-7."""
    B, T, nbase = move.shape
    tvalid = torch.arange(T, device=move.device)[None, :] < nblocks.to(move.device)[:, None]
    alpha = move.new_zeros(B, nbase)
    for t in range(T):
        total = lse(alpha, -1)[:, None]
        excl = total + torch.log1p(-torch.clamp(torch.exp(alpha - total), max=1.0 - 1e-7))
        nxt = _logaddexp(excl + move[:, t], alpha + stay[:, t])
        alpha = torch.where(tvalid[:, t, None], nxt, alpha)
    return lse(alpha, -1)
