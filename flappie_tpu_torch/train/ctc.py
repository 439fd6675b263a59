"""Flip-flop sequence negative log-likelihood (CTC-style lattice loss).

Counterpart of flappie_tpu/train/ctc.py.  The probability of a base
sequence is the sum over all monotonic alignments of the sequence onto
the T blocks.  The flip-flop encoding makes the state sequence
deterministic given the bases (consecutive identical bases alternate
flip/flop, otherwise flip), so the lattice is a chain of L states with
per-block stay (s_i -> s_i) and move (s_{i-1} -> s_i) transitions, and

    NLL = -logsumexp over alignments = -alpha_T[L-1]

computed by a forward loop over the blocks with a [B, L] log-alpha
carry; autograd differentiates through it.  With globally-normalised
transition weights this is exactly -log P(y | signal).

The JAX package's CTC step runs its scan recurrence; the port's runs
the same training path as ``nll_loss`` (``transitions(..., train=True)``):
the mathematics is the same.  It runs the f32 stream always: JAX's scan
recurrence (flappie_tpu/train/ctc.py:131, ``rnn_impl="scan"``) ignores
FLAPPIE_TPU_RNN_STREAM.
"""

from __future__ import annotations

import numpy as np
import torch

from ..models.network import transitions
from ..ops.crf import NEG_BIG, flipflop_index
from .trainer import make_train_step


def flipflop_encode(targets: np.ndarray, target_lengths: np.ndarray, nbase: int) -> np.ndarray:
    """Base indices [B, L] -> flip-flop state codes [B, L] (host-side)."""
    targets = np.asarray(targets)
    B, L = targets.shape
    states = np.zeros((B, L), np.int32)
    for b in range(B):
        prev_state = -1
        for i in range(int(target_lengths[b])):
            y = int(targets[b, i])
            if i > 0 and y == int(targets[b, i - 1]) and prev_state < nbase:
                prev_state = y + nbase
            else:
                prev_state = y
            states[b, i] = prev_state
    return states


def flipflop_ctc_nll(trans, nblocks, states, target_lengths, nbase: int):
    """Sequence NLL under globally-normalised flip-flop weights.

    trans: [B, T, nparam] (the network head's output); nblocks: [B]
    valid blocks; states: [B, L] flip-flop state codes (from
    flipflop_encode); target_lengths: [B].  Returns [B] NLL per read.
    """
    idx = flipflop_index(nbase)
    dev = trans.device
    pidx = torch.as_tensor(np.maximum(idx.param_idx, 0), dtype=torch.int64, device=dev)
    B, T, _ = trans.shape
    states = states.to(device=dev, dtype=torch.int64)
    target_lengths = target_lengths.to(device=dev, dtype=torch.int64)
    L = states.shape[1]

    stay_idx = pidx[states, states]  # [B, L]
    prev_states = torch.cat([states[:, :1], states[:, :-1]], dim=1)
    move_idx = pidx[prev_states, states]  # [B, L]; [:, 0] unused

    lpos = torch.arange(L, device=dev)[None, :]
    in_seq = lpos < target_lengths[:, None]
    neg = torch.full((B, 1), NEG_BIG, dtype=trans.dtype, device=dev)
    alpha = torch.where(lpos == 0, 0.0, NEG_BIG).to(trans.dtype).expand(B, L)
    tvalid = torch.arange(T, device=dev)[None, :] < nblocks[:, None]  # [B, T]

    stay_w = torch.gather(trans, 2, stay_idx[:, None, :].expand(B, T, L))  # [B, T, L]
    move_w = torch.gather(trans, 2, move_idx[:, None, :].expand(B, T, L))
    for t in range(T):
        stay = alpha + stay_w[:, t]
        moved = torch.cat([neg, alpha[:, :-1] + move_w[:, t, 1:]], dim=1)
        nxt = torch.where(in_seq, torch.logaddexp(stay, moved), NEG_BIG)
        alpha = torch.where(tvalid[:, t, None], nxt, alpha)
    final = torch.gather(alpha, 1, (target_lengths[:, None] - 1).clamp(min=0))[:, 0]
    return -final


def ctc_loss(params, cfg, signal, lengths, states, target_lengths):
    """Mean per-block sequence NLL of a batch through the training path."""
    trans, nblocks = transitions(params, cfg, signal, lengths, train=True,
                                 stream=torch.float32)
    nll = flipflop_ctc_nll(trans, nblocks, states, target_lengths, cfg.nbase)
    return torch.mean(nll / torch.clamp(nblocks, min=1).to(trans.dtype))


def make_ctc_train_step(cfg, lr: float = 1e-4):
    """(train_step, init) over the sequence NLL, as
    trainer.make_train_step: ``train_step(params, optimizer, signal,
    lengths, states, target_lengths)`` -> loss."""
    return make_train_step(cfg, lr, ctc_loss)
