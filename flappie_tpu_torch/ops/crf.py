"""Flip-flop CRF structure, forward pass, partition and phred bytes.

Counterpart of flappie_tpu/ops/crf.py.  The flip-flop CRF over
``nbase`` bases has ``nstate = 2*nbase`` states (flip 0..nbase-1, flop
nbase..2nbase-1) and per-block parameter vectors of length ``nparam =
nstate*(nbase+1)`` (reference: src/decode.c:104-114,
src/layers.c:1035-1079):

- ``p[to*nstate + from]``            for ``to < nbase`` (into flip, any from)
- ``p[nbase*nstate + b]``            flip b  -> flop nbase+b (move)
- ``p[nbase*nstate + nbase + b]``    flop    -> flop (stay)

The scans run batch-minor on the port's CRF kernels (ops/crf_bm.py ->
ops/crf_bm_cuda.py), the JAX package's TPU path; forbidden transitions
are the finite NEG_BIG rather than -inf.
"""

from __future__ import annotations

from functools import lru_cache
from typing import NamedTuple

import numpy as np
import torch

NEG_BIG = -3.0e38  # effectively -inf in float32 without nan arithmetic
RANK_BIG = 10**6  # tie_rank for forbidden transitions


class TransIndex(NamedTuple):
    """Static sparse-transition structure of a CRF."""

    nbase: int
    nstate: int
    nparam: int
    from_state: np.ndarray  # [nparam] int32
    to_state: np.ndarray  # [nparam] int32
    param_idx: np.ndarray  # [nstate, nstate] int32, -1 where forbidden
    allowed: np.ndarray  # [nstate, nstate] bool
    tie_rank: np.ndarray  # [nstate, nstate] int32: Viterbi tie preference
    # (lower wins on equal scores), transcribing the reference decode
    # loop's candidate iteration order and strict-> comparisons


@lru_cache(maxsize=None)
def flipflop_index(nbase: int) -> TransIndex:
    nstate = 2 * nbase
    nparam = nstate * (nbase + 1)
    from_state = np.empty(nparam, dtype=np.int32)
    to_state = np.empty(nparam, dtype=np.int32)
    param_idx = np.full((nstate, nstate), -1, dtype=np.int32)
    for to in range(nbase):
        for frm in range(nstate):
            p = to * nstate + frm
            from_state[p] = frm
            to_state[p] = to
            param_idx[frm, to] = p
    off = nbase * nstate
    for b in range(nbase):
        # flip b -> flop nbase+b
        from_state[off + b] = b
        to_state[off + b] = nbase + b
        param_idx[b, nbase + b] = off + b
        # flop stay
        from_state[off + nbase + b] = nbase + b
        to_state[off + nbase + b] = nbase + b
        param_idx[nbase + b, nbase + b] = off + nbase + b
    allowed = param_idx >= 0
    # Viterbi tie order (decode.c:153-180): flip destinations iterate
    # from-state 0..nstate-1 with strict >, so the lowest from wins
    # ties; flop destinations initialise with the stay and only take
    # the flip->flop move on strict >, so the stay wins ties.
    tie_rank = np.full((nstate, nstate), RANK_BIG, dtype=np.int32)
    for to in range(nbase):
        for frm in range(nstate):
            tie_rank[frm, to] = frm
    for b in range(nbase):
        tie_rank[nbase + b, nbase + b] = 0  # stay preferred
        tie_rank[b, nbase + b] = 1
    return TransIndex(
        nbase, nstate, nparam, from_state, to_state, param_idx, allowed, tie_rank
    )


def lse(x, dim: int):
    """max + log(sum(exp(x - max))) along ``dim`` (finite inputs)."""
    mx = x.amax(dim=dim, keepdim=True)
    return (mx + torch.log(torch.sum(torch.exp(x - mx), dim=dim, keepdim=True))).squeeze(dim)


def crf_forward(trans, nblocks, nbase: int, idx: TransIndex | None = None):
    """Forward pass: trans [B, T, nparam], nblocks [B] ->
    (alphas [B, T+1, nstate], logZ [B]).

    alpha[:, 0] = 0 (src/layers.c:1042-1047); padded blocks leave alpha
    unchanged; logZ is the lse of alpha at each read's own final block.
    The scan is the batch-minor sum kernel (K3)."""
    from .crf_bm import _dense_tm, _fwd_states_tm

    idx = idx if idx is not None else flipflop_index(nbase)
    B, T, _ = trans.shape
    trans_tm = trans.permute(1, 2, 0)  # [T, P, B]
    tvalid = torch.arange(T, device=trans.device)[:, None] < nblocks[None, :]
    alphas = _fwd_states_tm(_dense_tm(trans_tm, idx), tvalid).permute(2, 0, 1)
    final = torch.gather(
        alphas, 1, nblocks.to(torch.int64)[:, None, None].expand(B, 1, idx.nstate)
    )[:, 0]
    return alphas, lse(final, -1)


def crf_partition(trans, nblocks, nbase: int, idx: TransIndex | None = None):
    """log partition function (reference src/layers.c:1035-1079)."""
    return crf_forward(trans, nblocks, nbase, idx=idx)[1]


def crf_partition_ad(trans, nblocks, nbase: int):
    """Differentiable log partition function [B] (the training path):
    K3 forward, K4 backward (ops/crf_bm.py ``PartitionScan``)."""
    from .crf_bm import PartitionScan

    return PartitionScan.apply(trans, nblocks, nbase)


def path_score(trans, path, nblocks, nbase: int, idx: TransIndex | None = None):
    """Total log-weight of a block path [B, T+1]: the sum over valid
    blocks of trans[t, param_idx[path[t], path[t+1]]] (counterpart of
    flappie_tpu/ops/crf.py:513 ``path_score``).  With globally-normalised
    weights it is the path log-probability."""
    idx = idx if idx is not None else flipflop_index(nbase)
    pidx = torch.as_tensor(np.maximum(idx.param_idx, 0), dtype=torch.int64, device=trans.device)
    path = path.to(device=trans.device, dtype=torch.int64)
    sel = pidx[path[:, :-1], path[:, 1:]]  # [B, T]
    q = torch.gather(trans, 2, sel[..., None])[..., 0]
    T = trans.shape[1]
    valid = torch.arange(T, device=trans.device)[None, :] < nblocks[:, None]
    return torch.where(valid, q, torch.zeros_like(q)).sum(dim=1)


M_LOG10E = 0.43429448190325182765  # glibc math.h
# The reference multiplies log1pf(-p) by the *double* -10*M_LOG10E
# (src/util.h:288) and rounds once to float; emulate that without f64
# via a hi/lo split of the constant (double-single product).
_QC = -10.0 * M_LOG10E
_QC_HI = float(np.float32(_QC))
_QC_LO = float(np.float32(_QC - _QC_HI))


def phred_from_qpath(qpath):
    """Per-block Phred+33 quality bytes from transition log-weights
    (qscoref/phredf, src/util.h:286-304): p = exp(q) clipped at 0.99999,
    Q = -10*log10(1-p), chr(round(33+Q)) capped at 126.  qpath[0] is NaN
    (reference quirk) and maps to 33; its byte is never consumed."""
    p = torch.exp(qpath.to(torch.float32))
    p = torch.clamp(p, max=0.99999)
    l1p = torch.log1p(-p)
    q = _QC_HI * l1p + _QC_LO * l1p
    ph = torch.floor(33.0 + q + 0.5)
    ph = torch.where(torch.isnan(ph), torch.full_like(ph, 33.0), ph)
    return torch.clamp(ph, max=126.0).to(torch.uint8)
