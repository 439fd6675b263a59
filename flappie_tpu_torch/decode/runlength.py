"""Run-length (runnie) decoding (counterpart of
flappie_tpu/decode/runlength.py).

Reference semantics:
- decode_crf_runlength (src/decode.c:927-1011): Viterbi over the V2 RLE
  transition structure; path[t] = state after transition t (T entries,
  unlike flip-flop's T+1);
- transpost_crf_runlength (src/decode.c:1037-1159): transition
  "posterior" = alpha + trans + beta elementwise on the transition
  block, NOT normalised; shape/scale parameters are copied through;
- the .run emitter (src/runnie.c:277-311): per move block, emit base,
  shape, scale and dwell (1 + following stay blocks);
- dwmean / runlengths_mean (src/decode.c:552-601): discrete-Weibull
  mean estimate, kept for API completeness;
- the V1 model (decode_runlength / posterior_runlength,
  src/decode.c:692-892): ``rle_v1_viterbi`` and ``rle_v1_posterior``
  over the nbase-state chain of ``rle_v1_index``.

The scans run on the kernels that ops/crf.py's FLAPPIE_TPU_CRF_IMPL
selects: the V1 chain's S = 4 on K3/K4, K5 and K6 (``scanb``) or K11
(``pallas``).
"""

from __future__ import annotations

from functools import lru_cache
from typing import List, NamedTuple

import numpy as np
import torch

from ..ops.crf import TransIndex, crf_backward, crf_forward, crf_viterbi, lse, rle_index

BASES = "ACGT"


# ---------------------------------------------------------------------------
# V1 run-length model (reference decode_runlength / posterior_runlength,
# src/decode.c:692-892).  The V1 chain has nbase states (one per base); a
# block either MOVES to a different base (weight depends only on the
# destination) or STAYS in the same base.  Parameter layout per block
# (src/decode.c:688-691): [shape x nbase, scale x nbase, move x nbase,
# stay x nbase].
# ---------------------------------------------------------------------------


@lru_cache(maxsize=None)
def rle_v1_index(nbase: int) -> TransIndex:
    """TransIndex of the V1 chain, so that the batched CRF scans apply:
    dense[from=b2, to=b1] = move[b1] if b2 != b1 else stay[b1].

    Viterbi tie order (src/decode.c:720-747): the move winner is the
    first argmax over origins (lowest b2 wins ties) and the stay
    replaces it only on a strictly greater score -- rank = b2 for moves,
    nbase for the stay.  from_state/to_state are left empty (a V1 param
    serves several origins, so per-param gathers are undefined; the V1
    posterior has its own formulation below).  Cached, so that the CRF
    functions' device tables of it (ops/crf.py ``index_tables``) are
    built once a device."""
    nparam = 4 * nbase
    param_idx = np.full((nbase, nbase), -1, dtype=np.int32)
    tie_rank = np.full((nbase, nbase), 10**6, dtype=np.int32)
    for b2 in range(nbase):
        for b1 in range(nbase):
            param_idx[b2, b1] = (3 * nbase + b1) if b2 == b1 else (2 * nbase + b1)
            tie_rank[b2, b1] = nbase if b2 == b1 else b2
    allowed = np.ones((nbase, nbase), dtype=bool)
    empty = np.zeros(0, dtype=np.int32)
    return TransIndex(nbase, nbase, nparam, empty, empty, param_idx, allowed, tie_rank)


def rle_v1_viterbi(params, nblocks, nbase: int = 4):
    """Batched decode_runlength (src/decode.c:692-770).

    params: [B, T, 4*nbase]; returns (score [B], path [B, T] int32) with
    the reference convention: path[t] = the base moved into at block t,
    or -1 when block t is a stay (and past the read's end)."""
    score, states, _ = crf_viterbi(params, nblocks, nbase, idx=rle_v1_index(nbase))
    # states [B, T+1]: a V1 transition is a stay iff the state repeats (a
    # move to the same base is not in the chain)
    prev, curr = states[:, :-1], states[:, 1:]
    minus = torch.full_like(curr, -1)
    T = params.shape[1]
    valid = torch.arange(T, device=params.device)[None, :] < nblocks.to(params.device)[:, None]
    return score, torch.where(valid & (curr != prev), curr, minus)


def rle_v1_posterior(params, nblocks, nbase: int = 4):
    """Batched posterior_runlength (src/decode.c:795-892).

    Returns [B, T, 4*nbase], the move and stay slots holding the
    UNNORMALISED log posterior (the reference's alpha/beta products) and
    the shape and scale slots zero (the reference leaves those rows of
    its output untouched):

    post[move b1, t] = lse_{b2 != b1}(alpha_t[b2]) + move_t[b1] + beta_{t+1}[b1]
    post[stay b,  t] = alpha_t[b] + stay_t[b] + beta_{t+1}[b]
    """
    idx = rle_v1_index(nbase)
    move = params[..., 2 * nbase : 3 * nbase]
    stay = params[..., 3 * nbase :]
    alphas, _ = crf_forward(params, nblocks, nbase, idx=idx)  # [B, T+1, nbase]
    betas = crf_backward(params, nblocks, nbase, idx=idx)
    a, b = alphas[:, :-1], betas[:, 1:]
    # lse over origins b2 != b1: the total less the own term, stably
    total = lse(a, -1)[..., None]
    excl = total + torch.log1p(-torch.clamp(torch.exp(a - total), max=1.0 - 1e-7))
    zeros = torch.zeros_like(params[..., : 2 * nbase])
    return torch.cat([zeros, excl + move + b, a + stay + b], dim=-1)


def runlengths_unit(path: np.ndarray, nbase: int = 4) -> np.ndarray:
    """Unit run length per move block; 0 for stays (src/decode.c:610-632)."""
    s = np.asarray(path)
    return ((s >= 0) & (s < nbase)).astype(np.int64)


def rle_split(params, nbase: int):
    """[.., 2*nbase + 2*nbase^2] -> (shape, scale, trans) slices."""
    return params[..., :nbase], params[..., nbase : 2 * nbase], params[..., 2 * nbase :]


def rle_transpost(params, nblocks, nbase: int):
    """Batched transpost_crf_runlength: the input's layout, transitions
    replaced by alpha + trans + beta (unnormalised), shape and scale
    copied through."""
    idx = rle_index(nbase)
    shape, scale, trans = rle_split(params, nbase)
    alphas, _ = crf_forward(trans, nblocks, nbase, idx=idx)
    betas = crf_backward(trans, nblocks, nbase, idx=idx)
    fr = torch.as_tensor(idx.from_state, dtype=torch.int64, device=params.device)
    to = torch.as_tensor(idx.to_state, dtype=torch.int64, device=params.device)
    post = alphas[:, :-1].index_select(2, fr) + trans + betas[:, 1:].index_select(2, to)
    return torch.cat([shape, scale, post], dim=-1)


def rle_viterbi(params, nblocks, nbase: int):
    """Batched decode_crf_runlength: (score [B], path [B, T] int32) with
    the reference's path convention (the state after each transition:
    the Viterbi path without its entry 0)."""
    _, _, trans = rle_split(params, nbase)
    score, path, _ = crf_viterbi(trans, nblocks, nbase, idx=rle_index(nbase))
    return score, path[:, 1:]


class RunRecord(NamedTuple):
    base: str
    shape: float
    scale: float
    dwell: int


def _runs(path, shape_at, scale_at, nblocks: int, nbase: int) -> List[RunRecord]:
    """The .run emitter (src/runnie.c:277-311): a stay block (state >=
    nbase) lengthens the dwell of the last move block; each move block
    emits the previous one."""
    out: List[RunRecord] = []
    dwell = 1
    last_blk = -1
    for blk in range(nblocks):
        if path[blk] >= nbase:
            dwell += 1
            continue
        if last_blk >= 0:
            base = int(path[last_blk])
            out.append(RunRecord(BASES[base], float(shape_at(last_blk, base)),
                                 float(scale_at(last_blk, base)), dwell))
        last_blk = blk
        dwell = 1
    if last_blk >= 0:
        base = int(path[last_blk])
        out.append(RunRecord(BASES[base], float(shape_at(last_blk, base)),
                             float(scale_at(last_blk, base)), dwell))
    return out


def runs_from_path(params: np.ndarray, path: np.ndarray, nblocks: int,
                   nbase: int = 4) -> List[RunRecord]:
    """Per-base runs from the decoded matrix params [T, nparam] (the
    transpost output in fb mode, the raw weights in Viterbi mode) and
    the path [T]."""
    return _runs(path, lambda t, b: params[t, b], lambda t, b: params[t, nbase + b],
                 nblocks, nbase)


def runs_from_selected(path: np.ndarray, shape_sel: np.ndarray, scale_sel: np.ndarray,
                       nblocks: int, nbase: int = 4) -> List[RunRecord]:
    """runs_from_path when only the path-selected weights reached the
    host (shape_sel[t] = params[t, path[t] % nbase], scale_sel[t] =
    params[t, nbase + path[t] % nbase]): the identical records."""
    return _runs(path, lambda t, b: shape_sel[t], lambda t, b: scale_sel[t], nblocks, nbase)


def dwmean(shape: float, scale: float, maxval: int = 100) -> float:
    """Approximate mean of a discrete Weibull (src/decode.c:552-561)."""
    i = np.arange(1, maxval + 1, dtype=np.float64)
    return float(np.exp(-np.power(i / scale, shape)).sum())


def runlengths_mean(params: np.ndarray, path: np.ndarray, nbase: int = 4) -> np.ndarray:
    """Expected run length per block; 0 for stays (src/decode.c:574-601).
    Path convention: -1 (or >= nbase) for a stay."""
    runs = np.zeros(path.shape[0], dtype=np.int64)
    for blk, s in enumerate(path):
        if s < 0 or s >= nbase:
            continue
        runs[blk] = 1 + round(dwmean(float(params[blk, s]), float(params[blk, nbase + s]), 100))
    return runs


def runlength_to_basecall(path: np.ndarray, runlength: np.ndarray, nbase: int = 4) -> str:
    """src/decode.c:643-667."""
    return "".join(BASES[int(s)] * int(r) for s, r in zip(path, runlength) if 0 <= s < nbase)
