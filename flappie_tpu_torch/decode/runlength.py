"""Run-length (runnie) decoding (counterpart of
flappie_tpu/decode/runlength.py, V2 model).

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
  mean estimate, kept for API completeness.

The scans run on the kernels that ops/crf.py's FLAPPIE_TPU_CRF_IMPL
selects.  The V1 run-length functions (``rle_v1_*``) wait with the V1
head (ROADMAP item 11): their 4-state chain is not compiled in the scan
kernels.
"""

from __future__ import annotations

from typing import List, NamedTuple

import numpy as np
import torch

from ..ops.crf import crf_backward, crf_forward, crf_viterbi, rle_index

BASES = "ACGT"


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
