"""Batch-minor CRF decode (counterpart of flappie_tpu/ops/crf_bm.py).

The whole decode stays time-major with the batch minor: forward,
backward + transition posterior, Viterbi, traceback; only the byte-sized
outputs transpose back at the end.  The scans are the port's CRF
kernels (ops/crf_bm_cuda.py: K3/K4, or K9 for the posterior's two
scans under FLAPPIE_TPU_SCANB_FB=fused, then K5 and K6), or their plain
versions under FLAPPIE_TPU_SCANB_KERNELS=off (``_use_kernels``);
everything around them is plain tensor code.

Reference semantics: src/decode.c:119-204 (Viterbi), :377-498
(forward/backward transition posterior), src/layers.c:1035 (partition).
"""

from __future__ import annotations

import os

import numpy as np
import torch

from . import crf_bm_cuda
from .crf import NEG_BIG, TransIndex, flipflop_index, index_tables, lse

def _use_kernels(device) -> bool:
    """FLAPPIE_TPU_SCANB_KERNELS, read at call time, as the JAX package's
    (crf_bm.py:39-53): ``auto`` (default) calls the kernels' wrappers,
    which launch on a CUDA device and run their plain versions on the
    CPU; ``off`` runs the plain scans on any device (JAX's blocked
    ``lax.scan``, the formulation reference); ``on`` (or ``1``, ``true``)
    runs the kernels and raises on the CPU, which has none."""
    v = os.environ.get("FLAPPIE_TPU_SCANB_KERNELS", "auto")
    if v in ("1", "on", "true") and torch.device(device).type != "cuda":
        raise ValueError(f"FLAPPIE_TPU_SCANB_KERNELS={v}: the CRF scan kernels run on a "
                         f"CUDA device, not {device}")
    return v != "off"


def _dense_tm(trans_tm, idx: TransIndex):
    """[T, P, B] -> [T, S, S, B] (from, to); forbidden = NEG_BIG."""
    T, P, B = trans_tm.shape
    S = idx.nstate
    tab = index_tables(idx, trans_tm.device)
    gathered = trans_tm.index_select(1, tab.pidx.reshape(-1)).reshape(T, S, S, B)
    allowed = tab.allowed[None, :, :, None]
    return torch.where(allowed, gathered, torch.full_like(gathered, NEG_BIG))


def _fwd_states_tm(dense_tm, tvalid_tm):
    """alphas [T+1, S, B] of the sum-semiring forward scan (K3)."""
    if _use_kernels(dense_tm.device):
        return crf_bm_cuda.fwd_states(dense_tm, tvalid_tm)
    return crf_bm_cuda.sum_states_plain(dense_tm, tvalid_tm, False)


def _bwd_states_tm(dense_tm, tvalid_tm):
    """betas [T+1, S, B]: beta[T]=0, beta[t]=lse_j m[t,i,j]+beta[t+1,j] (K4)."""
    if _use_kernels(dense_tm.device):
        return crf_bm_cuda.bwd_states(dense_tm, tvalid_tm)
    return crf_bm_cuda.sum_states_plain(dense_tm, tvalid_tm, True)


def _use_fused_fb() -> bool:
    """FLAPPIE_TPU_SCANB_FB=fused, read at call time: the posterior's
    alpha and beta scans run as one launch (K9), bit-equal to the split
    K3 and K4.  Opt-in, as in the JAX package (crf_bm.py:56), where it
    measured slower on the TPU; default ``split``."""
    return os.environ.get("FLAPPIE_TPU_SCANB_FB", "split") == "fused"


def _transpost_tm(trans_tm, tvalid_tm, idx: TransIndex):
    """Per-block transition posteriors [T, P, B], log-normalised per
    block (log_row_normalise, src/flappie_matrix.c:450-467)."""
    dense = _dense_tm(trans_tm, idx)
    if _use_fused_fb() and _use_kernels(dense.device):
        alphas, betas = crf_bm_cuda.fwdbwd_states(dense, tvalid_tm)
    else:
        alphas = _fwd_states_tm(dense, tvalid_tm)
        betas = _bwd_states_tm(dense, tvalid_tm)
    dev = trans_tm.device
    fr = torch.as_tensor(idx.from_state, dtype=torch.int64, device=dev)
    to = torch.as_tensor(idx.to_state, dtype=torch.int64, device=dev)
    tpost = alphas[:-1].index_select(1, fr) + trans_tm + betas[1:].index_select(1, to)
    return tpost - lse(tpost, 1)[:, None, :]


class PartitionScan(torch.autograd.Function):
    """``apply(trans [B, T, P], nblocks [B], nbase)`` -> logZ [B], the
    differentiable log partition function of the training path.

    Forward: the K3 scan over the dense matrix, the gather at each read's
    ``nblocks``, then lse.  Backward: the K4 scan, then the edge
    posteriors g_b * exp(alpha_t[i] + m_t[i, j] + beta_{t+1}[j] - logZ_b)
    on valid blocks and 0 elsewhere (``_transpost_tm`` without its
    per-block normalisation), gathered back to the P parameters.  That is
    the gradient XLA computes for the scan the JAX package trains
    through (flappie_tpu/ops/crf.py:246 ``crf_forward``, impl "scan").

    Both scans run on a centred matrix m'_t = m_t - c_t with c_t =
    lse_{i,j}(m_t) - log S, and logZ adds the c_t of the valid blocks
    back.  The posterior is the same function of m' as of m, but
    uncentred states grow by ~log S + a few units a block (thousands
    after 512 blocks), where a float32 ulp is ~2e-4, and the rounding
    that alpha and beta gather over the blocks then reaches the
    exponent: at T=512 and S=10 the uncentred posteriors were ~1e-3 off
    autograd through the plain scan on the card; centred states stay
    near zero."""

    @staticmethod
    def forward(ctx, trans, nblocks, nbase: int):
        idx = flipflop_index(nbase)
        B, T, _ = trans.shape
        S = idx.nstate
        tvalid = torch.arange(T, device=trans.device)[:, None] < nblocks[None, :]
        dense = _dense_tm(trans.permute(1, 2, 0), idx)  # [T, S, S, B]
        c = lse(dense.reshape(T, S * S, B), 1) - float(np.log(S))  # [T, B]
        dense = dense - c[:, None, None, :]
        alphas = _fwd_states_tm(dense, tvalid)  # [T+1, S, B]
        at = nblocks.to(device=trans.device, dtype=torch.int64)[None, None, :]
        final = torch.gather(alphas, 0, at.expand(1, S, B))[0]
        logZ_c = lse(final, 0)
        ctx.idx = idx
        ctx.save_for_backward(dense, tvalid, alphas, logZ_c)
        return logZ_c + torch.where(tvalid, c, torch.zeros_like(c)).sum(dim=0)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        dense, tvalid, alphas, logZ_c = ctx.saved_tensors
        idx = ctx.idx
        T, S, _, B = dense.shape
        betas = _bwd_states_tm(dense, tvalid)
        z = alphas[:-1, :, None, :] + dense + betas[1:, None, :, :] - logZ_c
        post = torch.where(tvalid[:, None, None, :], torch.exp(z), torch.zeros_like(z))
        flat = torch.as_tensor(idx.from_state * S + idx.to_state, dtype=torch.int64,
                               device=dense.device)
        d_tm = post.reshape(T, S * S, B).index_select(1, flat) * g
        return d_tm.permute(2, 0, 1), None, None


def _viterbi_fwd_tm(dense_tm, tvalid_tm, idx: TransIndex):
    """Max-plus forward (K5): (score [B], last_state [B], backptr [T,S,B])."""
    fwd = (crf_bm_cuda.viterbi_fwd if _use_kernels(dense_tm.device)
           else crf_bm_cuda.viterbi_fwd_plain)
    alpha, bps = fwd(dense_tm, tvalid_tm, index_tables(idx, dense_tm.device).tie_rank)
    score = alpha.amax(dim=0)
    last_state = alpha.argmax(dim=0).to(torch.int32)
    return score, last_state, bps


def _traceback_tm(backptr_tm, last_state, tvalid_tm):
    """path [T+1, B] int32 from [T, S, B] backpointers (K6)."""
    if _use_kernels(backptr_tm.device):
        return crf_bm_cuda.traceback(backptr_tm, tvalid_tm, last_state)
    return crf_bm_cuda.traceback_plain(backptr_tm, tvalid_tm, last_state)


def decode_bm(trans, nblocks, nbase: int, viterbi_only: bool, compute_trace: bool,
              idx: TransIndex | None = None):
    """Full decode of [B, T, P] transition weights, batch-minor inside.

    Returns (score [B], path [B, T+1] int32, qpath [B, T+1] f32,
    trace [B, T+1, S] uint8 or a [B, 1, S] dummy).  In fb mode the
    Viterbi runs over the per-block-normalised transition posterior
    (src/flappie.c:276-300); the trace is built from exp() of whichever
    matrix was decoded.
    """
    idx = idx if idx is not None else flipflop_index(nbase)
    B, T, P = trans.shape
    S = idx.nstate
    dev = trans.device

    trans_tm = trans.permute(1, 2, 0).contiguous()  # [T, P, B]
    tvalid_tm = torch.arange(T, device=dev)[:, None] < nblocks[None, :]

    mat_tm = trans_tm if viterbi_only else _transpost_tm(trans_tm, tvalid_tm, idx)

    dense = _dense_tm(mat_tm, idx)
    score, last_state, backptr = _viterbi_fwd_tm(dense, tvalid_tm, idx)
    path_tm = _traceback_tm(backptr, last_state, tvalid_tm).to(torch.int64)  # [T+1, B]

    # qpath[t] = mat[t-1, pidx[path[t-1], path[t]]]; qpath[0] = NaN
    pidx = index_tables(idx, dev).pidx
    sel = pidx[path_tm[:-1], path_tm[1:]]  # [T, B]
    q = torch.gather(mat_tm, 1, sel[:, None, :])[:, 0]  # [T, B]
    nan = torch.full((1, B), float("nan"), dtype=trans.dtype, device=dev)
    qpath_tm = torch.cat([nan, q], dim=0)

    if compute_trace:
        from_onehot = torch.as_tensor(np.eye(S, dtype=np.float32)[idx.from_state], device=dev)
        to_onehot = torch.as_tensor(np.eye(S, dtype=np.float32)[idx.to_state], device=dev)
        ep = torch.exp(mat_tm)  # [T, P, B]
        first = torch.einsum("pb,ps->sb", ep[0], from_onehot)
        rest = torch.einsum("tpb,ps->tsb", ep, to_onehot)
        occ = torch.cat([first[None], rest], dim=0)  # [T+1, S, B]
        # roundf = half away from zero for the non-negative occupancies
        trace = torch.clamp(torch.floor(255.0 * occ + 0.5), 0.0, 255.0).to(
            torch.uint8).permute(2, 0, 1)
    else:
        trace = torch.zeros(B, 1, S, dtype=torch.uint8, device=dev)

    return score, path_tm.to(torch.int32).T, qpath_tm.T, trace
