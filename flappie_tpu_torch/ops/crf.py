"""CRF structures (flip-flop and run-length), forward and backward
passes, transition posterior, Viterbi decode and phred bytes.

Counterpart of flappie_tpu/ops/crf.py.  The flip-flop CRF over
``nbase`` bases has ``nstate = 2*nbase`` states (flip 0..nbase-1, flop
nbase..2nbase-1) and per-block parameter vectors of length ``nparam =
nstate*(nbase+1)`` (reference: src/decode.c:104-114,
src/layers.c:1035-1079):

- ``p[to*nstate + from]``            for ``to < nbase`` (into flip, any from)
- ``p[nbase*nstate + b]``            flip b  -> flop nbase+b (move)
- ``p[nbase*nstate + nbase + b]``    flop    -> flop (stay)

The run-length (runnie V2) structure is ``rle_index``.  Forbidden
transitions are the finite NEG_BIG rather than -inf.

The scans are chosen by ``FLAPPIE_TPU_CRF_IMPL`` at call time
(``_impl``): ``auto`` and ``scanb`` run the batch-minor K3/K4, K5, K6
(ops/crf_bm.py -> ops/crf_bm_cuda.py), the JAX package's TPU default;
``pallas`` runs the batch-major K11 (ops/crf_cuda.py), as the JAX
package's opt-in crf_pallas.py does; ``seg`` runs the two-level
segmented scans of ops/crf_seg.py; ``scan`` runs the JAX package's
sequential batch-major formulation (its CPU reference) as plain torch
steps on any device, K11's plain versions (``fwd_scan_plain``,
``viterbi_scan_plain``, ``traceback_bt_plain``) through the transposes
the JAX scans use.  ``scan`` is a plain formulation by design, reached
only by the knob: it is not a kernel's twin standing in for one, and on
the card it is a Python loop of small ops a step.
"""

from __future__ import annotations

from functools import lru_cache
from typing import NamedTuple

import os

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


@lru_cache(maxsize=None)
def rle_index(nbase: int) -> TransIndex:
    """Transition structure of the CRF run-length model (V2).

    Reference: rle_trans_lookup (src/decode.c:907-921, layers.c:1241-1246):
    ``idx = base_to * 2*nbase + base_from + (stay_from ? nbase : 0)``.
    States: move 0..nbase-1, stay nbase..2nbase-1.  A move to a different
    base lands in that base's move state; a "move" to the same base is
    the stay transition into the stay state; moving to the same base's
    move state is forbidden.
    """
    nstate = 2 * nbase
    nparam = 2 * nbase * nbase
    from_state = np.empty(nparam, dtype=np.int32)
    to_state = np.empty(nparam, dtype=np.int32)
    param_idx = np.full((nstate, nstate), -1, dtype=np.int32)
    for p in range(nparam):
        bt = p // nstate
        rem = p % nstate
        bf = rem % nbase
        to = bt if bt != bf else nbase + bt
        from_state[p] = rem
        to_state[p] = to
        param_idx[rem, to] = p
    allowed = param_idx >= 0
    # Viterbi tie order (decode.c:960-995): move destinations iterate
    # b2 ascending trying move then stay, all strict >, so priority is
    # (move b2, stay b2) pairs in b2 order; stay destinations compare
    # `stay > move`, so the MOVE wins ties (unlike flip-flop's stay).
    tie_rank = np.full((nstate, nstate), RANK_BIG, dtype=np.int32)
    for b1 in range(nbase):
        for b2 in range(nbase):
            if b1 == b2:
                continue
            tie_rank[b2, b1] = 2 * b2
            tie_rank[nbase + b2, b1] = 2 * b2 + 1
    for b in range(nbase):
        tie_rank[b, nbase + b] = 0  # move preferred
        tie_rank[nbase + b, nbase + b] = 1
    return TransIndex(
        nbase, nstate, nparam, from_state, to_state, param_idx, allowed, tie_rank
    )


class IndexTables(NamedTuple):
    """A TransIndex's tables as tensors on one device."""

    pidx: torch.Tensor  # [nstate, nstate] int64: param_idx, forbidden at 0
    allowed: torch.Tensor  # [nstate, nstate] bool
    tie_rank: torch.Tensor  # [nstate, nstate] int32


_TABLES: dict = {}


def index_tables(idx: TransIndex, device) -> IndexTables:
    """``idx``'s tables on ``device``, built at the first call and kept
    for the TransIndex's lifetime (the index builders are cached, so for
    the process): a table built at every call is a host-to-device copy
    from pageable memory in the middle of a program.  They are built
    outside inference mode whatever the caller's (a basecall's programs
    run under it), so that a later differentiable gather may save them
    for backward.  Keyed by device, so a mesh's dispatch threads each
    find their own device's tables; two threads that miss at once build
    a table twice, and the last one stays, which is harmless."""
    device = torch.device(device)
    key = (id(idx), str(device))
    hit = _TABLES.get(key)
    if hit is None or hit[0] is not idx:
        with torch.inference_mode(False):
            tables = IndexTables(
                torch.as_tensor(np.maximum(idx.param_idx, 0), dtype=torch.int64, device=device),
                torch.as_tensor(idx.allowed, device=device),
                torch.as_tensor(idx.tie_rank, dtype=torch.int32, device=device))
        hit = _TABLES[key] = (idx, tables)
    return hit[1]


def dense_from_params(p, idx: TransIndex):
    """[..., nparam] -> [..., nstate, nstate] (from, to); forbidden = NEG_BIG."""
    S = idx.nstate
    tab = index_tables(idx, p.device)
    gathered = p.index_select(-1, tab.pidx.reshape(-1)).reshape(*p.shape[:-1], S, S)
    return torch.where(tab.allowed, gathered, torch.full_like(gathered, NEG_BIG))


IMPLS = ("scanb", "pallas", "seg", "scan")


def _impl() -> str:
    """The CRF scans' implementation, read from FLAPPIE_TPU_CRF_IMPL at
    call time: ``auto`` (default, on every device) and ``scanb`` ->
    ``"scanb"``, the batch-minor kernels K3/K4, K5, K6; ``pallas``, the
    batch-major K11; ``seg``, the segmented scans (ops/crf_seg.py);
    ``scan``, the sequential plain formulation.  Anything else raises."""
    v = os.environ.get("FLAPPIE_TPU_CRF_IMPL", "auto")
    if v == "auto":
        return "scanb"
    if v in IMPLS:
        return v
    raise ValueError(
        f"FLAPPIE_TPU_CRF_IMPL={v!r}: flappie_tpu_torch runs 'auto'/'scanb' (batch-minor "
        "kernels K3-K6), 'pallas' (batch-major kernels K11), 'seg' (segmented scans) and "
        "'scan' (the sequential plain formulation)")


def _bt_fns(impl: str):
    """(forward scan, Viterbi scan, traceback) of the batch-major impls:
    K11's wrappers under ``pallas``, their plain versions under ``scan``."""
    from . import crf_cuda

    if impl == "pallas":
        return crf_cuda.fwd_scan, crf_cuda.viterbi_scan, crf_cuda.traceback_bt
    return crf_cuda.fwd_scan_plain, crf_cuda.viterbi_scan_plain, crf_cuda.traceback_bt_plain


def _time_valid(nblocks, T: int, device):
    """[T, B] bool: block t of read b is valid (t < nblocks[b])."""
    return torch.arange(T, device=device)[:, None] < nblocks.to(device)[None, :]


def lse(x, dim: int):
    """max + log(sum(exp(x - max))) along ``dim`` (finite inputs), the
    sum in index order (a cumulative sum's last entry): torch.sum adds in
    an order that follows the tensor's strides and the vectorised and
    remaining columns, so a read's bits would depend on its batch's size."""
    mx = x.amax(dim=dim, keepdim=True)
    e = torch.exp(x - mx)
    return (mx + torch.log(torch.cumsum(e, dim=dim).narrow(dim, -1, 1))).squeeze(dim)


def crf_forward(trans, nblocks, nbase: int, idx: TransIndex | None = None):
    """Forward pass: trans [B, T, nparam], nblocks [B] ->
    (alphas [B, T+1, nstate], logZ [B]).

    alpha[:, 0] = 0 (src/layers.c:1042-1047); padded blocks leave alpha
    unchanged; logZ is the lse of alpha at each read's own final block.
    The scan is K3 (scanb), K11's forward scan (pallas), its plain version
    (scan) or ops/crf_seg.py's (seg)."""
    idx = idx if idx is not None else flipflop_index(nbase)
    B, T, _ = trans.shape
    S = idx.nstate
    tvalid = _time_valid(nblocks, T, trans.device)
    impl = _impl()
    if impl in ("pallas", "scan"):
        fwd_scan = _bt_fns(impl)[0]
        alphas = fwd_scan(dense_from_params(trans.transpose(0, 1), idx), tvalid)
        alphas = torch.cat([alphas.new_zeros(1, B, S), alphas], dim=0).transpose(0, 1)
    elif impl == "seg":
        from .crf_seg import seg_forward_states

        alphas = seg_forward_states(dense_from_params(trans, idx), nblocks)
    else:
        from .crf_bm import _dense_tm, _fwd_states_tm

        alphas = _fwd_states_tm(_dense_tm(trans.permute(1, 2, 0), idx), tvalid).permute(2, 0, 1)
    final = torch.gather(
        alphas, 1, nblocks.to(device=trans.device, dtype=torch.int64)[:, None, None].expand(B, 1, S)
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


def crf_backward(trans, nblocks, nbase: int, idx: TransIndex | None = None):
    """Backward pass: betas [B, T+1, nstate]; beta at the final valid
    block is 0 (and stays 0 through the padded tail).  scanb: K4; pallas:
    K11's forward scan over the transposed, time-reversed blocks (the
    backward update lse(m + beta, axis=to) is the forward update on the
    transposed matrices), as flappie_tpu/ops/crf.py:336-344 does; scan:
    its plain version the same way; seg: ops/crf_seg.py's."""
    idx = idx if idx is not None else flipflop_index(nbase)
    B, T, _ = trans.shape
    tvalid = _time_valid(nblocks, T, trans.device)
    impl = _impl()
    if impl == "seg":
        from .crf_seg import seg_backward_states

        return seg_backward_states(dense_from_params(trans, idx), nblocks)
    if impl in ("pallas", "scan"):
        fwd_scan = _bt_fns(impl)[0]
        dense = dense_from_params(trans.transpose(0, 1), idx)  # [T, B, S, S]
        betas_rev = fwd_scan(dense.flip(0).transpose(-1, -2), tvalid.flip(0))
        betas = torch.cat([betas_rev.new_zeros(1, B, idx.nstate), betas_rev], dim=0).flip(0)
        return betas.transpose(0, 1)
    from .crf_bm import _bwd_states_tm, _dense_tm

    return _bwd_states_tm(_dense_tm(trans.permute(1, 2, 0), idx), tvalid).permute(2, 0, 1)


def crf_transpost(trans, nblocks, nbase: int, return_log: bool = True,
                  idx: TransIndex | None = None):
    """Per-block transition posteriors, normalised per block:
    tpost[b, t, p] = alpha_t[from(p)] + trans[t, p] + beta_{t+1}[to(p)],
    each block lse-normalised (log_row_normalise_inplace,
    src/flappie_matrix.c:450-467).  Padded blocks are normalised
    garbage; callers slice to nblocks."""
    idx = idx if idx is not None else flipflop_index(nbase)
    alphas = crf_forward(trans, nblocks, nbase, idx=idx)[0]
    betas = crf_backward(trans, nblocks, nbase, idx=idx)
    fr = torch.as_tensor(idx.from_state, dtype=torch.int64, device=trans.device)
    to = torch.as_tensor(idx.to_state, dtype=torch.int64, device=trans.device)
    tpost = alphas[:, :-1].index_select(2, fr) + trans + betas[:, 1:].index_select(2, to)
    tpost = tpost - lse(tpost, -1)[..., None]
    return tpost if return_log else torch.exp(tpost)


def crf_viterbi_forward(trans, nblocks, nbase: int, idx: TransIndex | None = None):
    """Max-plus forward pass: (score [B], last_state [B] int32, backptr
    [B, T, nstate] int8).  Ties resolve by ``idx.tie_rank`` (the
    reference decode loops' orders, decode.c:153-180 and :960-995).
    scanb: K5; pallas: K11's Viterbi scan; scan: its plain version; seg:
    ops/crf_seg.py's max-plus states and elementwise backpointers."""
    idx = idx if idx is not None else flipflop_index(nbase)
    B, T, _ = trans.shape
    tvalid = _time_valid(nblocks, T, trans.device)
    impl = _impl()
    if impl == "seg":
        from .crf_seg import seg_backptr, seg_viterbi_states

        dense = dense_from_params(trans, idx)
        alphas = seg_viterbi_states(dense, nblocks)
        backptr = seg_backptr(alphas, dense, nblocks, idx.tie_rank, RANK_BIG)
        final = alphas[:, -1]  # frozen at each read's own nblocks
        return final.amax(dim=-1), final.argmax(dim=-1).to(torch.int32), backptr
    if impl in ("pallas", "scan"):
        viterbi_scan = _bt_fns(impl)[1]
        alphas, bps = viterbi_scan(dense_from_params(trans.transpose(0, 1), idx), tvalid,
                                   index_tables(idx, trans.device).tie_rank)
        # the state freezes on padded steps, so the last row is every
        # read's final alpha
        alpha = alphas[-1]
        return alpha.amax(dim=-1), alpha.argmax(dim=-1).to(torch.int32), bps.transpose(0, 1)
    from .crf_bm import _dense_tm, _viterbi_fwd_tm

    score, last_state, bps = _viterbi_fwd_tm(_dense_tm(trans.permute(1, 2, 0), idx), tvalid, idx)
    return score, last_state, bps.permute(2, 0, 1).to(torch.int8)


def viterbi_traceback(backptr, last_state, nblocks):
    """Walk backpointers [B, T, S] from last_state [B]: path [B, T+1]
    int32 with path[b, nblocks[b]] = last_state[b] and path[b, t] =
    backptr[b, t, path[b, t+1]] for t < nblocks[b]; the tail beyond
    nblocks holds last_state.  scanb: K6; pallas: K11's traceback over
    the time-reversed arrays; scan: its plain version; seg: the
    composition of ops/crf_seg.py (the backpointers are the identity at
    invalid steps, as every producer writes them)."""
    B, T, _ = backptr.shape
    tvalid = _time_valid(nblocks, T, backptr.device)
    impl = _impl()
    if impl == "seg":
        from .crf_seg import seg_traceback

        return seg_traceback(backptr, last_state, nblocks)
    if impl in ("pallas", "scan"):
        traceback_bt = _bt_fns(impl)[2]
        states_rev = traceback_bt(backptr.transpose(0, 1).flip(0), tvalid.flip(0), last_state)
        last = last_state.to(device=backptr.device, dtype=torch.int32)[None]
        return torch.cat([last, states_rev], dim=0).flip(0).T
    from .crf_bm import _traceback_tm

    return _traceback_tm(backptr.permute(1, 2, 0), last_state, tvalid).T


def qpath_from_path(trans, path, nbase: int, idx: TransIndex | None = None):
    """Per-block transition weight along a path (decode.c:188-193):
    qpath[b, t+1] = trans[b, t, param_idx[path[t], path[t+1]]], qpath[b, 0]
    = NaN (reference quirk)."""
    idx = idx if idx is not None else flipflop_index(nbase)
    pidx = index_tables(idx, trans.device).pidx
    path = path.to(device=trans.device, dtype=torch.int64)
    sel = pidx[path[:, :-1], path[:, 1:]]  # [B, T]
    q = torch.gather(trans, 2, sel[..., None])[..., 0]
    nan = torch.full((path.shape[0], 1), float("nan"), dtype=trans.dtype, device=trans.device)
    return torch.cat([nan, q], dim=1)


def crf_viterbi(trans, nblocks, nbase: int, idx: TransIndex | None = None):
    """Full Viterbi decode: (score [B], path [B, T+1] int32, qpath [B, T+1])."""
    if _impl() == "scanb":
        from .crf_bm import decode_bm

        score, path, qpath, _ = decode_bm(trans, nblocks, nbase, viterbi_only=True,
                                          compute_trace=False, idx=idx)
        return score, path, qpath
    score, last_state, backptr = crf_viterbi_forward(trans, nblocks, nbase, idx=idx)
    path = viterbi_traceback(backptr, last_state, nblocks)
    return score, path, qpath_from_path(trans, path, nbase, idx=idx)


def crf_decode_fused(trans, nblocks, nbase: int, viterbi_only: bool, compute_trace: bool,
                     idx: TransIndex | None = None):
    """One-call decode: (score, path [B, T+1] int32, qpath f32, trace u8).

    In fb mode the Viterbi runs over the per-block-normalised transition
    posterior (src/flappie.c:276-300); the trace is built from exp() of
    whichever matrix was decoded.  scanb runs the whole chain batch-minor
    (ops/crf_bm.py ``decode_bm``)."""
    idx = idx if idx is not None else flipflop_index(nbase)
    if _impl() == "scanb":
        from .crf_bm import decode_bm

        return decode_bm(trans, nblocks, nbase, viterbi_only, compute_trace, idx=idx)
    mat = trans if viterbi_only else crf_transpost(trans, nblocks, nbase, idx=idx)
    score, path, qpath = crf_viterbi(mat, nblocks, nbase, idx=idx)
    if compute_trace:
        trace = trace_from_posterior(torch.exp(mat), nbase, idx=idx)
    else:
        trace = torch.zeros(trans.shape[0], 1, idx.nstate, dtype=torch.uint8,
                            device=trans.device)
    return score, path, qpath, trace


def trace_from_posterior(tpost, nbase: int, idx: TransIndex | None = None):
    """exp'd transition posterior [B, T, nparam] -> [B, T+1, nstate]
    uint8 trace: state occupancy x 255, rounded half away from zero, then
    clipped (decode.c:499-543)."""
    idx = idx if idx is not None else flipflop_index(nbase)
    eye = np.eye(idx.nstate, dtype=np.float32)
    from_onehot = torch.as_tensor(eye[idx.from_state], device=tpost.device)
    to_onehot = torch.as_tensor(eye[idx.to_state], device=tpost.device)
    first = tpost[:, 0] @ from_onehot  # occupancy before block 0
    rest = tpost @ to_onehot  # occupancy after each block
    occ = torch.cat([first[:, None], rest], dim=1)
    return torch.clamp(torch.floor(255.0 * occ + 0.5), 0.0, 255.0).to(torch.uint8)


def path_score(trans, path, nblocks, nbase: int, idx: TransIndex | None = None):
    """Total log-weight of a block path [B, T+1]: the sum over valid
    blocks of trans[t, param_idx[path[t], path[t+1]]] (counterpart of
    flappie_tpu/ops/crf.py:513 ``path_score``).  With globally-normalised
    weights it is the path log-probability."""
    idx = idx if idx is not None else flipflop_index(nbase)
    pidx = index_tables(idx, trans.device).pidx
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
