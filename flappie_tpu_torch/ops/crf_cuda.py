"""Batch-major CRF scans: kernels K11 (csrc/crf_bt.cu) and their plain
versions.

Counterparts of flappie_tpu/ops/crf_pallas.py, with its signatures,
layouts and outputs: ``fwd_scan`` (``fwd_scan_pallas:153``),
``viterbi_scan`` (``viterbi_scan_pallas:178``) and ``traceback_bt``
(``traceback_pallas:217``).  Shapes: dense [T, B, S, S] (step, read,
from, to), valid [T, B] bool, states [T, B, S] -- the state AFTER each
block, with no alpha_0 row.  ops/crf.py selects them under
``FLAPPIE_TPU_CRF_IMPL=pallas``.

Each wrapper launches its CUDA kernel for a CUDA tensor and runs the
plain version beside it for a CPU tensor; any other device raises.  The
plain versions repeat the kernels' arithmetic step for step: from-states
in order 0..S-1, lse = max + log(sum(exp(z - max))), invalid steps
blended as v*nxt + (1-v)*a, Viterbi backpointers by lowest tie_rank
among the maxima and identity on invalid steps, written as int8.
``<wrapper>.launches`` counts kernel launches.

All three are compiled for S in (4, 8, 10).  The forward and Viterbi
scans run a chain warp per R = 32 // S reads
(lane = read * S + state), fed by the CTA's producer warp through a ring
in shared memory, a step's R contiguous blocks by 16-byte copies.  ``bt_plan`` in the
source sets their grid; ``_bt_plan`` mirrors it and ``bt_info`` reports
it on the card.

The traceback is csrc/traceback.cuh's time-parallel walk, shared with K6
(ops/crf_bm_cuda.py): its grid is ``_tb_bt_plan``, reported by
``traceback_bt_info``, and ``traceback_bt_segmented_plain`` repeats the
algorithm on the CPU.
"""

from __future__ import annotations

import ctypes

import torch

from . import cuda_build
from .crf_bm_cuda import RANK_BIG, TB_INFO, _check_cuda, _tb_plan, segmented_walk_plain

# -- plain versions ----------------------------------------------------------


def fwd_scan_plain(dense_tm, valid_tm):
    T, B, S, _ = dense_tm.shape
    v = valid_tm.to(dense_tm.dtype)[..., None]  # [T, B, 1]
    a = dense_tm.new_zeros(B, S)
    out = dense_tm.new_empty(T, B, S)
    for t in range(T):
        z = a[:, :, None] + dense_tm[t]  # [B, from, to]
        mx = z[:, 0]
        for f in range(1, S):
            mx = torch.maximum(mx, z[:, f])
        acc = torch.exp(z[:, 0] - mx)
        for f in range(1, S):
            acc = acc + torch.exp(z[:, f] - mx)
        nxt = mx + torch.log(acc)
        a = v[t] * nxt + (1.0 - v[t]) * a
        out[t] = a
    return out


def viterbi_scan_plain(dense_tm, valid_tm, tie_rank):
    T, B, S, _ = dense_tm.shape
    dev = dense_tm.device
    v = valid_tm.to(dense_tm.dtype)[..., None]
    rank = torch.as_tensor(tie_rank, dtype=torch.int64, device=dev)[None]  # [1, f, to]
    ident = torch.arange(S, device=dev)[None, :].expand(B, S)
    big = torch.full((), RANK_BIG, dtype=torch.int64, device=dev)
    a = dense_tm.new_zeros(B, S)
    alphas = dense_tm.new_empty(T, B, S)
    bps = torch.empty(T, B, S, dtype=torch.int8, device=dev)
    for t in range(T):
        z = a[:, :, None] + dense_tm[t]  # [B, from, to]
        best = z.amax(dim=1)
        # argmin returns the first minimum, as the strict < scan over
        # from-states does
        bp = torch.where(z == best[:, None, :], rank, big).argmin(dim=1)
        a = v[t] * best + (1.0 - v[t]) * a
        alphas[t] = a
        bps[t] = torch.where(valid_tm[t][:, None], bp, ident).to(torch.int8)
    return alphas, bps


def traceback_bt_plain(bp_rev_tm, valid_rev_tm, last_state):
    T, B, S = bp_rev_tm.shape
    s = last_state.to(device=bp_rev_tm.device, dtype=torch.int64)
    out = torch.empty(T, B, dtype=torch.int32, device=bp_rev_tm.device)
    for k in range(T):
        prev = bp_rev_tm[k].to(torch.int64).gather(1, s[:, None])[:, 0]
        s = torch.where(valid_rev_tm[k], prev, s)
        out[k] = s
    return out


def _tb_bt_words(S: int) -> int:
    """4-byte words K11's traceback stages a step: they hold a step's R *
    S int8 backpointers at any offset (csrc/crf_bt.cu BtTrace)."""
    return (32 // S * S + 3) // 4 + 1


def _tb_bt_plan(T: int, S: int, B: int):
    """K11's traceback plan: ``_tb_plan`` at its staged words a step."""
    return _tb_plan(T, S, B, _tb_bt_words(S))


def traceback_bt_segmented_plain(bp_rev_tm, valid_rev_tm, last_state, plan=None):
    """K11's traceback's algorithm (csrc/traceback.cuh) on the CPU, at
    ``plan`` (its own by default): bit-equal to ``traceback_bt_plain``.
    The reversed arrays are in walk order already."""
    T, B, S = bp_rev_tm.shape
    if T == 0:
        return torch.empty(0, B, dtype=torch.int32, device=bp_rev_tm.device)
    return segmented_walk_plain(bp_rev_tm.permute(0, 2, 1), valid_rev_tm, last_state,
                                plan or _tb_bt_plan(T, S, B))


# -- kernels -----------------------------------------------------------------


# csrc/crf_bt.cu (with csrc/crf_chain.cuh): steps a ring tile, tiles in a
# warp's ring, chain warps a CTA by S (kBtWarps), and the floats from one
# read's S*S block to the next in the ring by S (a padded stride that keeps
# each block 16-byte aligned and spreads the reads over the banks)
BT_KT, BT_RING, BT_WARPS, BT_STRIDE = 8, 4, {4: 1, 8: 1, 10: 1}, {4: 20, 8: 72, 10: 104}


def _bt_plan(S: int, B: int):
    """(reads a warp, chain warps a CTA, CTAs, shared bytes a CTA, ring
    stride) of K11's forward and Viterbi scans for S states and B reads: a
    mirror of bt_plan in csrc/crf_bt.cu, which launches them and which
    ``bt_info`` reports on the card.  Each chain warp holds R = 32 // S
    reads and a ring of BT_RING tiles of BT_KT steps of their S*S blocks,
    each at BT_STRIDE[S] floats from the last, and their valid flags, with
    a full and an empty mbarrier a tile; one producer warp a CTA fills the
    rings by 16-byte copies."""
    R = 32 // S
    nwarps = -(-B // R)
    W = max(1, min(BT_WARPS[S], nwarps))
    ring = 16 * BT_RING + 4 * BT_RING * BT_KT * (R * BT_STRIDE[S] + R)
    ring = -(-ring // 16) * 16
    return R, W, -(-nwarps // W), W * ring, BT_STRIDE[S]


def bt_info(S: int, B: int) -> dict:
    """The plan the C side launches (``_bt_plan``'s fields by name). Card
    only."""
    lib = _lib()
    info = (ctypes.c_int * 5)()
    cuda_build.check(lib, lib.flappie_crf_bt_info(S, B, info), "bt_info")
    return dict(zip(("R", "W", "ctas", "smem", "stride"), info))


def traceback_bt_info(T: int, S: int, B: int) -> dict:
    """The plan K11's traceback launches (``_tb_bt_plan``'s fields by
    name) and how many of its clusters the card holds at once. Card
    only."""
    lib = _lib()
    info = (ctypes.c_int * 7)()
    cuda_build.check(lib, lib.flappie_crf_bt_traceback_info(T, S, B, info),
                     "traceback_bt_info")
    return dict(zip(TB_INFO, info))


def _lib():
    lib = cuda_build.load("crf_bt")
    with cuda_build.lock:  # a mesh's dispatch threads may type it at once
        if lib.flappie_crf_bt_fwd.argtypes is None:
            P, I = ctypes.c_void_p, ctypes.c_int
            lib.flappie_crf_bt_info.argtypes = [I, I, P]
            lib.flappie_crf_bt_fwd.argtypes = [P, P, P, I, I, I, P]
            lib.flappie_crf_bt_viterbi.argtypes = [P, P, P, P, P, I, I, I, P]
            lib.flappie_crf_bt_traceback.argtypes = [P, P, P, P, I, I, I, P]
            lib.flappie_crf_bt_traceback_info.argtypes = [I, I, I, P]
            for fn in (lib.flappie_crf_bt_info, lib.flappie_crf_bt_fwd, lib.flappie_crf_bt_viterbi,
                       lib.flappie_crf_bt_traceback, lib.flappie_crf_bt_traceback_info):
                fn.restype = ctypes.c_int
    return lib


def _dense_args(name, dense_tm, valid_tm):
    """The kernels' inputs: dense contiguous on a 16-byte boundary (the
    16-byte copies' alignment; a view that starts elsewhere is copied), valid
    as int32."""
    T, B, S, S2 = dense_tm.shape
    _check_cuda(name, dense_tm, S)
    if S2 != S or tuple(valid_tm.shape) != (T, B) or dense_tm.dtype != torch.float32:
        raise ValueError(f"{name}: dense must be float32 [T, B, S, S] with valid [T, B]")
    dense = dense_tm.contiguous()
    if dense.data_ptr() % 16:
        dense = dense.clone()
    return dense, valid_tm.to(device=dense_tm.device, dtype=torch.int32).contiguous(), T, S, B


def fwd_scan(dense_tm, valid_tm):
    """Sum-semiring forward scan: [T, B, S, S], [T, B] -> [T, B, S], the
    state after each block (the caller prepends alpha_0 = 0)."""
    if dense_tm.device.type == "cpu":
        return fwd_scan_plain(dense_tm, valid_tm)
    dense, valid, T, S, B = _dense_args("fwd_scan", dense_tm, valid_tm)
    out = torch.empty(T, B, S, dtype=torch.float32, device=dense.device)
    lib = _lib()
    rc = lib.flappie_crf_bt_fwd(cuda_build.ptr(dense), cuda_build.ptr(valid),
                                cuda_build.ptr(out), T, S, B, cuda_build.stream_of(dense))
    cuda_build.check(lib, rc, "fwd_scan")
    cuda_build.count(fwd_scan)
    return out


fwd_scan.launches = 0


def viterbi_scan(dense_tm, valid_tm, tie_rank):
    """Max-plus forward: (alphas [T, B, S] f32, backptr [T, B, S] int8).
    ``tie_rank`` [S, S] (from, to): the lowest rank among the maxima wins."""
    if dense_tm.device.type == "cpu":
        return viterbi_scan_plain(dense_tm, valid_tm, tie_rank)
    dense, valid, T, S, B = _dense_args("viterbi_scan", dense_tm, valid_tm)
    rank = torch.as_tensor(tie_rank, dtype=torch.int32, device=dense.device).contiguous()
    if tuple(rank.shape) != (S, S):
        raise ValueError(f"viterbi_scan: tie_rank must be [{S}, {S}]")
    alphas = torch.empty(T, B, S, dtype=torch.float32, device=dense.device)
    bps = torch.empty(T, B, S, dtype=torch.int8, device=dense.device)
    lib = _lib()
    rc = lib.flappie_crf_bt_viterbi(cuda_build.ptr(dense), cuda_build.ptr(valid),
                                    cuda_build.ptr(rank), cuda_build.ptr(alphas),
                                    cuda_build.ptr(bps), T, S, B, cuda_build.stream_of(dense))
    cuda_build.check(lib, rc, "viterbi_scan")
    cuda_build.count(viterbi_scan)
    return alphas, bps


viterbi_scan.launches = 0


def traceback_bt(bp_rev_tm, valid_rev_tm, last_state):
    """Walk time-reversed backpointers: bp_rev [T, B, S], valid_rev [T, B],
    last_state [B] -> states [T, B] int32, in reversed order (the state
    BEFORE each block)."""
    if bp_rev_tm.device.type == "cpu":
        return traceback_bt_plain(bp_rev_tm, valid_rev_tm, last_state)
    T, B, S = bp_rev_tm.shape
    _check_cuda("traceback_bt", bp_rev_tm, S)
    if tuple(valid_rev_tm.shape) != (T, B) or tuple(last_state.shape) != (B,):
        raise ValueError("traceback_bt: expected valid_rev [T, B] and last_state [B]")
    bp = bp_rev_tm.to(torch.int8).contiguous()
    if bp.data_ptr() % 4:  # the kernel copies aligned 4-byte words
        bp = bp.clone()
    valid = valid_rev_tm.to(device=bp.device, dtype=torch.int32).contiguous()
    last = last_state.to(device=bp.device, dtype=torch.int32).contiguous()
    out = torch.empty(T, B, dtype=torch.int32, device=bp.device)
    lib = _lib()
    rc = lib.flappie_crf_bt_traceback(cuda_build.ptr(bp), cuda_build.ptr(valid),
                                      cuda_build.ptr(last), cuda_build.ptr(out), T, S, B,
                                      cuda_build.stream_of(bp))
    cuda_build.check(lib, rc, "traceback_bt")
    cuda_build.count(traceback_bt)
    return out


traceback_bt.launches = 0
