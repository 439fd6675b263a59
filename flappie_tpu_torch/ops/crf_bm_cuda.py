"""Batch-minor CRF decode scans: kernels K3/K4, K9, K5, K6
(csrc/crf_scan.cu) and their plain versions.

Counterparts of flappie_tpu/ops/crf_bm_pallas.py: ``fwd_states`` /
``bwd_states`` (``fwd_states_pallas:194`` / ``bwd_states_pallas:218``,
one kernel with a direction flag, as ``_sum_kernel`` is),
``fwdbwd_states`` (``fwdbwd_states_pallas:251``: both chains in one
launch, bit-equal to K3 and K4), ``viterbi_fwd`` (``viterbi_fwd_pallas:300``) and ``traceback``
(``traceback_pallas:333``).  Shapes: dense [T, S, S, B] (from, to,
read), tvalid [T, B] bool, states [T+1, S, B].

Each wrapper launches its CUDA kernel for a CUDA tensor and runs the
plain version beside it for a CPU tensor; any other device raises.  The
plain versions repeat the kernels' arithmetic step for step: lse = max
+ log(sum(exp(z - max))), invalid steps blended as v*nxt + (1-v)*a,
Viterbi backpointers by lowest tie_rank among the maxima and identity on
invalid steps.  ``<wrapper>.launches`` counts kernel launches.

K3/K4, K5 and K6 are compiled for S in (4, 8, 10): the V1 run-length
chain, flip-flop over 4 bases and over 5; K9 for S in (8, 10).  K3/K4,
K9 and K5 run a chain warp per R = 32 // S reads (lane = read * S +
state), fed its reads' slice of the weights through a ring in shared
memory by the CTA's producer warp.  ``scan_plan`` in the source sets
their grid; ``_scan_plan`` mirrors it and ``scan_info`` reports it on
the card.

K6 is csrc/traceback.cuh's time-parallel walk, shared with K11's
traceback (ops/crf_cuda.py): segments of L steps walked from every start
state at once, their maps composed across a cluster, each output the
candidate of the lane that started at its segment's entry state.
``tb_plan`` there sets its grid; ``_tb_plan`` mirrors it,
``traceback_info`` reports it on the card, and
``traceback_segmented_plain`` repeats the algorithm on the CPU (bit-equal
to ``traceback_plain``; nothing on the main path uses it).
"""

from __future__ import annotations

import ctypes

import torch

from . import cuda_build
from .crf import lse

RANK_BIG = 10**6


# -- plain versions ----------------------------------------------------------


def sum_states_plain(dense_tm, tvalid_tm, backward: bool):
    T, S, _, B = dense_tm.shape
    v = tvalid_tm.to(dense_tm.dtype)
    a = dense_tm.new_zeros(S, B)
    out = dense_tm.new_empty(T + 1, S, B)
    if backward:
        out[T] = a
        for t in range(T - 1, -1, -1):
            nxt = lse(dense_tm[t] + a[None, :, :], 1)
            a = v[t] * nxt + (1.0 - v[t]) * a
            out[t] = a
    else:
        out[0] = a
        for t in range(T):
            nxt = lse(a[:, None, :] + dense_tm[t], 0)
            a = v[t] * nxt + (1.0 - v[t]) * a
            out[t + 1] = a
    return out


def fwdbwd_states_plain(dense_tm, tvalid_tm):
    """K9's plain version: the two chains are independent, so it is
    K3's and K4's."""
    return (sum_states_plain(dense_tm, tvalid_tm, False),
            sum_states_plain(dense_tm, tvalid_tm, True))


def viterbi_fwd_plain(dense_tm, tvalid_tm, tie_rank):
    T, S, _, B = dense_tm.shape
    v = tvalid_tm.to(dense_tm.dtype)
    rank = torch.as_tensor(tie_rank, dtype=torch.int64, device=dense_tm.device)[:, :, None]
    ident = torch.arange(S, device=dense_tm.device)[:, None].expand(S, B)
    big = torch.full((), RANK_BIG, dtype=torch.int64, device=dense_tm.device)
    a = dense_tm.new_zeros(S, B)
    bps = torch.empty(T, S, B, dtype=torch.int32, device=dense_tm.device)
    for t in range(T):
        z = a[:, None, :] + dense_tm[t]  # [from, to, B]
        best = z.amax(dim=0)
        bp = torch.where(z == best[None], rank, big).argmin(dim=0)
        a = v[t] * best + (1.0 - v[t]) * a
        bps[t] = torch.where(tvalid_tm[t][None, :], bp, ident)
    return a, bps


def traceback_plain(backptr_tm, tvalid_tm, last_state):
    T, S, B = backptr_tm.shape
    s = last_state.to(torch.int64)
    out = torch.empty(T + 1, B, dtype=torch.int32, device=backptr_tm.device)
    out[T] = s
    for t in range(T - 1, -1, -1):
        prev = backptr_tm[t].to(torch.int64).gather(0, s[None, :])[0]
        s = torch.where(tvalid_tm[t], prev, s)
        out[t] = s
    return out


# csrc/traceback.cuh: segments (warps) a CTA, CTAs a cluster at most, the
# CTAs the grid aims at (two on each of the H100's 132 SMs), bytes of staged
# steps a CTA at most, reads a warp at most (S = 4)
TB_WARPS, TB_CLUSTER, TB_CTAS, TB_BUDGET, TB_MAX_R = 8, 8, 264, 72 * 1024, 8


def _tb_slots(S: int) -> int:
    """Slots for a warp's reads in a staged step's valid flags and the
    entry states (tb_slots in csrc/traceback.cuh): R = 32 // S, at least 4,
    so that S = 8 and 10 keep the layout they had before S = 4."""
    return max(4, 32 // S)


def _tb_words(S: int) -> int:
    """4-byte words K6 stages a step: one backpointer a (read, state)
    (csrc/crf_scan.cu BmTrace)."""
    return 32 // S * S


def _tb_plan(T: int, S: int, B: int, words: int | None = None):
    """(L steps a segment, W warps a CTA, C CTAs a cluster, CTAs, rounds,
    shared bytes a CTA) of a traceback over T steps, S states and B reads
    whose source stages ``words`` 4-byte words a step: a mirror of tb_plan
    in csrc/traceback.cuh, which launches K6 (``_tb_words``: R * S words)
    and K11's traceback (ops/crf_cuda.py ``_tb_bt_plan``) and which
    ``traceback_info`` reports on the card.  A cluster holds one group of
    R = 32 // S reads; its C CTAs of W warps, a segment a warp, cover C *
    W * L steps a round; C is as many as two CTAs an SM over the card
    allow (at most TB_CLUSTER), L as long as TB_BUDGET bytes of staged
    steps a CTA allow, spread evenly over the rounds the walk needs."""
    R = 32 // S
    words = _tb_words(S) if words is None else words
    groups = -(-B // R)
    C = max(1, min(TB_CLUSTER, TB_CTAS // groups)) if groups else 1
    W, slots = TB_WARPS, _tb_slots(S)
    step = 4 * words + 4 * slots + 32
    span = C * W * (TB_BUDGET // (W * step))
    rounds = -(-T // span) if T > 0 else 0
    L = -(-T // (rounds * C * W)) if rounds else 1
    fixed = 2 * 4 * slots + W * 4 * slots + 2 * 32 + TB_CLUSTER * 32 + 2 * W * 32
    return L, W, C, groups * C, rounds, W * L * step + fixed


TB_INFO = ("L", "W", "C", "ctas", "rounds", "smem", "max_active_clusters")


def traceback_info(T: int, S: int, B: int) -> dict:
    """The plan K6 launches (``_tb_plan``'s fields by name) and how many
    of its clusters the card holds at once. Card only."""
    lib = _lib()
    info = (ctypes.c_int * 7)()
    cuda_build.check(lib, lib.flappie_crf_traceback_info(T, S, B, info), "traceback_info")
    return dict(zip(TB_INFO, info))


def segmented_walk_plain(bp_w, valid_w, last_state, plan):
    """csrc/traceback.cuh's algorithm on the CPU, in walk order: bp_w [T,
    S, B] (step k's backpointer of each state), valid_w [T, B], last_state
    [B] -> the state after each step [T, B] int32, bit-equal to the serial
    walk.  ``plan``: a ``_tb_plan`` tuple (L, W, C and rounds are read).

    1. Segment g (steps g*L ...) of every read walked from every start
       state at once: cand[g, l, s0] is where start s0 is after step l,
       and the segment's map where it ends.
    2. For each round and each of its C CTAs of W segments, the prefix
       tables (the segments before each, composed) and the CTA's map; the
       round's entry state through the C CTA maps in order gives each
       CTA's entry, its prefix table each segment's.
    3. Each step's state: the candidate of the start state that is its
       segment's entry."""
    T, S, B = bp_w.shape
    L, W, C, _, rounds, _ = plan
    G = rounds * C * W
    if G * L < T:
        raise ValueError(f"plan {plan} covers {G * L} of {T} steps")
    dev = bp_w.device
    ident = torch.arange(S, device=dev)[:, None].expand(S, B)
    step = torch.where(valid_w.to(torch.bool)[:, None, :], bp_w.to(torch.int64), ident)
    step = torch.cat([step, ident.expand(G * L - T, S, B)]).view(G, L, S, B)
    s = ident.expand(G, S, B)
    cand = torch.empty(G, L, S, B, dtype=torch.int64, device=dev)
    for k in range(L):
        s = step[:, k].gather(1, s)
        cand[:, k] = s
    maps = s.view(rounds, C, W, S, B)
    went = torch.empty(rounds, C, W, B, dtype=torch.int64, device=dev)
    entry = last_state.to(device=dev, dtype=torch.int64)
    for j in range(rounds):
        tab = ident.expand(C, S, B)
        pre = []
        for w in range(W):
            pre.append(tab)
            tab = maps[j, :, w].gather(1, tab)
        for c in range(C):
            for w in range(W):
                went[j, c, w] = pre[w][c].gather(0, entry[None])[0]
            entry = tab[c].gather(0, entry[None])[0]
    out = cand.gather(2, went.view(G, 1, 1, B).expand(G, L, 1, B))[:, :, 0]
    return out.reshape(G * L, B)[:T].to(torch.int32)


def traceback_segmented_plain(backptr_tm, tvalid_tm, last_state, plan=None):
    """K6's algorithm (csrc/traceback.cuh) on the CPU, at ``plan`` (a
    ``_tb_plan`` tuple; K6's own by default): path [T+1, B] int32,
    bit-equal to ``traceback_plain``.  Walk step k is time T-1-k."""
    T, S, B = backptr_tm.shape
    plan = plan or _tb_plan(T, S, B)
    out = torch.empty(T + 1, B, dtype=torch.int32, device=backptr_tm.device)
    out[T] = last_state.to(torch.int32)
    if T:
        out[:T] = segmented_walk_plain(backptr_tm.flip(0), tvalid_tm.flip(0), last_state,
                                       plan).flip(0)
    return out


# -- kernels -----------------------------------------------------------------


# csrc/crf_scan.cu: steps a ring tile, tiles in a warp's ring, and chain
# warps a CTA by S (kWarps: the fastest of 1, 2 and 4 on the H100)
SCAN_KT, SCAN_RING, SCAN_WARPS = 8, 4, {4: 1, 8: 1, 10: 2}
# the state counts each kernel is compiled for: K3/K4, K5 and K6; K9
SCAN_STATES, FWDBWD_STATES = (4, 8, 10), (8, 10)


def _scan_plan(S: int, B: int):
    """(reads a warp, chain warps a CTA, CTAs, shared bytes a CTA) of the
    chain kernels (K3/K4, K5; K9 launches two rows of CTAs) for S states
    and B reads: a mirror of scan_plan in csrc/crf_scan.cu, which launches
    them and which ``scan_info`` reports on the card.  Each chain warp
    holds R = 32 // S reads and a ring of SCAN_RING tiles of SCAN_KT steps
    of their [S, S, R] slices and valid flags, with a full and an empty
    mbarrier a tile, and two tiles of [S, R] outputs staged for writing
    out; one producer warp a CTA fills the rings."""
    R = 32 // S
    nwarps = -(-B // R)
    W = max(1, min(SCAN_WARPS[S], nwarps))
    ring = 16 * SCAN_RING + 4 * (SCAN_RING * SCAN_KT * (S * S * R + R) + 2 * SCAN_KT * S * R)
    return R, W, -(-nwarps // W), W * ring


def scan_info(S: int, B: int) -> dict:
    """The plan the C side launches (``_scan_plan``'s fields by name).
    Card only."""
    lib = _lib()
    info = (ctypes.c_int * 4)()
    cuda_build.check(lib, lib.flappie_crf_scan_info(S, B, info), "scan_info")
    return dict(zip(("R", "W", "ctas", "smem"), info))


def _lib():
    lib = cuda_build.load("crf_scan")
    with cuda_build.lock:  # a mesh's dispatch threads may type it at once
        if lib.flappie_crf_sum.argtypes is None:
            P, I = ctypes.c_void_p, ctypes.c_int
            lib.flappie_crf_scan_info.argtypes = [I, I, P]
            lib.flappie_crf_sum.argtypes = [P, P, P, I, I, I, I, P]
            lib.flappie_crf_fwdbwd.argtypes = [P, P, P, P, I, I, I, P]
            lib.flappie_crf_viterbi.argtypes = [P, P, P, P, P, I, I, I, P]
            lib.flappie_crf_traceback.argtypes = [P, P, P, P, I, I, I, P]
            lib.flappie_crf_traceback_info.argtypes = [I, I, I, P]
            for fn in (lib.flappie_crf_scan_info, lib.flappie_crf_sum, lib.flappie_crf_fwdbwd,
                       lib.flappie_crf_viterbi, lib.flappie_crf_traceback,
                       lib.flappie_crf_traceback_info):
                fn.restype = ctypes.c_int
    return lib


def _check_cuda(name, t, S=None, states=SCAN_STATES):
    if t.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {t.device}")
    if S is not None and S not in states:
        raise ValueError(f"{name}: the kernel is compiled for S in {states}, got {S}")


def _dense_args(name, dense_tm, tvalid_tm, states=SCAN_STATES):
    T, S, S2, B = dense_tm.shape
    _check_cuda(name, dense_tm, S, states)
    if S2 != S or tuple(tvalid_tm.shape) != (T, B) or dense_tm.dtype != torch.float32:
        raise ValueError(f"{name}: dense must be float32 [T, S, S, B] with tvalid [T, B]")
    return (dense_tm.contiguous(), tvalid_tm.to(device=dense_tm.device, dtype=torch.int32).contiguous(),
            T, S, B)


def sum_states(dense_tm, tvalid_tm, backward: bool = False):
    """Sum-semiring scan: alphas (forward) or betas (backward), [T+1, S, B]."""
    if dense_tm.device.type == "cpu":
        return sum_states_plain(dense_tm, tvalid_tm, backward)
    dense, valid, T, S, B = _dense_args("sum_states", dense_tm, tvalid_tm)
    out = torch.empty(T + 1, S, B, dtype=torch.float32, device=dense.device)
    lib = _lib()
    rc = lib.flappie_crf_sum(cuda_build.ptr(dense), cuda_build.ptr(valid),
                             cuda_build.ptr(out), T, S, B, int(backward),
                             cuda_build.stream_of(dense))
    cuda_build.check(lib, rc, "sum_states")
    cuda_build.count(sum_states)
    return out


sum_states.launches = 0


def fwd_states(dense_tm, tvalid_tm):
    """alphas [T+1, S, B]: alpha_0 = 0, alpha_{t+1}[to] =
    lse_from(alpha_t + m_t), frozen at invalid t (K3)."""
    return sum_states(dense_tm, tvalid_tm, backward=False)


def bwd_states(dense_tm, tvalid_tm):
    """betas [T+1, S, B]: beta_T = 0, beta_t[from] =
    lse_to(m_t + beta_{t+1}), frozen at invalid t (K4)."""
    return sum_states(dense_tm, tvalid_tm, backward=True)


def fwdbwd_states(dense_tm, tvalid_tm):
    """(alphas, betas), each [T+1, S, B]: K3's and K4's chains in one
    launch (K9), bit-equal to ``fwd_states`` and ``bwd_states``."""
    if dense_tm.device.type == "cpu":
        return fwdbwd_states_plain(dense_tm, tvalid_tm)
    dense, valid, T, S, B = _dense_args("fwdbwd_states", dense_tm, tvalid_tm, FWDBWD_STATES)
    alphas = torch.empty(T + 1, S, B, dtype=torch.float32, device=dense.device)
    betas = torch.empty_like(alphas)
    lib = _lib()
    rc = lib.flappie_crf_fwdbwd(cuda_build.ptr(dense), cuda_build.ptr(valid),
                                cuda_build.ptr(alphas), cuda_build.ptr(betas), T, S, B,
                                cuda_build.stream_of(dense))
    cuda_build.check(lib, rc, "fwdbwd_states")
    cuda_build.count(fwdbwd_states)
    return alphas, betas


fwdbwd_states.launches = 0


def viterbi_fwd(dense_tm, tvalid_tm, tie_rank):
    """Max-plus forward (K5): (alpha_final [S, B], backptr [T, S, B] int32)."""
    if dense_tm.device.type == "cpu":
        return viterbi_fwd_plain(dense_tm, tvalid_tm, tie_rank)
    dense, valid, T, S, B = _dense_args("viterbi_fwd", dense_tm, tvalid_tm)
    rank = torch.as_tensor(tie_rank, dtype=torch.int32).to(dense.device).contiguous()
    if tuple(rank.shape) != (S, S):
        raise ValueError(f"viterbi_fwd: tie_rank must be [{S}, {S}]")
    alpha = torch.empty(S, B, dtype=torch.float32, device=dense.device)
    bps = torch.empty(T, S, B, dtype=torch.int32, device=dense.device)
    lib = _lib()
    rc = lib.flappie_crf_viterbi(cuda_build.ptr(dense), cuda_build.ptr(valid),
                                 cuda_build.ptr(rank), cuda_build.ptr(alpha),
                                 cuda_build.ptr(bps), T, S, B,
                                 cuda_build.stream_of(dense))
    cuda_build.check(lib, rc, "viterbi_fwd")
    cuda_build.count(viterbi_fwd)
    return alpha, bps


viterbi_fwd.launches = 0


def traceback(backptr_tm, tvalid_tm, last_state):
    """[T, S, B] backptr, [T, B] valid, [B] last -> path [T+1, B] int32 (K6,
    at ``_tb_plan(T, S, B)``)."""
    if backptr_tm.device.type == "cpu":
        return traceback_plain(backptr_tm, tvalid_tm, last_state)
    T, S, B = backptr_tm.shape
    _check_cuda("traceback", backptr_tm, S)
    if tuple(tvalid_tm.shape) != (T, B) or tuple(last_state.shape) != (B,):
        raise ValueError("traceback: expected tvalid [T, B] and last_state [B]")
    bp = backptr_tm.to(torch.int32).contiguous()
    valid = tvalid_tm.to(device=bp.device, dtype=torch.int32).contiguous()
    last = last_state.to(device=bp.device, dtype=torch.int32).contiguous()
    out = torch.empty(T + 1, B, dtype=torch.int32, device=bp.device)
    lib = _lib()
    rc = lib.flappie_crf_traceback(cuda_build.ptr(bp), cuda_build.ptr(valid),
                                   cuda_build.ptr(last), cuda_build.ptr(out),
                                   T, S, B, cuda_build.stream_of(bp))
    cuda_build.check(lib, rc, "traceback")
    cuda_build.count(traceback)
    return out


traceback.launches = 0
