"""Fused recurrent layers: kernels K1 (LSTM, csrc/lstm.cu), K8 (its
training forward, which also returns the cell state) and K7 (GRU-mod,
csrc/grumod.cu), their bf16-stream, precision-``default`` and rnn-``high``
variants, and their plain versions; and K12, the recurrences alone over a caller's
affine (``lstm_seq_cuda``, ``grumod_seq_cuda``).

Counterparts of flappie_tpu/ops/rnn_pallas.py:563 ``lstm_layer_tm``
(``_lstm_fused_kernel``), :584 ``lstm_layer_tm_train``
(``_lstm_fused_train_kernel``) and :578 ``grumod_layer_tm``
(``_grumod_fused_kernel``): time-major in and out, the block input
affine computed by the kernel itself, backward layers walking time in
reverse, and steps at or past a read's length freezing the carried state
and writing zeros.

K12 is the counterpart of flappie_tpu/ops/rnn_pallas.py:144
``lstm_seq_pallas`` and :149 ``grumod_seq_pallas`` (``_lstm_kernel``,
``_grumod_kernel``): drop-ins for ops/rnn.py ``lstm_seq`` /
``grumod_seq``, batch-major [B, T, G*H] -> [B, T, H], forward, zero
initial state, no length mask, inference only.  They launch the same
recurrence kernel as K1/K7, which reads and writes the batch-major
tensors in place (a template flag on its row offsets), every row
running all T steps.

Every f32-step recurrence runs csrc/cluster_rnn.cuh: clusters of 8 CTAs,
each holding an eighth of sW in shared memory, R rows a cluster
(``_cluster_plan``); H must be a multiple of 16 and at most 256.

The bf16 stream (``--fast``; ops/precision.py): an ``x_tm`` in bf16
selects K1-bf16 / K7-bf16 / K8-bf16 (``lstm_layer_tm_bf16``,
``grumod_layer_tm_bf16``, ``lstm_layer_tm_train_bf16``), the counterpart
of rnn_pallas.py's fused kernels under FLAPPIE_TPU_RNN_STREAM=bf16
(:515-519): x and iW in bf16, the block affine as a bf16 product with
f32 accumulation plus the f32 bias, rounded to a bf16 xa (``affine_bf16``,
a tensor-core kernel in csrc/affine.cuh); the steps in f32 on xa widened
to f32, the state and the step product f32; only the stored outputs (h,
and K8's c) rounded to bf16, which the next layer takes as it is.  K12
keeps f32 and raises on bf16: the JAX package's layer-by-layer stack
ignores the stream.

Precision ``default`` (ops/precision.py: ``"bf16"`` on a CUDA device).
At FLAPPIE_TPU_RNN_PRECISION=default a layer runs the cluster recurrence
with the one-pass step product on the tensor cores (sW in bf16, h rounded
to bf16 for the product, f32 sums; csrc/lstm_p1.cu and csrc/grumod_p1.cu,
both csrc/cluster_rnn_mma.cuh), under either stream: ``lstm_layer_tm_p1``,
``lstm_layer_tm_train_p1``, ``grumod_layer_tm_p1``, counted under the bf16
stream on
``lstm_layer_tm_bf16_p1``, ``lstm_layer_tm_train_bf16_p1`` and
``grumod_layer_tm_bf16_p1``.  At FLAPPIE_TPU_MATMUL_PRECISION=default on
the f32 stream the block affine is the one-pass affine with an f32 output
(``affine_bf16_f32``: x and iW rounded to bf16 first), before the f32
recurrence or the one-pass one; under the bf16 stream the affine is already
one pass (rnn_pallas.py:517).  The dispatchers ``lstm_layer_tm``,
``lstm_layer_tm_train`` and ``grumod_layer_tm`` pick the kernel from x's
dtype and the levels resolved for x's device; on the CPU every level is
true f32 (JAX's CPU bytes).  The plain versions take the levels as
arguments (``rdot``, ``ff``) and round where the kernels round.  Every
layer is one call of a fused C entry (csrc/layer.cuh: the block affine,
then the recurrence, on one stream); those that only ``default`` reaches
are in the _p1 sources.

Rnn precision ``high`` on the card (ops/precision.py: ``"bf16x3"``).  At
an explicit FLAPPIE_TPU_RNN_PRECISION=high a layer runs the cluster
recurrence with the three-pass step product on the tensor cores (h and sW
split into bf16 high parts and remainders, h_hi.sW_hi + h_hi.sW_lo +
h_lo.sW_hi with f32 sums; csrc/lstm_h3.cu and csrc/grumod_h3.cu, both
csrc/cluster_rnn_mma.cuh at three passes), under either stream and after
any of the three block affines: ``lstm_layer_tm_h3``,
``lstm_layer_tm_train_h3``, ``grumod_layer_tm_h3``, counted under the bf16
stream on ``lstm_layer_tm_bf16_h3``, ``lstm_layer_tm_train_bf16_h3`` and
``grumod_layer_tm_bf16_h3``.  The plain versions take it as ``rdot``.

Both block affines live in csrc/affine.cuh and run alone through
``affine_f32`` (a pipelined CUDA-core SGEMM, true f32) and
``affine_bf16`` (wgmma on TMA tiles where K and N are multiples of 8 and
K <= 256, every model shape; a wmma kernel elsewhere; ``affine_bf16_f32``
the same kernels with an f32 output); ``_affine_plan`` mirrors the C
side's choice of path and grid.

Each wrapper launches its CUDA kernel for a CUDA tensor and runs the
plain version for a CPU tensor; any other device raises.
``<wrapper>.launches`` counts kernel launches; a layer launches its affine
too, which its wrapper counts on ``affine_f32``, ``affine_bf16_f32``, or
``affine_bf16`` (the wgmma path) or ``affine_bf16_wmma`` (the wmma path).
"""

from __future__ import annotations

import ctypes
import types

import torch

from . import cuda_build, precision
from .precision import F32, ONE_PASS, THREE_PASS, one_pass, split_bf16
from .rnn import grumod_seq, grumod_step, lstm_seq, lstm_step, rows_matmul

BF16 = torch.bfloat16


def affine_f32_plain(x, iW, b):
    """x . iW + b in f32: x [..., K], iW [K, N], b [N] -> [..., N]."""
    return rows_matmul(x, iW) + b


def affine_bf16_plain(x, iW, b):
    """bf16(x . iW + b): x [..., K] and iW [K, N] rounded to bf16, the
    product and the bias in f32, one round to bf16 -> [..., N] bf16."""
    return (rows_matmul(x.to(BF16).float(), iW.to(BF16).float()) + b).to(BF16)


def affine_bf16_f32_plain(x, iW, b):
    """x . iW + b with x and iW rounded to bf16, the exact products and
    the bias summed in f32 -> [..., N] f32 (the one-pass affine)."""
    return rows_matmul(one_pass(x), one_pass(iW)) + b


def _xa_plain(x_tm, iW, b, ff):
    """(the block affine [T, B, G], the dtype of the steps): under the
    bf16 stream the bf16 xa (affine_bf16_plain) widened to f32 and f32
    steps; on the f32 stream the f32 affine, or at ``ff`` one pass
    ``affine_bf16_f32_plain``."""
    if x_tm.dtype == BF16:
        return affine_bf16_plain(x_tm, iW, b).float(), torch.float32
    if ff == ONE_PASS:
        return affine_bf16_f32_plain(x_tm, iW, b), x_tm.dtype
    return rows_matmul(x_tm, iW) + b, x_tm.dtype


def _step_dot(sW, rdot):
    """(sW as the step reads it, the step product h . sW): at ``rdot``
    one pass, sW rounded to bf16 once and h at every step (the carried h
    stays f32), the exact products summed in f32; three passes, sW split
    once into bf16 hi and lo (``split_bf16``) and h at every step,
    (h_hi.sW_hi + h_hi.sW_lo) + h_lo.sW_hi, each product in f32 (JAX's
    ``_dot_bf16x3`` and its order)."""
    if rdot == ONE_PASS:
        return one_pass(sW), lambda h, w: rows_matmul(one_pass(h), w)
    if rdot == THREE_PASS:
        hi, lo = split_bf16(sW)

        def dot3(h, w):
            h_hi, h_lo = split_bf16(h)
            return (rows_matmul(h_hi, w) + rows_matmul(h_hi, lo)) + rows_matmul(h_lo, w)

        return hi, dot3
    return sW, rows_matmul


def _check_levels(rdot, ff):
    for name, v, ok in (("rdot", rdot, (F32, ONE_PASS, THREE_PASS)), ("ff", ff, (F32, ONE_PASS))):
        if v not in ok:
            raise ValueError(f"{name} must be one of {ok}, got {v!r}")


def _lstm_plain(x_tm, iW, b, sW, backward, lengths, want_c: bool, rdot=F32, ff=F32):
    _check_levels(rdot, ff)
    T, B, _ = x_tm.shape
    H = sW.shape[0]
    if lengths is None:
        lengths = torch.full((B,), T, dtype=torch.int32, device=x_tm.device)
    xa, dt = _xa_plain(x_tm, iW, b, ff)  # [T, B, 4H]
    sW, dot = _step_dot(sW, rdot)
    h = x_tm.new_zeros(B, H, dtype=dt)
    c = x_tm.new_zeros(B, H, dtype=dt)
    out = x_tm.new_empty(T, B, H, dtype=dt)
    cout = x_tm.new_empty(T, B, H, dtype=dt) if want_c else None
    for t in (range(T - 1, -1, -1) if backward else range(T)):
        h2, c2 = lstm_step(xa[t], h, c, sW, dot)
        valid = (t < lengths)[:, None]
        out[t] = torch.where(valid, h2, torch.zeros_like(h2))
        if want_c:
            cout[t] = torch.where(valid, c2, torch.zeros_like(c2))
        h = torch.where(valid, h2, h)
        c = torch.where(valid, c2, c)
    if want_c:
        return out.to(x_tm.dtype), cout.to(x_tm.dtype)
    return out.to(x_tm.dtype)


def lstm_layer_tm_plain(x_tm, iW, b, sW, backward: bool = False, lengths=None, rdot=F32,
                        ff=F32):
    """x_tm [T, B, IN] -> [T, B, H] with plain tensor ops (same math); an
    x_tm in bf16 runs the bf16 stream and returns bf16.  ``rdot`` and
    ``ff``: the step product's and the f32 stream's affine's level,
    ``"highest"`` (true f32) or ``"bf16"`` (one pass), and for ``rdot``
    also ``"bf16x3"`` (three passes)."""
    return _lstm_plain(x_tm, iW, b, sW, backward, lengths, False, rdot, ff)


def lstm_layer_tm_train_plain(x_tm, iW, b, sW, backward: bool = False, lengths=None,
                              rdot=F32, ff=F32):
    """x_tm [T, B, IN] -> (h [T, B, H], c [T, B, H]) with plain tensor
    ops (same math); both are 0 at invalid steps and in x_tm's dtype
    (the bf16 stream rounds both)."""
    return _lstm_plain(x_tm, iW, b, sW, backward, lengths, True, rdot, ff)


def grumod_layer_tm_plain(x_tm, iW, b, sW, backward: bool = False, lengths=None, rdot=F32,
                          ff=F32):
    """x_tm [T, B, IN] -> [T, B, H] with plain tensor ops (same math); an
    x_tm in bf16 runs the bf16 stream and returns bf16; ``rdot``, ``ff``
    as for ``lstm_layer_tm_plain``."""
    _check_levels(rdot, ff)
    T, B, _ = x_tm.shape
    H = sW.shape[0]
    if lengths is None:
        lengths = torch.full((B,), T, dtype=torch.int32, device=x_tm.device)
    xa, dt = _xa_plain(x_tm, iW, b, ff)  # [T, B, 3H]
    sW, dot = _step_dot(sW, rdot)
    h = x_tm.new_zeros(B, H, dtype=dt)
    out = x_tm.new_empty(T, B, H, dtype=dt)
    for t in (range(T - 1, -1, -1) if backward else range(T)):
        h2 = grumod_step(xa[t], h, sW, dot)
        valid = (t < lengths)[:, None]
        out[t] = torch.where(valid, h2, torch.zeros_like(h2))
        h = torch.where(valid, h2, h)
    return out.to(x_tm.dtype)


# csrc/cluster_rnn.cuh: CTAs a cluster, k slices a gate column, the
# clusters of 8 the H100 holds at once, the rows a cluster it instantiates,
# the largest H
CLUSTER, KSPLIT, MAX_CLUSTERS, MAX_H = 8, 4, 15, 256
ROWS = (1, 2, 4, 8, 12, 16, 20)


# csrc/cluster_rnn_mma.cuh (the one-pass step on the tensor cores): hidden
# units a warp, the rows of an n-tile and of an m-tile, the k of a k-tile,
# the m-tiles a warp, the most clusters its rows rule lets a batch take
# (one CTA an SM for 128 SMs)
MMA_UNITS, MMA_N, MMA_M, MMA_K, MMA_M_TILES, MMA_MAX_CLUSTERS = 8, 8, 16, 16, 2, 16


def _rows(B: int, most: int) -> int:
    """The fewest rows of ``ROWS`` that keep a batch of B within ``most``
    clusters, else the most (rows_within in csrc/cluster_rnn.cuh)."""
    return next((r for r in ROWS if -(-B // r) <= most), ROWS[-1])


def _mma_plan(H: int, R: int, gates: int = 4, passes: int = 1) -> dict:
    """The tensor-core step's layout at H, R rows a cluster, ``gates`` and
    ``passes`` (1 or 3; mma_warps, mma_rows, mma_lo_lines,
    cluster_mma_smem in csrc/cluster_rnn_mma.cuh): warps a CTA (MMA_UNITS
    units each, the last padded), the exchanged h's chunks of 8 units (K
    padded to 8 of them), its k-tiles, the rows padded to n-tiles, the
    shared bytes (h by step parity, 16 bytes a chunk and row, two parts
    hi and lo at three passes; then at three passes sW_lo's A fragments,
    ``lo_lines`` 16-byte lines a warp and k-tile: 32 an m-tile, 16 for
    GRU-mod's m-tile 1, whose zero rows are not stored) and the A words a
    thread holds in registers that are not the constant 0 (sW_hi: 2 a
    k-tile for each gate of its 8 units: 4 a k-tile for each of its 2
    m-tiles at 4 gates; GRU-mod's zero rows, ``_mma_gate_rows``, hold
    none)."""
    warps = -(-(H // CLUSTER) // MMA_UNITS)
    chunks = CLUSTER * warps
    n_tiles = -(-R // MMA_N)
    k_tiles = chunks * MMA_UNITS // MMA_K
    parts = 2 if passes == 3 else 1
    lo_lines = 32 + (32 if gates == 4 else 16)
    smem = 2 * parts * chunks * MMA_N * n_tiles * 16
    if passes == 3:
        smem += warps * k_tiles * lo_lines * 16
    return dict(warps=warps, chunks=chunks, k_tiles=k_tiles, n_tiles=n_tiles,
                rows=MMA_N * n_tiles, smem=smem, a_registers=2 * gates * k_tiles)


def _mma_gate_rows(gates: int) -> list:
    """The tensor-core step's A rows (the gate-to-row map of
    cluster_rnn_mma_kernel): [m-tile][row] -> (gate, unit slot of the
    warp's 8), or None for a zero row.  Row m of m-tile mt is gate
    2 mt + m // 8 of unit slot m % 8, so the accumulator rows of lane group
    g (rows g and g + 8 of each m-tile) hold every gate of unit slot g;
    GRU-mod's gate 3 (m-tile 1, rows 8-15) is zero."""
    return [[(gate, m % MMA_UNITS) if (gate := 2 * mt + m // MMA_UNITS) < gates else None
             for m in range(MMA_M)] for mt in range(MMA_M_TILES)]


def _cluster_plan(B: int, H: int, gates: int, passes: int = 0):
    """(R, clusters, shared bytes a CTA) of the cluster recurrence for a
    batch of B rows: the fewest rows R of ``ROWS`` that let every cluster
    run at once (at most 15), else the most (cluster_rows in
    csrc/cluster_rnn.cuh); ``passes`` 1 or 3 (the one-pass or three-pass
    step product, the tensor-core step of either cell): the same rule at
    16 clusters (mma_cluster_rows), the shared bytes ``_mma_plan``'s.
    Raises ValueError for an H the kernel does not take."""
    if H <= 0 or H % 16 or H > MAX_H:
        raise ValueError(f"the cluster recurrence needs H % 16 == 0 and H <= {MAX_H} (an "
                         f"eighth of sW must fit one SM's shared memory), got H={H}")
    if passes:
        R = _rows(B, MMA_MAX_CLUSTERS)
        return R, -(-B // R), _mma_plan(H, R, gates, passes)["smem"]
    R = _rows(B, MAX_CLUSTERS)
    cols = gates * H // CLUSTER
    smem = 4 * (H * cols + 2 * H * R + KSPLIT * R * cols)
    return R, -(-B // R), smem


# variant of each kernel in its source's <source>_cluster_info entry; the
# _p1 sources hold the one-pass step product, the _h3 sources the
# three-pass one
_INFO = {"lstm_layer": ("lstm", 0), "lstm_layer_train": ("lstm", 1), "lstm_seq": ("lstm", 2),
         "lstm_layer_bf16": ("lstm", 3), "lstm_layer_train_bf16": ("lstm", 4),
         "grumod_layer": ("grumod", 0), "grumod_seq": ("grumod", 2),
         "grumod_layer_bf16": ("grumod", 3),
         "lstm_layer_p1": ("lstm_p1", 0), "lstm_layer_train_p1": ("lstm_p1", 1),
         "lstm_layer_bf16_p1": ("lstm_p1", 3), "lstm_layer_train_bf16_p1": ("lstm_p1", 4),
         "grumod_layer_p1": ("grumod_p1", 0), "grumod_layer_bf16_p1": ("grumod_p1", 3),
         "lstm_layer_h3": ("lstm_h3", 0), "lstm_layer_train_h3": ("lstm_h3", 1),
         "lstm_layer_bf16_h3": ("lstm_h3", 3), "lstm_layer_train_bf16_h3": ("lstm_h3", 4),
         "grumod_layer_h3": ("grumod_h3", 0), "grumod_layer_bf16_h3": ("grumod_h3", 3)}


def info_plan(kind: str, B: int, H: int = 256):
    """``_cluster_plan`` of ``kind`` (a key of ``_INFO``) at batch B."""
    source = _INFO[kind][0]
    passes = 1 if source.endswith("_p1") else 3 if source.endswith("_h3") else 0
    return _cluster_plan(B, H, 4 if source.startswith("lstm") else 3, passes)


def cluster_info(kind: str, B: int, H: int = 256) -> dict:
    """The plan the C side launches for ``kind`` (a key of ``_INFO``) at
    batch B, with cudaOccupancyMaxActiveClusters for that instantiation:
    {"R", "clusters", "smem", "max_active_clusters"}.  Card only."""
    source, variant = _INFO[kind]
    lib = cuda_build.load(source)
    fn = getattr(lib, f"flappie_{source}_cluster_info")
    info = (ctypes.c_int * 4)()
    cuda_build.check(lib, fn(B, H, variant, info), f"cluster_info({kind})")
    return dict(zip(("R", "clusters", "smem", "max_active_clusters"), info))


# csrc/affine.cuh: (tile rows, tile columns, k step, stages) of the f32
# SGEMM, the bf16 wmma kernel and the bf16 wgmma kernel; the largest K whose
# slice of W the wgmma kernel keeps resident; the H100's SMs
AFFINE_F32, AFFINE_WMMA, AFFINE_WGMMA = (128, 128, 16, 3), (128, 128, 32, 2), (128, 256, 64, 4)
WGMMA_KMAX, H100_SMS = 256, 132
PATH_F32, PATH_WMMA, PATH_WGMMA = 0, 1, 2


def _affine_smem(path: int) -> int:
    """Shared bytes a CTA of each affine path (affine.cuh's F_SMEM, H_SMEM,
    G_SMEM): the f32 ring of A (rows padded by 4 floats) and W tiles; the
    wmma kernel's two buffers (rows padded by 8 bf16) and 8 warps' 16x16
    f32 scratch; the wgmma kernel's resident W (4 slabs of WGMMA_KMAX rows
    x 128 bytes), two warpgroups' A rings of 64-row slots, 2 x 2 staged
    64 x 64 output boxes, the bias, the rings' full and empty mbarriers
    and W's, and 1024 bytes to align the base."""
    if path == PATH_F32:
        bm, bn, bk, stages = AFFINE_F32
        return stages * (bm * (bk + 4) + bk * bn) * 4
    if path == PATH_WMMA:
        bm, bn, bk, _ = AFFINE_WMMA
        return (2 * bm * (bk + 8) + 2 * bk * (bn + 8)) * 2 + 8 * 16 * 16 * 4
    bm, bn, bk, stages = AFFINE_WGMMA
    return (4 * WGMMA_KMAX * 128 + stages * bm * bk * 2 + 4 * 64 * 64 * 2 + bn * 4
            + (4 * stages + 1) * 8 + 1024)


def _affine_plan(M: int, N: int, K: int, bf16: bool, sms: int = H100_SMS) -> tuple:
    """(path, tile rows, tile columns, k step, stages, shared bytes, CTAs,
    output tiles) of the affine [M, K] x [K, N] (affine_plan in
    csrc/affine.cuh).  f32: one CTA a 128x128 tile.  bf16: the wgmma path
    where K % 8 == 0, N % 8 == 0 and 0 < K <= WGMMA_KMAX (TMA's 16-byte
    strides, W's resident slice), a persistent grid of ``groups`` CTAs for
    each of the nN column tiles (at most one an SM, at most the M
    blocks); the wmma path elsewhere, one CTA a 128x128 tile."""
    def grid(bm, bn):
        return -(-M // bm) * -(-N // bn)

    if not bf16:
        t = grid(*AFFINE_F32[:2])
        return (PATH_F32, *AFFINE_F32, _affine_smem(PATH_F32), t, t)
    if not (M > 0 and N > 0 and 0 < K <= WGMMA_KMAX and K % 8 == 0 and N % 8 == 0):
        t = grid(*AFFINE_WMMA[:2])
        return (PATH_WMMA, *AFFINE_WMMA, _affine_smem(PATH_WMMA), t, t)
    bm, bn = AFFINE_WGMMA[:2]
    mblocks, nN = -(-M // bm), -(-N // bn)
    groups = min(max(sms // nN, 1), mblocks)
    return (PATH_WGMMA, *AFFINE_WGMMA, _affine_smem(PATH_WGMMA), groups * nN, mblocks * nN)


def affine_info(M: int, N: int, K: int, bf16: bool) -> tuple:
    """The plan the C side launches (flappie_affine_info in csrc/lstm.cu),
    as ``_affine_plan`` orders it, for this card's SMs.  Card only."""
    lib = cuda_build.load("lstm")
    fn = lib.flappie_affine_info
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_long, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    info = (ctypes.c_int * 8)()
    cuda_build.check(lib, fn(M, N, K, int(bf16), info), "affine_info")
    return tuple(info)


def _aligned(t):
    """t, or a copy of it that starts on a 16-byte boundary (the kernels
    copy 16 bytes at a time and TMA needs it); torch's own allocations
    are aligned, so only a view at an offset is copied."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _entry(source: str, name: str, argtypes: list):
    """(library, C entry ``name`` of csrc/<source>.cu typed once)."""
    lib = cuda_build.load(source)
    with cuda_build.lock:
        fn = getattr(lib, name)
        if fn.argtypes is None:
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
    return lib, fn


_P, _I = ctypes.c_void_p, ctypes.c_int


def _layer_args(what, gates, x_tm, iW, b, sW, lengths):
    """Checks shared by the fused-layer wrappers: (x_tm, iW, b, sW,
    lengths) contiguous on x's device, lengths [B] int32 (default all T).
    The stream is x's dtype: float32, or bfloat16, where iW may arrive in
    f32 and is cast (plain torch, as the JAX package casts it outside its
    kernel); b and sW are float32 either way."""
    T, B, IN = x_tm.shape
    H = sW.shape[0]
    G = gates * H
    if tuple(iW.shape) != (IN, G) or tuple(b.shape) != (G,) or tuple(sW.shape) != (H, G):
        raise ValueError(f"{what}: bad weight shapes {tuple(iW.shape)}, "
                         f"{tuple(b.shape)}, {tuple(sW.shape)} for IN={IN}, H={H}")
    _cluster_plan(B, H, gates)
    xdt = x_tm.dtype
    if xdt not in (torch.float32, BF16):
        raise ValueError(f"{what}: x must be float32 or bfloat16, got {xdt}")
    if xdt == BF16 and iW.dtype == torch.float32:
        iW = iW.to(xdt)
    for name, t, dt in (("x", x_tm, xdt), ("iW", iW, xdt), ("b", b, torch.float32),
                        ("sW", sW, torch.float32)):
        if t.dtype != dt or t.device != x_tm.device:
            raise ValueError(f"{what}: {name} must be {dt} on {x_tm.device}")
    if lengths is None:
        lengths = torch.full((B,), T, dtype=torch.int32, device=x_tm.device)
    x_tm, iW, b, sW = (_aligned(t.contiguous()) for t in (x_tm, iW, b, sW))
    lengths = lengths.to(device=x_tm.device, dtype=torch.int32).contiguous()
    if tuple(lengths.shape) != (B,):
        raise ValueError(f"{what}: lengths must be [{B}]")
    return x_tm, iW, b, sW, lengths


# csrc/layer.cuh's BlockAffine: the block affine a fused layer runs
BLOCK_F32, BLOCK_ONE_PASS, BLOCK_BF16 = 0, 1, 2
# layer kind (its dispatcher's name) -> (C source, gates, whether it
# returns the cell state)
_LAYERS = {"lstm_layer_tm": ("lstm", 4, False), "lstm_layer_tm_train": ("lstm", 4, True),
           "grumod_layer_tm": ("grumod", 3, False)}


def _launch_layer(kind, what, x_tm, iW, b, sW, backward, lengths, step: str):
    """One launch of a fused C entry of layer ``kind`` (a key of
    ``_LAYERS``) after ``_layer_args``: the block affine, then the cluster
    recurrence (csrc/layer.cuh).  The affine follows x's dtype and the ff
    level for x's device: the bf16 one under the bf16 stream, else the
    one-pass affine with an f32 output (x and iW rounded to bf16 here),
    else the f32 one; it is counted on its wrapper's counter.  The step
    product is at level ``step`` (``F32``, ``ONE_PASS`` or
    ``THREE_PASS``).  The three-pass layers are csrc/<source>_h3.cu's,
    which take the affine as an argument; the others that only precision
    ``default`` reaches (the one-pass step, or the one-pass affine)
    csrc/<source>_p1.cu's, which take the affine and the step; the rest
    csrc/<source>.cu's, an entry for each stream.  The xa scratch and the
    outputs are in the stream's dtype."""
    source, gates, want_c = _LAYERS[kind]
    x_tm, iW, b, sW, lengths = _layer_args(what, gates, x_tm, iW, b, sW, lengths)
    T, B, IN = x_tm.shape
    H = sW.shape[0]
    dt = x_tm.dtype
    if dt == BF16:
        affine = BLOCK_BF16
    elif precision.ff_precision(x_tm.device) == ONE_PASS:
        affine = BLOCK_ONE_PASS
        x_tm, iW = x_tm.to(BF16), iW.to(BF16)
    else:
        affine = BLOCK_F32
    train = "_train" if want_c else ""
    if step == THREE_PASS:
        source, entry = source + "_h3", f"flappie_{source}_h3_layer{train}"
        flags = [affine]
    elif step == ONE_PASS or affine == BLOCK_ONE_PASS:
        source, entry = source + "_p1", f"flappie_{source}_p1_layer{train}"
        flags = [affine, int(step == ONE_PASS)]
    else:
        entry = f"flappie_{source}_layer{train}" + ("_bf16" if affine == BLOCK_BF16 else "")
        flags = []
    xa = torch.empty(T * B, gates * H, dtype=dt, device=x_tm.device)
    outs = [torch.empty(T, B, H, dtype=dt, device=x_tm.device) for _ in range(1 + want_c)]
    lib, fn = _entry(source, entry, [_P] * (6 + len(outs)) + [_I] * (5 + len(flags)) + [_P])
    rc = fn(*(cuda_build.ptr(t) for t in (x_tm, iW, b, sW, lengths, xa, *outs)),
            T, B, IN, H, int(backward), *flags, cuda_build.stream_of(x_tm))
    cuda_build.check(lib, rc, what)
    if affine == BLOCK_BF16:
        _count_affine_bf16(T * B, gates * H, IN)
    else:
        cuda_build.count(affine_f32 if affine == BLOCK_F32 else affine_bf16_f32)
    return tuple(outs) if want_c else outs[0]


def _device(what, x):
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: unsupported device {x.device}")
    return x.device.type == "cuda"


def _need_bf16(what, x):
    if x.dtype != BF16:
        raise ValueError(f"{what}: x must be bfloat16 (the bf16 stream), got {x.dtype}")


def _dispatch(kind, x_tm, iW, b, sW, backward, lengths):
    """``lstm_layer_tm``, ``lstm_layer_tm_train`` and ``grumod_layer_tm``
    (``kind``): the plain version on the CPU (every level true f32); on
    the card the rnn-``default`` kernel where the step product's level
    for x's device is one pass, the rnn-``high`` kernel where it is three
    passes, else the bf16 stream's kernel for an x in bf16, else the f32
    kernel (its affine at the ff level), counted on the dispatcher."""
    w = _wrappers(kind)
    if not _device(kind, x_tm):
        return w.plain(x_tm, iW, b, sW, backward, lengths)
    level = precision.rnn_precision(x_tm.device)
    if level == ONE_PASS:
        return w.p1(x_tm, iW, b, sW, backward, lengths)
    if level == THREE_PASS:
        return w.h3(x_tm, iW, b, sW, backward, lengths)
    if x_tm.dtype == BF16:
        return w.bf16(x_tm, iW, b, sW, backward, lengths)
    out = _launch_layer(kind, kind, x_tm, iW, b, sW, backward, lengths, F32)
    cuda_build.count(w.f32)
    return out


def _bf16_layer(kind, x_tm, iW, b, sW, backward, lengths):
    """K1-bf16, K8-bf16 or K7-bf16 (``kind``): the plain version on the
    CPU, else one launch counted on its wrapper."""
    w = _wrappers(kind)
    what = kind + "_bf16"
    _need_bf16(what, x_tm)
    if not _device(what, x_tm):
        return w.plain(x_tm, iW, b, sW, backward, lengths)
    out = _launch_layer(kind, what, x_tm, iW, b, sW, backward, lengths, F32)
    cuda_build.count(w.bf16)
    return out


def _step_layer(kind, step, x_tm, iW, b, sW, backward, lengths):
    """Layer ``kind`` with the step product at ``step`` (``ONE_PASS``:
    the ``*_p1`` wrappers, ``THREE_PASS``: the ``*_h3`` ones): its plain
    twin on the CPU (the affine true f32, the CPU's level), else one
    launch counted on the wrapper for an f32 x and on its ``*_bf16_p1`` /
    ``*_bf16_h3`` counter for an x in bf16.  A launch that fails raises:
    nothing runs another kernel or the plain twin in its place."""
    w = _wrappers(kind)
    sfx = "_p1" if step == ONE_PASS else "_h3"
    what = kind + sfx
    if not _device(what, x_tm):
        return w.plain(x_tm, iW, b, sW, backward, lengths, rdot=step)
    out = _launch_layer(kind, what, x_tm, iW, b, sW, backward, lengths, step)
    if step == ONE_PASS:
        cuda_build.count(w.p1_bf16 if x_tm.dtype == BF16 else w.p1)
    else:
        cuda_build.count(w.h3_bf16 if x_tm.dtype == BF16 else w.h3)
    return out


def lstm_layer_tm(x_tm, iW, b, sW, backward: bool = False, lengths=None):
    """Fused input affine + LSTM recurrence, time-major [T, B, IN] ->
    [T, B, H]; ``lengths`` [B] int32 (default: all T).  An x_tm in bf16
    runs the bf16 stream (``lstm_layer_tm_bf16``) and returns bf16; at
    precision ``default`` on the card the step product is one pass
    (``lstm_layer_tm_p1``) and, on the f32 stream, the affine too."""
    return _dispatch("lstm_layer_tm", x_tm, iW, b, sW, backward, lengths)


lstm_layer_tm.launches = 0


def lstm_layer_tm_bf16(x_tm, iW, b, sW, backward: bool = False, lengths=None):
    """K1-bf16: ``lstm_layer_tm`` under the bf16 stream.  x_tm [T, B, IN]
    bf16, iW bf16 or f32, b and sW f32 -> [T, B, H] bf16."""
    return _bf16_layer("lstm_layer_tm", x_tm, iW, b, sW, backward, lengths)


lstm_layer_tm_bf16.launches = 0


def lstm_layer_tm_train(x_tm, iW, b, sW, backward: bool = False, lengths=None):
    """K8: ``lstm_layer_tm`` that also returns the carried cell state,
    (h [T, B, H], c [T, B, H]), both 0 at invalid steps; h is K1's h bit
    for bit.  The forward of the training path (ops/rnn_vjp.py).  An x_tm
    in bf16 runs K8-bf16 (``lstm_layer_tm_train_bf16``); at precision
    ``default`` on the card, ``lstm_layer_tm_train_p1``."""
    return _dispatch("lstm_layer_tm_train", x_tm, iW, b, sW, backward, lengths)


lstm_layer_tm_train.launches = 0


def lstm_layer_tm_train_bf16(x_tm, iW, b, sW, backward: bool = False, lengths=None):
    """K8-bf16: K8 under the bf16 stream, the training forward under
    ``--fast``'s stream.  x_tm [T, B, IN] bf16, iW bf16 or f32, b and sW
    f32 -> (h, c) [T, B, H] bf16; h is K1-bf16's bit for bit."""
    return _bf16_layer("lstm_layer_tm_train", x_tm, iW, b, sW, backward, lengths)


lstm_layer_tm_train_bf16.launches = 0


def grumod_layer_tm(x_tm, iW, b, sW, backward: bool = False, lengths=None):
    """Fused input affine + GRU-mod recurrence, time-major [T, B, IN] ->
    [T, B, H]; ``lengths`` [B] int32 (default: all T).  An x_tm in bf16
    runs the bf16 stream (``grumod_layer_tm_bf16``) and returns bf16; at
    precision ``default`` on the card as ``lstm_layer_tm``
    (``grumod_layer_tm_p1``)."""
    return _dispatch("grumod_layer_tm", x_tm, iW, b, sW, backward, lengths)


grumod_layer_tm.launches = 0


def grumod_layer_tm_bf16(x_tm, iW, b, sW, backward: bool = False, lengths=None):
    """K7-bf16: ``grumod_layer_tm`` under the bf16 stream.  x_tm
    [T, B, IN] bf16, iW bf16 or f32, b and sW f32 -> [T, B, H] bf16."""
    return _bf16_layer("grumod_layer_tm", x_tm, iW, b, sW, backward, lengths)


grumod_layer_tm_bf16.launches = 0


def lstm_layer_tm_p1(x_tm, iW, b, sW, backward: bool = False, lengths=None):
    """K1 (or K1-bf16 for an x_tm in bf16, counted on
    ``lstm_layer_tm_bf16_p1``) with the step product at precision
    ``default``: one bf16 pass, f32 sums (csrc/lstm_p1.cu); on the f32
    stream the affine at the ff level for x's device."""
    return _step_layer("lstm_layer_tm", ONE_PASS, x_tm, iW, b, sW, backward, lengths)


def lstm_layer_tm_train_p1(x_tm, iW, b, sW, backward: bool = False, lengths=None):
    """K8 (or K8-bf16, counted on ``lstm_layer_tm_train_bf16_p1``) with
    the step product at precision ``default``: (h, c) as
    ``lstm_layer_tm_train``."""
    return _step_layer("lstm_layer_tm_train", ONE_PASS, x_tm, iW, b, sW, backward, lengths)


def grumod_layer_tm_p1(x_tm, iW, b, sW, backward: bool = False, lengths=None):
    """K7 (or K7-bf16, counted on ``grumod_layer_tm_bf16_p1``) with the
    step product at precision ``default``: one bf16 pass, f32 sums
    (csrc/grumod_p1.cu); on the f32 stream the affine at the ff level for
    x's device."""
    return _step_layer("grumod_layer_tm", ONE_PASS, x_tm, iW, b, sW, backward, lengths)


lstm_layer_tm_p1.launches = lstm_layer_tm_train_p1.launches = grumod_layer_tm_p1.launches = 0
# the launch counts of the rnn-default kernels under the bf16 stream
lstm_layer_tm_bf16_p1 = types.SimpleNamespace(launches=0)
lstm_layer_tm_train_bf16_p1 = types.SimpleNamespace(launches=0)
grumod_layer_tm_bf16_p1 = types.SimpleNamespace(launches=0)


def lstm_layer_tm_h3(x_tm, iW, b, sW, backward: bool = False, lengths=None):
    """K1 (or K1-bf16 for an x_tm in bf16, counted on
    ``lstm_layer_tm_bf16_h3``) with the step product at rnn precision
    ``high``: three bf16 passes, f32 sums (csrc/lstm_h3.cu); on the f32
    stream the affine at the ff level for x's device."""
    return _step_layer("lstm_layer_tm", THREE_PASS, x_tm, iW, b, sW, backward, lengths)


def lstm_layer_tm_train_h3(x_tm, iW, b, sW, backward: bool = False, lengths=None):
    """K8 (or K8-bf16, counted on ``lstm_layer_tm_train_bf16_h3``) with
    the step product at rnn precision ``high``: (h, c) as
    ``lstm_layer_tm_train``; h is ``lstm_layer_tm_h3``'s bit for bit."""
    return _step_layer("lstm_layer_tm_train", THREE_PASS, x_tm, iW, b, sW, backward, lengths)


def grumod_layer_tm_h3(x_tm, iW, b, sW, backward: bool = False, lengths=None):
    """K7 (or K7-bf16, counted on ``grumod_layer_tm_bf16_h3``) with the
    step product at rnn precision ``high``: three bf16 passes, f32 sums
    (csrc/grumod_h3.cu); on the f32 stream the affine at the ff level for
    x's device."""
    return _step_layer("grumod_layer_tm", THREE_PASS, x_tm, iW, b, sW, backward, lengths)


lstm_layer_tm_h3.launches = lstm_layer_tm_train_h3.launches = grumod_layer_tm_h3.launches = 0
# the launch counts of the rnn-high kernels under the bf16 stream
lstm_layer_tm_bf16_h3 = types.SimpleNamespace(launches=0)
lstm_layer_tm_train_bf16_h3 = types.SimpleNamespace(launches=0)
grumod_layer_tm_bf16_h3 = types.SimpleNamespace(launches=0)


def _wrappers(kind):
    """Layer ``kind``'s dispatcher (the f32 kernel's counter), bf16-stream
    kernel, rnn-default and rnn-high kernels and their bf16-stream
    counters, and plain version, looked up when called (tests may replace
    them)."""
    g = globals()
    return types.SimpleNamespace(f32=g[kind], bf16=g[kind + "_bf16"], p1=g[kind + "_p1"],
                                 p1_bf16=g[kind + "_bf16_p1"], h3=g[kind + "_h3"],
                                 h3_bf16=g[kind + "_bf16_h3"], plain=g[kind + "_plain"])


def _launch_affine(what: str, entry: str, dt, x, iW, b, out_dt=None):
    """Checks shared by the affine wrappers, then one launch of the C
    entry ``entry`` of csrc/lstm.cu: x [M, K] and iW [K, N] of dtype
    ``dt``, b [N] f32 -> [M, N] of dtype ``out_dt`` (default ``dt``)."""
    if x.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {x.device}")
    if x.dim() != 2:
        raise ValueError(f"{what}: x must be [M, K], got {tuple(x.shape)}")
    M, K = x.shape
    N = iW.shape[-1]
    if tuple(iW.shape) != (K, N) or tuple(b.shape) != (N,):
        raise ValueError(f"{what}: bad shapes iW {tuple(iW.shape)}, b {tuple(b.shape)} "
                         f"for K={K}")
    for name, t, want in (("x", x, dt), ("iW", iW, dt), ("b", b, torch.float32)):
        if t.dtype != want or t.device != x.device:
            raise ValueError(f"{what}: {name} must be {want} on {x.device}")
    x, iW, b = (_aligned(t.contiguous()) for t in (x, iW, b))
    out = torch.empty(M, N, dtype=out_dt or dt, device=x.device)
    lib, fn = _entry("lstm", entry, [_P] * 4 + [ctypes.c_long, _I, _I, _P])
    rc = fn(*(cuda_build.ptr(t) for t in (x, iW, b, out)), M, N, K, cuda_build.stream_of(x))
    cuda_build.check(lib, rc, what)
    return out


def affine_f32(x, iW, b):
    """The f32 affine of K1, K7 and K8 alone (csrc/affine.cuh, true f32
    FMA on the CUDA cores): x [M, K], iW [K, N], b [N] f32 -> x . iW + b
    [M, N].  ``affine_f32.launches`` also counts the affines the f32
    layers launch."""
    if x.device.type == "cpu":
        return affine_f32_plain(x, iW, b)
    out = _launch_affine("affine_f32", "flappie_affine_f32", torch.float32, x, iW, b)
    cuda_build.count(affine_f32)
    return out


affine_f32.launches = 0


def affine_bf16(x, iW, b):
    """The bf16 affine of K1-bf16 and K7-bf16 alone (csrc/affine.cuh, on
    the tensor cores): x [M, K] and iW [K, N] bf16, b [N] f32 ->
    bf16(x . iW + b) [M, N].  ``affine_bf16.launches`` counts the wgmma
    path's launches, ``affine_bf16_wmma.launches`` the wmma path's
    (``_affine_plan``), the bf16 layers' included."""
    if x.device.type == "cpu":
        return affine_bf16_plain(x, iW, b)
    out = _launch_affine("affine_bf16", "flappie_affine_bf16", BF16, x, iW, b)
    _count_affine_bf16(x.shape[0], iW.shape[-1], x.shape[1])
    return out


affine_bf16.launches = 0
# the launch count of the bf16 affine's wmma path (shapes off the TMA grid)
affine_bf16_wmma = types.SimpleNamespace(launches=0)


def affine_bf16_f32(x, iW, b):
    """The one-pass affine of precision ``default`` on the f32 stream
    (csrc/affine.cuh, the bf16 kernels with an f32 output): x [M, K] and
    iW [K, N] bf16, b [N] f32 -> x . iW + b [M, N] f32, f32 sums.  The
    layers round their f32 x and iW to bf16 before it; its launches, theirs
    included, count on ``affine_bf16_f32.launches`` (either path)."""
    if x.device.type == "cpu":
        return affine_bf16_f32_plain(x, iW, b)
    out = _launch_affine("affine_bf16_f32", "flappie_affine_bf16_f32", BF16, x, iW, b,
                         torch.float32)
    cuda_build.count(affine_bf16_f32)
    return out


affine_bf16_f32.launches = 0


def _count_affine_bf16(M: int, N: int, K: int) -> None:
    """One bf16 affine launch at [M, K] x [K, N], on its path's counter."""
    if _affine_plan(M, N, K, True)[0] == PATH_WGMMA:
        cuda_build.count(affine_bf16)
    else:
        cuda_build.count(affine_bf16_wmma)


# K12 takes no bf16: the JAX package's layer-by-layer stack ignores the stream
_K12_F32 = ("{} (K12) takes float32: the layer-by-layer recurrence runs in f32 under "
            "every stream, as the JAX package's does")


def _launch_seq(what, source, entry, gates, xaffine, sW):
    """Checks shared by the K12 wrappers, then one launch of ``entry``."""
    if xaffine.dim() != 3:
        raise ValueError(f"{what}: xaffine must be [B, T, G*H], got {tuple(xaffine.shape)}")
    B, T, G = xaffine.shape
    H = sW.shape[0]
    if tuple(sW.shape) != (H, gates * H) or G != gates * H:
        raise ValueError(f"{what}: bad shapes xaffine {tuple(xaffine.shape)}, "
                         f"sW {tuple(sW.shape)} for {gates} gates")
    _cluster_plan(B, H, gates)
    for name, t in (("xaffine", xaffine), ("sW", sW)):
        if t.dtype != torch.float32 or t.device != xaffine.device:
            raise ValueError(f"{what}: {name} must be float32 on {xaffine.device}")
    xaffine, sW = xaffine.contiguous(), sW.contiguous()
    # every row runs all T steps: the layer kernels' mask never fires
    lengths = torch.full((B,), T, dtype=torch.int32, device=xaffine.device)
    out = torch.empty(B, T, H, dtype=torch.float32, device=xaffine.device)
    lib = cuda_build.load(source)
    fn = getattr(lib, entry)
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    rc = fn(*(cuda_build.ptr(t) for t in (xaffine, sW, lengths, out)), T, B, H,
            cuda_build.stream_of(xaffine))
    cuda_build.check(lib, rc, what)
    return out


def lstm_seq_cuda(xaffine, sW):
    """K12: LSTM recurrence over xaffine [B, T, 4H] (= x iW + b), sW
    [H, 4H] -> [B, T, H]; ops/rnn.py ``lstm_seq`` for a CPU tensor.
    float32 only."""
    if xaffine.dtype == BF16:
        raise ValueError(_K12_F32.format("lstm_seq_cuda"))
    if xaffine.device.type == "cpu":
        return lstm_seq(xaffine, sW)
    if xaffine.device.type != "cuda":
        raise ValueError(f"lstm_seq_cuda: unsupported device {xaffine.device}")
    out = _launch_seq("lstm_seq_cuda", "lstm", "flappie_lstm_seq", 4, xaffine, sW)
    cuda_build.count(lstm_seq_cuda)
    return out


lstm_seq_cuda.launches = 0


def grumod_seq_cuda(xaffine, sW):
    """K12: GRU-mod recurrence over xaffine [B, T, 3H], sW [H, 3H] ->
    [B, T, H]; ops/rnn.py ``grumod_seq`` for a CPU tensor.  float32 only."""
    if xaffine.dtype == BF16:
        raise ValueError(_K12_F32.format("grumod_seq_cuda"))
    if xaffine.device.type == "cpu":
        return grumod_seq(xaffine, sW)
    if xaffine.device.type != "cuda":
        raise ValueError(f"grumod_seq_cuda: unsupported device {xaffine.device}")
    out = _launch_seq("grumod_seq_cuda", "grumod", "flappie_grumod_seq", 3, xaffine, sW)
    cuda_build.count(grumod_seq_cuda)
    return out


grumod_seq_cuda.launches = 0
