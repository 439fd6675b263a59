"""The two leading stride-1 swish convs as one kernel: K10
(csrc/conv12.cu) and its plain version.

Counterpart of flappie_tpu/ops/conv_pallas.py: ``conv12_fused`` (its
custom VJP, :134-151) over ``_conv12_pallas`` (the TPU kernel) and
``_conv12_xla`` (the differentiable chain).  The stride-5 model family
opens with conv 1->4 and conv 4->16 (width 5, swish); both layers are
zeroed outside each read's [0, length), and only the [B, 16, T]
channels-major conv2 output leaves the kernel.

The forward launches K10 for a CUDA tensor and runs the plain version
for a CPU tensor; any other device raises.  The backward recomputes the
chain through the plain version under autograd, as the JAX custom VJP
does (the JAX package has no backward kernel here).
``conv12_fused.launches`` counts kernel launches.

K10 runs a persistent grid over items of (read, tile of samples), each
thread a register tile of 4 samples x 16 / G channels (G channel groups:
1, or 4 when the items would not fill the card), each item's y2 staged in
shared memory and sent by bulk copies: ``conv12_plan`` in the source
sets the grid, ``_conv12_plan`` mirrors it and ``conv12_info`` reports
it on the card.
"""

from __future__ import annotations

import ctypes

import torch

from . import cuda_build
from .activations import swish
from .conv import conv1d_same_ct

SHAPES = {"W1": (5, 1, 4), "b1": (4,), "W2": (5, 4, 16), "b2": (16,)}

# csrc/conv12.cu: threads a CTA (kThreads), output samples a thread (N), the
# channel groups a plan may take and the shared bytes a CTA holds besides
# the staging tile, the zero row and y1 (the weights and biases)
CONV12_THREADS, CONV12_N, CONV12_GROUPS, CONV12_WBYTES = 128, 4, (1, 4), 4 * 360
INFO = ("groups", "tile", "threads", "ntiles", "items", "ctas", "sms", "smem",
        "per_sm_g1", "per_sm_g4")


def _conv12_plan(B: int, T: int, per_sm: dict, sms: int):
    """(channel groups G, tile, threads, tiles a read, items, CTAs, shared
    bytes a CTA) of K10 over B reads of T samples on a card holding
    ``per_sm[G]`` CTAs of the G-group kernel on each of ``sms`` SMs: a
    mirror of conv12_plan in csrc/conv12.cu, which ``conv12_info``
    reports.  G is 1 if its items fill the resident CTAs, else 4; a thread
    holds 4 samples x 16 / G channels, so a tile is 4 * threads / G
    samples.  Item i is read i // ntiles, samples
    [(i % ntiles) * tile, + tile); CTA k walks items k, k + ctas, ...  A
    CTA holds the tile's y2 ([16][tile] floats, the bulk copies' source), a
    row of tile zeros, y1 on the tile +- 2 and the weights."""
    for G in CONV12_GROUPS:
        tile = CONV12_N * CONV12_THREADS // G
        ntiles = -(-T // tile)
        items = B * ntiles
        resident = per_sm[G] * sms
        if items >= resident:
            break
    smem = 4 * (17 * tile + 4 * (tile + 4)) + CONV12_WBYTES
    return G, tile, CONV12_THREADS, ntiles, items, min(items, resident), smem


def conv12_info(B: int, T: int) -> dict:
    """The plan the C side launches (``INFO``'s fields by name; ``per_sm``
    from cudaOccupancyMaxActiveBlocksPerMultiprocessor).  Card only."""
    lib = _lib()
    info = (ctypes.c_int * len(INFO))()
    cuda_build.check(lib, lib.flappie_conv12_info(B, T, info), "conv12_info")
    return dict(zip(INFO, info))


def _lib():
    lib = cuda_build.load("conv12")
    with cuda_build.lock:  # a mesh's dispatch threads may type it at once
        if lib.flappie_conv12.argtypes is None:
            P, I = ctypes.c_void_p, ctypes.c_int
            lib.flappie_conv12_info.argtypes = [I, I, P]
            lib.flappie_conv12.argtypes = [P] * 7 + [I, I, P]
            for fn in (lib.flappie_conv12_info, lib.flappie_conv12):
                fn.restype = ctypes.c_int
    return lib


def conv12_fused_plain(x, W1, b1, W2, b2, lengths):
    """x [B, T] (tail zeroed) -> y2 [B, 16, T], masked, with plain tensor
    ops: ``_conv12_xla`` (conv_pallas.py:122) on the port's
    ``conv1d_same_ct``."""
    T = x.shape[1]
    m = torch.arange(T, device=x.device)[None, None, :] < lengths[:, None, None]
    y1 = torch.where(m, swish(conv1d_same_ct(x[:, None, :], W1, b1)), 0.0)
    return torch.where(m, swish(conv1d_same_ct(y1, W2, b2)), 0.0)


def _check(x, W1, b1, W2, b2, lengths) -> None:
    if x.dim() != 2:
        raise ValueError(f"conv12_fused: x must be [B, T], got {tuple(x.shape)}")
    for name, t in (("W1", W1), ("b1", b1), ("W2", W2), ("b2", b2)):
        if tuple(t.shape) != SHAPES[name]:
            raise ValueError(f"conv12_fused: {name} must be {SHAPES[name]}, got {tuple(t.shape)}")
    for name, t in (("x", x), ("W1", W1), ("b1", b1), ("W2", W2), ("b2", b2)):
        if t.dtype != torch.float32 or t.device != x.device:
            raise ValueError(f"conv12_fused: {name} must be float32 on {x.device}")
    if tuple(lengths.shape) != (x.shape[0],) or lengths.dtype not in (torch.int32, torch.int64):
        raise ValueError(f"conv12_fused: lengths must be integer [{x.shape[0]}]")


def _launch(x, W1, b1, W2, b2, lengths):
    B, T = x.shape
    x, W1, b1, W2, b2 = (t.contiguous() for t in (x, W1, b1, W2, b2))
    lengths = lengths.to(device=x.device, dtype=torch.int32).contiguous()
    y2 = torch.empty(B, 16, T, dtype=torch.float32, device=x.device)
    lib = _lib()
    rc = lib.flappie_conv12(*(cuda_build.ptr(t) for t in (x, W1, b1, W2, b2, lengths, y2)),
                            B, T, cuda_build.stream_of(x))
    cuda_build.check(lib, rc, "conv12_fused")
    cuda_build.count(conv12_fused)
    return y2


class _Conv12(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, W1, b1, W2, b2, lengths):
        ctx.save_for_backward(x, W1, b1, W2, b2, lengths)
        if x.device.type == "cpu":
            return conv12_fused_plain(x, W1, b1, W2, b2, lengths)
        return _launch(x, W1, b1, W2, b2, lengths)

    @staticmethod
    def backward(ctx, g):
        x, W1, b1, W2, b2, lengths = ctx.saved_tensors
        with torch.enable_grad():
            ins = [t.detach().requires_grad_() for t in (x, W1, b1, W2, b2)]
            y = conv12_fused_plain(*ins, lengths)
            grads = torch.autograd.grad(y, ins, g)
        return (*grads, None)


def conv12_fused(x, W1, b1, W2, b2, lengths):
    """K10: x [B, T] float32 (zero past each read's length), W1 [5, 1, 4],
    b1 [4], W2 [5, 4, 16], b2 [16], lengths [B] -> y2 [B, 16, T], swish
    after each conv, both layers zeroed outside [0, length).
    Differentiable in x and the weights."""
    _check(x, W1, b1, W2, b2, lengths)
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"conv12_fused: unsupported device {x.device}")
    return _Conv12.apply(x, W1, b1, W2, b2, lengths)


conv12_fused.launches = 0
