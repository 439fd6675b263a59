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
"""

from __future__ import annotations

import ctypes

import torch

from . import cuda_build
from .activations import swish
from .conv import conv1d_same_ct

SHAPES = {"W1": (5, 1, 4), "b1": (4,), "W2": (5, 4, 16), "b2": (16,)}


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
    lib = cuda_build.load("conv12")
    fn = lib.flappie_conv12
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 2 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    rc = fn(*(cuda_build.ptr(t) for t in (x, W1, b1, W2, b2, lengths, y2)), B, T,
            cuda_build.stream_of(x))
    cuda_build.check(lib, rc, "conv12_fused")
    conv12_fused.launches += 1
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
