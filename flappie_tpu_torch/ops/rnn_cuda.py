"""Fused LSTM layer: kernel K1 (csrc/lstm.cu) and its plain version.

Counterpart of flappie_tpu/ops/rnn_pallas.py:563 ``lstm_layer_tm``
(``_lstm_fused_kernel``): time-major in and out, the block input affine
computed by the kernel itself, backward layers walking time in reverse,
and steps at or past a read's length freezing the carried state and
writing zeros.

``lstm_layer_tm`` launches the CUDA kernel for a CUDA tensor and runs
``lstm_layer_tm_plain`` for a CPU tensor; any other device raises.  The
recurrent product is true f32 (the TPU's bf16x3 split is not the parity
tier).  ``lstm_layer_tm.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from . import cuda_build
from .rnn import lstm_step


def lstm_layer_tm_plain(x_tm, iW, b, sW, backward: bool = False, lengths=None):
    """x_tm [T, B, IN] -> [T, B, H] with plain tensor ops (same math)."""
    T, B, _ = x_tm.shape
    H = sW.shape[0]
    if lengths is None:
        lengths = torch.full((B,), T, dtype=torch.int32, device=x_tm.device)
    xa = torch.matmul(x_tm, iW) + b  # [T, B, 4H]
    h = x_tm.new_zeros(B, H)
    c = x_tm.new_zeros(B, H)
    out = x_tm.new_empty(T, B, H)
    for t in (range(T - 1, -1, -1) if backward else range(T)):
        h2, c2 = lstm_step(xa[t], h, c, sW)
        valid = (t < lengths)[:, None]
        out[t] = torch.where(valid, h2, torch.zeros_like(h2))
        h = torch.where(valid, h2, h)
        c = torch.where(valid, c2, c)
    return out


def _lib():
    lib = cuda_build.load("lstm")
    fn = lib.flappie_lstm_layer
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def lstm_layer_tm(x_tm, iW, b, sW, backward: bool = False, lengths=None):
    """Fused input affine + LSTM recurrence, time-major [T, B, IN] ->
    [T, B, H]; ``lengths`` [B] int32 (default: all T)."""
    if x_tm.device.type == "cpu":
        return lstm_layer_tm_plain(x_tm, iW, b, sW, backward, lengths)
    if x_tm.device.type != "cuda":
        raise ValueError(f"lstm_layer_tm: unsupported device {x_tm.device}")
    T, B, IN = x_tm.shape
    H = sW.shape[0]
    if tuple(iW.shape) != (IN, 4 * H) or tuple(b.shape) != (4 * H,) or tuple(sW.shape) != (H, 4 * H):
        raise ValueError(f"lstm_layer_tm: bad weight shapes {tuple(iW.shape)}, "
                         f"{tuple(b.shape)}, {tuple(sW.shape)} for IN={IN}, H={H}")
    if H % 16 or H > 512:
        raise ValueError(f"lstm_layer_tm: kernel needs H % 16 == 0 and H <= 512, got {H}")
    for name, t in (("x", x_tm), ("iW", iW), ("b", b), ("sW", sW)):
        if t.dtype != torch.float32 or t.device != x_tm.device:
            raise ValueError(f"lstm_layer_tm: {name} must be float32 on {x_tm.device}")
    if lengths is None:
        lengths = torch.full((B,), T, dtype=torch.int32, device=x_tm.device)
    x_tm, iW, b, sW = (t.contiguous() for t in (x_tm, iW, b, sW))
    lengths = lengths.to(device=x_tm.device, dtype=torch.int32).contiguous()
    xa = torch.empty(T * B, 4 * H, dtype=torch.float32, device=x_tm.device)
    out = torch.empty(T, B, H, dtype=torch.float32, device=x_tm.device)
    lib = _lib()
    rc = lib.flappie_lstm_layer(
        cuda_build.ptr(x_tm), cuda_build.ptr(iW), cuda_build.ptr(b),
        cuda_build.ptr(sW), cuda_build.ptr(lengths), cuda_build.ptr(xa),
        cuda_build.ptr(out), T, B, IN, H, int(backward),
        cuda_build.stream_of(x_tm),
    )
    cuda_build.check(lib, rc, "lstm_layer_tm")
    lstm_layer_tm.launches += 1
    return out


lstm_layer_tm.launches = 0
