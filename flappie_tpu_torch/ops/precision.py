"""Precision policy of the port: the matmul levels and the recurrent
layers' stream dtype.

Counterpart of flappie_tpu/ops/precision.py and of
flappie_tpu/ops/rnn_pallas.py:429 ``_stream_dtype``.

Levels.  ``FLAPPIE_TPU_MATMUL_PRECISION`` (feed-forward products: the
convolutions, the layers' input affines, the head; default ``high``) and
``FLAPPIE_TPU_RNN_PRECISION`` (the recurrent step product; unset by
default) take ``default``, ``high`` or ``highest``, read when this module
is imported, as in the JAX package; ``set_ff_precision`` and
``set_rnn_precision`` change them later.  ``FLAPPIE_TPU_GRAD_PRECISION``
(the training adjoint's products, flappie_tpu/ops/rnn_vjp.py:46
``_grad_precision``; default ``high``) takes the same levels and is read
at call time, as there.  The getters return what runs on a device,
resolved as the JAX package resolves it off the TPU: ``high`` and
``highest`` are true f32 on every device (``"highest"``: its
``_resolve_ffprec`` and ``rnn_precision`` give HIGHEST there), and
``default`` is true f32 on the CPU, where precision is ignored (JAX's
CPU bytes).  On a CUDA device ``default`` resolves to ``"bf16"``, the
one-pass product of the MXU: both operands rounded to bf16, the products
summed in f32 (ops/rnn_cuda.py: the one-pass recurrence steps, the
LSTM's on the tensor cores, and the one-pass affine; ops/rnn.py ``affine``, ops/conv.py and
ops/rnn_vjp.py: plain products on rounded operands, TF32 off).

Stream.  ``FLAPPIE_TPU_RNN_STREAM`` = ``f32`` (default) or ``bf16``,
read at call time: the dtype the fused recurrent layers (K1, K7, and K8
in training) take their input in and give their output in.  Under
``bf16`` a layer rounds x and iW to bf16, computes the block affine in
f32 and rounds it to bf16, runs the steps and their state in f32 (the
step product at the rnn level), and rounds only the stored outputs to
bf16 (ops/rnn_cuda.py).  The CLIs' ``--fast`` passes ``torch.bfloat16``
explicitly instead of setting it.
"""

from __future__ import annotations

import os

import torch

LEVELS = ("default", "high", "highest")
STREAMS = {"f32": torch.float32, "bf16": torch.bfloat16}
# what a level runs as: true f32, or one bf16 pass with f32 sums
F32, ONE_PASS = "highest", "bf16"


def _level(name: str, what: str) -> str:
    level = name.lower()
    if level not in LEVELS:
        raise ValueError(f"{what}: precision must be one of {LEVELS}, got {name!r}")
    return level


_ff_level = _level(os.environ.get("FLAPPIE_TPU_MATMUL_PRECISION", "high"),
                   "FLAPPIE_TPU_MATMUL_PRECISION")
_env_rnn = os.environ.get("FLAPPIE_TPU_RNN_PRECISION", "")
_rnn_level = _level(_env_rnn, "FLAPPIE_TPU_RNN_PRECISION") if _env_rnn else None


def _resolve(level, device) -> str:
    dev = torch.device("cpu" if device is None else device)
    return ONE_PASS if level == "default" and dev.type == "cuda" else F32


def ff_precision(device=None) -> str:
    """The feed-forward level that runs on ``device`` (the CPU when
    None): ``"bf16"`` for ``default`` on a CUDA device, else
    ``"highest"`` (true f32)."""
    return _resolve(_ff_level, device)


def set_ff_precision(level: str) -> None:
    global _ff_level
    _ff_level = _level(level, "set_ff_precision")


def rnn_precision(device=None) -> str:
    """The recurrent step product's level on ``device`` (the CPU when
    None): ``"bf16"`` for ``default`` on a CUDA device, else
    ``"highest"`` (true f32; unset is HIGHEST off the TPU)."""
    return _resolve(_rnn_level, device)


def set_rnn_precision(level: str) -> None:
    global _rnn_level
    _rnn_level = _level(level, "set_rnn_precision")


def grad_precision(device=None) -> str:
    """FLAPPIE_TPU_GRAD_PRECISION at call time (default ``high``), the
    training adjoint's level on ``device`` (the CPU when None):
    ``"bf16"`` for ``default`` on a CUDA device, else ``"highest"``."""
    level = _level(os.environ.get("FLAPPIE_TPU_GRAD_PRECISION", "high"),
                   "FLAPPIE_TPU_GRAD_PRECISION")
    return _resolve(level, device)


def one_pass(t):
    """t rounded to bf16 and widened back to f32: an operand of a
    one-pass product."""
    return t.to(torch.bfloat16).float()


def stream_dtype() -> torch.dtype:
    """FLAPPIE_TPU_RNN_STREAM at call time: ``torch.float32`` (``f32``,
    the default) or ``torch.bfloat16`` (``bf16``); any other value
    raises."""
    name = os.environ.get("FLAPPIE_TPU_RNN_STREAM", "f32").lower()
    if name not in STREAMS:
        raise ValueError(f"FLAPPIE_TPU_RNN_STREAM must be one of {tuple(STREAMS)}, "
                         f"got {name!r}")
    return STREAMS[name]


def check_stream(stream) -> torch.dtype:
    """``stream`` (a dtype, or None for ``stream_dtype()``) as one of the
    two stream dtypes; raises for any other."""
    if stream is None:
        return stream_dtype()
    if stream not in STREAMS.values():
        raise ValueError(f"stream must be torch.float32 or torch.bfloat16, got {stream}")
    return stream
