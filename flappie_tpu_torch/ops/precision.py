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
at call time, as there.  The getters return what runs on a device:

- On the CPU every level is true f32 (``"highest"``), as the JAX package
  runs it there (its CPU backend ignores precision; its CPU CLI runs
  ``rnn_impl="scan"``, where XLA does), so the CPU keeps JAX's CPU bytes.
- On a CUDA device ``default`` resolves to ``"bf16"``, the one-pass
  product of the MXU: both operands rounded to bf16, the products summed
  in f32 (ops/rnn_cuda.py: the one-pass recurrence steps on the tensor
  cores, and the one-pass affine; ops/rnn.py ``affine``, ops/conv.py and
  ops/rnn_vjp.py: plain products on rounded operands, TF32 off).
- On a CUDA device an explicit rnn ``high`` resolves to ``"bf16x3"``, the
  three-pass product the JAX kernels run at rnn HIGH
  (flappie_tpu/ops/rnn_pallas.py:505-507 -> ``"high3"``, :161
  ``_dot_bf16x3``): h and sW split into a bf16 high part and a bf16
  remainder, ``(h_hi.sW_hi + h_hi.sW_lo) + h_lo.sW_hi`` with f32 sums
  (ops/rnn_cuda.py: the three-pass recurrence steps on the tensor cores).
- Every other level is true f32: ``highest`` everywhere; an unset rnn
  level (the port's parity tier: JAX's default on a TPU is HIGH, i.e.
  the three passes, which the port runs only when asked for); ff ``high``
  (FLAPPIE_TPU_MATMUL_PRECISION's default, which must stay the true-f32
  parity tier; JAX's in-kernel ff ``"high3"`` runs only on a TPU backend,
  rnn_pallas.py:195-201) and grad ``high`` (the adjoint is plain torch, no
  Pallas kernel behind it).

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
# what a level runs as: true f32, one bf16 pass with f32 sums, or (the
# recurrent step alone) three bf16 passes with f32 sums
F32, ONE_PASS, THREE_PASS = "highest", "bf16", "bf16x3"


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
    None): on a CUDA device ``"bf16"`` for ``default`` and ``"bf16x3"``
    (three passes) for an explicit ``high``; else ``"highest"`` (true f32:
    every level on the CPU, ``highest``, and unset)."""
    dev = torch.device("cpu" if device is None else device)
    if _rnn_level == "high" and dev.type == "cuda":
        return THREE_PASS
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


def split_bf16(t):
    """(hi, lo) of f32 t, each a bf16 value widened to f32: hi = bf16(t),
    lo = bf16(t - hi), both nearest even (flappie_tpu/ops/rnn_pallas.py:154
    ``_split_bf16``); the operands of a three-pass product."""
    hi = one_pass(t)
    return hi, one_pass(t - hi)


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
