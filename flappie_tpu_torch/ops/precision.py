"""Precision policy of the port: the matmul levels and the recurrent
layers' stream dtype.

Counterpart of flappie_tpu/ops/precision.py and of
flappie_tpu/ops/rnn_pallas.py:429 ``_stream_dtype``.

Levels.  ``FLAPPIE_TPU_MATMUL_PRECISION`` (feed-forward products: the
convolutions, the layers' input affines, the head; default ``high``) and
``FLAPPIE_TPU_RNN_PRECISION`` (the recurrent step product; unset by
default) take ``default``, ``high`` or ``highest``, read when this module
is imported, as in the JAX package; ``set_ff_precision`` and
``set_rnn_precision`` change them later.  The getters return the level
that runs on a device, resolved as the JAX package resolves it off the
TPU: ``high`` and ``highest`` are true f32 on every device (its
``_resolve_ffprec`` and ``rnn_precision`` give HIGHEST there), and
``default`` is true f32 on the CPU, where precision is ignored.  On a
CUDA device ``default`` (a one-pass bf16 product) raises: the port has
no such product yet (ROADMAP item 17's remainder), and nothing may run
f32 in its place under that name.

Stream.  ``FLAPPIE_TPU_RNN_STREAM`` = ``f32`` (default) or ``bf16``,
read at call time: the dtype the fused recurrent layers (K1, K7) take
their input in and give their output in.  Under ``bf16`` a layer rounds
x and iW to bf16, computes the block affine in f32 and rounds it to
bf16, runs the steps, their state and the step product in f32, and
rounds only the stored output to bf16 (ops/rnn_cuda.py).  The CLIs'
``--fast`` passes ``torch.bfloat16`` explicitly instead of setting it.
"""

from __future__ import annotations

import os

import torch

LEVELS = ("default", "high", "highest")
STREAMS = {"f32": torch.float32, "bf16": torch.bfloat16}

# the remainder of ROADMAP item 17 that a one-pass bf16 product waits for
_DEFAULT_ON_CARD = (
    "precision 'default' (a one-pass bf16 product) is not ported to the CUDA kernels "
    "(ROADMAP item 17's remainder); use 'high' or 'highest' (true f32), or --fast for "
    "the bf16 stream")


def _level(name: str, what: str) -> str:
    level = name.lower()
    if level not in LEVELS:
        raise ValueError(f"{what}: precision must be one of {LEVELS}, got {name!r}")
    return level


_ff_level = _level(os.environ.get("FLAPPIE_TPU_MATMUL_PRECISION", "high"),
                   "FLAPPIE_TPU_MATMUL_PRECISION")
_env_rnn = os.environ.get("FLAPPIE_TPU_RNN_PRECISION", "")
_rnn_level = _level(_env_rnn, "FLAPPIE_TPU_RNN_PRECISION") if _env_rnn else None


def _resolve(level, device, what: str) -> str:
    dev = torch.device("cpu" if device is None else device)
    if level == "default" and dev.type == "cuda":
        raise ValueError(f"{what}: {_DEFAULT_ON_CARD}")
    return "highest"


def ff_precision(device=None) -> str:
    """The feed-forward level that runs on ``device`` (the CPU when
    None): ``highest``, true f32; raises for ``default`` on a CUDA
    device."""
    return _resolve(_ff_level, device, "FLAPPIE_TPU_MATMUL_PRECISION")


def set_ff_precision(level: str) -> None:
    global _ff_level
    _ff_level = _level(level, "set_ff_precision")


def rnn_precision(device=None) -> str:
    """The recurrent step product's level on ``device`` (the CPU when
    None): ``highest``, true f32, when unset as on every device off the
    TPU; raises for ``default`` on a CUDA device."""
    return _resolve(_rnn_level, device, "FLAPPIE_TPU_RNN_PRECISION")


def set_rnn_precision(level: str) -> None:
    global _rnn_level
    _rnn_level = _level(level, "set_rnn_precision")


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
