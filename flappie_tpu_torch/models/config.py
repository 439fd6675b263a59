"""Model architecture configs.

The reference hard-wires five network graphs (src/networks.c:403-743)
with weights compiled into the binary.  Here the same graphs are data:
a ``ModelConfig`` describes the conv stack, the alternating-direction
recurrent stack and the output head; weights live in a checkpoint
pytree (see params.py).  Dimensions are *derived from the checkpoint*
at load time wherever possible (the C code does the same at runtime,
e.g. nbase from the output width, src/layers.c:1029).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Tuple


@dataclass(frozen=True)
class ConvSpec:
    """1-D same-padded strided convolution + activation.

    Reference: src/layers.c:189-276 (convolution), activations at
    src/layers.c:24-123.
    """

    winlen: int
    in_ch: int
    out_ch: int
    stride: int = 1
    activation: str = "swish"  # swish | tanh | elu


@dataclass(frozen=True)
class RnnSpec:
    """One recurrent layer: input affine + directional recurrence.

    kind: lstm (src/layers.c:877-1026), grumod (:571-715),
    gru (:412-568, sloika 2-matrix), gru_relu (:718-874).
    """

    kind: str
    size: int
    backward: bool
    # sloika-era graphs add the layer input back onto the recurrence
    # output (residual_inplace, src/layers.c:338-354; used by
    # flipflop_gru_transitions, src/networks.c:403-448)
    residual: bool = False


@dataclass(frozen=True)
class ModelConfig:
    name: str
    description: str
    convs: Tuple[ConvSpec, ...]
    rnns: Tuple[RnnSpec, ...]
    head: str  # flipflop | runlength | runlengthV2
    nbase: int = 4
    out_dim: int = field(init=False, default=0)

    def __post_init__(self):
        object.__setattr__(self, "out_dim", head_nparam(self.head, self.nbase))

    @property
    def total_stride(self) -> int:
        s = 1
        for c in self.convs:
            s *= c.stride
        return s

    @property
    def nstate(self) -> int:
        return 2 * self.nbase

    def nblocks(self, nsamples: int) -> int:
        """Number of output blocks for a read of n samples.

        ceil(n / stride) applied per conv layer (reference: iceil in
        src/layers.c:204).
        """
        n = nsamples
        for c in self.convs:
            n = -(-n // c.stride)
        return n


def head_nparam(head: str, nbase: int) -> int:
    if head == "flipflop":
        # nstate * (nbase + 1): nbase blocks of [to-flip x from-any]
        # plus one stay/move block (src/layers.c:1029-1033)
        return 2 * nbase * (nbase + 1)
    if head == "runlength":
        # shape, scale, move, stay per base (src/decode.c:682-691)
        return 4 * nbase
    if head == "runlengthV2":
        # nbase shape + nbase scale + (2*nbase*nbase) transitions
        # (src/decode.c:913-921); numerically equal to flipflop nparam
        return 2 * nbase + 2 * nbase * nbase
    raise ValueError(f"unknown head {head!r}")


def nbase_from_flipflop_nparam(nparam: int) -> int:
    """round((-1+sqrt(1+2n))/2) (reference src/layers.c:1029-1032)."""
    return int(round((-1.0 + math.sqrt(1.0 + 2.0 * nparam)) / 2.0))


def _lstm5(size: int) -> Tuple[RnnSpec, ...]:
    # Alternating B,F,B,F,B as in flipflop5_guppy_transitions
    # (src/networks.c:539-586)
    return tuple(
        RnnSpec("lstm", size, backward=(i % 2 == 0)) for i in range(5)
    )


def _grumod5(size: int) -> Tuple[RnnSpec, ...]:
    # flipflop_guppy_transitions (src/networks.c:450-489)
    return tuple(
        RnnSpec("grumod", size, backward=(i % 2 == 0)) for i in range(5)
    )


def _guppy_stride5_convs(size: int) -> Tuple[ConvSpec, ...]:
    # 3-conv stack with total stride 5 feeding the LSTM stack; exact
    # channel dims are read from checkpoints, these are the synthetic
    # defaults (consistent with the ~2.7M-parameter r941 blobs).
    return (
        ConvSpec(winlen=5, in_ch=1, out_ch=4, stride=1, activation="swish"),
        ConvSpec(winlen=5, in_ch=4, out_ch=16, stride=1, activation="swish"),
        ConvSpec(winlen=19, in_ch=16, out_ch=size, stride=5, activation="swish"),
    )


HIDDEN = 256

MODELS = {
    "r941_native": ModelConfig(
        name="r941_native",
        description="R9.4.1 model for MinION.  Trained from native DNA library",
        convs=_guppy_stride5_convs(HIDDEN),
        rnns=_lstm5(HIDDEN),
        head="flipflop",
        nbase=4,
    ),
    "r941_rna002": ModelConfig(
        name="r941_rna002",
        description="R9.4.1 dRNA model for MinION.  Trained from native and synthetic RNA library",
        convs=_guppy_stride5_convs(HIDDEN),
        rnns=_lstm5(HIDDEN),
        # like the reference, dRNA mode is explicit: --reverse --delta 1.0
        head="flipflop",
        nbase=4,
    ),
    "r941_5mC": ModelConfig(
        name="r941_5mC",
        description="R9.4.1 model for PromethION; 5mC aware.  Trained from native NA12878 library",
        convs=(ConvSpec(winlen=19, in_ch=1, out_ch=HIDDEN, stride=2, activation="tanh"),),
        rnns=_grumod5(HIDDEN),
        head="flipflop",
        nbase=5,
    ),
    "r103_native": ModelConfig(
        name="r103_native",
        description="R10.3 model for MinION.  Trained from native DNA library",
        convs=_guppy_stride5_convs(HIDDEN),
        rnns=_lstm5(HIDDEN),
        head="flipflop",
        nbase=4,
    ),
    "rle_r941_native": ModelConfig(
        name="rle_r941_native",
        description="R9.4.1 run-length encoded model for MinION.  Trained from native DNA library",
        convs=_guppy_stride5_convs(HIDDEN),
        rnns=_lstm5(HIDDEN),
        head="runlengthV2",
        nbase=4,
    ),
}

# Order matters for `--model help` output parity (src/networks.h:18-28):
# the four flip-flop models are listed by flappie, the RLE model by runnie.
FLAPPIE_MODELS = ("r941_native", "r941_rna002", "r941_5mC", "r103_native")
RUNNIE_MODELS = ("rle_r941_native",)


def get_model_config(name: str) -> ModelConfig:
    try:
        return MODELS[name]
    except KeyError:
        raise KeyError(f"Invalid model {name!r}; known: {', '.join(MODELS)}")
