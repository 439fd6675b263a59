"""Batched forward graph: raw signal -> CRF transition weights.

Counterpart of flappie_tpu/models/network.py:207 ``transitions`` for the
non-residual LSTM and GRU-mod graphs: the stride-5 LSTM graph of
r941_native, r941_rna002 and r103_native (reference
flipflop5_guppy_transitions, src/networks.c:539-586) and of the
run-length model rle_r941_native (runlength5_guppy, :675-722, head
runlengthV2), and the stride-2 GRU-mod graph of r941_5mC
(flipflop_guppy_transitions, :450-489).  The conv stack runs
batch-major [B, T, C]; the recurrent stack runs time-major [T, B, H]
through the fused layer kernels (ops/rnn_cuda.py: K1 for LSTM, K7 for
GRU-mod), as the JAX package's
``_rnn_stack_fused_tm`` does: direction and per-read tail masking live
inside the kernel.

``train=True`` is the differentiable path (the JAX package's
``rnn_impl="train"``): the layers go through ops/rnn_vjp.py (K8 for
LSTM, K7 for GRU-mod, each with its adjoint) and the head's logZ through
``crf_partition_ad`` (K3 forward, K4 backward); the conv stack
differentiates through autograd.
"""

from __future__ import annotations

import torch

from ..ops.activations import ACTIVATIONS
from ..ops.conv import conv1d_same
from ..ops.heads import globalnorm_flipflop, globalnorm_runlengthV2
from ..ops.masking import mask_tail
from ..ops.rnn_cuda import grumod_layer_tm, lstm_layer_tm
from ..ops.rnn_vjp import grumod_layer_tm_ad, lstm_layer_tm_ad
from .config import ModelConfig


def ceil_div(a, b):
    return -((-a) // b)


# the fused layer kernel for each recurrent kind the port runs
LAYERS = {"lstm": lstm_layer_tm, "grumod": grumod_layer_tm}
# ... and its differentiable wrapper, for training
LAYERS_AD = {"lstm": lstm_layer_tm_ad, "grumod": grumod_layer_tm_ad}


HEADS = ("flipflop", "runlengthV2")


def check_supported(cfg: ModelConfig) -> None:
    """Raise for a graph the port does not run yet (the V1 run-length
    head and the GRU / residual graphs: ROADMAP item 11)."""
    if cfg.head not in HEADS or any(r.kind not in LAYERS or r.residual for r in cfg.rnns):
        raise NotImplementedError(
            f"model {cfg.name!r}: the port runs the non-residual LSTM and GRU-mod "
            "graphs with the flip-flop or run-length V2 head only so far"
        )


def conv_stack(params, cfg: ModelConfig, x, lengths):
    """x: [B, T, 1] float32, lengths: [B] -> (y [B, T', C], lengths')."""
    for i, c in enumerate(cfg.convs):
        p = params[f"conv{i}"]
        x = conv1d_same(x, p["W"], p["b"], c.stride, lengths)
        x = ACTIVATIONS[c.activation](x)
        lengths = ceil_div(lengths, c.stride)
        # zero the padded tail: the reference zero-pads past the read
        # end, so the next conv/affine must see zeros there too
        x = mask_tail(x, lengths)
    return x, lengths


def rnn_stack_tm(params, cfg: ModelConfig, x, lengths, train: bool = False):
    """[B, T, C] -> [B, T, H]: one fused kernel per layer, time-major
    in between (one transpose in, one out)."""
    layers = LAYERS_AD if train else LAYERS
    x_tm = x.transpose(0, 1).contiguous()
    for i, r in enumerate(cfg.rnns):
        p = params[f"rnn{i}"]
        x_tm = layers[r.kind](x_tm, p["iW"], p["b"], p["sW"],
                              backward=r.backward, lengths=lengths)
    return x_tm.transpose(0, 1)


def transitions(params, cfg: ModelConfig, signal, lengths, temperature=1.0,
                return_norm: bool = False, train: bool = False):
    """signal: [B, T] or [B, T, 1] normalised signal (zero-padded),
    lengths: [B] int32 valid sample counts.

    Returns (trans [B, ceil(T/stride), out_dim], nblocks [B]); the head
    is picked by ``cfg.head``.  With ``return_norm`` (flip-flop head
    only) additionally the per-read global-norm shift [B] and the
    per-block partition increments [B, T'] used to stitch exact viterbi
    scores across chunks.  ``train`` (flip-flop head only) selects the
    differentiable layers and partition (module docstring).
    """
    check_supported(cfg)
    if cfg.head != "flipflop" and (return_norm or train):
        raise ValueError("transitions: return_norm and train need the flip-flop head")
    if signal.dim() == 2:
        signal = signal[..., None]
    signal = signal.to(torch.float32)
    # zero beyond each read's end: valid outputs must not depend on
    # whatever the caller left in the padded tail
    signal = mask_tail(signal, lengths)
    x, nblocks = conv_stack(params, cfg, signal, lengths)
    x = rnn_stack_tm(params, cfg, x, nblocks, train)
    W, b = params["ff"]["W"], params["ff"]["b"]
    if cfg.head == "runlengthV2":
        return globalnorm_runlengthV2(x, W, b, temperature, nblocks, cfg.nbase), nblocks
    if return_norm:
        out, shift, incs = globalnorm_flipflop(
            x, W, b, temperature, nblocks, cfg.nbase, return_norm=True, train=train)
        return out, nblocks, shift, incs
    return globalnorm_flipflop(x, W, b, temperature, nblocks, cfg.nbase, train=train), nblocks
