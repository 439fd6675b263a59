"""Batched forward graph: raw signal -> CRF transition weights.

Counterpart of flappie_tpu/models/network.py:207 ``transitions``: the
stride-5 LSTM graph of r941_native, r941_rna002 and r103_native
(reference flipflop5_guppy_transitions, src/networks.c:539-586) and of
the run-length model rle_r941_native (runlength5_guppy, :675-722, head
runlengthV2), the stride-2 GRU-mod graph of r941_5mC
(flipflop_guppy_transitions, :450-489), and the sloika-era graphs that
weights/sloika.py converts: five residual 2-matrix GRUs under the
flip-flop head (flipflop_gru_transitions, :403-448), five GRU-mods under
the flip-flop head (:450-489) or the V1 run-length head
(runlength_guppy_transitions, :589-630).

The conv stack follows ``FLAPPIE_TPU_CONV_IMPL``, read at call time as
in the JAX package: ``xla`` (``auto``; batch-major [B, T, C] through
``F.conv1d``), ``fast`` (channels-major [B, C, T] shifted-slice convs and
one strided im2col product) or ``pallas`` (``fast`` with the two leading
stride-1 swish convs as one kernel, K10 in ops/conv_cuda.py).

By default (``rnn_impl="auto"``) a stack of LSTM and GRU-mod layers
none of which is residual runs time-major [T, B, H] through the fused
layer kernels (ops/rnn_cuda.py: K1 for LSTM, K7 for GRU-mod), as the
JAX package's ``_rnn_stack_fused_tm`` does: direction and per-read tail
masking live inside the kernel.  Any other stack (sloika GRUs, residual
layers), and every stack under ``rnn_impl="scan"``, takes the JAX
package's layer-by-layer ``rnn_stack``: affine, per-read reversal for
backward layers, the recurrence alone (K12: ``lstm_seq_cuda`` /
``grumod_seq_cuda``; ``gru_seq`` / ``gru_relu_seq``, plain time loops
as JAX's are scans), reversal back, the residual add, tail mask.

The bf16 stream (``stream=torch.bfloat16``, the CLIs' ``--fast``;
``None`` reads FLAPPIE_TPU_RNN_STREAM, ops/precision.py): the fused stack
casts its input to bf16 before layer 1, each layer (K1-bf16, K7-bf16)
hands the next its bf16 output, and the result is cast back to f32 for
the head (flappie_tpu/models/network.py:171-172).  The layer-by-layer
stack ignores the stream, as the JAX package's does.

``train=True`` is the differentiable path (the JAX package's
``rnn_impl="train"``): the layers go through ops/rnn_vjp.py (K8 for
LSTM, K7 for GRU-mod, each with its adjoint) and the head's logZ through
``crf_partition_ad`` (K3 forward, K4 backward); the conv stack
differentiates through autograd.  Under the bf16 stream the first layer
takes the f32 x and rounds it itself (K8-bf16 or K7-bf16), as JAX's
``_rnn_stack_fused_tm`` passes f32 into ``_run_fused``, so its residual
and its dx stay f32; the trained iW stays f32 (``stream_params`` is for
inference only).

The precision levels (ops/precision.py) are resolved for each tensor's
device where its product runs: the layers, ``ops/rnn.py affine`` and the
convs; on the CPU every level is true f32.

A data replica's tree from parallel/mesh.py ``shard_params`` runs as a
plain one: each ``rnn*`` layer and the ``ff`` head read their leaves
through ``whole``, which gathers a model-sharded leaf on the layer's
device for that layer alone, so the kernels see the tensors they see on
one device.
"""

from __future__ import annotations

import os

import torch

from ..ops.activations import ACTIVATIONS
from ..ops.conv import conv1d_same, conv1d_same_ct, conv1d_strided_ct
from ..ops.conv_cuda import conv12_fused
from ..ops.heads import globalnorm_flipflop, globalnorm_runlength, globalnorm_runlengthV2
from ..ops import precision
from ..ops.masking import mask_tail, reverse_sequence
from ..ops.rnn import affine, gru_relu_seq, gru_seq
from ..ops.rnn_cuda import grumod_layer_tm, grumod_seq_cuda, lstm_layer_tm, lstm_seq_cuda
from ..ops.rnn_vjp import grumod_layer_tm_ad, lstm_layer_tm_ad
from ..parallel.mesh import whole
from .config import ModelConfig


def ceil_div(a, b):
    return -((-a) // b)


# the fused layer kernel for each recurrent kind the port runs
LAYERS = {"lstm": lstm_layer_tm, "grumod": grumod_layer_tm}
# ... and its differentiable wrapper, for training
LAYERS_AD = {"lstm": lstm_layer_tm_ad, "grumod": grumod_layer_tm_ad}
# the recurrence alone over a computed affine, for the layer-by-layer stack:
# K12 for LSTM and GRU-mod, plain time loops for the sloika GRUs (which take
# sW2 as well)
SEQS = {"lstm": lstm_seq_cuda, "grumod": grumod_seq_cuda, "gru": gru_seq,
        "gru_relu": gru_relu_seq}

HEADS = ("flipflop", "runlengthV2", "runlength")
RNN_IMPLS = ("auto", "scan")


def check_supported(cfg: ModelConfig, rnn_impl: str = "auto") -> None:
    """Raise for an ``rnn_impl``, a recurrent kind or a head the port
    does not know."""
    if rnn_impl not in RNN_IMPLS:
        raise ValueError(f"rnn_impl must be one of {RNN_IMPLS}, got {rnn_impl!r}")
    for r in cfg.rnns:
        if r.kind not in SEQS:
            raise ValueError(f"model {cfg.name!r}: unknown rnn kind {r.kind!r}")
    if cfg.head not in HEADS:
        raise ValueError(f"model {cfg.name!r}: unknown head {cfg.head!r}")


def fused(cfg: ModelConfig) -> bool:
    """Whether ``rnn_impl="auto"`` runs the fused time-major stack: every
    layer an LSTM or a GRU-mod and none residual
    (flappie_tpu/models/network.py:177-180)."""
    return all(r.kind in LAYERS and not r.residual for r in cfg.rnns)


def _conv_impl() -> str:
    """FLAPPIE_TPU_CONV_IMPL at call time: ``xla`` (``auto``), ``fast``
    or ``pallas`` (flappie_tpu/models/network.py:42)."""
    return os.environ.get("FLAPPIE_TPU_CONV_IMPL", "auto").replace("auto", "xla")


def _conv_stack_fast(params, cfg: ModelConfig, x, lengths, fuse12: bool = False):
    """Channels-major conv stack (flappie_tpu/models/network.py:59):
    stride-1 layers stay [B, C, T], the strided layer emits the recurrent
    stack's [B, T', C].  With ``fuse12`` (impl ``pallas``) the two leading
    stride-1 swish convs of the stride-5 family run as K10."""
    if (
        fuse12
        and len(cfg.convs) == 3
        and cfg.convs[0].stride == 1
        and cfg.convs[1].stride == 1
        and cfg.convs[0].activation == cfg.convs[1].activation == "swish"
        and cfg.convs[0].winlen == cfg.convs[1].winlen == 5
        and (cfg.convs[0].in_ch, cfg.convs[0].out_ch, cfg.convs[1].out_ch)
        == (1, 4, 16)
    ):
        y2 = conv12_fused(
            x[..., 0],
            params["conv0"]["W"], params["conv0"]["b"],
            params["conv1"]["W"], params["conv1"]["b"],
            lengths,
        )  # [B, 16, T] masked
        c3 = cfg.convs[2]
        y = ACTIVATIONS[c3.activation](
            conv1d_strided_ct(y2, params["conv2"]["W"], params["conv2"]["b"],
                              c3.stride, lengths)
        )
        lengths = ceil_div(lengths, c3.stride)
        return mask_tail(y, lengths), lengths

    xc = x.transpose(1, 2)  # [B, C=1, T]
    for i, c in enumerate(cfg.convs):
        W = params[f"conv{i}"]["W"]
        b = params[f"conv{i}"]["b"]
        act = ACTIVATIONS[c.activation]
        if c.stride == 1:
            y = act(conv1d_same_ct(xc, W, b))
            # zero the padded tail (t >= length) in channels-major
            m = torch.arange(y.shape[-1], device=y.device)[None, None, :] < lengths[:, None, None]
            xc = torch.where(m, y, 0.0)
        else:
            y = act(conv1d_strided_ct(xc, W, b, c.stride, lengths))
            lengths = ceil_div(lengths, c.stride)
            y = mask_tail(y, lengths)
            if i != len(cfg.convs) - 1:  # a later stride-1 conv follows
                xc = y.transpose(1, 2)
            else:
                return y, lengths
    return xc.transpose(1, 2), lengths


def conv_stack(params, cfg: ModelConfig, x, lengths):
    """x: [B, T, 1] float32, lengths: [B] -> (y [B, T', C], lengths');
    the implementation is ``FLAPPIE_TPU_CONV_IMPL``'s (module docstring):
    ``fast`` and ``pallas`` apply when the last conv is strided."""
    impl = _conv_impl()
    if impl in ("fast", "pallas") and cfg.convs[-1].stride > 1:
        return _conv_stack_fast(params, cfg, x, lengths, fuse12=(impl == "pallas"))
    for i, c in enumerate(cfg.convs):
        p = params[f"conv{i}"]
        x = conv1d_same(x, p["W"], p["b"], c.stride, lengths)
        x = ACTIVATIONS[c.activation](x)
        lengths = ceil_div(lengths, c.stride)
        # zero the padded tail: the reference zero-pads past the read
        # end, so the next conv/affine must see zeros there too
        x = mask_tail(x, lengths)
    return x, lengths


def rnn_stack_tm(params, cfg: ModelConfig, x, lengths, train: bool = False,
                 stream=torch.float32):
    """[B, T, C] -> [B, T, H]: one fused kernel per layer, time-major
    in between (one transpose in, one out).  ``stream`` bf16: the input
    cast to bf16 before layer 1 (under ``train`` the first layer takes it
    in f32 and rounds it itself), the layers' bf16 outputs passed on, the
    result cast back to f32."""
    x_tm = x.transpose(0, 1).contiguous()
    if stream == torch.bfloat16 and not train:
        x_tm = x_tm.to(stream)
    for i, r in enumerate(cfg.rnns):
        p = whole(params[f"rnn{i}"], x_tm.device)
        if train:
            x_tm = LAYERS_AD[r.kind](x_tm, p["iW"], p["b"], p["sW"], backward=r.backward,
                                     lengths=lengths, stream=stream)
        else:
            x_tm = LAYERS[r.kind](x_tm, p["iW"], p["b"], p["sW"], backward=r.backward,
                                  lengths=lengths)
    return x_tm.transpose(0, 1).to(torch.float32)


def stream_params(params, cfg: ModelConfig, stream, rnn_impl: str = "auto"):
    """``params`` with each fused layer's iW rounded to bf16 once, when
    the bf16 stream runs the fused stack (else ``params`` itself), so
    that no call rounds it again."""
    if precision.check_stream(stream) != torch.bfloat16 or not (
            rnn_impl == "auto" and fused(cfg)):
        return params
    out = dict(params)
    for i in range(len(cfg.rnns)):
        out[f"rnn{i}"] = {**params[f"rnn{i}"],
                          "iW": params[f"rnn{i}"]["iW"].to(torch.bfloat16)}
    return out


def rnn_stack(params, cfg: ModelConfig, x, lengths):
    """[B, T, C] -> [B, T, H] layer by layer, batch-major
    (flappie_tpu/models/network.py:175-204 with ``rnn_impl="scan"``):
    affine, per-read reversal for backward layers, the recurrence alone
    (K12 on the card, the plain scan on the CPU), reversal back, the
    residual add, tail mask."""
    for i, r in enumerate(cfg.rnns):
        p = whole(params[f"rnn{i}"], x.device)
        xa = affine(x, p["iW"], p["b"])
        if r.backward:
            xa = reverse_sequence(xa, lengths)
        if r.kind in ("gru", "gru_relu"):
            y = SEQS[r.kind](xa, p["sW"], p["sW2"])
        else:
            y = SEQS[r.kind](xa, p["sW"])
        if r.backward:
            y = reverse_sequence(y, lengths)
        if r.residual:
            # residual_inplace (src/layers.c:338-354): the layer's input
            # added onto the recurrence output, as in the sloika graphs
            # (src/networks.c:415,421,427,433,439)
            y = y + x
        x = mask_tail(y, lengths)
    return x


def transitions(params, cfg: ModelConfig, signal, lengths, temperature=1.0,
                return_norm: bool = False, train: bool = False, rnn_impl: str = "auto",
                stream=None):
    """signal: [B, T] or [B, T, 1] normalised signal (zero-padded),
    lengths: [B] int32 valid sample counts.

    Returns (trans [B, ceil(T/stride), out_dim], nblocks [B]); the head
    is picked by ``cfg.head``.  With ``return_norm`` (flip-flop head
    only) additionally the per-read global-norm shift [B] and the
    per-block partition increments [B, T'] used to stitch exact viterbi
    scores across chunks.  ``train`` (flip-flop head only) selects the
    differentiable layers and partition (module docstring); ``rnn_impl``
    ``"auto"`` the fused layer kernels where the stack allows them
    (``fused``) and the layer-by-layer stack elsewhere, ``"scan"`` the
    layer-by-layer stack always (inference only: K12 has no adjoint).
    ``stream``: the fused stack's stream dtype, torch.float32 or
    torch.bfloat16 (None: FLAPPIE_TPU_RNN_STREAM), for inference and
    ``train`` alike; the layer-by-layer stack ignores it.  The precision
    levels (ops/precision.py) are resolved for the signal's device by the
    products themselves.
    """
    check_supported(cfg, rnn_impl)
    stream = precision.check_stream(stream)
    if cfg.head != "flipflop" and (return_norm or train):
        raise ValueError("transitions: return_norm and train need the flip-flop head")
    if train and not (rnn_impl == "auto" and fused(cfg)):
        raise ValueError("transitions: train runs the fused layers (rnn_impl='auto', "
                         "LSTM or GRU-mod layers, none residual)")
    if signal.dim() == 2:
        signal = signal[..., None]
    signal = signal.to(torch.float32)
    # zero beyond each read's end: valid outputs must not depend on
    # whatever the caller left in the padded tail
    signal = mask_tail(signal, lengths)
    x, nblocks = conv_stack(params, cfg, signal, lengths)
    if rnn_impl == "auto" and fused(cfg):
        x = rnn_stack_tm(params, cfg, x, nblocks, train, stream)
    else:
        x = rnn_stack(params, cfg, x, nblocks)
    ff = whole(params["ff"], x.device)
    W, b = ff["W"], ff["b"]
    if cfg.head == "runlengthV2":
        return globalnorm_runlengthV2(x, W, b, temperature, nblocks, cfg.nbase), nblocks
    if cfg.head == "runlength":
        return globalnorm_runlength(x, W, b, temperature, nblocks, cfg.nbase), nblocks
    if return_norm:
        out, shift, incs = globalnorm_flipflop(
            x, W, b, temperature, nblocks, cfg.nbase, return_norm=True, train=train)
        return out, nblocks, shift, incs
    return globalnorm_flipflop(x, W, b, temperature, nblocks, cfg.nbase, train=train), nblocks
