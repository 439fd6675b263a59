"""Parser for the reference's compiled-in weight headers (.h/.mdl).

The reference ships weights as C headers of hex-float arrays plus
``_Mat`` struct literals and ``#define <layer>stride N`` constants
(src/models/*.mdl, generated by misc/taiyaki_flipflop5_guppy.py and
friends; included at src/networks.c:10-14).  This module parses that
format back into the package's npz pytree layout, so real reference
weights drop straight in when available (the blobs in this source tree
are git-LFS pointers, so tests round-trip through our emitter instead).

Layout conversions (see misc/taiyaki_flipflop5_guppy.py:28-99):
- cformatM writes one *torch row* per flappie column, each padded to a
  multiple of 4 floats -> parsed array is the torch-layout matrix.
- LSTM/GRU iW is torch [G*H, in], sW [G*H, H]; ours are transposed.
  Gate order is already guppy order in the header (the exporter applies
  _cudnn_to_guppy_gru for GRUs; cudnn LSTM order i,f,g,o equals the
  reference's update,forget,candidate,output).
- conv W rows interleave winlen windows of nf features each padded to
  nf2 = 4*ceil(nf/4): row[w*nf2 + f], except the final window is
  unpadded (nr = nf2*winlen - nf2 + nf).
- FF W is torch [out, H]; ours [H, out].

A copy of flappie_tpu/weights/header_parser.py (numpy only; the port
imports nothing of the JAX package).
"""

from __future__ import annotations

import math
import re
from typing import Dict, Tuple

import numpy as np

from ..models.config import ConvSpec, ModelConfig, RnnSpec, head_nparam
from ..models.params import Params, unflatten

_ARRAY_RE = re.compile(
    r"float\s+__(\w+)\s*\[\]\s*=\s*\{(.*?)\};", re.DOTALL
)
_MAT_RE = re.compile(
    r"_Mat\s+_(\w+)\s*=\s*\{\s*"
    r"\.nr\s*=\s*(\d+)\s*,\s*"
    r"\.nrq\s*=\s*(\d+)\s*,\s*"
    r"\.nc\s*=\s*(\d+)\s*,\s*"
    r"\.stride\s*=\s*(\d+)\s*,\s*"
    r"\.data\.f\s*=\s*__(\w+)\s*\}",
    re.DOTALL,
)
_DEFINE_RE = re.compile(r"#define\s+(\w+?)stride\s+(\d+)")


def parse_model_header(text: str) -> Tuple[Dict[str, np.ndarray], Dict[str, int]]:
    """Parse header text -> ({matrix name: [nc, nr] float32}, {conv name: stride}).

    Matrices come out in torch layout (one header column per array row),
    padding stripped.
    """
    raw: Dict[str, np.ndarray] = {}
    for m in _ARRAY_RE.finditer(text):
        name, body = m.group(1), m.group(2)
        vals = [float.fromhex(tok) for tok in re.split(r"[,\s]+", body.strip()) if tok]
        raw[name] = np.asarray(vals, dtype=np.float32)

    mats: Dict[str, np.ndarray] = {}
    for m in _MAT_RE.finditer(text):
        name = m.group(1)
        nr, nrq, nc, stride = (int(m.group(i)) for i in range(2, 6))
        data_name = m.group(6)
        data = raw[data_name]
        # Each column occupies ceil(nr/4)*4 floats in the emitted text
        # (cformatM pads per column); the declared stride can disagree
        # for interleave-padded conv rows - trust the data length.
        percol = data.size // nc
        mat = data[: percol * nc].reshape(nc, percol)[:, :nr]
        mats[name] = mat

    strides = {m.group(1): int(m.group(2)) for m in _DEFINE_RE.finditer(text)}
    return mats, strides


def _deinterleave_conv(row_mat: np.ndarray, winlen: int, nf: int) -> np.ndarray:
    """[nfilter, nr] interleaved conv rows -> [winlen, nf, nfilter]."""
    nfilter, nr = row_mat.shape
    nf2 = 4 * math.ceil(nf / 4)
    expect = nf2 * winlen - nf2 + nf
    W = np.zeros((winlen, nf, nfilter), dtype=np.float32)
    for w in range(winlen):
        off = w * nf2
        width = nf if off + nf <= nr else nr - off
        W[w, :width] = row_mat[:, off : off + width].T
    return W


def _conv_dims_from_row(nr: int, in_ch: int) -> int:
    """Infer winlen from the padded row length for a known in_ch."""
    nf2 = 4 * math.ceil(in_ch / 4)
    # nr = nf2*winlen - nf2 + in_ch
    winlen = (nr - in_ch) // nf2 + 1
    if nf2 * winlen - nf2 + in_ch != nr:
        raise ValueError(f"cannot infer winlen from nr={nr}, in_ch={in_ch}")
    return winlen


_LAYER_RE = re.compile(r"^(conv\d*|lstm[BF]\d|gru[BF]\d|FF)_(.*?)_?(iW|sW|sW2|W|b)$")


def _layer_key(name: str):
    m = _LAYER_RE.match(name)
    if not m:
        return None
    return m.group(1), m.group(3)


def convert_reference_header(text: str) -> Tuple[ModelConfig, Params]:
    """Parse a reference model header into (ModelConfig, params).

    Dimensions (channels, hidden size, window lengths, strides, nbase)
    are derived from the arrays, as the C code derives nbase at runtime
    (src/layers.c:1029).
    """
    mats, strides = parse_model_header(text)

    by_layer: Dict[str, Dict[str, np.ndarray]] = {}
    stride_by_layer: Dict[str, int] = {}
    for name, mat in mats.items():
        lk = _layer_key(name)
        if lk is None:
            continue
        layer, part = lk
        by_layer.setdefault(layer, {})[part] = mat
    for name, s in strides.items():
        lk = _layer_key(name + "W")  # define names lack the W suffix
        if lk:
            stride_by_layer[lk[0]] = s

    conv_names = sorted(k for k in by_layer if k.startswith("conv"))
    rnn_names = sorted(
        (k for k in by_layer if k[:4] in ("lstm", "gruB", "gruF")),
        key=lambda k: int(k[-1]),
    )

    flat: Dict[str, np.ndarray] = {}
    convs = []
    in_ch = 1
    for i, cname in enumerate(conv_names):
        d = by_layer[cname]
        row_mat = d["W"]  # [nfilter, nr]
        nfilter = row_mat.shape[0]
        winlen = _conv_dims_from_row(row_mat.shape[1], in_ch)
        W = _deinterleave_conv(row_mat, winlen, in_ch)
        stride = stride_by_layer.get(cname, 1)
        convs.append(
            ConvSpec(winlen=winlen, in_ch=in_ch, out_ch=nfilter, stride=stride,
                     activation="swish" if len(conv_names) > 1 else "tanh")
        )
        flat[f"conv{i}/W"] = W
        flat[f"conv{i}/b"] = d["b"].reshape(-1)
        in_ch = nfilter

    rnns = []
    for i, rname in enumerate(rnn_names):
        d = by_layer[rname]
        kind = "lstm" if rname.startswith("lstm") else "grumod"
        backward = rname[-2] == "B" if len(rname) >= 2 else False
        gh, h = d["sW"].shape
        size = h
        rnns.append(RnnSpec(kind, size, backward))
        flat[f"rnn{i}/iW"] = d["iW"].T.copy()
        flat[f"rnn{i}/sW"] = d["sW"].T.copy()
        flat[f"rnn{i}/b"] = d["b"].reshape(-1)

    ff = by_layer["FF"]
    flat["ff/W"] = ff["W"].T.copy()
    flat["ff/b"] = ff["b"].reshape(-1)
    out_dim = flat["ff/b"].size

    # Derive head/nbase from the output width
    if out_dim in (40, 60):
        # flipflop (40: nbase 4; 60: nbase 5) - note RLE V2 also has 40
        # params; header names disambiguate (rle exporters use the same
        # structure, caller may override the head)
        nbase = 4 if out_dim == 40 else 5
        head = "flipflop"
    elif out_dim == 16:
        nbase, head = 4, "runlength"
    else:
        raise ValueError(f"cannot infer head from out_dim={out_dim}")

    cfg = ModelConfig(
        name="converted",
        description="converted from reference header",
        convs=tuple(convs),
        rnns=tuple(rnns),
        head=head,
        nbase=nbase,
    )
    return cfg, unflatten(flat)


def config_from_arrays(cfg: ModelConfig, head: str) -> ModelConfig:
    """Override the head of a converted config (flipflop vs runlengthV2
    share out_dim 40)."""
    from dataclasses import replace

    return replace(cfg, head=head)
