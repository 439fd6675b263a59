"""Emitter: npz params -> reference-format C weight header.

The counterpart of header_parser: writes the exact format the
reference's exporters produce (misc/taiyaki_flipflop5_guppy.py:28-99,
hex-float arrays with per-column x4 padding, _Mat literals, stride
defines), so converted models can be compiled back into the C flappie,
and so the parser has a bit-exact roundtrip test without the LFS blobs.

A copy of flappie_tpu/weights/header_emit.py (numpy only; the port
imports nothing of the JAX package).
"""

from __future__ import annotations

import math
import re
from typing import List

import numpy as np

from ..models.config import ModelConfig
from ..models.params import Params

_TRIM = re.compile(r"0+p")


def _small_hex(f: float) -> str:
    return _TRIM.sub("p", float(f).hex())


def _format_mat(name: str, rows: np.ndarray, nr=None, nc=None) -> str:
    """rows: [n, m] - one emitted column per input row (cformatM)."""
    rows = np.asarray(rows, dtype=np.float32)
    nrq0 = math.ceil(rows.shape[1] / 4.0)
    pad = nrq0 * 4 - rows.shape[1]
    lines = [
        ", ".join([_small_hex(v) for v in row] + [_small_hex(0.0)] * pad)
        for row in rows
    ]
    if nr is None:
        nr, nrq = rows.shape[1], nrq0
    else:
        nrq = math.ceil(nr / 4.0)
    if nc is None:
        nc = rows.shape[0]
    out = [f"float __{name}[] = {{"]
    out.append("\t" + ",\n\t".join(lines))
    out.append("};")
    out.append(
        f"_Mat _{name} = {{\n\t.nr = {nr},\n\t.nrq = {nrq},\n\t.nc = {nc},"
        f"\n\t.stride = {nrq * 4},\n\t.data.f = __{name}\n}};"
    )
    out.append(f"const flappie_matrix {name} = &_{name};\n")
    return "\n".join(out)


def _format_vec(name: str, v: np.ndarray) -> str:
    v = np.asarray(v, dtype=np.float32).reshape(-1)
    nrq = math.ceil(v.size / 4.0)
    pad = nrq * 4 - v.size
    body = ", ".join([_small_hex(x) for x in v] + [_small_hex(0.0)] * pad)
    return (
        f"float __{name}[] = {{\n\t{body}}};\n"
        f"_Mat _{name} = {{\n\t.nr = {v.size},\n\t.nrq = {nrq},\n\t.nc = 1,"
        f"\n\t.stride = {nrq * 4},\n\t.data.f = __{name}\n}};\n"
        f"const flappie_matrix {name} = &_{name};\n"
    )


def _interleave_conv(W: np.ndarray) -> tuple[np.ndarray, int]:
    """[winlen, nf, nfilter] -> ([nfilter, nr] interleaved rows, nr)."""
    winlen, nf, nfilter = W.shape
    nf2 = 4 * math.ceil(nf / 4)
    nr = nf2 * winlen - nf2 + nf
    rows = np.zeros((nfilter, nr), dtype=np.float32)
    for w in range(winlen):
        off = w * nf2
        rows[:, off : off + nf] = W[w].T
    return rows, nr


def emit_model_header(
    cfg: ModelConfig, params: Params, modelid: str = "model", stem: str | None = None
) -> str:
    """Emit a reference-compatible weight header for this model.

    ``stem`` overrides the symbol stem; the reference uses
    ``rnnrf_flipflop5_<id>`` (3-conv flip-flop), ``rnnrf_flipflop_<id>``
    (1-conv GRU-mod) and ``rnnrf_rle5_<id>`` (run-length) stems
    (src/networks.c:218-399).
    """
    from ..models.params import flatten

    flat = flatten(params)
    if stem is None:
        stem = f"rnnrf_flipflop5_{modelid}" if len(cfg.convs) > 1 else f"rnnrf_flipflop_{modelid}"
    parts: List[str] = [
        "#pragma once",
        f"#ifndef FLIPFLOP_{modelid.upper()}_MODEL_H",
        f"#define FLIPFLOP_{modelid.upper()}_MODEL_H",
        '#include "../util.h"',
    ]
    for i, c in enumerate(cfg.convs):
        name = f"conv{i+1}_{stem}" if len(cfg.convs) > 1 else f"conv_{stem}"
        rows, nr = _interleave_conv(np.asarray(flat[f"conv{i}/W"]))
        parts.append(_format_mat(f"{name}_W", rows, nr=nr, nc=c.out_ch))
        parts.append(_format_vec(f"{name}_b", flat[f"conv{i}/b"]))
        parts.append(f"#define {name}_stride  {c.stride}")
        parts.append(f"#define {name}_nfilter  {c.out_ch}")
        parts.append(f"#define {name}_winlen  {c.winlen}")
    for i, r in enumerate(cfg.rnns):
        tag = ("lstm" if r.kind == "lstm" else "gru") + ("B" if r.backward else "F") + str(i + 1)
        name = f"{tag}_{stem}"
        parts.append(_format_mat(f"{name}_iW", np.asarray(flat[f"rnn{i}/iW"]).T))
        parts.append(_format_mat(f"{name}_sW", np.asarray(flat[f"rnn{i}/sW"]).T))
        parts.append(_format_vec(f"{name}_b", flat[f"rnn{i}/b"]))
    parts.append(_format_mat(f"FF_{stem}_W", np.asarray(flat["ff/W"]).T))
    parts.append(_format_vec(f"FF_{stem}_b", flat["ff/b"]))
    parts.append(f"#endif /* FLIPFLOP_{modelid.upper()}_MODEL_H */")
    return "\n".join(parts) + "\n"
