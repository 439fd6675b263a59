"""Model parameter trees: creation, (de)serialisation, synthesis.

A copy of the JAX package's params module (the port imports nothing of
that package); ``params_to_torch`` is the port's own addition.

Layouts are TPU-natural (dense, unpadded, [in, out] matmul-ready):

- conv layer i:  ``conv{i}/W`` [winlen, in_ch, out_ch], ``conv{i}/b`` [out_ch]
- rnn layer i:   ``rnn{i}/iW`` [in, G*H], ``rnn{i}/sW`` [H, G*H],
                 ``rnn{i}/b`` [G*H]   (G = 4 for lstm, 3 for grumod)
- output head:   ``ff/W`` [H, out_dim], ``ff/b`` [out_dim]

Gate order follows the reference exactly: LSTM [update, forget,
candidate, output] (src/layers.c:1014-1025), GRU-mod [z, r, hbar]
(src/layers.c:664-715).

The reference compiles weights into the binary as column-major
SSE-padded C arrays (src/models/*.h, generated by
misc/taiyaki_flipflop5_guppy.py); ``flappie_tpu.weights`` converts that
format (and synthesises checkpoints when, as in this checkout, the
blobs are git-LFS pointers).
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from .config import ModelConfig

Params = Dict[str, dict]

RNN_GATES = {"lstm": 4, "grumod": 3, "gru": 3, "gru_relu": 3}


def rnn_in_dim(cfg: ModelConfig, i: int) -> int:
    return cfg.convs[-1].out_ch if i == 0 else cfg.rnns[i - 1].size


def param_shapes(cfg: ModelConfig) -> Dict[str, tuple]:
    shapes = {}
    for i, c in enumerate(cfg.convs):
        shapes[f"conv{i}/W"] = (c.winlen, c.in_ch, c.out_ch)
        shapes[f"conv{i}/b"] = (c.out_ch,)
    for i, r in enumerate(cfg.rnns):
        g = RNN_GATES[r.kind]
        d_in = rnn_in_dim(cfg, i)
        shapes[f"rnn{i}/iW"] = (d_in, g * r.size)
        shapes[f"rnn{i}/sW"] = (r.size, g * r.size)
        if r.kind == "gru":
            # sloika GRU: sW [H,2H] for z,r + sW2 [H,H] for candidate
            shapes[f"rnn{i}/sW"] = (r.size, 2 * r.size)
            shapes[f"rnn{i}/sW2"] = (r.size, r.size)
        shapes[f"rnn{i}/b"] = (g * r.size,)
    h = cfg.rnns[-1].size if cfg.rnns else cfg.convs[-1].out_ch
    shapes["ff/W"] = (h, cfg.out_dim)
    shapes["ff/b"] = (cfg.out_dim,)
    return shapes


def init_synthetic(cfg: ModelConfig, seed: int = 0) -> Params:
    """Random but stable weights with realistic dynamics.

    Used because the reference checkpoints are git-LFS pointers in this
    checkout.  Scaled so activations neither saturate nor vanish and
    basecalls are non-degenerate.
    """
    rng = np.random.default_rng(seed)
    flat = {}
    for k, shp in param_shapes(cfg).items():
        if k.endswith("/b"):
            flat[k] = np.zeros(shp, dtype=np.float32)
        else:
            fan_in = int(np.prod(shp[:-1]))
            scale = 1.0 / np.sqrt(max(fan_in, 1))
            flat[k] = rng.normal(0.0, scale, size=shp).astype(np.float32)
    # Bias LSTM forget gates positive for stable (non-chaotic) dynamics
    for i, r in enumerate(cfg.rnns):
        if r.kind == "lstm":
            b = flat[f"rnn{i}/b"]
            H = r.size
            b[H : 2 * H] = 1.0
    return unflatten(flat)


def flatten(params: Params) -> Dict[str, np.ndarray]:
    out = {}
    for layer, d in params.items():
        for k, v in d.items():
            out[f"{layer}/{k}"] = np.asarray(v)
    return out


def unflatten(flat: Dict[str, np.ndarray]) -> Params:
    out: Params = {}
    for key, v in flat.items():
        layer, k = key.rsplit("/", 1)
        out.setdefault(layer, {})[k] = np.asarray(v, dtype=np.float32)
    return out


def save_npz(path: str, params: Params, cfg: ModelConfig | None = None) -> None:
    flat = {k: np.asarray(v) for k, v in flatten(params).items()}
    if cfg is not None:
        flat["__model_name__"] = np.array(cfg.name)
    np.savez(path, **flat)


def load_npz(path: str) -> Params:
    with np.load(path, allow_pickle=False) as z:
        flat = {k: z[k] for k in z.files if not k.startswith("__")}
    return unflatten(flat)


def params_to_torch(params: Params, device) -> Dict[str, dict]:
    """numpy parameter tree (this module's layout, which is also the
    JAX package's) -> the same tree of float32 tensors on ``device``.
    This is how weights cross from either package into the port."""
    import torch

    return {
        layer: {
            k: torch.as_tensor(np.asarray(v, np.float32)).to(device).contiguous()
            for k, v in d.items()
        }
        for layer, d in params.items()
    }


def validate(params: Params, cfg: ModelConfig) -> None:
    shapes = param_shapes(cfg)
    flat = flatten(params)
    missing = set(shapes) - set(flat)
    if missing:
        raise ValueError(f"checkpoint missing arrays: {sorted(missing)}")
    for k, shp in shapes.items():
        got = tuple(flat[k].shape)
        if got != shp:
            raise ValueError(f"{k}: shape {got}, expected {shp}")
