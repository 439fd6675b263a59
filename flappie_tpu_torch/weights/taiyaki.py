"""Taiyaki / torch checkpoint conversion.

The reference's weights originate from ONT's taiyaki training stack;
its exporters (misc/taiyaki_flipflop5_guppy.py, taiyaki_flipflop_guppy.py)
read pickled taiyaki models.  Unpickling those requires the taiyaki
package (not available here), but the tensor layout is plain torch:

- conv:  ``conv.weight`` [nfilter, nf, winlen], ``conv.bias`` [nfilter]
- LSTM:  ``lstm.weight_ih_l0`` [4H, in] (gate order i,f,g,o =
  update,forget,candidate,output), ``weight_hh_l0`` [4H, H],
  ``bias_ih_l0`` [4H]
- GRU:   cudnn order (r,z,h) - reordered to guppy order (z,r,h) by
  ``_cudnn_to_guppy_gru``, reproduced here
- linear head: ``linear.weight`` [out, H], ``linear.bias`` [out]

``convert_state_dict`` maps a flat {name: array} state dict (e.g. from
``torch.load(..., map_location='cpu')['model_state_dict']`` or a
taiyaki params dump) into the package layout, applying the exporters'
transforms: optional x1.4826 MAD scale on the first conv
(taiyaki_flipflop5_guppy.py:89-91) and GRU gate reordering
(taiyaki_flipflop_guppy.py print_gru).

A copy of flappie_tpu/weights/taiyaki.py (numpy; ``torch.load`` on the
CPU for a checkpoint file; the port imports nothing of the JAX package).
"""

from __future__ import annotations

import re
from typing import Dict, Mapping

import numpy as np

from ..models.config import ModelConfig
from ..models.params import Params, param_shapes, unflatten

MAD_SCALE = 1.4826


def cudnn_to_guppy_gru(x: np.ndarray) -> np.ndarray:
    """Reorder cudnn GRU gates (r, z, h) -> guppy order (z, r, h).

    Mirrors taiyaki.layers._cudnn_to_guppy_gru as used by
    misc/taiyaki_flipflop_guppy.py:68-74.
    """
    G = x.shape[0] // 3
    r, z, h = x[:G], x[G : 2 * G], x[2 * G :]
    return np.concatenate([z, r, h], axis=0)


def convert_state_dict(
    state: Mapping[str, np.ndarray],
    cfg: ModelConfig,
    scale_first_conv: bool = False,
    gru_cudnn_order: bool = True,
) -> Params:
    """Map a torch-style state dict onto ``cfg``'s parameter layout.

    Conv layers are discovered by scanning ``*.conv.weight`` keys in
    sublayer order (real taiyaki checkpoints keep a leading
    parameterless DeltaSample layer, so the conv sublayer indices start
    at 1 — the exporter strips it at misc/taiyaki_flipflop5_guppy.py:
    111-113 but the *state dict* still numbers around it); ``conv{i}``
    style names are a fallback.  Recurrent layers are the
    ``weight_ih_l0`` keys in sublayer order (backward layers sit under
    a Reverse wrapper's ``.layer.`` prefix, which sorts the same).
    ``bias_hh_l0`` keys are ignored exactly as the exporter ignores
    them (print_lstm reads bias_ih_l0 only).

    ``scale_first_conv`` mirrors the exporter's ``--scale`` flag, which
    multiplies EVERY conv weight by 1.4826
    (misc/taiyaki_flipflop5_guppy.py:86-95 — print_convolution is
    called with scale=args.scale for all three convs).
    """
    keys = list(state.keys())

    def find(patterns):
        for p in patterns:
            rx = re.compile(p)
            for k in keys:
                if rx.search(k):
                    return k
        raise KeyError(f"no state-dict key matching any of {patterns}")

    def sublayer_index(k):
        nums = re.findall(r"\d+", k)
        return int(nums[0]) if nums else 0

    flat: Dict[str, np.ndarray] = {}
    conv_keys = sorted(
        (k for k in keys if re.search(r"(^|\.)conv\.weight$", k)),
        key=sublayer_index,
    )
    for i, c in enumerate(cfg.convs):
        if i < len(conv_keys):
            wkey = conv_keys[i]
        else:
            wkey = find([rf"conv{i+1}\D*\.weight$"])
        W = np.asarray(state[wkey], dtype=np.float32)  # [nfilter, nf, winlen]
        if scale_first_conv:
            W = W * np.float32(MAD_SCALE)
        flat[f"conv{i}/W"] = W.transpose(2, 1, 0).copy()
        flat[f"conv{i}/b"] = np.asarray(
            state[wkey.replace("weight", "bias")], dtype=np.float32
        ).reshape(-1)

    # recurrent layers appear in graph order after the convs
    ih_keys = [k for k in keys if k.endswith("weight_ih_l0")]

    def layer_index(k):
        nums = re.findall(r"\d+", k)
        return int(nums[0]) if nums else 0

    ih_keys.sort(key=layer_index)
    if len(ih_keys) < len(cfg.rnns):
        raise KeyError(
            f"found {len(ih_keys)} recurrent layers in state dict, "
            f"need {len(cfg.rnns)}"
        )
    for i, r in enumerate(cfg.rnns):
        base = ih_keys[i][: -len("weight_ih_l0")]
        iW = np.asarray(state[base + "weight_ih_l0"], dtype=np.float32)
        sW = np.asarray(state[base + "weight_hh_l0"], dtype=np.float32)
        b = np.asarray(state[base + "bias_ih_l0"], dtype=np.float32).reshape(-1)
        if r.kind == "grumod" and gru_cudnn_order:
            iW, sW, b = (cudnn_to_guppy_gru(x) for x in (iW, sW, b))
        flat[f"rnn{i}/iW"] = iW.T.copy()
        flat[f"rnn{i}/sW"] = sW.T.copy()
        flat[f"rnn{i}/b"] = b

    wkey = find([r"linear\.weight$", r"FF.*weight$", r"fc\.weight$"])
    flat["ff/W"] = np.asarray(state[wkey], dtype=np.float32).T.copy()
    flat["ff/b"] = np.asarray(
        state[wkey.replace("weight", "bias")], dtype=np.float32
    ).reshape(-1)

    params = unflatten(flat)
    # shape check against the config
    for k, shp in param_shapes(cfg).items():
        layer, part = k.rsplit("/", 1)
        got = tuple(params[layer][part].shape)
        if got != shp:
            raise ValueError(f"{k}: converted shape {got} != expected {shp}")
    return params


def load_torch_checkpoint(path: str):
    """Load a torch checkpoint file to a flat numpy state dict."""
    import torch

    obj = torch.load(path, map_location="cpu", weights_only=False)
    if hasattr(obj, "state_dict"):
        obj = obj.state_dict()
    for key in ("model_state_dict", "state_dict", "model"):
        if isinstance(obj, dict) and key in obj and isinstance(obj[key], dict):
            obj = obj[key]
    return {k: np.asarray(v.detach().cpu().numpy() if hasattr(v, "detach") else v)
            for k, v in obj.items()}
