"""Random weights of a flip-flop configuration, made on the device from
the seed.

The parameter shapes and the init are a frozen copy of
flappie_tpu_torch/models/params.py (``param_shapes``,
``init_synthetic``): conv{i}/W [winlen, in, out], rnn{i}/iW [in, G*H],
rnn{i}/sW [H, G*H], ff/W [H, out] drawn N(0, 1/fan_in), biases zero but
the LSTM forget gates' at 1; gate orders LSTM [update, forget,
candidate, output], GRU-mod [z, r, hbar].  They are drawn in one call of
a generator on the device, in float32 (the served type).

Random weights call bases at a rate that depends on the draw (from 2 to
4.4 blocks a base at stride 5 over five draws), and the host's work
grows with the bases called (``path_to_basecall``, the records), so a
seed would change the amount of work.  ``calibrate`` shifts the head's
biases of the stay transitions by one constant so that the draw calls
the configuration's ``blocks_per_base``: the signal's 9 samples a base
over the model's stride, what a trained model calls on it.
"""

from __future__ import annotations

import os
from typing import Dict

import numpy as np

GATES = {"lstm": 4, "grumod": 3}


def nparam(widths: dict) -> int:
    """Flip-flop head outputs: 2 nbase (nbase + 1)."""
    nb = widths["nbase"]
    return 2 * nb * (nb + 1)


def shapes(widths: dict) -> Dict[str, tuple]:
    out = {}
    for i, c in enumerate(widths["convs"]):
        out[f"conv{i}/W"] = (c["winlen"], c["in_ch"], c["out_ch"])
        out[f"conv{i}/b"] = (c["out_ch"],)
    d_in = widths["convs"][-1]["out_ch"]
    for i, r in enumerate(widths["rnns"]):
        g = GATES[r["kind"]] * r["size"]
        out[f"rnn{i}/iW"] = (d_in, g)
        out[f"rnn{i}/sW"] = (r["size"], g)
        out[f"rnn{i}/b"] = (g,)
        d_in = r["size"]
    out["ff/W"] = (d_in, nparam(widths))
    out["ff/b"] = (nparam(widths),)
    return out


def make(widths: dict, seed: int, device) -> Dict[str, "torch.Tensor"]:  # noqa: F821
    import torch

    shp = shapes(widths)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    mats = [k for k in shp if not k.endswith("/b")]
    sizes = [int(np.prod(shp[k])) for k in mats]
    draw = torch.randn(sum(sizes), generator=gen, device=device, dtype=torch.float32)
    out, ofs = {}, 0
    for k, n in zip(mats, sizes):
        fan_in = int(np.prod(shp[k][:-1]))
        out[k] = (draw[ofs:ofs + n] / float(np.sqrt(fan_in))).view(shp[k])
        ofs += n
    for k in shp:
        if k.endswith("/b"):
            out[k] = torch.zeros(shp[k], device=device, dtype=torch.float32)
    for i, r in enumerate(widths["rnns"]):
        if r["kind"] == "lstm":
            H = r["size"]
            out[f"rnn{i}/b"][H:2 * H] = 1.0
    return out


def save_npz(params: dict, path: str) -> str:
    """The weights as the program's ``--checkpoint`` (flat names)."""
    os.makedirs(os.path.dirname(path), exist_ok=True)
    np.savez(path, **{k: v.detach().cpu().numpy() for k, v in params.items()})
    return path


def stay_params(nbase: int) -> list:
    """Flip-flop parameters of a stay: flip b to flip b (b * nstate + b)
    and flop b to flop b (nbase * nstate + nbase + b)."""
    S = 2 * nbase
    return [b * S + b for b in range(nbase)] + [nbase * S + nbase + b for b in range(nbase)]


def calibrate(params: dict, config: dict, seed: int, device, rows: int = 32,
              blocks: int = 512, steps: int = 14) -> float:
    """Shift ``params``' stay biases in place so that the fb-then-Viterbi
    path of the plain reference, over ``rows`` seeded synthetic reads of
    ``blocks`` blocks, changes state once every ``blocks_per_base``
    blocks (bisection on the shift); returns the shift."""
    import torch

    from ..harness import fast5
    from . import flipflop, signal

    widths = config["widths"]
    model = flipflop.Model.from_config(config)
    n = blocks * model.stride
    rng = np.random.default_rng([seed, 3])
    sig = np.stack([signal.normalise(signal.scale_to_pA(
        fast5.synthetic_adc(n, rng), fast5.CHANNEL["offset"], fast5.CHANNEL["range"],
        fast5.CHANNEL["digitisation"])) for _ in range(rows)])
    net = flipflop.Network(model, params)
    stay = torch.zeros(nparam(widths), device=device)
    stay[stay_params(widths["nbase"])] = 1.0
    with torch.no_grad(), flipflop.exact_float32():
        x, nb = net.features(torch.from_numpy(sig).to(device), [n] * rows)

        def blocks_per_base(shift):
            trans = net.head(x, nb, params["ff/b"] + shift * stay)
            path, _ = flipflop.viterbi(flipflop.posterior(trans, nb, model.nbase), nb, model.nbase)
            changes = int((path[:, 1:blocks] != path[:, :blocks - 1]).sum())
            return rows * blocks / max(1, changes)

        lo, hi = -4.0, 4.0
        for _ in range(steps):
            mid = 0.5 * (lo + hi)
            if blocks_per_base(mid) < config["blocks_per_base"]:
                lo = mid
            else:
                hi = mid
    shift = 0.5 * (lo + hi)
    params["ff/b"] += shift * stay
    return shift
