"""How far a correct f32 step moves the --fast calls, on one CUDA card: the
witness that sets chip_smoke.py's gate of the rnn-``high`` band under
--fast.

    python3 high_witness.py

Under --fast every recurrent layer rounds its output to bf16, so two f32
steps that sum the same products in other orders (their states a few f32
ulps apart) flip some outputs by a bf16 ulp, and the next layers carry
the flip into the calls.  This script measures that floor and the two
tensor-core steps beside it.  It basecalls chip_smoke.py's accuracy
corpus (ACCURACY_READS, made from its seed) with r941_native and r941_5mC
through the flappie CLI, each run in this one process:

- ``exact``: the f32 stream at the unset rnn level (the f32 step);
- ``fast``: --fast at the unset level (the bf16 stream's f32-step
  kernels, K1-bf16 / K7-bf16), the run every other --fast run is held to;
- ``witness``: --fast at the unset level with each recurrent layer's step
  run by its plain twin (ops/rnn_cuda.py ``*_plain`` on the card's
  tensors: the f32 step as torch's matmul sums it, TF32 off) over the
  bf16 affine kernel's own output: a correct f32 step in another
  summation order, and nothing else changed;
- ``high``: --fast at FLAPPIE_TPU_RNN_PRECISION=high (the three-pass
  kernels, K1-/K7-high3-bf16);
- ``default``: --fast with both precision knobs at default (the one-pass
  kernels, as chip_smoke.py's default band runs them).

Then each of witness, high and default against fast, and fast against
exact, per read (chip_smoke.py's band: identity p5, p50, min, identical
reads), with the byte-equal records and the largest |score delta|.
Writes under build/high_witness/ only.  Imports nothing of JAX or of the
JAX package.  Prints the card's name and power limit last; exits 1 when
no CUDA card is visible.
"""

from __future__ import annotations

import contextlib
import json
import os
import shutil
import sys

import chip_smoke as cs

MODELS = ("r941_native", "r941_5mC")


@contextlib.contextmanager
def plain_f32_steps():
    """The bf16 stream's f32-step layers run by their plain twins over the
    bf16 affine kernel's output, for the block."""
    from flappie_tpu_torch.ops import rnn_cuda

    saved = rnn_cuda._bf16_layer, rnn_cuda.affine_bf16_plain

    def affine(x, iW, b):
        bf16 = rnn_cuda.BF16
        return rnn_cuda.affine_bf16(x.reshape(-1, x.shape[-1]).to(bf16), iW.to(bf16), b).view(
            *x.shape[:-1], iW.shape[1])

    def layer(kind, x_tm, iW, b, sW, backward, lengths):
        return rnn_cuda._wrappers(kind).plain(x_tm, iW, b, sW, backward, lengths)

    rnn_cuda._bf16_layer, rnn_cuda.affine_bf16_plain = layer, affine
    try:
        yield
    finally:
        rnn_cuda._bf16_layer, rnn_cuda.affine_bf16_plain = saved


RUNS = {"exact": ([], {}, None), "fast": (["--fast"], {}, None),
        "witness": (["--fast"], {}, plain_f32_steps),
        "high": (["--fast"], {"rnn": "high"}, None),
        "default": (["--fast"], {"ff": "default", "rnn": "default"}, None)}


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("high_witness: no CUDA device available", file=sys.stderr)
        return 1
    from flappie_tpu_torch.models.config import get_model_config

    card = cs.card_line()
    cs.log(f"card: {card}")
    wdir = os.path.join(cs.HERE, "build", "high_witness")
    shutil.rmtree(wdir, ignore_errors=True)
    reads_dir = os.path.join(wdir, "reads")
    names = cs.write_reads(np, np.random.default_rng(20261020), reads_dir, cs.ACCURACY_READS,
                           (0, 0, 1))
    os.environ.update(cs.KNOBS)
    out = {}
    try:
        for model in MODELS:
            alphabet = "ACGTZ"[: get_model_config(model).nbase]
            calls, walls = {}, {}
            for run, (flags, levels, patch) in RUNS.items():
                path = os.path.join(wdir, f"{model}_{run}.fastq")
                with cs.precision_levels(**levels), (patch or contextlib.nullcontext)():
                    walls[run] = cs.run_cli(torch, [reads_dir, "-o", path, "--model", model]
                                            + flags)
                with open(path) as fh:
                    calls[run] = cs.parse_fastq(fh.read(), alphabet)
            for run, ref in (("witness", "fast"), ("high", "fast"), ("default", "fast"),
                             ("fast", "exact")):
                got, want = calls[run], calls[ref]
                res = cs.band({k: (v[0], v[2].split("\n")[3]) for k, v in want.items()},
                              {k: (v[0], v[2].split("\n")[3]) for k, v in got.items()})
                both = [k for k in want if k in got]
                res["byte_equal"] = sum(got[k][2] == want[k][2] for k in both)
                res["max_score_delta"] = max(abs(got[k][1] - want[k][1]) for k in both)
                out[f"{model} {run} vs {ref}"] = res
                cs.log(f"{model} {run} against {ref} ({len(names)} reads; walls {run} "
                       f"{walls[run]:.3f} s, {ref} {walls[ref]:.3f} s): identity p5 "
                       f"{res['p5']:.3f}%, p50 {res['p50']:.3f}%, min {res['min']:.3f}%, "
                       f"{res['identical']} reads identical, {res['byte_equal']} records "
                       f"byte-equal, largest |score delta| {res['max_score_delta']:.3e}, "
                       f"{res['missing_in_fast']} missing [{card}]")
    finally:
        if cs._band_workers is not None:
            cs._band_workers.shutdown()
            cs._band_workers = None
    cs.log("high witness (JSON): " + json.dumps(out))
    cs.log(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
