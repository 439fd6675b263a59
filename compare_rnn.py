"""The port's f32 recurrent layers against another checkout's, on one CUDA
card.

    python3 compare_rnn.py DIR

DIR is the root of another checkout of this repository (e.g. an earlier
commit unpacked with ``git archive`` into build/) whose
flappie_tpu_torch/csrc/lstm.cu and grumod.cu have this checkout's f32 C
entry points.  Both sources are built from DIR beside this checkout's
own (all nvcc at once), then:

1. the SASS of each source's kernels (cuobjdump), matched by content: each
   of DIR's kernels has an identical instruction list in this build, or
   the script says which do not (a template argument added to a kernel
   renames it, so names are not compared); this build's kernels without
   a twin in DIR's are listed as new;
2. ptxas's registers and spills of the cluster recurrence in each build;
3. K1, K8 (h and c), K7 and both K12 through the port's wrappers on each
   checkout's build at T=2560, B=256, IN=H=256 (ragged lengths including
   0 and T, both directions for K1 and K7), each output bit-equal to the
   other build's and timed alternated over 10 runs (chip_smoke.py's
   time_builds).

Prints the card's name and power limit last.  Imports nothing of JAX or of
the JAX package; writes only under build/ in this checkout.  Exits 1 when
no CUDA card is visible.
"""

from __future__ import annotations

import os
import sys

import chip_smoke as cs
from compare_scans import sass_by_kernel

SOURCES = ("lstm", "grumod")


def build_both(parent: str) -> dict:
    """This checkout's kernels and SOURCES from ``parent``'s checkout, all
    nvcc at once: {source: the other checkout's library}."""
    from flappie_tpu_torch.ops import cuda_build

    csrc = os.path.join(os.path.abspath(parent), "flappie_tpu_torch", "csrc")
    jobs = cs.start_builds(cuda_build, {f"parent_{src}": (src, ()) for src in SOURCES}, csrc)
    cs.log(f"build: {cuda_build.build(SOURCES)}")
    return {k[len("parent_"):]: lib for k, lib in cs.finish_builds(jobs).items()}


def compare_sass(source: str, parent: str) -> None:
    from flappie_tpu_torch.ops import cuda_build

    mine = sass_by_kernel(cuda_build._paths(source)[1])
    theirs = sass_by_kernel(os.path.join(cuda_build.BUILD_DIR, f"parent_{source}",
                                         f"lib{source}.so"))
    pool = [tuple(v) for v in mine.values()]
    unmatched = []
    for name, code in sorted(theirs.items()):
        if tuple(code) in pool:
            pool.remove(tuple(code))
        else:
            unmatched.append(name)
    twins = {tuple(v) for v in theirs.values()}
    new = sorted(k for k, v in mine.items() if tuple(v) not in twins)
    cs.log(f"SASS of {source}.cu, this checkout against {parent}: "
           f"{len(theirs) - len(unmatched)} of {len(theirs)} kernels of {parent} have an "
           f"identical instruction list in this build"
           + (f"; without one: {unmatched}" if unmatched else "")
           + f"; {len(new)} kernels new here: {new}")
    for label, text in (("this", cuda_build.build_log.get(source, "")),
                        (parent, cs.variant_log.get(f"parent_{source}", ""))):
        for entry in ("cluster_rnn_kernel", "affine"):
            cs.log(f"  ptxas {source}.cu ({label}): {entry} {cs.ptxas_usage(text, entry)}")


def compare_layers(torch, card: str, parent: str, other: dict) -> None:
    from flappie_tpu_torch.ops import rnn_cuda

    dev = torch.device("cuda")
    gen = torch.Generator(device="cuda").manual_seed(4323)
    T, B, IN, H = 2560, 256, 256, 256
    lengths = torch.randint(1, T, (B,), generator=gen, device=dev, dtype=torch.int32)
    lengths[0], lengths[1] = T, 0
    x = torch.randn(T, B, IN, generator=gen, device=dev)
    for kind, gates, source in (("lstm", 4, "lstm"), ("grumod", 3, "grumod")):
        G = gates * H
        iW = torch.randn(IN, G, generator=gen, device=dev) / IN ** 0.5
        b = torch.randn(G, generator=gen, device=dev) * 0.2
        sW = torch.randn(H, G, generator=gen, device=dev) / H ** 0.5
        xa = torch.randn(B, T, G, generator=gen, device=dev) * 0.5
        layer = getattr(rnn_cuda, f"{kind}_layer_tm")
        seq = getattr(rnn_cuda, f"{kind}_seq_cuda")
        calls = [(f"{kind}_layer backward={bw}",
                  lambda bw=bw: layer(x, iW, b, sW, bw, lengths)) for bw in (False, True)]
        if kind == "lstm":
            calls.append(("lstm_layer_train backward=True",
                          lambda: rnn_cuda.lstm_layer_tm_train(x, iW, b, sW, True, lengths)))
        calls.append((f"{kind}_seq", lambda: seq(xa, sW)))
        libs = {"other": other[source], "this": None}
        for what, fn in calls:
            cs.time_builds(torch, source, libs, fn, fn(),
                           f"{what} at T={T}, B={B}, this checkout against {parent} [{card}]",
                           T)


def main() -> int:
    if len(sys.argv) != 2 or not os.path.isdir(sys.argv[1]):
        print(__doc__, file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("compare_rnn: no CUDA device available", file=sys.stderr)
        return 1
    card = cs.card_line()
    other = build_both(sys.argv[1])
    for source in SOURCES:
        compare_sass(source, sys.argv[1])
    with torch.no_grad():
        compare_layers(torch, card, sys.argv[1], other)
    cs.log(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
