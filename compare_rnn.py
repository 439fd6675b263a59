"""The port's recurrent layers and block affines against another
checkout's, on one CUDA card.

    python3 compare_rnn.py DIR

DIR is the root of another checkout of this repository (e.g. an earlier
commit unpacked with ``git archive`` into build/) whose
flappie_tpu_torch/csrc/lstm.cu, grumod.cu, lstm_p1.cu and grumod_p1.cu
have this checkout's layer C entry points and whose csrc/affine.cuh has
``launch_affine`` and ``launch_affine_bf16``.  The four sources are built
from DIR beside this checkout's own, with a small shim that exports DIR's
f32 affine alone (all nvcc at once), then:

1. the SASS of each source's kernels (cuobjdump), matched by content: the
   script names each of DIR's kernels without an identical instruction
   list in this build and this build's kernels without a twin in DIR's (a
   template argument added to a kernel renames it, so names are not
   compared); every kernel of DIR's must have its twin here (the
   tensor-core steps of lstm_p1.cu included), except DIR's one-pass steps
   on CUDA cores (cluster_rnn.cuh's DOT1 instantiations, in lstm_p1.cu
   before the LSTM's step moved to the tensor cores and in grumod_p1.cu
   before GRU-mod's did), whose place the tensor-core step
   (cluster_rnn_mma.cuh) takes: only in a source where such kernels went
   may this build have kernels without a twin, and those must be
   tensor-core steps; every tensor-core step must issue HMMA, this build's
   bf16 affine HGMMA (wgmma) and its f32 affine no tensor-core
   instruction;
2. ptxas's registers and spills of the cluster recurrence and the affines
   in each build;
3. K1, K8 (h and c), K7 and both K12 through the port's wrappers on each
   checkout's build at T=2560, B=256, IN=H=256 (ragged lengths including
   0 and T, both directions for K1 and K7): K12 bit-equal to the other
   build's (its recurrence is unchanged), K1, K7 and K8 within 1e-4 (the
   band they meet against their plain versions; the affine under them may
   sum in another order; bit-equality is logged), each timed alternated
   over 10 runs;
4. both affines alone at M = 655,360, IN=256, G=1024 and 768 on each
   checkout's build: the f32 affine within 1e-4 of the other's (bit-equal
   logged), the bf16 affine held to its plain version on both
   (chip_smoke.py's affine_agreement), each timed alternated over 10 runs;
5. the layers of precision ``default`` on each checkout's lstm_p1.cu and
   grumod_p1.cu at T=2560, B=256, IN=H=256, backward: K1-default,
   K8-default, K7-default (f32 stream) and their bf16-stream twins within
   the one-pass band's max (chip_smoke.py's P1_MAX, 1e-2 of max(1,
   |value|): two one-pass steps sum the same exact products in other
   orders; bit-equality logged), timed alternated over 10 runs; K1, K8 and
   K7's f32 step after the one-pass affine bit-equal to the other build's
   (their kernels are unchanged).

Prints the card's name and power limit last.  Imports nothing of JAX or of
the JAX package; writes only under build/ in this checkout.  Exits 1 when
no CUDA card is visible.
"""

from __future__ import annotations

import os
import re
import statistics
import sys

import chip_smoke as cs
from compare_scans import sass_by_kernel

SOURCES = ("lstm", "grumod", "lstm_p1", "grumod_p1")
# DIR's kernels whose place this checkout's tensor-core step takes: the
# one-pass steps on CUDA cores, cluster_rnn.cuh's instantiations with the
# DOT1 flag (its last template argument) set, in lstm_p1.cu (GN = 4) and
# grumod_p1.cu (GN = 3)
DOT1_STEP = re.compile(r"cluster_rnn_kernelILi[34]ELi\d+ELb[01]ELb0E(f|13__nv_bfloat16)Lb1E")
REPLACED = {"lstm_p1": DOT1_STEP, "grumod_p1": DOT1_STEP}
# the other checkout's f32 affine alone, through its own affine.cuh
SHIM = """#include "affine.cuh"
extern "C" const char* flappie_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
extern "C" int flappie_affine_f32(const float* x, const float* iW, const float* b, float* xa,
                                  long M, int N, int K, void* stream) {
  return flappie::launch_affine(x, iW, b, xa, M, N, K, static_cast<cudaStream_t>(stream));
}
"""
# the band K1, K7 and K8 hold to their plain versions (tests/test_torch_cuda.py)
LAYER_TOL = 1e-4


def build_both(parent: str) -> dict:
    """This checkout's kernels, SOURCES from ``parent``'s checkout and the
    shim over its affine.cuh, all nvcc at once: {source or "affine": the
    other checkout's library}."""
    from flappie_tpu_torch.ops import cuda_build

    csrc = os.path.join(os.path.abspath(parent), "flappie_tpu_torch", "csrc")
    shim_dir = os.path.join(cuda_build.BUILD_DIR, "parent_shim")
    os.makedirs(shim_dir, exist_ok=True)
    with open(os.path.join(shim_dir, "affine_shim.cu"), "w") as fh:
        fh.write(SHIM)
    jobs = cs.start_builds(cuda_build, {f"parent_{src}": (src, ()) for src in SOURCES}, csrc)
    jobs.update(cs.start_builds(cuda_build, {"parent_affine": ("affine_shim", ("-I", csrc))},
                                shim_dir))
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
           + (f"; the SASS differs for: {unmatched}" if unmatched else "")
           + f"; {len(new)} kernels here without a twin there: {new}")
    replaced = REPLACED.get(source)
    gone = [k for k in unmatched if replaced and replaced.search(k)]
    changed = [k for k in unmatched if k not in gone]
    if changed:
        raise AssertionError(f"{source}.cu: the SASS differs from {parent}'s for {changed}")
    if [k for k in new if not (gone and "cluster_rnn_mma_kernel" in k)]:
        raise AssertionError(f"{source}.cu: kernels without a twin in {parent}: {new}"
                             + ("" if gone else f" ({parent} had no one-pass step they replace)"))
    tensor_ops = ("HGMMA", "HMMA", "IMMA")
    for name, code in mine.items():
        ops = {op for op in tensor_ops if any(re.search(rf"\b{op}\b", ins) for ins in code)}
        if "cluster_rnn_mma_kernel" in name:
            if "HMMA" not in ops:
                raise AssertionError(f"{source}.cu: the tensor-core step {name} issues no HMMA")
            hmma = sum(1 for ins in code if re.search(r"\bHMMA\b", ins))
            cs.log(f"  SASS {source}.cu: {name}: {len(code)} instructions, {hmma} HMMA")
        if "affine_bf16_kernel" in name and "HGMMA" not in ops:
            raise AssertionError(f"{source}.cu: {name} issues no HGMMA")
        if "affine_kernel" in name and ops:
            raise AssertionError(f"{source}.cu: the f32 affine {name} issues {sorted(ops)}")
        if "affine" in name:
            cs.log(f"  SASS {source}.cu: {name}: {len(code)} instructions, tensor-core "
                   f"instructions {sorted(ops) or 'none'}")
    for label, text in (("this", cuda_build.build_log.get(source, "")),
                        (parent, cs.variant_log.get(f"parent_{source}", ""))):
        for entry in ("cluster_rnn_kernel", "cluster_rnn_mma_kernel", "affine_kernel",
                      "affine_bf16_kernel", "affine_bf16_wmma_kernel"):
            cs.log(f"  ptxas {source}.cu ({label}): {entry} {cs.ptxas_usage(text, entry)}")


def time_close(torch, source: str, libs: dict, fn, what: str, tol: float, T: int = 0,
               relative: bool = False) -> None:
    """``fn`` through each build of csrc/<source>.cu in ``libs`` ({label:
    library}; None: this checkout's), the outputs within ``tol`` of each
    other (``relative``: of max(1, max |output|), as the one-pass band
    holds c; bit-equality logged), then timed alternated over 10 runs
    (with the time a step over T steps, if given)."""
    from flappie_tpu_torch.ops import cuda_build

    libs = {k: lib or cuda_build.load(source) for k, lib in libs.items()}

    def run(lib):
        with cs.using_lib(source, lib):
            return fn()

    outs = [run(lib) for lib in libs.values()]
    outs = [o if isinstance(o, tuple) else (o,) for o in outs]
    err = max((a.float() - b.float()).abs().max().item()
              / (max(1.0, a.float().abs().max().item()) if relative else 1.0)
              for a, b in zip(*outs))
    if not err <= tol:
        raise AssertionError(f"{what}: max |delta| between builds {err} > {tol}")
    equal = cs.same(outs[0], outs[1])
    del outs
    times = cs.alternated_ms(torch, {k: lambda lib=lib: run(lib) for k, lib in libs.items()},
                             cs.SCAN_REPS)
    cs.log(f"{what}: max |delta| between builds {err:.2e}{' relative' if relative else ''} "
           f"({'bit-equal' if equal else 'not bit-equal'}; band {tol}); " + "; ".join(
               f"{k}: {cs.spread(ts)}"
               + (f" = {1e6 * statistics.median(ts) / T:.1f} ns a step" if T else "")
               for k, ts in times.items()))


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
        libs = {"other": other[source], "this": None}
        calls = [(f"{kind}_layer backward={bw}",
                  lambda bw=bw: layer(x, iW, b, sW, bw, lengths)) for bw in (False, True)]
        if kind == "lstm":
            calls.append(("lstm_layer_train backward=True",
                          lambda: rnn_cuda.lstm_layer_tm_train(x, iW, b, sW, True, lengths)))
        for what, fn in calls:
            time_close(torch, source, libs, fn,
                       f"{what} at T={T}, B={B}, this checkout against {parent} [{card}]",
                       LAYER_TOL, T)
        cs.time_builds(torch, source, libs, lambda: seq(xa, sW), seq(xa, sW),
                       f"{kind}_seq at T={T}, B={B}, this checkout against {parent} [{card}]",
                       T)


def compare_p1_layers(torch, card: str, parent: str, other: dict) -> None:
    """The layers of precision ``default`` on each checkout's _p1 builds."""
    from flappie_tpu_torch.ops import rnn_cuda

    dev = torch.device("cuda")
    gen = torch.Generator(device="cuda").manual_seed(4326)
    T, B, IN, H = 2560, 256, 256, 256
    for kind, gates, source in (("lstm", 4, "lstm_p1"), ("grumod", 3, "grumod_p1")):
        x, iW, b, sW, lengths = cs.layer_inputs(torch, gen, gates, T, B, IN, H)
        xb = x.to(torch.bfloat16)
        libs = {"other": other[source], "this": None}
        if kind == "lstm":
            one_pass = (("K1-default", rnn_cuda.lstm_layer_tm_p1),
                        ("K8-default", rnn_cuda.lstm_layer_tm_train_p1))
            f32_step = (("K1", rnn_cuda.lstm_layer_tm), ("K8", rnn_cuda.lstm_layer_tm_train))
        else:
            one_pass = (("K7-default", rnn_cuda.grumod_layer_tm_p1),)
            f32_step = (("K7", rnn_cuda.grumod_layer_tm),)
        calls = [(f"{kid} ({stream})", fn, xs, cs.P1_MAX)
                 for stream, xs in (("f32 stream", x), ("bf16 stream", xb))
                 for kid, fn in one_pass]
        calls += [(f"{kid}'s f32 step after the one-pass affine", cs.at_ff_default(
            lambda fn=fn: fn(x, iW, b, sW, True, lengths)), None, 0.0) for kid, fn in f32_step]
        for what, fn, xs, tol in calls:
            call = fn if xs is None else (lambda fn=fn, xs=xs: fn(xs, iW, b, sW, True, lengths))
            time_close(torch, source, libs, call,
                       f"{what} at T={T}, B={B}, this checkout against {parent} [{card}]",
                       tol, T, relative=tol > 0)


def compare_affines(torch, card: str, parent: str, other: dict) -> None:
    """Both affines alone on each checkout's build at a chunk batch's
    layer shapes, TF32 off."""
    from flappie_tpu_torch.ops import cuda_build, rnn_cuda

    dev = torch.device("cuda")
    gen = torch.Generator(device="cuda").manual_seed(4324)
    M, K = cs.AFFINE_SHAPE
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        x = torch.randn(M, K, generator=gen, device=dev)
        xb = x.to(torch.bfloat16)
        for G in (1024, 768):
            iW = torch.randn(K, G, generator=gen, device=dev) / K ** 0.5
            b = torch.randn(G, generator=gen, device=dev) * 0.2
            time_close(torch, "lstm", {"other": other["affine"], "this": None},
                       lambda: rnn_cuda.affine_f32(x, iW, b),
                       f"affine_f32 at M={M}, IN={K}, G={G}, this checkout against {parent} "
                       f"[{card}]", LAYER_TOL)
            iW16 = iW.to(torch.bfloat16)
            want = rnn_cuda.affine_bf16_plain(xb, iW16, b)
            libs = {"other": other["lstm"], "this": cuda_build.load("lstm")}

            def bf16_on(lib):
                with cs.using_lib("lstm", lib):
                    return rnn_cuda.affine_bf16(xb, iW16, b)

            for label, lib in libs.items():
                cs.affine_agreement(torch, bf16_on(lib), want, xb, iW16,
                                    f"affine_bf16 ({label}) at G={G}")
            del want
            times = cs.alternated_ms(torch, {label: lambda lib=lib: bf16_on(lib)
                                             for label, lib in libs.items()}, cs.SCAN_REPS)
            cs.log(f"affine_bf16 at M={M}, IN={K}, G={G}, each build held to the plain version, "
                   f"this checkout against {parent} [{card}]: " + "; ".join(
                       f"{k}: {cs.spread(ts)}" for k, ts in times.items()))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32


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
        compare_affines(torch, card, sys.argv[1], other)
        compare_layers(torch, card, sys.argv[1], other)
        compare_p1_layers(torch, card, sys.argv[1], other)
    cs.log(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
