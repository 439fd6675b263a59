"""The port's chain scans against another checkout's, on one CUDA card.

    python3 compare_scans.py DIR

DIR is the root of another checkout of this repository (e.g. an earlier
commit unpacked with ``git archive`` into build/) whose
flappie_tpu_torch/csrc/crf_scan.cu, crf_bt.cu and conv12.cu have this
checkout's C entry points.  The three sources are built from DIR beside
this checkout's own (all nvcc at once), then:

0. K10, the fused conv 1->4->16: the SASS of conv12.cu's kernels compared,
   then at each of chip_smoke.py's CONV12_SHAPES (r941_native's chunk
   batch B=256, T=12800; runnie's heaviest bucket B=24, T=65,536; the
   training batch B=32, T=2560), with ragged lengths including 0, 3 and T
   and once more with every read full, K10 through each checkout's build,
   bit-equal to the other's and timed alternated over 10 runs behind a
   device sleep; then
   r941_native's conv stack alone under FLAPPIE_TPU_CONV_IMPL=pallas on one
   full chunk batch, on each checkout's K10, bit-equal and alternated; and
   under pallas on each checkout's K10: r941_native's fb run of the CLI
   (chip_smoke.py's 80 reads) and runnie's (its 40 reads), their FASTQ and
   .run bytes equal, and 3 training steps of r941_native at batch 32 x
   2560 samples from the same weights, their losses equal;

1. the SASS of crf_scan.cu's kernels (cuobjdump) compared, kernel by kernel
   ("new": a kernel the other checkout does not have);
2. K3, K4, K9, K5, K6 and K11's forward and Viterbi scans and traceback,
   through the port's wrappers on each checkout's build, each output
   bit-equal to the other's and timed alternated over 10 runs (chip_smoke.py's
   time_builds; the tracebacks, microseconds long, behind a device sleep) at
   T=2560, B=256 (the run-length structure at S=8 and the 5-base flip-flop
   at S=10) and at runnie's heaviest program's shape (T=13,108, B=24);
3. runnie's fb run under each CRF impl profiled on each checkout's kernels
   in turns (other, this, this, other): K11's forward and Viterbi, K6 and
   K11's traceback kernel time a run, and the traceback's glue.

Prints the card's name and power limit last.  Imports nothing of JAX or of
the JAX package; writes only under build/ in this checkout.  Exits 1 when
no CUDA card is visible.
"""

from __future__ import annotations

import os
import re
import shutil
import subprocess
import sys

import chip_smoke as cs


def sass_by_kernel(so: str) -> dict:
    """{kernel: [SASS instructions]} of a built library, by cuobjdump; the
    kernel's mangled name without its source file's anonymous-namespace
    tag, which differs between checkouts."""
    exe = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    out = subprocess.run([exe, "-sass", so], capture_output=True, text=True, check=True,
                         timeout=120).stdout
    got, name = {}, None
    for line in out.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            name = re.sub(r"\d+_GLOBAL__N__\w+?_cu_[0-9a-f]{8}", "", m.group(1))
            got[name] = []
        elif name:
            m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(.*?)\s*;", line)
            if m:
                got[name].append(m.group(1))
    return got


SOURCES = ("crf_scan", "crf_bt", "conv12")


def build_both(parent: str) -> dict:
    """This checkout's kernels and SOURCES from ``parent``'s checkout, all
    nvcc at once: {source: the other checkout's library}."""
    from flappie_tpu_torch.ops import cuda_build

    csrc = os.path.join(os.path.abspath(parent), "flappie_tpu_torch", "csrc")
    jobs = cs.start_builds(cuda_build, {f"parent_{src}": (src, ()) for src in SOURCES}, csrc)
    cs.log(f"build: {cuda_build.build()}")
    return {k[len("parent_"):]: lib for k, lib in cs.finish_builds(jobs).items()}


def compare_sass(source: str, parent: str) -> None:
    from flappie_tpu_torch.ops import cuda_build

    mine = sass_by_kernel(cuda_build._paths(source)[1])
    theirs = sass_by_kernel(os.path.join(cuda_build.BUILD_DIR, f"parent_{source}",
                                         f"lib{source}.so"))
    cs.log(f"SASS of {source}.cu's kernels, this checkout against {parent}: " + "; ".join(
        f"{k}: " + ("new" if k not in theirs else "identical" if theirs[k] == v else "differs")
        + f" ({len(v)} instructions)" for k, v in sorted(mine.items())))


def compare_conv12(torch, card: str, parent: str, other: dict) -> None:
    """Step 0 of the module docstring."""
    from flappie_tpu_torch.models.config import get_model_config
    from flappie_tpu_torch.models.network import conv_stack
    from flappie_tpu_torch.models.params import init_synthetic, params_to_torch
    from flappie_tpu_torch.ops import conv_cuda

    compare_sass("conv12", parent)
    libs = {"other": other["conv12"], "this": None}
    gen = torch.Generator(device="cuda").manual_seed(4322)
    for B, T in cs.CONV12_SHAPES:
        for full in (False, True):
            args = cs.conv12_inputs(torch, gen, B, T, full)
            cs.time_builds(torch, "conv12", libs, lambda: conv_cuda.conv12_fused(*args),
                           conv_cuda.conv12_fused(*args),
                           f"K10 at B={B}, T={T}, {'every read full' if full else 'ragged'}, "
                           f"this checkout against {parent}, behind a device sleep [{card}]",
                           B * T, lead=True, unit="sample")
    cfg = get_model_config("r941_native")
    params = params_to_torch(init_synthetic(cfg, seed=0), "cuda")
    B, W = 256, 2560 * cfg.total_stride
    x = torch.randn(B, W, 1, device="cuda", generator=gen)
    lengths = torch.full((B,), W, dtype=torch.int32, device="cuda")
    with torch.inference_mode(), cs.knobs({"FLAPPIE_TPU_CONV_IMPL": "pallas"}):
        def stack():
            return conv_stack(params, cfg, x, lengths)[0]

        cs.time_builds(torch, "conv12", libs, stack, stack(),
                       f"r941_native conv stack alone under pallas on {B} x {W} samples, this "
                       f"checkout's K10 against {parent}'s [{card}]", B * W, unit="sample")
        cs.log(f"pallas stack split on this checkout's K10: "
               f"{cs.pallas_stack_split(torch, params, cfg, x, lengths)} [{card}]")


def compare_conv12_outputs(torch, np, card: str, parent: str, other: dict) -> None:
    """The end of step 0: the CLIs' bytes and the training losses under
    FLAPPIE_TPU_CONV_IMPL=pallas on each checkout's K10."""
    from flappie_tpu_torch.cli.runnie import main as runnie_main
    from flappie_tpu_torch.models.config import get_model_config
    from flappie_tpu_torch.models.params import init_synthetic
    from flappie_tpu_torch.ops import cuda_build
    from flappie_tpu_torch.train import make_train_step, synthetic_batch

    env = {"FLAPPIE_TPU_CONV_IMPL": "pallas"}
    libs = {"this": cuda_build.load("conv12"), "other": other["conv12"]}
    shutil.rmtree(cs.WORK, ignore_errors=True)
    flappie_reads = os.path.join(cs.WORK, "r941_native", "reads")
    cs.write_reads(np, np.random.default_rng(20261016), flappie_reads, *cs.RUNS["r941_native"])
    _, runnie_reads, _ = cs.write_runnie_reads(np)
    for what, reads, main, ext in (("r941_native fb FASTQ", flappie_reads, None, "fastq"),
                                   ("runnie fb .run", runnie_reads, runnie_main, "run")):
        got = {}
        for who, lib in libs.items():
            out = os.path.join(cs.WORK, f"{who}.{ext}")
            with cs.using_lib("conv12", lib):
                cs.run_cli(torch, [reads, "-o", out], main, env)
            with open(out, "rb") as fh:
                got[who] = fh.read()
        if got["this"] != got["other"]:
            raise AssertionError(f"{what} under conv pallas: this checkout's bytes differ "
                                 f"from {parent}'s")
        cs.log(f"{what} under conv pallas: {len(got['this'])} bytes, equal on this "
               f"checkout's K10 and {parent}'s [{card}]")
    cfg = get_model_config("r941_native")
    batch = [torch.from_numpy(a).to("cuda") for a in synthetic_batch(cfg, 32, 2560, seed=3)]
    losses = {}
    for who, lib in libs.items():
        step, init = make_train_step(cfg, lr=2e-4)
        params, opt = init(init_synthetic(cfg, seed=7))
        with cs.using_lib("conv12", lib), cs.knobs(env):
            losses[who] = [float(step(params, opt, *batch)) for _ in range(3)]
    if losses["this"] != losses["other"]:
        raise AssertionError(f"training under conv pallas: losses {losses}")
    cs.log(f"r941_native training, 3 steps under conv pallas: losses {losses['this']}, equal on "
           f"this checkout's K10 and {parent}'s [{card}]")


def compare(torch, np, card: str, parent: str, other: dict) -> None:
    from flappie_tpu_torch.cli.runnie import main as runnie_main
    from flappie_tpu_torch.ops import crf_bm_cuda, crf_cuda, cuda_build
    from flappie_tpu_torch.ops.crf import dense_from_params, flipflop_index, rle_index
    from flappie_tpu_torch.ops.crf_bm import _dense_tm

    compare_sass("crf_scan", parent)
    dev = torch.device("cuda")
    gen = torch.Generator(device="cuda").manual_seed(4321)
    for (T, B), kinds in (((2560, 256), (("rle", 4), ("flipflop", 5))),
                          (cs.RUNNIE_SCAN_SHAPE, (("rle", 4),))):
        for kind, nbase in kinds:
            idx = rle_index(nbase) if kind == "rle" else flipflop_index(nbase)
            trans = torch.randn(T, B, idx.nparam, generator=gen, device=dev) * 2.0
            nblocks = torch.randint(T // 2, T, (B,), generator=gen, device=dev)
            nblocks[0], nblocks[1] = T, 0
            valid = torch.arange(T, device=dev)[:, None] < nblocks[None, :]
            bt = dense_from_params(trans, idx)
            bm = _dense_tm(trans.permute(0, 2, 1), idx)
            rank = idx.tie_rank
            # the tracebacks' inputs: Viterbi's backpointers in each layout,
            # valid flags already int32 (no conversion in the timed call)
            alpha, bps = crf_bm_cuda.viterbi_fwd(bm, valid, rank)
            last, vi = alpha.argmax(dim=0).to(torch.int32), valid.to(torch.int32)
            bp_rev = crf_cuda.viterbi_scan(bt, valid, rank)[1].flip(0).contiguous()
            vri = vi.flip(0).contiguous()
            for name, src, fn in (
                    ("K6", "crf_scan", lambda: crf_bm_cuda.traceback(bps, vi, last)),
                    ("K11 traceback", "crf_bt", lambda: crf_cuda.traceback_bt(bp_rev, vri, last))):
                cs.time_builds(torch, src, {"other": other[src], "this": None}, fn,
                               fn(), f"{name} at S={idx.nstate}, T={T}, B={B}, this checkout "
                               f"against {parent} (behind a device sleep)", T, lead=True)
            for name, src, fn in (
                    ("K3", "crf_scan", lambda: crf_bm_cuda.sum_states(bm, valid, False)),
                    ("K4", "crf_scan", lambda: crf_bm_cuda.sum_states(bm, valid, True)),
                    ("K9", "crf_scan", lambda: crf_bm_cuda.fwdbwd_states(bm, valid)),
                    ("K5", "crf_scan", lambda: crf_bm_cuda.viterbi_fwd(bm, valid, rank)),
                    ("K11 forward", "crf_bt", lambda: crf_cuda.fwd_scan(bt, valid)),
                    ("K11 Viterbi", "crf_bt", lambda: crf_cuda.viterbi_scan(bt, valid, rank))):
                cs.time_builds(torch, src, {"other": other[src], "this": None}, fn,
                               fn(), f"{name} at S={idx.nstate}, T={T}, B={B}, this checkout "
                               f"against {parent}", T)
    shutil.rmtree(cs.WORK, ignore_errors=True)
    _, reads_dir, _ = cs.write_runnie_reads(np)
    for impl, groups in (("pallas", ("K11 forward + Viterbi", "K11 traceback")),
                         ("scanb", ("K6",))):
        env = {"FLAPPIE_TPU_CRF_IMPL": impl}
        cs.run_cli(torch, [reads_dir, "-o", os.path.join(cs.WORK, "warm.run")], runnie_main, env)
        got = {"other": [], "this": []}
        for who in ("other", "this", "this", "other"):
            libs = {src: other[src] if who == "other" else cuda_build.load(src)
                    for src in ("crf_scan", "crf_bt")}
            with cs.using_lib("crf_scan", libs["crf_scan"]), cs.using_lib("crf_bt", libs["crf_bt"]):
                got[who].append(cs.profiled_runnie(torch, reads_dir, card, env,
                                                   f", {who} checkout's kernels"))
        for g in groups + ("glue",):
            cs.log(f"{g} ms a profiled runnie fb run under {impl}: this checkout "
                   f"{[r[g] for r in got['this']]}, {parent} {[r[g] for r in got['other']]} "
                   f"[{card}]")


def main() -> int:
    if len(sys.argv) != 2 or not os.path.isdir(sys.argv[1]):
        print(__doc__, file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("compare_scans: no CUDA device available", file=sys.stderr)
        return 1
    import numpy as np

    os.environ.update(cs.KNOBS)
    card = cs.card_line()
    other = build_both(sys.argv[1])
    compare_conv12(torch, card, sys.argv[1], other)
    compare_conv12_outputs(torch, np, card, sys.argv[1], other)
    compare(torch, np, card, sys.argv[1], other)
    cs.log(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
