"""The port's chain scans against another checkout's, on one CUDA card.

    python3 compare_scans.py DIR

DIR is the root of another checkout of this repository (e.g. an earlier
commit unpacked with ``git archive`` into build/) whose
flappie_tpu_torch/csrc/crf_scan.cu and crf_bt.cu have this checkout's C
interfaces.  Both sources are built from DIR beside this checkout's own
(all nvcc at once), then:

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


def compare(torch, np, card: str, parent: str) -> None:
    from flappie_tpu_torch.cli.runnie import main as runnie_main
    from flappie_tpu_torch.ops import crf_bm_cuda, crf_cuda, cuda_build
    from flappie_tpu_torch.ops.crf import dense_from_params, flipflop_index, rle_index
    from flappie_tpu_torch.ops.crf_bm import _dense_tm

    csrc = os.path.join(os.path.abspath(parent), "flappie_tpu_torch", "csrc")
    jobs = cs.start_builds(
        cuda_build, {f"parent_{src}": (src, ()) for src in ("crf_scan", "crf_bt")}, csrc)
    cs.log(f"build: {cuda_build.build()}")
    other = cs.finish_builds(jobs)
    mine = sass_by_kernel(cuda_build._paths("crf_scan")[1])
    theirs = sass_by_kernel(os.path.join(cuda_build.BUILD_DIR, "parent_crf_scan",
                                         "libcrf_scan.so"))
    cs.log(f"SASS of crf_scan.cu's kernels, this checkout against {parent}: " + "; ".join(
        f"{k}: " + ("new" if k not in theirs else "identical" if theirs[k] == v else "differs")
        + f" ({len(v)} instructions)" for k, v in sorted(mine.items())))
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
                cs.time_builds(torch, src, {"other": other[f"parent_{src}"], "this": None}, fn,
                               fn(), f"{name} at S={idx.nstate}, T={T}, B={B}, this checkout "
                               f"against {parent} (behind a device sleep)", T, lead=True)
            for name, src, fn in (
                    ("K3", "crf_scan", lambda: crf_bm_cuda.sum_states(bm, valid, False)),
                    ("K4", "crf_scan", lambda: crf_bm_cuda.sum_states(bm, valid, True)),
                    ("K9", "crf_scan", lambda: crf_bm_cuda.fwdbwd_states(bm, valid)),
                    ("K5", "crf_scan", lambda: crf_bm_cuda.viterbi_fwd(bm, valid, rank)),
                    ("K11 forward", "crf_bt", lambda: crf_cuda.fwd_scan(bt, valid)),
                    ("K11 Viterbi", "crf_bt", lambda: crf_cuda.viterbi_scan(bt, valid, rank))):
                cs.time_builds(torch, src, {"other": other[f"parent_{src}"], "this": None}, fn,
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
            libs = {src: other[f"parent_{src}"] if who == "other" else cuda_build.load(src)
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
    compare(torch, np, card, sys.argv[1])
    cs.log(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
