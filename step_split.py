"""Where a step of the cluster recurrences goes, on one CUDA card.

    python3 step_split.py

Builds a small source of its own (written under build/) that runs the
recurrence alone over a time-major xa [T, B, GN.H] in three forms for each
cell (the LSTM, GN = 4, and GRU-mod, GN = 3): the one-pass step on the
tensor cores (csrc/cluster_rnn_mma.cuh), cluster_rnn.cuh's f32 step, and
the three-pass step on the tensor cores (cluster_rnn_mma.cuh at PASSES =
3, rnn precision ``high`` on the card); as the kernels ship and with
-DFLAPPIE_STEP_PROBE (csrc/step_probe.cuh), both nvcc at once.  Then, for
each cell at T=2560, H=256, B=256 and B=24, ragged lengths including 0 and
T, backward, the forms each at its own plan's rows (cluster_rnn.cuh's R=20
and R=2, the tensor-core steps' R=16 and R=2):

1. ptxas's registers and spills of each kernel at R=20 and R=2 (the
   tensor-core steps' by n-tiles, GRU-mod's beside the LSTM's: what its
   zero rows cost; the three-pass step's at every n-tile count), and HMMA
   in the tensor-core kernels' SASS (none in the others; the three-pass
   kernels issue three times the one-pass kernels' HMMA);
2. every form against the plain one-pass twin and the plain three-pass
   twin of the recurrence (ops/rnn.py's steps over h and sW rounded to
   bf16, or split into bf16 high parts and remainders, f32 sums; the
   distances logged: kernel and twin sum the same exact products in other
   orders, the f32 step rounds nothing);
3. the forms timed alternated over 10 runs (CUDA events), their
   microseconds a step, and each tensor-core step at each R of ROWS_AT[B]
   (bit-equal to its plan's; the clusters each launches and the card
   holds at once);
4. the probe build: thread 0 of CTA 0's cycles a step in wait, product,
   update, exchange and the rest (stores of out), in microseconds at the
   clock the probe read (cycles over %globaltimer), beside the probe
   build's own time (the probe's cost).

Prints the card's name and power limit last.  Imports nothing of JAX or of
the JAX package; writes only under build/.  Exits 1 when no CUDA card is
visible.
"""

from __future__ import annotations

import ctypes
import os
import re
import statistics
import sys

import chip_smoke as cs
from compare_scans import sass_by_kernel

SHIM = r"""#include "layer.cuh"
extern "C" const char* flappie_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
// The recurrence of ``gates`` gates (4 LSTM, 3 GRU-mod) in form ``which``:
// 0 the one-pass tensor-core step (cluster_rnn_mma.cuh), 1 cluster_rnn.cuh's
// f32 step, 2 the three-pass tensor-core step; xa [T, B, gates.H] f32 ->
// out [T, B, H].  Returns the launch error code.
extern "C" int flappie_probe_rnn(int gates, int which, const float* xa, const float* sW,
                                 const int* lengths, float* out, int T, int B, int H,
                                 int backward, void* stream) {
  const flappie::RnnArgs<float> a = {xa, sW, lengths, out, nullptr, T, B, H, backward,
                                     static_cast<cudaStream_t>(stream)};
  if (gates == 3) {
    if (which == 2) return flappie::cluster_rnn_mma<3, false, float, 3>(a);
    return which == 0 ? flappie::cluster_rnn_mma<3, false, float>(a)
                      : flappie::cluster_rnn<3, false, false, float>(a);
  }
  if (which == 2) return flappie::cluster_rnn_mma<4, false, float, 3>(a);
  return which == 0 ? flappie::cluster_rnn_mma<4, false, float>(a)
                    : flappie::cluster_rnn<4, false, false, float>(a);
}
// the tensor-core step of ``passes`` passes (1 or 3) at R rows a cluster,
// whatever B (max_active: only ask how many of its clusters the card holds
// at once)
extern "C" int flappie_probe_rows(int gates, int passes, int R, const float* xa,
                                  const float* sW, const int* lengths, float* out, int T, int B,
                                  int H, int backward, void* stream, int* max_active) {
  const flappie::RnnArgs<float> a = {xa, sW, lengths, out, nullptr, T, B, H, backward,
                                     static_cast<cudaStream_t>(stream)};
  if (gates == 3)
    return passes == 3 ? flappie::cluster_rnn_mma_r<3, false, float, 3>(a, R, max_active)
                       : flappie::cluster_rnn_mma_r<3, false, float>(a, R, max_active);
  return passes == 3 ? flappie::cluster_rnn_mma_r<4, false, float, 3>(a, R, max_active)
                     : flappie::cluster_rnn_mma_r<4, false, float>(a, R, max_active);
}
"""
# the builds: {name: -D flags}
BUILDS = {"shipped": (), "probe": ("-DFLAPPIE_STEP_PROBE",)}
# rows a cluster the tensor-core steps are timed at, by batch (their plan's
# and the others they instantiate)
ROWS_AT = {256: (8, 12, 16, 20), 24: (1, 2, 4)}
FORMS = {0: "tensor-core", 1: "f32 step", 2: "three-pass"}
# the tensor-core forms' bf16 passes
PASSES = {0: 1, 2: 3}
CELLS = {4: "LSTM", 3: "GRU-mod"}
BUCKETS = ("wait", "product", "update", "exchange", "rest")
T, H = 2560, 256


def build(compile_: bool = True) -> dict:
    """The kernels as shipped and probed, both nvcc at once (or, without
    ``compile_``, as an earlier call built them): {name: library}."""
    from flappie_tpu_torch.ops import cuda_build

    shim_dir = os.path.join(cuda_build.BUILD_DIR, "step_split")
    os.makedirs(shim_dir, exist_ok=True)
    with open(os.path.join(shim_dir, "step_shim.cu"), "w") as fh:
        fh.write(SHIM)
    inc = ("-I", cuda_build.CSRC_DIR)
    builds = {name: ("step_shim", flags + inc) for name, flags in BUILDS.items()}
    if compile_:
        libs = cs.finish_builds(cs.start_builds(cuda_build, builds, shim_dir))
    else:
        libs = {name: ctypes.CDLL(os.path.join(cuda_build.BUILD_DIR, name, "libstep_shim.so"))
                for name in builds}
    for lib in libs.values():
        lib.flappie_cuda_error_string.argtypes = [ctypes.c_int]
        lib.flappie_cuda_error_string.restype = ctypes.c_char_p
        lib.flappie_probe_rnn.argtypes = [ctypes.c_int] * 2 + [ctypes.c_void_p] * 4 + [
            ctypes.c_int] * 4 + [ctypes.c_void_p]
        lib.flappie_probe_rnn.restype = ctypes.c_int
        lib.flappie_probe_rows.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p] * 4 + [
            ctypes.c_int] * 4 + [ctypes.c_void_p] * 2
        lib.flappie_probe_rows.restype = ctypes.c_int
    return libs


def log_code(libs: dict) -> None:
    """ptxas's registers and spills at R = 20 and 2 of each cell's forms,
    and the tensor-core instructions in each build's kernels."""
    from flappie_tpu_torch.ops import cuda_build

    for name in libs:
        text = cs.variant_log[name]
        for gates, cell in CELLS.items():
            for r in (20, 2):
                mma = f"cluster_rnn_mma_kernelILi{gates}ELi{-(-r // 8)}ELb0EfLi1E"
                f32 = f"cluster_rnn_kernelILi{gates}ELi{r}ELb0ELb0EfE"
                cs.log(f"ptxas {name} {cell} R={r}: tensor-core {cs.ptxas_usage(text, mma)}; "
                       f"f32 {cs.ptxas_usage(text, f32)}")
            cs.log(f"ptxas {name} {cell} three-pass, n-tiles 1, 2, 3: " + "; ".join(
                cs.ptxas_usage(text, f"cluster_rnn_mma_kernelILi{gates}ELi{nt}ELb0EfLi3E")
                for nt in (1, 2, 3)))
        so = os.path.join(cuda_build.BUILD_DIR, name, "libstep_shim.so")
        hmmas = {}
        for kernel, code in sorted(sass_by_kernel(so).items()):
            hmma = sum(1 for ins in code if re.search(r"\bHMMA\b", ins))
            if ("cluster_rnn_mma_kernel" in kernel) != (hmma > 0):
                raise AssertionError(f"{name}: {kernel} issues {hmma} HMMA")
            if "mma_kernel" in kernel or "ELi20E" in kernel:
                cs.log(f"  SASS {name}: {kernel}: {len(code)} instructions, {hmma} HMMA")
            hmmas[kernel] = hmma
        for kernel, n in hmmas.items():
            one = kernel.replace("ELb0EfLi3E", "ELb0EfLi1E")
            if "ELb0EfLi3E" in kernel and hmmas.get(one) and n != 3 * hmmas[one]:
                raise AssertionError(f"{name}: {kernel} issues {n} HMMA, not 3x {one}'s")


def run(torch, lib, gates: int, which: int, xa, sW, lengths):
    from flappie_tpu_torch.ops import cuda_build

    Tn, B, _ = xa.shape
    out = torch.empty(Tn, B, H, device=xa.device)
    rc = lib.flappie_probe_rnn(gates, which, xa.data_ptr(), sW.data_ptr(), lengths.data_ptr(),
                               out.data_ptr(), Tn, B, H, 1,
                               torch.cuda.current_stream().cuda_stream)
    cuda_build.check(lib, rc, f"flappie_probe_rnn({gates}, {which})")
    return out


def plain(torch, gates: int, xa, sW, lengths, rdot: str = "bf16"):
    """The one-pass twin of the recurrence alone, backward: ops/rnn.py's
    step with h and sW rounded to bf16 for the product, the exact
    products summed in f32 (TF32 off), the state carried in f32; ``rdot``
    "bf16x3", the three-pass twin (ops/rnn_cuda.py ``_step_dot``)."""
    from flappie_tpu_torch.ops import rnn, rnn_cuda

    Tn, B, _ = xa.shape
    w, dot = rnn_cuda._step_dot(sW, rdot)

    h = xa.new_zeros(B, H)
    c = xa.new_zeros(B, H)
    out = xa.new_empty(Tn, B, H)
    for t in range(Tn - 1, -1, -1):
        if gates == 4:
            h2, c2 = rnn.lstm_step(xa[t], h, c, w, dot)
        else:
            h2, c2 = rnn.grumod_step(xa[t], h, w, dot), c
        valid = (t < lengths)[:, None]
        out[t] = torch.where(valid, h2, torch.zeros_like(h2))
        h, c = torch.where(valid, h2, h), torch.where(valid, c2, c)
    return out


def time_rows(torch, lib, gates: int, xa, sW, lengths, card: str, which: int = 0) -> None:
    """The tensor-core step of form ``which`` (0 one pass, 2 three passes)
    at each R of ROWS_AT[B], alternated, each bit-equal to the plan's,
    with the clusters it launches and the clusters the card holds at
    once."""
    from flappie_tpu_torch.ops import cuda_build

    Tn, B, _ = xa.shape
    stream = torch.cuda.current_stream().cuda_stream
    passes = PASSES[which]

    def launch(R):
        out = torch.empty(Tn, B, H, device=xa.device)
        rc = lib.flappie_probe_rows(gates, passes, R, xa.data_ptr(), sW.data_ptr(),
                                    lengths.data_ptr(), out.data_ptr(), Tn, B, H, 1, stream, None)
        cuda_build.check(lib, rc, f"flappie_probe_rows({gates}, {passes}, {R})")
        return out

    ref = run(torch, lib, gates, which, xa, sW, lengths)
    held = []
    for R in ROWS_AT[B]:
        n = ctypes.c_int(0)
        cuda_build.check(lib, lib.flappie_probe_rows(gates, passes, R, 0, 0, 0, 0, Tn, B, H, 1,
                                                     stream, ctypes.addressof(n)), "max active")
        if not torch.equal(launch(R), ref):
            raise AssertionError(f"{CELLS[gates]} R={R} at B={B} is not the plan's output bit "
                                 f"for bit")
        held.append(f"R={R}: {-(-B // R)} clusters, the card holds {n.value}")
    times = cs.alternated_ms(torch, {R: lambda R=R: launch(R) for R in ROWS_AT[B]},
                             cs.ALTERNATED_REPS)
    cs.log(f"{CELLS[gates]} {FORMS[which]} step by rows a cluster at T={Tn}, B={B} [{card}], "
           f"each bit-equal to the plan's: " + "; ".join(held) + "; " + "; ".join(
               f"R={R} {cs.spread(ts)} = {1e3 * statistics.median(ts) / Tn:.3f} us a step"
               for R, ts in times.items()))


def split(torch, lib, gates: int, which: int, xa, sW, lengths) -> str:
    """The probe's buckets of one launch, in microseconds a step."""
    run(torch, lib, gates, which, xa, sW, lengths)
    torch.cuda.synchronize()
    buf = (ctypes.c_ulonglong * 8)()
    rc = lib.flappie_step_probe(buf)
    if rc != 0:
        raise RuntimeError(f"flappie_step_probe: CUDA error {rc}")
    acc, cycles, ns, steps = list(buf[:5]), buf[5], buf[6], buf[7]
    ghz = cycles / ns
    us = [a / ghz / 1e3 / steps for a in acc]
    return (", ".join(f"{k} {v:.3f}" for k, v in zip(BUCKETS, us))
            + f"; total {cycles / ghz / 1e3 / steps:.3f} us a step at {ghz:.3f} GHz")


def cell_inputs(torch, gen, gates: int, B: int):
    """sW [H, gates.H], xa [T, B, gates.H] (the LSTM's forget gate, or
    GRU-mod's candidate, shifted off zero) and ragged lengths with row 0
    full and row 1 empty."""
    dev = torch.device("cuda")
    sW = torch.randn(H, gates * H, generator=gen, device=dev) / H ** 0.5
    lengths = torch.randint(1, T, (B,), generator=gen, device=dev, dtype=torch.int32)
    lengths[0], lengths[1] = T, 0
    xa = torch.randn(T, B, gates * H, generator=gen, device=dev)
    xa[:, :, (1 if gates == 4 else 2) * H : (2 if gates == 4 else 3) * H] += 1.0
    return sW, xa, lengths


def smoke(torch, libs: dict) -> None:
    """One short launch of every form of each cell in every build (T=8,
    B=24), each finite: run first in a child process with a time limit, so
    that a kernel that never finishes is killed with it."""
    dev = torch.device("cuda")
    gen = torch.Generator(device="cuda").manual_seed(1)
    lengths = torch.full((24,), 8, dtype=torch.int32, device=dev)
    for gates in CELLS:
        sW = torch.randn(H, gates * H, generator=gen, device=dev) / H ** 0.5
        xa = torch.randn(8, 24, gates * H, generator=gen, device=dev)
        for name, lib in libs.items():
            for which in FORMS:
                out = run(torch, lib, gates, which, xa, sW, lengths)
                torch.cuda.synchronize()
                if not torch.isfinite(out).all():
                    raise AssertionError(f"smoke: {name} {CELLS[gates]} form {which}: "
                                         f"non-finite h")
    cs.log("smoke: every form of every cell and build ran at T=8, B=24")


# seconds the child process's smoke run may take
SMOKE_LIMIT = 120


def main() -> int:
    import subprocess

    import torch

    if not torch.cuda.is_available():
        print("step_split: no CUDA device available", file=sys.stderr)
        return 1
    if sys.argv[1:] == ["--smoke"]:
        smoke(torch, build(compile_=False))
        return 0
    libs = build()
    card = cs.card_line()
    cs.log(f"card: {card}")
    log_code(libs)
    subprocess.run([sys.executable, os.path.abspath(__file__), "--smoke"], check=True,
                   timeout=SMOKE_LIMIT)
    gen = torch.Generator(device="cuda").manual_seed(4325)
    lib, probe = libs["shipped"], libs["probe"]
    for gates, cell in CELLS.items():
        for B in (256, 24):
            sW, xa, lengths = cell_inputs(torch, gen, gates, B)
            early = cs.first_steps(torch, T, lengths, True, cs.P1_STEPS)
            twins = {"one-pass": plain(torch, gates, xa, sW, lengths),
                     "three-pass": plain(torch, gates, xa, sW, lengths, "bf16x3")}
            outs = {w: run(torch, lib, gates, w, xa, sW, lengths) for w in FORMS}
            torch.cuda.synchronize()
            for which, got in outs.items():
                what = FORMS[which]
                if not torch.isfinite(got).all():
                    raise AssertionError(f"{cell} {what} at B={B}: non-finite h")
                parts = []
                for k, want in twins.items():
                    dmax, dmean, dearly = cs.p1_distance(got, want, early)
                    parts.append(f"{k}: max {dmax:.2e} mean {dmean:.2e} first {cs.P1_STEPS} "
                                 f"steps {dearly:.2e}")
                cs.log(f"{cell} B={B}, the {what} against the plain twins: " + "; ".join(parts))
            h3_err = (outs[2] - twins["three-pass"]).abs().max().item()
            if not h3_err <= cs.H3_MAX:
                raise AssertionError(f"{cell} three-pass step at B={B}: {h3_err} from its twin")
            del twins, outs
            fns = {FORMS[w]: lambda w=w: run(torch, lib, gates, w, xa, sW, lengths)
                   for w in FORMS}
            times = cs.alternated_ms(torch, fns, cs.ALTERNATED_REPS)
            cs.log(f"{cell} recurrence alone at T={T}, B={B}, H={H}, alternated [{card}]: "
                   + "; ".join(f"{k} {cs.spread(ts)} = "
                               f"{1e3 * statistics.median(ts) / T:.3f} us a step"
                               for k, ts in times.items()))
            for which in PASSES:
                time_rows(torch, lib, gates, xa, sW, lengths, card, which)
            for which in FORMS:
                ms = cs.cuda_ms(torch, lambda: run(torch, probe, gates, which, xa, sW, lengths),
                                3)
                cs.log(f"{cell} step split at B={B}, {FORMS[which]} (probe build, {ms:.3f} ms a "
                       f"launch with the probe): "
                       + split(torch, probe, gates, which, xa, sW, lengths))
    cs.log(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
