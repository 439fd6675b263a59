"""Where a step of the one-pass LSTM recurrence goes, on one CUDA card.

    python3 step_split.py

Builds a small source of its own (written under build/) that runs the
recurrence alone over a time-major xa [T, B, 4H] in three forms:
cluster_rnn.cuh's one-pass step on CUDA cores (DOT1, the LSTM's step
before csrc/cluster_rnn_mma.cuh), the tensor-core step of
cluster_rnn_mma.cuh, and cluster_rnn.cuh's f32 step; once as the
kernels ship and once with -DFLAPPIE_STEP_PROBE (csrc/step_probe.cuh),
both nvcc at once.  Then, at T=2560, H=256, B=256 and B=24, ragged
lengths including 0 and T, backward, the three forms each at its own
plan's rows (cluster_rnn.cuh's R=20 and R=2, the tensor-core step's R=16
and R=2):

1. ptxas's registers and spills of each kernel at R=20 and R=2, and HMMA
   in the tensor-core kernels' SASS (none in the others);
2. the tensor-core step against the CUDA-core one-pass step (the distance
   logged: the two sum the same exact products in other orders);
3. the three forms timed alternated over 10 runs (CUDA events), their
   microseconds a step, and the tensor-core step at each R of ROWS_AT[B]
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
// which: 0 cluster_rnn.cuh's one-pass step (DOT1), 1 the tensor-core step
// (cluster_rnn_mma.cuh), 2 cluster_rnn.cuh's f32 step; xa [T, B, 4H] f32 ->
// out [T, B, H].  Returns the launch error code.
extern "C" int flappie_probe_rnn(int which, const float* xa, const float* sW, const int* lengths,
                                 float* out, int T, int B, int H, int backward, void* stream) {
  const flappie::RnnArgs<float> a = {xa, sW, lengths, out, nullptr, T, B, H, backward,
                                     static_cast<cudaStream_t>(stream)};
  if (which == 0) return flappie::cluster_rnn<4, false, false, float, true>(a);
  if (which == 1) return flappie::cluster_rnn_mma<false, float>(a);
  return flappie::cluster_rnn<4, false, false, float, false>(a);
}
// the tensor-core step at R rows a cluster, whatever B (max_active: only
// ask how many of its clusters the card holds at once)
extern "C" int flappie_probe_rows(int R, const float* xa, const float* sW, const int* lengths,
                                  float* out, int T, int B, int H, int backward, void* stream,
                                  int* max_active) {
  const flappie::RnnArgs<float> a = {xa, sW, lengths, out, nullptr, T, B, H, backward,
                                     static_cast<cudaStream_t>(stream)};
  return flappie::cluster_rnn_mma_r<false, float>(a, R, max_active);
}
"""
# the two builds: {name: -D flags}
BUILDS = {"shipped": (), "probe": ("-DFLAPPIE_STEP_PROBE",)}
# rows a cluster the tensor-core step is timed at, by batch (its plan's
# and the others it instantiates)
ROWS_AT = {256: (8, 12, 16, 20), 24: (1, 2, 4)}
FORMS = {0: "CUDA-core one-pass (DOT1)", 1: "tensor-core", 2: "f32 step"}
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
        lib.flappie_probe_rnn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 4 + [
            ctypes.c_int] * 4 + [ctypes.c_void_p]
        lib.flappie_probe_rnn.restype = ctypes.c_int
        lib.flappie_probe_rows.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 4 + [
            ctypes.c_int] * 4 + [ctypes.c_void_p] * 2
        lib.flappie_probe_rows.restype = ctypes.c_int
    return libs


def log_code(libs: dict) -> None:
    """ptxas's registers and spills at R = 20 and 2, and the tensor-core
    instructions in each build's kernels."""
    from flappie_tpu_torch.ops import cuda_build

    for name in libs:
        text = cs.variant_log[name]
        for r in (20, 2):
            cs.log(f"ptxas {name} R={r}: tensor-core "
                   f"{cs.ptxas_usage(text, f'cluster_rnn_mma_kernelILi{-(-r // 8)}E')}; CUDA-core "
                   f"one-pass "
                   f"{cs.ptxas_usage(text, f'cluster_rnn_kernelILi4ELi{r}ELb0ELb0EfLb1E')}; f32 "
                   f"{cs.ptxas_usage(text, f'cluster_rnn_kernelILi4ELi{r}ELb0ELb0EfLb0E')}")
        so = os.path.join(cuda_build.BUILD_DIR, name, "libstep_shim.so")
        for kernel, code in sorted(sass_by_kernel(so).items()):
            hmma = sum(1 for ins in code if re.search(r"\bHMMA\b", ins))
            if ("cluster_rnn_mma_kernel" in kernel) != (hmma > 0):
                raise AssertionError(f"{name}: {kernel} issues {hmma} HMMA")
            if "mma_kernelILi3E" in kernel or "ILi4ELi20E" in kernel:
                cs.log(f"  SASS {name}: {kernel}: {len(code)} instructions, {hmma} HMMA")


def run(torch, lib, which: int, xa, sW, lengths):
    from flappie_tpu_torch.ops import cuda_build

    Tn, B, _ = xa.shape
    out = torch.empty(Tn, B, H, device=xa.device)
    rc = lib.flappie_probe_rnn(which, xa.data_ptr(), sW.data_ptr(), lengths.data_ptr(),
                               out.data_ptr(), Tn, B, H, 1,
                               torch.cuda.current_stream().cuda_stream)
    cuda_build.check(lib, rc, f"flappie_probe_rnn({which})")
    return out


def time_rows(torch, lib, xa, sW, lengths, card: str) -> None:
    """The tensor-core step at each R of ROWS_AT[B], alternated, each
    bit-equal to the plan's, with the clusters it launches and the
    clusters the card holds at once."""
    from flappie_tpu_torch.ops import cuda_build

    Tn, B, _ = xa.shape
    stream = torch.cuda.current_stream().cuda_stream

    def launch(R):
        out = torch.empty(Tn, B, H, device=xa.device)
        rc = lib.flappie_probe_rows(R, xa.data_ptr(), sW.data_ptr(), lengths.data_ptr(),
                                    out.data_ptr(), Tn, B, H, 1, stream, None)
        cuda_build.check(lib, rc, f"flappie_probe_rows({R})")
        return out

    ref = run(torch, lib, 1, xa, sW, lengths)
    held = []
    for R in ROWS_AT[B]:
        n = ctypes.c_int(0)
        cuda_build.check(lib, lib.flappie_probe_rows(R, 0, 0, 0, 0, Tn, B, H, 1, stream,
                                                     ctypes.addressof(n)), "max active")
        if not torch.equal(launch(R), ref):
            raise AssertionError(f"R={R} at B={B} is not the plan's output bit for bit")
        held.append(f"R={R}: {-(-B // R)} clusters, the card holds {n.value}")
    times = cs.alternated_ms(torch, {R: lambda R=R: launch(R) for R in ROWS_AT[B]},
                             cs.ALTERNATED_REPS)
    cs.log(f"tensor-core step by rows a cluster at T={Tn}, B={B} [{card}], each bit-equal to "
           f"the plan's: " + "; ".join(held) + "; " + "; ".join(
               f"R={R} {cs.spread(ts)} = {1e3 * statistics.median(ts) / Tn:.3f} us a step"
               for R, ts in times.items()))


def split(torch, lib, which: int, xa, sW, lengths) -> str:
    """The probe's buckets of one launch, in microseconds a step."""
    run(torch, lib, which, xa, sW, lengths)
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


def smoke(torch, libs: dict) -> None:
    """One short launch of every form in every build (T=8, B=24), each
    finite: run first in a child process with a time limit, so that a
    kernel that never finishes is killed with it."""
    dev = torch.device("cuda")
    gen = torch.Generator(device="cuda").manual_seed(1)
    sW = torch.randn(H, 4 * H, generator=gen, device=dev) / H ** 0.5
    xa = torch.randn(8, 24, 4 * H, generator=gen, device=dev)
    lengths = torch.full((24,), 8, dtype=torch.int32, device=dev)
    for name, lib in libs.items():
        for which in FORMS:
            out = run(torch, lib, which, xa, sW, lengths)
            torch.cuda.synchronize()
            if not torch.isfinite(out).all():
                raise AssertionError(f"smoke: {name} form {which}: non-finite h")
    cs.log("smoke: every form of every build ran at T=8, B=24")


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
    dev = torch.device("cuda")
    gen = torch.Generator(device="cuda").manual_seed(4325)
    sW = torch.randn(H, 4 * H, generator=gen, device=dev) / H ** 0.5
    for B in (256, 24):
        lengths = torch.randint(1, T, (B,), generator=gen, device=dev, dtype=torch.int32)
        lengths[0], lengths[1] = T, 0
        xa = torch.randn(T, B, 4 * H, generator=gen, device=dev)
        xa[:, :, H : 2 * H] += 1.0
        early = cs.first_steps(torch, T, lengths, True, cs.P1_STEPS)
        lib = libs["shipped"]
        ref = run(torch, lib, 0, xa, sW, lengths)
        f32 = run(torch, lib, 2, xa, sW, lengths)
        got = run(torch, lib, 1, xa, sW, lengths)
        torch.cuda.synchronize()
        if not torch.isfinite(got).all():
            raise AssertionError(f"tensor-core step at B={B}: non-finite h")
        dmax, dmean, dearly = cs.p1_distance(got, ref, early)
        cmax, cmean, cearly = cs.p1_distance(f32, ref, early)
        cs.log(f"B={B}, tensor-core step against the CUDA-core one-pass step: max {dmax:.2e} "
               f"mean {dmean:.2e} first {cs.P1_STEPS} steps {dearly:.2e}; the f32 step against "
               f"it: max {cmax:.2e} mean {cmean:.2e} first steps {cearly:.2e}")
        del ref, f32, got
        fns = {"DOT1": lambda: run(torch, lib, 0, xa, sW, lengths),
               "mma": lambda: run(torch, lib, 1, xa, sW, lengths),
               "f32": lambda: run(torch, lib, 2, xa, sW, lengths)}
        times = cs.alternated_ms(torch, fns, cs.ALTERNATED_REPS)
        cs.log(f"recurrence alone at T={T}, B={B}, H={H}, alternated [{card}]: " + "; ".join(
            f"{k} {cs.spread(ts)} = {1e3 * statistics.median(ts) / T:.3f} us a step"
            for k, ts in times.items()))
        time_rows(torch, lib, xa, sW, lengths, card)
        probe = libs["probe"]
        for which in FORMS:
            ms = cs.cuda_ms(torch, lambda: run(torch, probe, which, xa, sW, lengths), 3)
            cs.log(f"step split at B={B}, {FORMS[which]} (probe build, {ms:.3f} ms a launch with "
                   f"the probe): " + split(torch, probe, which, xa, sW, lengths))
    cs.log(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
