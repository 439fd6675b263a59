"""Build and load the port's CUDA kernels.

Each source ``flappie_tpu_torch/csrc/<name>.cu`` exposes a plain C
interface and is compiled by ``nvcc`` for ``sm_90a`` into
``build/flappie_tpu_torch/lib<name>.so`` (a directory .gitignore lists)
the first time a wrapper launches one of its kernels, then loaded with
ctypes.  A library older than its source or than any shared header
``csrc/*.cuh`` is rebuilt.  ``build()``
compiles several sources at once, one ``nvcc`` process each.  No
``--use_fast_math``: precise ``expf``/``logf``/``tanhf`` belong to the
parity tier.

    python3 -m flappie_tpu_torch.ops.cuda_build [SOURCE ...]

builds the stale ones of the named sources (all by default) at once and
prints each one's nvcc seconds.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import sys
import threading
import time

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(PKG_DIR), "build", "flappie_tpu_torch")
# lstm_p1 and grumod_p1 hold the recurrences of precision ``default`` (the
# one-pass step product), lstm_h3 and grumod_h3 those of rnn ``high`` on the
# card (three passes): load() builds them only when a layer needs them
SOURCES = ("lstm", "grumod", "crf_scan", "crf_bt", "conv12", "lstm_p1", "grumod_p1", "lstm_h3",
           "grumod_h3")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

lock = threading.RLock()  # the builds, the loads and the typing of entry points
_count_lock = threading.Lock()
_libs: dict = {}
# nvcc's output per source from the last build in this process: ptxas
# prints each kernel's registers, shared memory and spills there
build_log: dict = {}
# seconds from the start of that build to each source's nvcc exit
build_seconds: dict = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")
    return path


def _paths(name: str):
    return (os.path.join(CSRC_DIR, name + ".cu"),
            os.path.join(BUILD_DIR, f"lib{name}.so"))


def _stale(name: str) -> bool:
    src, so = _paths(name)
    if not os.path.exists(so):
        return True
    deps = [src] + [os.path.join(CSRC_DIR, f) for f in os.listdir(CSRC_DIR) if f.endswith(".cuh")]
    return os.path.getmtime(so) < max(os.path.getmtime(d) for d in deps)


def read_async(proc):
    """Read ``proc``'s output on a thread of its own from now on, so that
    it never stalls on a full pipe and its exit is timed when it happens:
    returns wait() -> (stdout, stderr, time.perf_counter() at its exit)."""
    got = []
    th = threading.Thread(target=lambda: got.append((*proc.communicate(), time.perf_counter())),
                          daemon=True)
    th.start()

    def wait():
        th.join()
        return got[0]

    return wait


def build(names=SOURCES) -> list:
    """Compile every stale source in ``names`` (one nvcc per source, all
    started together); returns the names that were compiled."""
    with lock:
        todo = [n for n in names if _stale(n)]
        if not todo:
            return []
        os.makedirs(BUILD_DIR, exist_ok=True)
        nvcc = _nvcc()
        jobs = []
        t0 = time.perf_counter()
        try:
            for n in todo:
                src, so = _paths(n)
                tmp = f"{so}.{os.getpid()}.tmp"
                proc = subprocess.Popen(
                    [nvcc, *NVCC_FLAGS, "-o", tmp, src],
                    stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                )
                jobs.append((n, proc, read_async(proc), tmp, so))
        finally:
            failed = []
            for n, proc, wait, tmp, so in jobs:
                out, err, end = wait()
                build_log[n] = out + err
                build_seconds[n] = end - t0
                if proc.returncode == 0:
                    os.replace(tmp, so)
                else:
                    failed.append(f"{n}.cu:\n{err}")
        if failed:
            raise RuntimeError("nvcc failed for " + "\n".join(failed))
        return todo


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use."""
    with lock:
        lib = _libs.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(_paths(name)[1])
            lib.flappie_cuda_error_string.restype = ctypes.c_char_p
            lib.flappie_cuda_error_string.argtypes = [ctypes.c_int]
            _libs[name] = lib
        return lib


def check(lib: ctypes.CDLL, rc: int, what: str) -> None:
    """Raise on a launch error code returned by a C entry point."""
    if rc != 0:
        msg = lib.flappie_cuda_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")


def ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def count(wrapper) -> None:
    """One launch on ``wrapper.launches``.  A mesh's dispatch threads
    launch at once, and ``+=`` on an attribute is a read-modify-write
    that can drop a count across threads, so it takes a lock."""
    with _count_lock:
        wrapper.launches += 1


def stream_of(t) -> ctypes.c_void_p:
    import torch

    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


if __name__ == "__main__":
    built = build(sys.argv[1:] or SOURCES)
    print("nvcc seconds from the build's start to each exit, all at once: " + ", ".join(
        f"{n} {build_seconds[n]:.1f}" for n in built))
