"""ctypes binding of the native host library (native/preprocess.cpp).

Counterpart of flappie_tpu/native.py.  The C++ library holds two host
passes: per-read trimming and med-MAD normalisation on a thread pool
(``preprocess_batch``) and the d8 wire's encoder (``encode_d8``), each
bit-identical to the port's numpy versions (signal/preprocess.py and
basecall.py ``_encode_d8_np``).

The library is built at first use with ``g++`` and native/Makefile's
flags from native/preprocess.cpp into ``build/flappie_tpu_torch/``
(which .gitignore lists), and rebuilt when the source is newer.  Its
name carries a tag of the host's CPU (``-march=native`` code runs only on
a CPU with the same instruction sets), so a checkout copied to another
machine builds its own.  Nothing is written under native/, and the
library committed there is never loaded: it was built on another host
for that host's CPU.  Where the build fails, ``available()`` is false,
``preprocess_batch`` runs the numpy path and ``encode_d8`` raises
(basecall.encode_d8 then takes the numpy encoder).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
import threading
from typing import List, Optional, Sequence

import numpy as np

from .signal.preprocess import RawTable

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_ROOT, "native", "preprocess.cpp")
BUILD_DIR = os.path.join(_ROOT, "build", "flappie_tpu_torch")

def _host_tag() -> str:
    """12 hex digits of the machine type and the CPU's feature flags."""
    flags = ""
    try:
        with open("/proc/cpuinfo") as fh:
            flags = next((ln for ln in fh if ln.startswith(("flags", "Features"))), "")
    except OSError:
        pass
    return hashlib.sha1(f"{platform.machine()} {flags}".encode()).hexdigest()[:12]


LIB_NAME = f"libflappie_host-{_host_tag()}.so"
# native/Makefile's CXXFLAGS and LDFLAGS
CXXFLAGS = ("-O3", "-std=c++17", "-fPIC", "-Wall", "-Wextra", "-march=native")
LDFLAGS = ("-shared", "-pthread")

_lock = threading.Lock()
_lib = None
_tried = False
# g++'s output of the last build in this process
build_log = ""


def lib_path() -> str:
    return os.path.join(BUILD_DIR, LIB_NAME)


def _build() -> bool:
    """Compile SOURCE into lib_path() (through a temporary file, so that
    processes building at once never load a half-written library)."""
    global build_log
    path = lib_path()
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.{threading.get_ident()}.tmp"
    try:
        proc = subprocess.run(["g++", *CXXFLAGS, SOURCE, *LDFLAGS, "-o", tmp],
                              capture_output=True, text=True, timeout=300)
    except (OSError, subprocess.SubprocessError) as exc:
        build_log = str(exc)
        return False
    build_log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        if os.path.exists(tmp):
            os.remove(tmp)
        return False
    os.replace(tmp, path)
    return True


def _stale() -> bool:
    path = lib_path()
    return not os.path.exists(path) or os.path.getmtime(path) < os.path.getmtime(SOURCE)


def load() -> Optional[ctypes.CDLL]:
    """The loaded library, built if missing or stale; None if it cannot
    be built or loaded (tried once a process)."""
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        if not os.path.exists(SOURCE) or (_stale() and not _build()):
            return None
        try:
            lib = ctypes.CDLL(lib_path())
        except OSError:
            return None
        i64p = ctypes.POINTER(ctypes.c_int64)
        f32p = ctypes.POINTER(ctypes.c_float)
        lib.ft_preprocess_batch2.argtypes = [
            f32p, i64p, ctypes.c_int64,
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_float,
            ctypes.c_float, i64p, i64p, f32p, f32p, ctypes.c_int32,
        ]
        lib.ft_preprocess_batch2.restype = None
        lib.ft_encode_d8.argtypes = [
            ctypes.POINTER(ctypes.c_int16), ctypes.c_int64, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int8), ctypes.c_int32,
        ]
        lib.ft_encode_d8.restype = ctypes.c_int32
        lib.ft_version.restype = ctypes.c_int32
        _lib = lib
        return _lib


def available() -> bool:
    return load() is not None


def _f32p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _i64p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))


def preprocess_batch(
    reads: Sequence[RawTable],
    trim_start: int = 200,
    trim_end: int = 10,
    varseg_chunk: int = 100,
    varseg_thresh: float = 0.0,
    delta: float = 0.0,
    nthreads: int = 0,
) -> List[Optional[RawTable]]:
    """Trim + normalise a batch of reads on the native thread pool (the
    numpy path where the library is unavailable).  Inputs are never
    mutated: each read's active window is copied, trimmed and normalised,
    and a new RawTable comes back with the same ``n`` and absolute
    start/end, the same (med, mad) ``norm``; None where trimming consumed
    the read."""
    lib = load()
    if lib is None:
        from .basecall import preprocess_batch as numpy_batch

        return numpy_batch(reads, trim_start, trim_end, varseg_chunk, varseg_thresh, delta)
    valid_idx = [i for i, rt in enumerate(reads) if rt.raw is not None]
    offsets = np.zeros(len(valid_idx) + 1, dtype=np.int64)
    bufs = []
    for j, i in enumerate(valid_idx):
        win = np.ascontiguousarray(reads[i].active(), dtype=np.float32)
        bufs.append(win)
        offsets[j + 1] = offsets[j] + win.size
    signals = np.concatenate(bufs) if bufs else np.zeros(0, np.float32)
    n = len(valid_idx)
    starts, ends = np.zeros(n, np.int64), np.zeros(n, np.int64)
    meds, mads = np.zeros(n, np.float32), np.zeros(n, np.float32)
    lib.ft_preprocess_batch2(
        _f32p(signals), _i64p(offsets), n,
        trim_start, trim_end, varseg_chunk, ctypes.c_float(varseg_thresh),
        ctypes.c_float(delta), _i64p(starts), _i64p(ends),
        _f32p(meds), _f32p(mads), nthreads,
    )
    out: List[Optional[RawTable]] = [None] * len(reads)
    for j, i in enumerate(valid_idx):
        if starts[j] >= ends[j]:
            continue
        rt = reads[i]
        # a full-length buffer around the processed window, so that start
        # and end stay absolute indices as on the numpy path
        full = np.asarray(rt.raw, dtype=np.float32).copy()
        full[rt.start : rt.end] = signals[offsets[j] : offsets[j + 1]]
        out[i] = RawTable(
            uuid=rt.uuid, n=rt.n,
            start=rt.start + int(starts[j]), end=rt.start + int(ends[j]),
            raw=full, adc=rt.adc, cal=rt.cal,
            norm=(meds[j], mads[j]) if delta == 0.0 and mads[j] != 0.0 else None,
        )
    return out


def encode_d8(buf_i16: np.ndarray, nthreads: int = 0):
    """The d8 wire encode (ft_encode_d8), rows in parallel: bit-identical
    to basecall._encode_d8_np.  Returns the [B, W + 6*exc + 32] int8 wire
    buffer, or None when a row needs more exception slots than it has (or
    a correction beyond int16); raises RuntimeError where the library is
    unavailable (basecall.encode_d8 takes the numpy encoder then)."""
    lib = load()
    if lib is None:
        raise RuntimeError("the native host library is unavailable")
    buf = np.ascontiguousarray(buf_i16, np.int16)
    B, Wt = buf.shape
    W = Wt - 16
    exc = (W + 63) // 64
    out = np.empty((B, W + 6 * exc + 32), np.int8)
    rc = lib.ft_encode_d8(
        buf.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)),
        ctypes.c_int64(B), ctypes.c_int64(Wt),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)),
        ctypes.c_int32(nthreads),
    )
    return None if rc else out
