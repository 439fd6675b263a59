"""PyTorch port on the CPU: flappie_tpu_torch/native.py, the ctypes
binding of native/preprocess.cpp.

- the library builds with g++ from native/preprocess.cpp into the build
  directory it is given (a temporary one here), and nothing is written
  under native/;
- ``preprocess_batch`` is bit-equal to the JAX package's numpy
  preprocessing (flappie_tpu/native.py's path without its library) and
  to the port's (signal bytes, trimmed windows, the (med, mad)
  scalars), in med-MAD and delta mode, on seeded synthetic ADC with a failing read (no
  signal) and a read that trims away in the batch, and leaves its inputs
  as they were;
- ``encode_d8`` is bit-equal to basecall._encode_d8_np, and returns None
  where a row overflows its exception slots, as the numpy encoder does;
- without the library (its source missing) ``available()`` is false,
  ``preprocess_batch`` runs the numpy path, ``encode_d8`` raises and
  basecall.encode_d8 takes the numpy encoder.
"""

from __future__ import annotations

import os
from dataclasses import fields

import numpy as np
import pytest

from flappie_tpu import native as j_native
from flappie_tpu.signal import preprocess as j_pre

from flappie_tpu_torch import basecall, native
from flappie_tpu_torch.signal.preprocess import F32, RawTable
from flappie_tpu_torch.signal.synthetic import synthetic_adc

OFFSET, RAW_UNIT = F32(16.0), F32(1373.41) / F32(8192.0)
NATIVE_DIR = os.path.dirname(native.SOURCE)


def _tree(path):
    return sorted((f, os.path.getmtime(os.path.join(path, f))) for f in os.listdir(path))


@pytest.fixture
def built(tmp_path, monkeypatch):
    """native.py with its library built afresh into tmp_path."""
    before = _tree(NATIVE_DIR)
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_tried", False)
    assert native.available(), native.build_log
    assert os.path.dirname(native.lib_path()) == str(tmp_path / "build")
    assert os.listdir(tmp_path / "build") == [native.LIB_NAME]
    yield native
    assert _tree(NATIVE_DIR) == before  # nothing written under native/


def _reads(seed=3, n=24):
    rng = np.random.default_rng(seed)
    reads = []
    for k in range(n):
        L = int(rng.integers(300, 30_000))
        adc = synthetic_adc(L, rng)
        raw = (adc.astype(F32) + OFFSET) * RAW_UNIT
        reads.append(RawTable(f"n{k}", L, 0, L, raw, adc=adc, cal=(OFFSET, RAW_UNIT)))
    reads.insert(5, RawTable(None, 0, 0, 0, None))  # a read that failed to load
    short = (synthetic_adc(150, rng).astype(F32) + OFFSET) * RAW_UNIT
    reads.insert(9, RawTable("short", 150, 0, 150, short))  # trims away
    return reads


def _same_read(a, b) -> bool:
    if a is None or b is None:
        return a is b
    return (a.uuid == b.uuid and a.n == b.n and (a.start, a.end) == (b.start, b.end)
            and a.raw.dtype == b.raw.dtype == np.float32
            and np.array_equal(a.raw.view(np.int32), b.raw.view(np.int32))
            and (a.norm is None) == (b.norm is None)
            and (a.norm is None or (F32(a.norm[0]).tobytes(), F32(a.norm[1]).tobytes())
                 == (F32(b.norm[0]).tobytes(), F32(b.norm[1]).tobytes())))


def _jax_preprocess(reads, monkeypatch, **kw):
    """The JAX package's preprocess_batch on its numpy path (its library
    left unloaded) over JAX RawTables of the same reads."""
    monkeypatch.setattr(j_native, "load", lambda: None)
    j_reads = [j_pre.RawTable(**{f.name: getattr(r, f.name) for f in fields(j_pre.RawTable)})
               for r in reads]
    return j_native.preprocess_batch(j_reads, **kw)


@pytest.mark.parametrize("delta", [0.0, 1.0], ids=["medmad", "delta"])
def test_preprocess_batch_bit_equal_to_numpy(built, monkeypatch, delta):
    reads = _reads()
    copies = [None if r.raw is None else r.raw.copy() for r in reads]
    got = built.preprocess_batch(reads, delta=delta)
    theirs = _jax_preprocess(reads, monkeypatch, delta=delta)
    assert all(_same_read(a, b) for a, b in zip(got, theirs))
    want = basecall.preprocess_batch(reads, delta=delta)
    assert len(got) == len(want) == len(theirs) == len(reads)
    assert got[5] is None and got[9] is None
    assert sum(r is not None for r in got) == len(reads) - 2
    assert all(_same_read(a, b) for a, b in zip(got, want))
    for r, c in zip(reads, copies):  # inputs untouched
        assert (r.raw is None) if c is None else np.array_equal(r.raw, c)


def test_preprocess_batch_trim_settings_and_threads(built, monkeypatch):
    reads = _reads(seed=4, n=10)
    kw = dict(trim_start=50, trim_end=30, varseg_chunk=80, varseg_thresh=0.3)
    want = _jax_preprocess(reads, monkeypatch, **kw)
    for nthreads in (1, 3):
        got = built.preprocess_batch(reads, nthreads=nthreads, **kw)
        assert all(_same_read(a, b) for a, b in zip(got, want))


def _i16_batch(rng, B, W, spread=None):
    adc = np.stack([synthetic_adc(W, rng) for _ in range(B)])
    if spread is not None:  # a smoother signal: fewer deltas past int8
        adc = (500 + (adc.astype(np.int32) - 500) // spread).astype(np.int16)
    lengths = rng.integers(1, W + 1, B).astype(np.int32)
    lengths[0] = W
    for j, L in enumerate(lengths):
        adc[j, L:] = 0
    scal = np.tile(np.array([OFFSET, RAW_UNIT, 100.0, 7.0], np.float32), (B, 1))
    z = np.zeros(B, np.int32)
    return basecall.pack_chunk_inputs_i16(adc, lengths, z, z, scal)


@pytest.mark.parametrize("W", [320, 2048, 4000])
def test_encode_d8_bit_equal_to_numpy(built, W):
    rng = np.random.default_rng(W)
    buf = _i16_batch(rng, 20, W, spread=4)
    want = basecall._encode_d8_np(buf)
    assert want is not None
    got = built.encode_d8(buf)
    assert got.dtype == np.int8 and np.array_equal(got, want)
    assert np.array_equal(built.encode_d8(buf, nthreads=1), want)


def test_encode_d8_overflow_returns_none(built):
    rng = np.random.default_rng(5)
    buf = _i16_batch(rng, 8, 2048, spread=4)
    buf[3, :2048:2] = 20_000  # a row of deltas far past int8, every other sample
    assert basecall._encode_d8_np(buf) is None
    assert built.encode_d8(buf) is None
    huge = _i16_batch(rng, 2, 256, spread=4)
    huge[1, 10], huge[1, 11] = -32_000, 32_000  # a correction beyond int16
    assert basecall._encode_d8_np(huge) is None and built.encode_d8(huge) is None


def test_without_the_library_numpy_takes_over(tmp_path, monkeypatch):
    monkeypatch.setattr(native, "SOURCE", str(tmp_path / "missing.cpp"))
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_tried", False)
    assert not native.available()
    reads = _reads(seed=6, n=6)
    assert all(_same_read(a, b) for a, b in zip(native.preprocess_batch(reads),
                                                 basecall.preprocess_batch(reads)))
    buf = _i16_batch(np.random.default_rng(7), 4, 512, spread=4)
    with pytest.raises(RuntimeError, match="unavailable"):
        native.encode_d8(buf)
    assert np.array_equal(basecall.encode_d8(buf), basecall._encode_d8_np(buf))
