"""PyTorch port on the CPU: the d8 wire and grouped dispatch (after
tests/test_d8_upload.py and tests/test_chunked.py's grouped tests).

- ``encode_d8`` / ``_encode_d8_np`` give the JAX package's wire bytes, and
  ``_decode_d8`` gives back the i16 buffer bit for bit, as JAX's does:
  seeded synthetic ADC at chunk and full-read widths, hostile int16 jumps
  within a row's slots; ``_d8_widths`` inverts every wire width; a row
  past its slots, or a correction past int16, encodes to None;
- the d8 programs give the i16 programs' bytes (chunk and bucket), and
  each grouped chunk program (f32, i16 and d8) the concatenation of its
  batches' own dispatches;
- through ``Basecaller.basecall_raw_tables``: FLAPPIE_TPU_UPLOAD=d8, i16
  and f32 give the default run's results byte for byte, and
  ``dispatch_stats`` names the programs that ran; a batch that overflows
  its slots takes the i16 wire; FLAPPIE_TPU_DISPATCH_GROUP=2 and 3 give
  the same bytes through the grouped programs, a partial group at its
  own length; the prewarm's dummy batch decodes to nothing; a failed
  grouped dispatch drops only its batches' reads.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax

from flappie_tpu import basecall as j_bc
from flappie_tpu.models.params import init_synthetic

from flappie_tpu_torch import basecall as t_bc
from flappie_tpu_torch.models.params import params_to_torch
from flappie_tpu_torch.signal.preprocess import F32, RawTable
from flappie_tpu_torch.signal.synthetic import synthetic_adc

from test_torch_decode import _small_cfgs

OFFSET, RAW_UNIT = F32(16.0), F32(1373.41) / F32(8192.0)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _adc(rng, n):
    """Synthetic ADC with the real signal's rate of steps past int8 (events
    of ~30 samples: ~0.5% of deltas, against 1.56% of slots)."""
    return synthetic_adc(n, rng, mean_dwell=30.0)


def _pack(rows, lengths):
    B = rows.shape[0]
    scal = np.tile(np.array([OFFSET, RAW_UNIT, 100.0, 7.0], np.float32), (B, 1))
    z = np.zeros(B, np.int32)
    return t_bc.pack_chunk_inputs_i16(rows, lengths, z, z, scal)


def _decode(b8):
    return t_bc._decode_d8(torch.from_numpy(b8)).numpy()


@pytest.mark.parametrize("W", [4096, 12800, 65536])
def test_roundtrip_and_jax_wire_bytes(W):
    rng = np.random.default_rng(W)
    B = 3 if W == 65536 else 6
    rows = np.stack([_adc(rng, W) for _ in range(B)])
    lengths = np.array([W, W - 1, W // 2, 5, W, W - 300][:B], np.int32)
    for j, L in enumerate(lengths):
        rows[j, L:] = 0  # the pad region, as the packing leaves it
    buf16 = _pack(rows, lengths)
    b8 = t_bc.encode_d8(buf16)
    assert b8 is not None and b8.dtype == np.int8
    assert b8.shape == (B, W + 6 * t_bc.d8_exc_slots(W) + 32)
    assert b8.nbytes < 0.6 * buf16.nbytes
    np.testing.assert_array_equal(b8, t_bc._encode_d8_np(buf16))
    np.testing.assert_array_equal(b8, j_bc._encode_d8_np(buf16))
    out = _decode(b8)
    assert out.dtype == np.int16
    np.testing.assert_array_equal(out, buf16)
    np.testing.assert_array_equal(out, np.asarray(jax.jit(j_bc._decode_d8)(b8)))


def test_width_inversion():
    for W in (1, 5, 63, 64, 2048, 5120, 10000, 12800, 65536, 131072):
        exc = t_bc.d8_exc_slots(W)
        assert exc == j_bc.d8_exc_slots(W)
        assert t_bc._d8_widths(W + 6 * exc + 32) == (W, exc)
    with pytest.raises(ValueError):
        t_bc._d8_widths(12800 + 6 * t_bc.d8_exc_slots(12800) + 33)


def test_roundtrip_hostile_values():
    """Jumps over most of the int16 range, within a row's slots."""
    rng = np.random.default_rng(3)
    B, T = 4, 4096  # 64 slots a row, ~40 used
    rows = rng.integers(-50, 50, size=(B, T)).astype(np.int16)
    for j in range(B):
        pos = rng.choice(np.arange(1, T), size=20, replace=False)
        rows[j, pos] = rng.integers(-16000, 16000, size=20).astype(np.int16)
    buf16 = _pack(rows, np.full(B, T, np.int32))
    b8 = t_bc.encode_d8(buf16)
    assert b8 is not None
    np.testing.assert_array_equal(_decode(b8), buf16)
    np.testing.assert_array_equal(b8, j_bc._encode_d8_np(buf16))


def test_overflow_returns_none():
    T = 1024
    row = np.zeros((1, T), np.int16)
    row[0, ::2] = 200  # an exception every step, past ceil(T/64) slots
    buf = _pack(row, np.array([T], np.int32))
    assert t_bc.encode_d8(buf) is None and t_bc._encode_d8_np(buf) is None
    jump = _pack(np.array([[-32768, 32767, 0, 0]], np.int16), np.array([4], np.int32))
    assert t_bc.encode_d8(jump) is None and t_bc._encode_d8_np(jump) is None


@pytest.fixture(scope="module")
def small():
    jcfg, tcfg = _small_cfgs(hid=16)
    params = init_synthetic(jcfg, seed=1234)
    return tcfg, params


def _run(program, params, cfg, buf, *extra):
    with torch.inference_mode():
        return program(params_to_torch(params, "cpu"), torch.from_numpy(buf), *extra, cfg, 1.0,
                       False, True).numpy()


def _chunk_bufs(rng, G, B=4, W=2000):
    bufs = []
    for _ in range(G):
        rows = np.stack([_adc(rng, W) for _ in range(B)])
        lengths = np.array([W, W - 50, W // 2, 300], np.int32)[:B]
        for j, L in enumerate(lengths):
            rows[j, L:] = 0
        scal = np.tile(np.array([OFFSET, RAW_UNIT, 100.0, 7.0], np.float32), (B, 1))
        qlo, qhi = np.array([1, 40, 0, 1], np.int32)[:B], np.array([360, 341, 0, 61], np.int32)[:B]
        bufs.append(t_bc.pack_chunk_inputs_i16(rows, lengths, qlo, qhi, scal))
    return bufs


@pytest.mark.parametrize("program", ["chunk", "bucket"])
def test_d8_programs_equal_i16_programs(small, program):
    cfg, params = small
    buf16 = _chunk_bufs(np.random.default_rng(9), 1)[0]
    b8 = t_bc.encode_d8(buf16)
    assert b8 is not None
    name = "_device_basecall_chunk_packed" if program == "chunk" else "_device_basecall_packed"
    want = _run(getattr(t_bc, name + "_i16"), params, cfg, buf16)
    np.testing.assert_array_equal(_run(getattr(t_bc, name + "_d8"), params, cfg, b8), want)


@pytest.mark.parametrize("name,wire", [
    ("_device_basecall_chunk_packed", "f32"),
    ("_device_basecall_chunk_packed_i16", "i16"),
    ("_device_basecall_chunk_packed_d8", "d8"),
])
def test_grouped_programs_equal_per_batch(small, name, wire):
    cfg, params = small
    G = 3
    bufs = _chunk_bufs(np.random.default_rng(11), G)
    if wire == "d8":
        bufs = [t_bc.encode_d8(b) for b in bufs]
        assert all(b is not None for b in bufs)
    elif wire == "f32":
        bufs = [t_bc.pack_chunk_inputs(t_bc._unpack_i16(torch.from_numpy(b))[0].numpy(),
                                       *(b[:, -16:].copy().view(np.float32)[:, :3].T))
                for b in bufs]
    single, grouped = getattr(t_bc, name), getattr(t_bc, name + "_grouped")
    assert grouped.__name__ == name + "_grouped"
    per = [_run(single, params, cfg, b) for b in bufs]
    got = _run(grouped, params, cfg, np.concatenate(bufs), G)
    np.testing.assert_array_equal(got, np.concatenate(per))


def _reads(sizes, seed, hostile=()):
    rng = np.random.default_rng(seed)
    out = []
    for k, n in enumerate(sizes):
        adc = _adc(rng, n)
        if k in hostile:  # a step past int8 every other sample
            adc[::2] += 300
        raw = (adc.astype(F32) + OFFSET) * RAW_UNIT
        out.append(RawTable(f"d8-{k}", n, 0, n, raw, adc=adc, cal=(OFFSET, RAW_UNIT)))
    return out


# three reads over the 3000-sample chunk (three chunk batches of 4 rows)
# and three short ones (two bucket batches: 2048 and 4096)
SIZES = [9100, 6300, 4400, 2900, 2100, 2600]


def _call(cfg, params, env, monkeypatch, sizes=SIZES, hostile=(), **kw):
    for k in ("FLAPPIE_TPU_UPLOAD", "FLAPPIE_TPU_DISPATCH_GROUP"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    caller = t_bc.Basecaller(model=cfg, params=params, device="cpu", chunk=3000, overlap=600,
                             chunk_batch=4, **kw)
    res = caller.basecall_raw_tables(_reads(sizes, 21, hostile))
    return res, caller.dispatch_stats


def _same(a, b):
    assert [r is None for r in a] == [r is None for r in b]
    for x, y in zip(a, b):
        if x is not None:
            assert (x.basecall, x.quality, x.score, x.nblock) == (y.basecall, y.quality, y.score,
                                                                  y.nblock)
            assert np.array_equal(x.trace, y.trace)


@pytest.mark.parametrize("env,programs", [
    ({}, {"_device_basecall_chunk_packed_i16": 3, "_device_basecall_packed_i16": 2}),
    ({"FLAPPIE_TPU_UPLOAD": "d8"},
     {"_device_basecall_chunk_packed_d8": 3, "_device_basecall_packed_d8": 2}),
    ({"FLAPPIE_TPU_UPLOAD": "f32"},
     {"_device_basecall_chunk_packed": 3, "_device_basecall_packed": 2}),
    ({"FLAPPIE_TPU_DISPATCH_GROUP": "2"},  # 2 + 1 batches: the second group partial
     {"_device_basecall_chunk_packed_i16_grouped": 2, "_device_basecall_packed_i16": 2}),
    ({"FLAPPIE_TPU_UPLOAD": "d8", "FLAPPIE_TPU_DISPATCH_GROUP": "3"},
     {"_device_basecall_chunk_packed_d8_grouped": 1, "_device_basecall_packed_d8": 2}),
], ids=["default", "d8", "f32", "group2", "d8_group3"])
def test_wires_and_groups_give_the_default_bytes(small, monkeypatch, env, programs):
    cfg, params = small
    base, _ = _call(cfg, params, {}, monkeypatch, compute_trace=True)
    got, stats = _call(cfg, params, env, monkeypatch, compute_trace=True)
    assert stats == programs
    assert all(r is not None for r in got)
    _same(got, base)


def test_overflowing_batch_takes_the_i16_wire(small, monkeypatch):
    """One hostile long read: the chunk batches holding its chunks take
    i16 (encode_d8 gives None), the others d8; the bytes are the i16
    run's."""
    cfg, params = small
    sizes = [9100, 2100]
    base, _ = _call(cfg, params, {"FLAPPIE_TPU_UPLOAD": "i16"}, monkeypatch, sizes=sizes,
                    hostile=(0,))
    got, stats = _call(cfg, params, {"FLAPPIE_TPU_UPLOAD": "d8"}, monkeypatch, sizes=sizes,
                       hostile=(0,))
    assert stats == {"_device_basecall_chunk_packed_i16": 1, "_device_basecall_packed_d8": 1}
    _same(got, base)


def test_partial_group_runs_at_its_length(small, monkeypatch):
    """Under G=3 a run of one chunk batch dispatches a group of one batch,
    unpadded, with the default run's bytes; the prewarm's dummy batch
    (zero signal, an empty score range) is the same on the d8 wire."""
    cfg, params = small
    base, _ = _call(cfg, params, {}, monkeypatch, sizes=[9100])
    monkeypatch.setenv("FLAPPIE_TPU_DISPATCH_GROUP", "3")
    caller = t_bc.Basecaller(model=cfg, params=params, device="cpu", chunk=3000, overlap=600,
                             chunk_batch=4)
    seen = []
    orig = caller._dispatch

    def spy(program, buf, G=None, chaos=True):
        seen.append((program.__name__, buf.shape[0], G))
        return orig(program, buf, G, chaos)

    monkeypatch.setattr(caller, "_dispatch", spy)
    res = caller.basecall_raw_tables(_reads([9100], 21))
    assert seen == [("_device_basecall_chunk_packed_i16_grouped", 4, 1)]
    _same(res, base)
    dummy = caller._dummy_chunk_buf("i16", 4)
    sig, lengths, qlo, qhi = (t.numpy() for t in t_bc._unpack_i16(torch.from_numpy(dummy)))
    assert not sig.any() and (qlo == qhi).all() and (lengths == cfg.total_stride).all()
    d8 = caller._dummy_chunk_buf("d8", 4)
    np.testing.assert_array_equal(_decode(d8), dummy)


def test_failed_group_drops_only_its_reads(small, monkeypatch):
    """The first grouped dispatch fails: the reads whose chunks it carried
    are dropped, the later group's reads and the bucket reads called."""
    cfg, params = small
    monkeypatch.setenv("FLAPPIE_TPU_DISPATCH_GROUP", "2")
    caller = t_bc.Basecaller(model=cfg, params=params, device="cpu", chunk=3000, overlap=600,
                             chunk_batch=4)
    orig, calls = caller._dispatch, []

    def flaky(program, buf, G=None, chaos=True):
        calls.append(program.__name__)
        if len(calls) == 1:
            raise RuntimeError("injected")
        return orig(program, buf, G, chaos)

    monkeypatch.setattr(caller, "_dispatch", flaky)
    res = caller.basecall_raw_tables(_reads([4400, 4300, 4200, 4100, 2000], 23))
    # each long read makes 2 chunks: reads 0-3 fill the first group's 8 rows
    assert [r is None for r in res] == [True, True, True, True, False]
    assert calls[0] == "_device_basecall_chunk_packed_i16_grouped"
