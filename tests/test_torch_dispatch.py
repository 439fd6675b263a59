"""PyTorch port on the CPU: the Basecaller's packed-dispatch entries
(after tests/test_d8_upload.py, test_chunked.py and test_basecall.py's
uses of them).

- each of the eleven ``dispatch_packed_*`` entries and
  ``call_chunk_batch_device`` against the JAX Basecaller's entry of the
  same name on the same packed buffer (seeded synthetic ADC, the shrunk
  r941_native of test_torch_decode), unpacked on each side: path and
  nblocks equal, qchar equal from block 1 (byte 0 is the reference's
  never-read NaN qpath), score within rtol 2e-5, atol 1e-5, trace within
  one; both name the same program in ``dispatch_stats``; the bucket
  entries on a ``Basecaller(chunk=0)``, as JAX's tests call them;
- every grouped entry byte-equal to the concatenation of its batches'
  single dispatches (the port's own bytes), chunk and bucket, f32, i16
  and d8;
- the static packers byte-equal to JAX's;
- ``np.asarray`` on a handle equal to ``result()``, and on a
  DistributedBasecaller's handle over two CPU replicas (grouped
  included) equal to one device's bytes, ``wire_summary`` naming the
  programs on two devices;
- ``ops.activations.softplus`` and ``ops.masking.mask_tail_tm`` against
  JAX's.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from flappie_tpu import basecall as j_bc
from flappie_tpu.models.params import init_synthetic
from flappie_tpu.ops import activations as j_act
from flappie_tpu.ops import masking as j_mask

from flappie_tpu_torch import basecall as t_bc
from flappie_tpu_torch.ops import activations as t_act
from flappie_tpu_torch.ops import masking as t_mask
from flappie_tpu_torch.parallel import mesh as p_mesh
from flappie_tpu_torch.parallel import pipeline
from flappie_tpu_torch.signal.synthetic import synthetic_adc

from test_torch_decode import _small_cfgs

CHUNK, BUCKET, G = 1000, 1024, 3
LENGTHS = np.array([1000, 850, 5, 450], np.int32)
QLO, QHI = np.array([1, 40, 0, 1], np.int32), np.array([180, 161, 0, 61], np.int32)
RAW_UNIT = np.float32(1373.41) / np.float32(8192.0)

# entry -> (program family, wire, grouped)
ENTRIES = {
    "dispatch_packed_batch": ("bucket", "f32", False),
    "dispatch_packed_batch_i16": ("bucket", "i16", False),
    "dispatch_packed_batch_d8": ("bucket", "d8", False),
    "dispatch_packed_chunk": ("chunk", "f32", False),
    "dispatch_packed_chunk_i16": ("chunk", "i16", False),
    "dispatch_packed_chunk_d8": ("chunk", "d8", False),
    "dispatch_packed_chunk_grouped": ("chunk", "f32", True),
    "dispatch_packed_chunk_i16_grouped": ("chunk", "i16", True),
    "dispatch_packed_chunk_d8_grouped": ("chunk", "d8", True),
    "dispatch_packed_batch_i16_grouped": ("bucket", "i16", True),
    "dispatch_packed_batch_d8_grouped": ("bucket", "d8", True),
}
GROUPED = [n for n, (_, _, g) in ENTRIES.items() if g]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def small():
    jcfg, tcfg = _small_cfgs()
    return jcfg, tcfg, init_synthetic(jcfg, seed=5)


def _batch(rng, width: int, chunk: bool) -> dict:
    """One batch on every wire: {"f32", "i16", "d8": packed buffer}, and
    the f32 wire's arguments under "args".  ADC of real-like steps (every
    row fits its d8 exception slots); the f32 signal is the ADC scaled and
    med/MAD-normalised on the host."""
    B = len(LENGTHS)
    adc = np.zeros((B, width), np.int16)
    sig = np.zeros((B, width), np.float32)
    scal = np.zeros((B, 4), np.float32)
    for j, n in enumerate(LENGTHS):
        adc[j, :n] = synthetic_adc(int(n), rng, mean_dwell=30.0)
        pa = (adc[j, :n].astype(np.float32) + np.float32(16.0)) * RAW_UNIT
        med = np.float32(np.median(pa))
        mad = np.float32(np.median(np.abs(pa - med))) * np.float32(1.4826)
        scal[j] = (16.0, RAW_UNIT, med, max(mad, np.float32(1.0)))
        sig[j, :n] = (pa - med) / scal[j, 3]
    qlo, qhi = (QLO, QHI) if chunk else (np.zeros(B, np.int32),) * 2
    i16 = t_bc.pack_chunk_inputs_i16(adc, LENGTHS, qlo, qhi, scal)
    d8 = t_bc.encode_d8(i16)
    assert d8 is not None
    return {"f32": t_bc.pack_chunk_inputs(sig, LENGTHS, qlo, qhi), "i16": i16, "d8": d8,
            "args": (sig, LENGTHS, qlo, qhi)}


@pytest.fixture(scope="module")
def batches():
    """G batches of each family: {"chunk": [...], "bucket": [...]}."""
    rng = np.random.default_rng(23)
    return {kind: [_batch(rng, CHUNK if kind == "chunk" else BUCKET, kind == "chunk")
                   for _ in range(G)] for kind in ("chunk", "bucket")}


def _buffer(batches, name: str):
    kind, wire, grouped = ENTRIES[name]
    bufs = [b[wire] for b in batches[kind]]
    return (np.concatenate(bufs), G) if grouped else (bufs[0],)


def _callers(small, chunk: int):
    jcfg, tcfg, params = small
    return (j_bc.Basecaller(jcfg, params=params, chunk=chunk),
            t_bc.Basecaller(tcfg, params=params, chunk=chunk, device="cpu"))


def _hold(got, want, nstate: int, T1: int, jb, tb, chunk: bool):
    """The packed output bytes ``got`` (port) against ``want`` (JAX) by
    the rule of the module docstring."""
    assert got.dtype == want.dtype == np.uint8 and got.shape == want.shape
    if chunk:
        ts, tp, tq, tn, tt = tb.unpack_chunk_outputs(got)
        js, jp, jq, jn, jt = jb.unpack_chunk_outputs(want)
    else:
        ts, tp, tq, tn, tt = t_bc._unpack_chunk_outputs(got, T1, nstate, True)
        js, jp, jq, jn, jt = j_bc._unpack_chunk_outputs(want, T1, nstate, True)
    assert tt.shape == (got.shape[0], T1, nstate)
    np.testing.assert_array_equal(tn, jn)
    for b in range(got.shape[0]):
        n = int(jn[b]) + 1
        np.testing.assert_array_equal(tp[b, :n], jp[b, :n])
        np.testing.assert_array_equal(tq[b, 1:n], jq[b, 1:n])
        assert np.abs(tt[b, :n].astype(int) - jt[b, :n].astype(int)).max() <= 1
    np.testing.assert_allclose(ts, js, rtol=2e-5, atol=1e-5)


def _entry_args(batches, name: str) -> tuple:
    if name == "call_chunk_batch_device":
        return batches["chunk"][0]["args"]
    return _buffer(batches, name)


def _family(name: str) -> str:
    return "chunk" if name == "call_chunk_batch_device" else ENTRIES[name][0]


@pytest.fixture(scope="module")
def jax_runs(small, batches):
    """Every JAX entry on its buffer, each on a Basecaller of its own:
    {name: a future of (caller, output bytes)}.  The eleven programs
    compile on a few threads at once (each takes seconds to compile, on
    the CPU, and a fraction of one to run)."""
    from concurrent.futures import ThreadPoolExecutor

    jcfg, _, params = small

    def run(name):
        jb = j_bc.Basecaller(jcfg, params=params, chunk=CHUNK if _family(name) == "chunk" else 0)
        return jb, np.asarray(getattr(jb, name)(*_entry_args(batches, name)))

    with ThreadPoolExecutor(4) as pool:
        # call_chunk_batch_device reuses dispatch_packed_chunk's program
        futures = {name: pool.submit(run, name) for name in ENTRIES}
        futures["call_chunk_batch_device"] = pool.submit(
            lambda: (futures["dispatch_packed_chunk"].result(),
                     run("call_chunk_batch_device"))[1])
        yield futures


@pytest.mark.parametrize("name", list(ENTRIES) + ["call_chunk_batch_device"])
def test_entry_matches_jax(small, batches, jax_runs, name):
    kind = _family(name)
    tb = t_bc.Basecaller(small[1], params=small[2], chunk=CHUNK if kind == "chunk" else 0,
                         device="cpu")
    got = np.asarray(getattr(tb, name)(*_entry_args(batches, name)))
    jb, want = jax_runs[name].result()
    cfg = small[1]
    width = CHUNK if kind == "chunk" else BUCKET
    _hold(got, want, cfg.nstate, -(-width // cfg.total_stride) + 1, jb, tb, kind == "chunk")
    assert tb.dispatch_stats == jb.dispatch_stats
    assert sum(tb.dispatch_stats.values()) == 1


@pytest.mark.parametrize("name", GROUPED)
def test_grouped_entry_is_its_singles(small, batches, name):
    kind, wire, _ = ENTRIES[name]
    _, tb = _callers(small, 0)
    single = getattr(tb, name[: -len("_grouped")])
    bufs = [b[wire] for b in batches[kind]]
    per = np.concatenate([np.asarray(single(b)) for b in bufs])
    np.testing.assert_array_equal(np.asarray(getattr(tb, name)(np.concatenate(bufs), G)), per)
    program = (t_bc.CHUNK_PROGRAMS[wire][1] if kind == "chunk"
               else f"_device_basecall_packed_{wire}_grouped")
    assert tb.dispatch_stats[program] == 1


def test_static_packers_match_jax(batches):
    for kind in ("chunk", "bucket"):
        b = batches[kind][0]
        sig, lengths, qlo, qhi = b["args"]
        np.testing.assert_array_equal(t_bc.Basecaller.pack_chunk_inputs(sig, lengths, qlo, qhi),
                                      j_bc.Basecaller.pack_chunk_inputs(sig, lengths, qlo, qhi))
        W = b["i16"].shape[1] - 16
        scal = b["i16"][:, W:].copy().view(np.float32)[:, 3:7]
        got = t_bc.Basecaller.pack_chunk_inputs_i16(b["i16"][:, :W], lengths, qlo, qhi, scal)
        np.testing.assert_array_equal(got, b["i16"])
        np.testing.assert_array_equal(
            got, j_bc.Basecaller.pack_chunk_inputs_i16(b["i16"][:, :W], lengths, qlo, qhi, scal))
        np.testing.assert_array_equal(b["d8"], j_bc._encode_d8_np(b["i16"]))


def test_handle_reads_as_array(small, batches):
    """``np.asarray`` on a handle gives ``result()``'s bytes; so does
    ``unpack_chunk_outputs`` on the handle itself."""
    _, tb = _callers(small, CHUNK)
    h = tb.dispatch_packed_chunk_i16(batches["chunk"][0]["i16"])
    want = h.result()
    np.testing.assert_array_equal(np.asarray(h), want)
    copied = np.array(h, copy=True)
    np.testing.assert_array_equal(copied, want)
    assert not np.shares_memory(copied, want)
    np.testing.assert_array_equal(np.asarray(h, dtype=np.int32), want.astype(np.int32))
    for field, ref in zip(tb.unpack_chunk_outputs(h), tb.unpack_chunk_outputs(want)):
        np.testing.assert_array_equal(field, ref)


def test_mesh_handles_read_as_arrays(small, batches):
    """A DistributedBasecaller over two CPU replicas: a chunk entry's
    handle and a grouped bucket entry's read as one device's bytes.  Two
    rows a batch (lengths 5 and 450), one a shard."""
    _, tcfg, params = small
    _, tb = _callers(small, CHUNK)
    runs = {
        "dispatch_packed_chunk_i16": (batches["chunk"][0]["i16"][2:],),
        "dispatch_packed_batch_d8_grouped": (
            np.concatenate([b["d8"][2:] for b in batches["bucket"][:2]]), 2),
    }
    mesh = pipeline.DistributedBasecaller(tcfg, params=params, chunk=CHUNK,
                                          mesh=p_mesh.make_mesh(2, 1, devices=["cpu"] * 2))
    try:
        for name, args in runs.items():
            got = np.asarray(getattr(mesh, name)(*args))
            np.testing.assert_array_equal(got, np.asarray(getattr(tb, name)(*args)))
        summary = mesh.wire_summary()
    finally:
        mesh.close()
    assert set(summary) == {"_device_basecall_chunk_packed_i16[int16]",
                            "_device_basecall_packed_d8_grouped[int8]"}
    assert all(ent["devices"] == [2] and ent["dispatches"] == 1 for ent in summary.values())


def test_softplus_matches_jax():
    x = np.random.default_rng(4).normal(scale=30.0, size=(64, 33)).astype(np.float32)
    x[0, :4] = (0.0, -100.0, 100.0, -1e-7)
    np.testing.assert_allclose(t_act.softplus(torch.from_numpy(x)).numpy(),
                               np.asarray(j_act.softplus(jnp.asarray(x))), rtol=1e-6, atol=1e-7)


def test_mask_tail_tm_matches_jax():
    rng = np.random.default_rng(5)
    T, B, C = 17, 5, 3
    x = rng.normal(size=(T, B, C)).astype(np.float32)
    lengths = np.array([17, 0, 9, 1, 16], np.int32)
    got = t_mask.mask_tail_tm(torch.from_numpy(x), torch.from_numpy(lengths)).numpy()
    np.testing.assert_array_equal(got, np.asarray(j_mask.mask_tail_tm(jnp.asarray(x),
                                                                      jnp.asarray(lengths))))
    np.testing.assert_array_equal(got, x * (np.arange(T)[:, None] < lengths)[:, :, None])
