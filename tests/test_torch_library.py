"""PyTorch port on the CPU: the Basecaller's per-batch library entries
and the chunk-and-stitch helpers against the JAX package's.

- ``extract_chunks`` / ``stitch_trans`` (parallel/chunking.py) equal to
  JAX's on reads that take one chunk, a few and many;
- ``_device_decode`` on random transition weights, fb and Viterbi, with
  and without the trace: JAX's bytes and score;
- ``call_batch`` (fb and ``--viterbi``, trace on), ``basecall_read`` and
  ``basecall_read_chunked`` (a 20,000-sample read at chunk 4000, overlap
  1000, so that seven chunks are stitched) against JAX's: the stitched
  transitions within 5e-6 (relative to max(|w|, 1)), sequence and quality bytes equal, the trace
  within one count, the normalised score in its last printed digit
  (2e-5);
- ``call_batch_device`` hands back tensors on the Basecaller's device.

Seeded synthetic reads only; torch on one intra-op thread.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from flappie_tpu import basecall as j_basecall
from flappie_tpu.models import config as j_config
from flappie_tpu.models.params import init_synthetic
from flappie_tpu.parallel import chunking as j_chunking
from flappie_tpu.signal.preprocess import RawTable as JRawTable

from flappie_tpu_torch import basecall as p_basecall
from flappie_tpu_torch.parallel import chunking as p_chunking
from flappie_tpu_torch.signal.preprocess import RawTable, normalise_signal, trim_and_segment
from flappie_tpu_torch.signal.synthetic import synthetic_adc

CHUNK, OVERLAP = 4000, 1000
READ = 20_000


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """As in test_torch_models.py: the CPU path's recurrences are
    thousands of tiny steps, faster on one intra-op thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def params():
    return init_synthetic(j_config.get_model_config("r941_native"), seed=0)


@pytest.fixture(scope="module")
def callers(params):
    """(JAX's Basecaller, the port's on the CPU), one model and weights;
    chunk 4000 so that the 20,000-sample read takes the chunk program in
    basecall_read."""
    kw = dict(params=params, chunk=CHUNK, overlap=OVERLAP)
    return (j_basecall.Basecaller("r941_native", **kw),
            p_basecall.Basecaller("r941_native", device="cpu", **kw))


def _read(seed: int, n: int = READ):
    """The same synthetic read for each package: (JAX's RawTable, the
    port's), int16 ADC with its calibration and the pA signal."""
    adc = synthetic_adc(n, np.random.default_rng(seed))
    cal = (np.float32(4.0), np.float32(0.18))
    raw = ((adc.astype(np.float32) + cal[0]) * cal[1]).astype(np.float32)
    return (JRawTable(f"read-{seed}", n, 0, n, raw.copy(), adc=adc.copy(), cal=cal),
            RawTable(f"read-{seed}", n, 0, n, raw.copy(), adc=adc.copy(), cal=cal))


def _assert_same_result(a, b):
    assert a is not None and b is not None
    assert (a.uuid, a.nblock, a.trim_start, a.trim_end) == (b.uuid, b.nblock, b.trim_start,
                                                            b.trim_end)
    assert a.basecall == b.basecall and a.quality == b.quality
    assert abs(a.score / a.nblock - b.score / b.nblock) < 2e-5, (a.score, b.score)
    _assert_traces(a.trace, b.trace)


def _assert_traces(x, y):
    """Within one count (test_torch_trace.py's contract)."""
    assert x.shape == y.shape and x.dtype == y.dtype
    assert np.abs(x.astype(int) - y.astype(int)).max() <= 1


@pytest.mark.parametrize("nsample", [3_000, 4_000, 9_001, 20_000, 61_234])
def test_extract_and_stitch_match_jax(nsample):
    plan = p_chunking.plan_chunks(nsample, 5, CHUNK, OVERLAP)
    jplan = j_chunking.plan_chunks(nsample, 5, CHUNK, OVERLAP)
    seg = np.random.default_rng(nsample).normal(size=nsample).astype(np.float32)
    got, want = p_chunking.extract_chunks(seg, plan), j_chunking.extract_chunks(seg, jplan)
    for x, y in zip(got, want):
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x, y)
    tb = CHUNK // 5
    trans = np.random.default_rng(1).normal(size=(plan.nchunk, tb, 40)).astype(np.float32)
    stitched = p_chunking.stitch_trans(trans, plan)
    assert stitched.shape == (-(-nsample // 5), 40)
    np.testing.assert_array_equal(stitched, j_chunking.stitch_trans(trans, jplan))


@pytest.mark.parametrize("viterbi_only", [False, True])
@pytest.mark.parametrize("compute_trace", [False, True])
def test_device_decode_matches_jax(viterbi_only, compute_trace):
    rng = np.random.default_rng(5)
    trans = rng.normal(size=(3, 300, 40)).astype(np.float32)
    nblocks = np.array([300, 211, 5], np.int32)
    want = j_basecall._device_decode(jnp.asarray(trans), jnp.asarray(nblocks), 4, 8,
                                     viterbi_only, compute_trace)
    got = p_basecall._device_decode(torch.from_numpy(trans), torch.from_numpy(nblocks), 4, 8,
                                    viterbi_only, compute_trace)
    (ws, *wb), (gs, *gb) = [np.asarray(x) for x in want], [x.numpy() for x in got]
    np.testing.assert_allclose(gs, ws, rtol=1e-5)
    for x, y, name in zip(gb, wb, ["path", "qchar", "trace"]):
        assert x.dtype == y.dtype and x.shape == y.shape
        if name == "qchar":  # block 0's qpath is the reference's NaN: no byte of a call
            x, y = x[:, 1:], y[:, 1:]
        if name == "trace":
            _assert_traces(x, y)
        else:
            np.testing.assert_array_equal(x, y, err_msg=name)


@pytest.mark.parametrize("viterbi_only", [False, True])
def test_call_batch_matches_jax(params, viterbi_only):
    rng = np.random.default_rng(4)
    B, T = 3, 2048
    sig = rng.normal(size=(B, T)).astype(np.float32)
    lengths = np.array([T, 1500, 777], np.int32)
    kw = dict(params=params, viterbi_only=viterbi_only)
    want = j_basecall.Basecaller("r941_native", **kw).call_batch(sig, lengths)
    caller = p_basecall.Basecaller("r941_native", device="cpu", **kw)
    got = caller.call_batch(sig, lengths)
    names = ["score", "path", "qpath", "nblocks", "trace"]
    for x, y, name in zip(got, want, names):
        assert x.shape == y.shape and x.dtype == y.dtype, name
        if name == "score":  # a block's score, as the header prints it
            np.testing.assert_allclose(x / got[3], y / got[3], rtol=0, atol=2e-5)
        elif name == "qpath":  # block 0's is the reference's NaN: no byte of a call
            np.testing.assert_array_equal(x[:, 1:], y[:, 1:])
        elif name == "trace":
            _assert_traces(x, y)
        else:
            np.testing.assert_array_equal(x, y, err_msg=name)
    dev = caller.call_batch_device(torch.from_numpy(sig), torch.from_numpy(lengths))
    assert all(isinstance(t, torch.Tensor) and t.device == caller.device for t in dev)
    for t, x in zip(dev, got):
        np.testing.assert_array_equal(t.numpy(), x)


def test_basecall_read_matches_jax(callers):
    jcaller, pcaller = callers
    jr, pr = _read(21)
    _assert_same_result(pcaller.basecall_read(pr), jcaller.basecall_read(jr))
    assert pcaller.basecall_read(RawTable("none", 0, 0, 0, None)) is None


def test_basecall_read_chunked_matches_jax(callers):
    """The stitched transitions within 5e-6 of JAX's, then the whole
    read's call; the caller's read is not changed."""
    jcaller, pcaller = callers
    jr, pr = _read(22)
    raw0 = pr.raw.copy()
    want = jcaller.basecall_read_chunked(jr, chunk=CHUNK, overlap=OVERLAP)
    got = pcaller.basecall_read_chunked(pr, chunk=CHUNK, overlap=OVERLAP)
    np.testing.assert_array_equal(pr.raw, raw0)
    _assert_same_result(got, want)
    # the stitched matrix itself, as basecall_read_chunked builds it
    rt = normalise_signal(trim_and_segment(RawTable("u", READ, 0, READ, raw0.copy())))
    seg = rt.active()
    plan = p_chunking.plan_chunks(seg.size, 5, CHUNK, OVERLAP)
    assert plan.nchunk == 7
    chunks, lengths = p_chunking.extract_chunks(seg, plan)
    with torch.inference_mode():
        trans, _ = p_basecall._device_basecall_fwd(pcaller.params, torch.from_numpy(chunks),
                                                   torch.from_numpy(lengths), pcaller.cfg, 1.0)
    jtrans, _ = j_basecall._device_basecall_fwd(jcaller.params, jnp.asarray(chunks),
                                                jnp.asarray(lengths), jcaller.cfg, 1.0, "auto")
    got = p_chunking.stitch_trans(trans.numpy(), plan).astype(np.float64)
    want = j_chunking.stitch_trans(np.asarray(jtrans), plan).astype(np.float64)
    # the 5e-6 band relative to max(|w|, 1), test_torch_crf_seg.py's measure:
    # 4,000 blocks of five layers, where an f32 sum in another order moves a
    # weight of magnitude 2 by up to ~6e-6
    assert np.max(np.abs(got - want) / np.maximum(np.abs(want), 1.0)) < 5e-6
    # --reverse and the trim arguments through the same entry
    for kw in (dict(reverse=True), dict(trim_start=50, trim_end=50, varseg_thresh=0.5)):
        _assert_same_result(pcaller.basecall_read_chunked(_read(23)[1], CHUNK, OVERLAP, **kw),
                            jcaller.basecall_read_chunked(_read(23)[0], CHUNK, OVERLAP, **kw))
