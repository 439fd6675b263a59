"""PyTorch port: decode, network and device programs against JAX.

- decode_bm: path and quality bytes equal to the JAX package's,
  score within float32 reassociation, trace bytes within one count;
- the C oracle's own transition dumps (tests/goldens/ff_*_fastq.npz,
  and mc5_fb.npz for the 5-base r941_5mC model) decode to the golden
  FASTQ records;
- transitions within 5e-6 (the CPU band) and independent of padding, for
  the r941_native graph and the r941_5mC graph (stride-2 tanh conv,
  GRU-mod layers, 5 bases) at small widths;
- the packed int16 chunk and bucket programs give the JAX programs'
  output bytes: path, quality (but the unused NaN byte 0), nblocks
  bytes equal, trace bytes within one count, the bit-cast f32 score
  within 2e-5 relative (summation order);
- the bucket packing (``pack_bucket``) carries each read's normalised
  signal on either wire.
"""

from __future__ import annotations

import json
import os
import re
from dataclasses import replace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from flappie_tpu import basecall as j_bc
from flappie_tpu.models import config as j_config
from flappie_tpu.models.network import transitions as j_transitions
from flappie_tpu.models.params import init_synthetic
from flappie_tpu.ops import crf_bm as j_bm

from flappie_tpu_torch import basecall as t_bc
from flappie_tpu_torch.io.fastx import BasecallResult, format_read
from flappie_tpu_torch.decode.seq import path_to_basecall
from flappie_tpu_torch.models import config as t_config
from flappie_tpu_torch.models.network import transitions as t_transitions
from flappie_tpu_torch.models.params import params_to_torch
from flappie_tpu_torch.ops.crf import phred_from_qpath
from flappie_tpu_torch.ops.crf_bm import decode_bm

GOLDENS = os.path.join(os.path.dirname(__file__), "goldens")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """As in test_torch_models.py: beside the test runner's other workers,
    torch's intra-op thread pool spends longer waiting for its threads than
    computing the CPU path's many small steps (the mc5_fb golden case took
    200 s in a 6-worker run)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
_SCORE_RE = re.compile(r'"normalised_score" : (-?[\d.]+|nan)')


def _small_cfgs(hid=24, model="r941_native", nrnn=None):
    """``model``'s graph at a small width (its last conv and every
    recurrent layer ``hid`` wide; the first ``nrnn`` recurrent layers
    only, if given), in both packages."""
    out = []
    for mod in (j_config, t_config):
        cfg = mod.MODELS[model]
        convs = cfg.convs[:-1] + (replace(cfg.convs[-1], out_ch=hid),)
        rnns = tuple(replace(r, size=hid) for r in cfg.rnns[:nrnn])
        out.append(replace(cfg, convs=convs, rnns=rnns))
    return out


def _small_5mc_cfgs():
    """r941_5mC shrunk: the stride-2 tanh conv, 2 GRU-mod layers of 16."""
    return _small_cfgs(hid=16, model="r941_5mC", nrnn=2)


@pytest.mark.parametrize("viterbi_only", [False, True])
@pytest.mark.parametrize("compute_trace", [False, True])
def test_decode_bm_matches_jax(viterbi_only, compute_trace):
    B, T = 4, 200
    rng = np.random.default_rng(11)
    trans = rng.uniform(-4, 4, size=(B, T, 40)).astype(np.float32)
    nblocks = np.array([200, 160, 57, 1], np.int32)
    js, jp, jq, jt = (np.asarray(x) for x in j_bm.decode_bm(
        jnp.asarray(trans), jnp.asarray(nblocks), 4, viterbi_only, compute_trace))
    ts, tp, tq, tt = decode_bm(torch.from_numpy(trans), torch.from_numpy(nblocks), 4,
                               viterbi_only, compute_trace)
    np.testing.assert_allclose(ts.numpy(), js, rtol=2e-6, atol=1e-5)
    for b in range(B):
        n = int(nblocks[b]) + 1
        np.testing.assert_array_equal(tp.numpy()[b, :n], jp[b, :n])
        np.testing.assert_array_equal(
            phred_from_qpath(tq)[b, 1:n].numpy(),
            np.asarray(j_bc.phred_from_qpath(jnp.asarray(jq)))[b, 1:n])
        if compute_trace:
            d = tt.numpy()[b, :n].astype(int) - jt[b, :n].astype(int)
            assert np.abs(d).max() <= 1
    assert tt.shape == jt.shape


@pytest.mark.parametrize("case", ["ff_fb_fastq", "ff_ckpt_fastq", "mc5_fb"])
def test_decode_golden_transitions(case):
    """The C oracle's transition dump through the port's decode and
    formatting gives the golden FASTQ record: header bytes except the
    score's last digit, sequence and qualities byte for byte."""
    with open(os.path.join(GOLDENS, "manifest.json")) as fh:
        man = json.load(fh)
    nbase = t_config.MODELS[man["cases"][case]["model"]].nbase
    z = np.load(os.path.join(GOLDENS, f"{case}.npz"))
    trans, gold_trace = z["trans"], z["trace"]
    T = trans.shape[0]
    assert trans.shape[1] == 2 * nbase * (nbase + 1)
    buf = np.zeros((1, -(-T // 256) * 256, trans.shape[1]), np.float32)
    buf[0, :T] = trans
    score, path, qpath, trace = decode_bm(torch.from_numpy(buf), torch.tensor([T]), nbase,
                                          False, True)
    seq, qual = path_to_basecall(path[0].numpy(), phred_from_qpath(qpath)[0].numpy(), T, nbase)
    assert trace.shape[2] == 2 * nbase
    ns = man["nsample"]
    res = BasecallResult(uuid=man["uuid"], score=float(score[0]), basecall=seq, quality=qual,
                         nblock=T, nsample=ns, trim_start=200, trim_end=ns - 10)
    ours = format_read("fastq", man["uuid"], man["readname"], True, "", res)
    with open(os.path.join(GOLDENS, man["cases"][case]["output"])) as fh:
        gold = fh.read()
    assert ours.splitlines()[1:] == gold.splitlines()[1:]
    assert _SCORE_RE.sub("X", ours) == _SCORE_RE.sub("X", gold)
    a, b = (float(_SCORE_RE.search(s).group(1)) for s in (ours, gold))
    assert abs(a - b) < 2e-5
    d = trace[0, : gold_trace.shape[0]].numpy().astype(int) - gold_trace.astype(int)
    assert np.abs(d).max() <= 1


def _signal_batch(seed=0):
    rng = np.random.default_rng(seed)
    B, Tn = 3, 1203
    sig = rng.normal(size=(B, Tn)).astype(np.float32)
    lengths = np.array([1203, 999, 317], np.int32)
    sig = sig * (np.arange(Tn)[None, :] < lengths[:, None])
    return sig, lengths


def _nonzero_biases(params, seed):
    """init_synthetic leaves most biases 0; give every bias a value, so
    that a bias applied at the wrong place shows."""
    rng = np.random.default_rng(seed)
    for layer in params.values():
        layer["b"] = layer["b"] + rng.normal(0, 0.2, layer["b"].shape).astype(np.float32)
    return params


def _check_transitions(jcfg, tcfg, params, return_norm, incs_atol=5e-5):
    sig, lengths = _signal_batch()
    want = j_transitions(jax.tree.map(jnp.asarray, params), jcfg, jnp.asarray(sig),
                         jnp.asarray(lengths), 0.9, "scan", return_norm=return_norm)
    got = t_transitions(params_to_torch(params, "cpu"), tcfg, torch.from_numpy(sig),
                        torch.from_numpy(lengths), 0.9, return_norm=return_norm)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=0, atol=5e-6)
    if return_norm:
        np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]), rtol=1e-5, atol=5e-6)
        np.testing.assert_allclose(got[3].numpy(), np.asarray(want[3]), rtol=0, atol=incs_atol)


@pytest.mark.parametrize("return_norm", [False, True])
def test_transitions_match_jax(return_norm):
    jcfg, tcfg = _small_cfgs()
    _check_transitions(jcfg, tcfg, init_synthetic(jcfg, seed=3), return_norm)


@pytest.mark.parametrize("return_norm", [False, True])
def test_transitions_5mc_match_jax(return_norm):
    jcfg, tcfg = _small_5mc_cfgs()
    assert (tcfg.total_stride, tcfg.nstate, tcfg.out_dim) == (2, 10, 60)
    params = _nonzero_biases(init_synthetic(jcfg, seed=13), seed=14)
    # each increment is the difference of two running log-partitions,
    # which reach |logZ| ~ 2.1e3 over the 602 stride-2 blocks of this
    # batch (vs ~7e2 over 241 stride-5 blocks above), where one float32
    # ulp is 2.4e-4: two ulps of reassociation
    _check_transitions(jcfg, tcfg, params, return_norm, incs_atol=4.9e-4)


def _check_ignore_padding(jcfg, tcfg):
    params = params_to_torch(init_synthetic(jcfg, seed=4), "cpu")
    sig, lengths = _signal_batch(seed=1)
    a, nb = t_transitions(params, tcfg, torch.from_numpy(sig), torch.from_numpy(lengths))
    junk = sig + 50.0 * (np.arange(sig.shape[1])[None, :] >= lengths[:, None])
    wide = np.concatenate([junk, np.full((3, 397), 9.0, np.float32)], axis=1)
    b, _ = t_transitions(params, tcfg, torch.from_numpy(wide), torch.from_numpy(lengths))
    alone, _ = t_transitions(params, tcfg, torch.from_numpy(sig[2:]), torch.from_numpy(lengths[2:]))
    # the valid region does not see the tail; the library conv and
    # matmul block differently at another width or batch, so equal only
    # to the CPU band
    for r in range(3):
        n = int(nb[r])
        np.testing.assert_allclose(b[r, :n].numpy(), a[r, :n].numpy(), rtol=0, atol=5e-6)
    n = int(nb[2])
    np.testing.assert_allclose(alone[0, :n].numpy(), a[2, :n].numpy(), rtol=0, atol=5e-6)


def test_transitions_ignore_padding():
    _check_ignore_padding(*_small_cfgs())


def test_transitions_5mc_ignore_padding():
    _check_ignore_padding(*_small_5mc_cfgs())


def _i16_buffer(width, lengths, qlo, qhi, seed):
    from flappie_tpu_torch.signal.synthetic import synthetic_adc

    rng = np.random.default_rng(seed)
    B = len(lengths)
    adc = np.zeros((B, width), np.int16)
    scal = np.zeros((B, 4), np.float32)
    scal[:, 3] = 1.0
    raw_unit = np.float32(1373.41) / np.float32(8192.0)
    for j, n in enumerate(lengths):
        adc[j, :n] = synthetic_adc(n, rng)
        pa = (adc[j, :n].astype(np.float32) + np.float32(16.0)) * raw_unit
        med = np.float32(np.median(pa))
        mad = np.float32(np.median(np.abs(pa - med))) * np.float32(1.4826)
        scal[j] = (16.0, raw_unit, med, mad)
    return t_bc.pack_chunk_inputs_i16(adc, lengths, qlo, qhi, scal)


def _check_packed_programs(jcfg, tcfg, params, program, viterbi_only, qlo, qhi):
    W = 2000
    lengths = np.array([2000, 1700, 5, 900], np.int32)
    buf = _i16_buffer(W, lengths, qlo, qhi, seed=6)
    np.testing.assert_array_equal(buf, j_bc.Basecaller.pack_chunk_inputs_i16(
        buf[:, :W], lengths, qlo, qhi,
        buf[:, W:].copy().view(np.float32)[:, 3:7]))
    j_prog, t_prog = {
        "chunk": (j_bc._device_basecall_chunk_packed_i16, t_bc._device_basecall_chunk_packed_i16),
        "bucket": (j_bc._device_basecall_packed_i16, t_bc._device_basecall_packed_i16),
    }[program]
    want = np.asarray(j_prog(jax.tree.map(jnp.asarray, params), jnp.asarray(buf), jcfg, 1.0,
                             viterbi_only, True, "auto"))
    with torch.inference_mode():
        got = t_prog(params_to_torch(params, "cpu"), torch.from_numpy(buf), tcfg, 1.0,
                     viterbi_only, True).numpy()
    assert got.shape == want.shape and got.dtype == want.dtype == np.uint8
    T1 = W // tcfg.total_stride + 1
    js, jp, jq, jn, jt = j_bc._unpack_chunk_outputs(want, T1, jcfg.nstate, True)
    ts, tp, tq, tn, tt = t_bc._unpack_chunk_outputs(got, T1, tcfg.nstate, True)
    assert tt.shape == (len(lengths), T1, tcfg.nstate)
    np.testing.assert_array_equal(tn, -(-lengths // tcfg.total_stride))
    np.testing.assert_array_equal(tn, jn)
    for b in range(len(lengths)):
        n = int(jn[b]) + 1
        np.testing.assert_array_equal(tp[b, :n], jp[b, :n])
        # byte 0 is the reference's qpath[0] = NaN, never consumed:
        # the port maps it to 33 as phred_from_qpath intends, while
        # XLA:CPU's min may return the non-NaN operand there (-> 83)
        np.testing.assert_array_equal(tq[b, 1:n], jq[b, 1:n])
        assert np.abs(tt[b, :n].astype(int) - jt[b, :n].astype(int)).max() <= 1
    np.testing.assert_allclose(ts, js, rtol=2e-5, atol=1e-5)


@pytest.mark.parametrize("viterbi_only", [False, True])
@pytest.mark.parametrize("program", ["chunk", "bucket"])
def test_packed_i16_programs_match_jax(program, viterbi_only):
    jcfg, tcfg = _small_cfgs()
    _check_packed_programs(jcfg, tcfg, init_synthetic(jcfg, seed=5), program, viterbi_only,
                           qlo=np.array([1, 40, 0, 1], np.int32),
                           qhi=np.array([360, 341, 0, 181], np.int32))


@pytest.mark.parametrize("viterbi_only", [False, True])
@pytest.mark.parametrize("program", ["chunk", "bucket"])
def test_packed_i16_programs_5mc_match_jax(program, viterbi_only):
    """Stride 2, 10 states, 60 parameters per block through the packed
    programs and the output unpacking."""
    jcfg, tcfg = _small_5mc_cfgs()
    params = _nonzero_biases(init_synthetic(jcfg, seed=15), seed=16)
    _check_packed_programs(jcfg, tcfg, params, program, viterbi_only,
                           qlo=np.array([1, 100, 0, 1], np.int32),
                           qhi=np.array([900, 851, 0, 451], np.int32))


@pytest.mark.parametrize("wire", ["i16", "f32"])
def test_pack_bucket_carries_each_reads_signal(tmp_path, wire):
    """basecall.pack_bucket, the bucket packing of the flappie and runnie
    CLIs: the int16 wire when every read keeps its ADC counts, else the
    f32 wire; either unpacks to each read's host-normalised active
    signal (i16 within 1e-5, replayed from the ADC counts on the device;
    f32 exactly) and zero past its length."""
    from flappie_tpu_torch.signal.fast5 import read_raw, write_single_read_fast5
    from flappie_tpu_torch.signal.synthetic import synthetic_adc

    rng = np.random.default_rng(21)
    reads = []
    for k, n in enumerate((3000, 2400, 1800)):
        fn = str(tmp_path / f"r{k}.fast5")
        write_single_read_fast5(fn, synthetic_adc(n, rng), f"00000000-0000-4000-8000-{k:012d}")
        reads.append(read_raw(fn))
    pre = t_bc.preprocess_batch(reads)
    if wire == "f32":
        pre[1] = replace(pre[1], adc=None)  # one read without its counts
    bucket = 4096
    i16, buf = t_bc.pack_bucket(list(enumerate(pre)), bucket)
    assert i16 == (wire == "i16")
    if i16:
        assert buf.dtype == np.int16 and buf.shape == (3, bucket + 16)
        sig, lengths, _, _ = (t.numpy() for t in t_bc._unpack_i16(torch.from_numpy(buf)))
    else:
        assert buf.dtype == np.float32 and buf.shape == (3, bucket + 4)
        sig, lengths = buf[:, :bucket], buf[:, bucket].astype(np.int32)
    for j, rt in enumerate(pre):
        seg = rt.active()
        assert lengths[j] == seg.size == rt.end - rt.start
        if i16:
            np.testing.assert_allclose(sig[j, : seg.size], seg, rtol=0, atol=1e-5)
        else:
            np.testing.assert_array_equal(sig[j, : seg.size], seg)
        assert not sig[j, seg.size :].any()
