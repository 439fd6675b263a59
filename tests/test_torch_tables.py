"""PyTorch port: model tables, parameters and the host-side copies.

The port keeps its own copies of the JAX package's jax-free modules
(config, params, signal, chunking, fastx, seq); these tests hold each
copy to the original, bit for bit.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from flappie_tpu.io import fastx as j_fastx
from flappie_tpu.models import config as j_config
from flappie_tpu.models import params as j_params
from flappie_tpu.parallel import chunking as j_chunking
from flappie_tpu.signal import fast5 as j_fast5
from flappie_tpu.signal import preprocess as j_pre
from flappie_tpu.decode import seq as j_seq

from flappie_tpu_torch.io import fastx as t_fastx
from flappie_tpu_torch.models import config as t_config
from flappie_tpu_torch.models import params as t_params
from flappie_tpu_torch.parallel import chunking as t_chunking
from flappie_tpu_torch.signal import fast5 as t_fast5
from flappie_tpu_torch.signal import preprocess as t_pre
from flappie_tpu_torch.decode import seq as t_seq
from flappie_tpu_torch.signal.synthetic import synthetic_adc

MODEL_NAMES = sorted(j_config.MODELS)


def _as_dict(cfg):
    d = dataclasses.asdict(cfg)
    return d, (cfg.total_stride, cfg.nstate, [cfg.nblocks(n) for n in (1, 4, 5, 6, 12801)])


@pytest.mark.parametrize("name", MODEL_NAMES)
def test_model_tables_equal(name):
    assert _as_dict(t_config.MODELS[name]) == _as_dict(j_config.MODELS[name])
    assert t_config.FLAPPIE_MODELS == j_config.FLAPPIE_MODELS
    assert t_config.RUNNIE_MODELS == j_config.RUNNIE_MODELS
    assert t_config.get_model_config(name).out_dim == j_config.head_nparam(
        j_config.MODELS[name].head, j_config.MODELS[name].nbase)
    for n in (40, 60, 24):
        assert t_config.nbase_from_flipflop_nparam(n) == j_config.nbase_from_flipflop_nparam(n)


@pytest.mark.parametrize("name", MODEL_NAMES)
@pytest.mark.parametrize("seed", [0, 1234])
def test_init_synthetic_bit_equal(name, seed):
    a = j_params.flatten(j_params.init_synthetic(j_config.MODELS[name], seed=seed))
    b = t_params.flatten(t_params.init_synthetic(t_config.MODELS[name], seed=seed))
    assert t_params.param_shapes(t_config.MODELS[name]) == j_params.param_shapes(
        j_config.MODELS[name])
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype == np.float32
        np.testing.assert_array_equal(a[k], b[k])


def test_weights_cross_packages_through_npz(tmp_path):
    """JAX save_npz -> port load_npz + params_to_torch, and back."""
    cfg = t_config.MODELS["r941_native"]
    pj = j_params.init_synthetic(j_config.MODELS["r941_native"], seed=5)
    j_params.save_npz(str(tmp_path / "j.npz"), pj, j_config.MODELS["r941_native"])
    pt = t_params.load_npz(str(tmp_path / "j.npz"))
    t_params.validate(pt, cfg)
    tens = t_params.params_to_torch(pt, "cpu")
    for layer, d in pj.items():
        for k, v in d.items():
            assert tens[layer][k].dtype == torch.float32
            np.testing.assert_array_equal(tens[layer][k].numpy(), v)
    t_params.save_npz(str(tmp_path / "t.npz"), pt, cfg)
    back = j_params.flatten(j_params.load_npz(str(tmp_path / "t.npz")))
    for k, v in j_params.flatten(pj).items():
        np.testing.assert_array_equal(back[k], v)
    bad = dict(pt)
    bad["ff"] = {"W": pt["ff"]["W"][:, :3], "b": pt["ff"]["b"]}
    with pytest.raises(ValueError):
        t_params.validate(bad, cfg)


@pytest.mark.parametrize("nsample,chunk,overlap", [
    (40000, 12800, 1600), (12801, 12800, 1600), (5000, 4000, 800), (100, 2560, 600),
])
def test_chunk_plans_equal(nsample, chunk, overlap):
    a = j_chunking.plan_chunks(nsample, 5, chunk, overlap)
    b = t_chunking.plan_chunks(nsample, 5, chunk, overlap)
    assert dataclasses.asdict(a) == dataclasses.asdict(b)
    assert [dataclasses.asdict(r) for r in j_chunking.chunk_records(a)] == [
        dataclasses.asdict(r) for r in t_chunking.chunk_records(b)]


def test_preprocess_and_fast5_copies_equal(tmp_path):
    rng = np.random.default_rng(11)
    adc = synthetic_adc(9000, rng)
    t_fast5.write_single_read_fast5(str(tmp_path / "t.fast5"), adc, "read-t")
    j_fast5.write_single_read_fast5(str(tmp_path / "j.fast5"), adc, "read-j")
    for path in ("t.fast5", "j.fast5"):
        a = j_fast5.read_raw(str(tmp_path / path))
        b = t_fast5.read_raw(str(tmp_path / path))
        assert (a.uuid, a.n, a.start, a.end, a.cal) == (b.uuid, b.n, b.start, b.end, b.cal)
        np.testing.assert_array_equal(a.raw, b.raw)
        np.testing.assert_array_equal(a.adc, b.adc)
        for trim in ((200, 10), (60, 25)):
            ja = j_pre.trim_and_segment(dataclasses.replace(a, raw=a.raw.copy()), *trim, 150, 0.1)
            tb = t_pre.trim_and_segment(dataclasses.replace(b, raw=b.raw.copy()), *trim, 150, 0.1)
            assert (ja.start, ja.end) == (tb.start, tb.end)
            for delta in (0.0, 1.0):
                jn = j_pre.normalise_signal(dataclasses.replace(ja, raw=ja.raw.copy()), delta)
                tn = t_pre.normalise_signal(dataclasses.replace(tb, raw=tb.raw.copy()), delta)
                np.testing.assert_array_equal(jn.active(), tn.active())
                assert jn.norm == tn.norm


@pytest.mark.parametrize("chunk", [2, 3, 100, 150])
def test_vectorised_chunk_mads_bit_equal(chunk):
    """The port's vectorised trim statistics equal the JAX package's
    per-chunk mad_f32 loop bit for bit, and so do the trims."""
    rng = np.random.default_rng(chunk)
    for n in (chunk, 7 * chunk + 1, 5000):
        x = (rng.normal(90, 25, n) * rng.uniform(0.1, 3)).astype(np.float32)
        x[: n // 3] = np.round(x[: n // 3])  # ties inside chunks
        k = n // chunk
        want = np.array([j_pre.mad_f32(x[i * chunk : (i + 1) * chunk]) for i in range(k)],
                        np.float32)
        np.testing.assert_array_equal(t_pre.chunk_mads_f32(x[: k * chunk].reshape(k, chunk)), want)
        for perc in (0.0, 0.1, 0.5):
            a = j_pre.trim_raw_by_mad(j_pre.RawTable("u", n, 0, n, x.copy()), chunk, perc)
            b = t_pre.trim_raw_by_mad(t_pre.RawTable("u", n, 0, n, x.copy()), chunk, perc)
            assert (a.start, a.end) == (b.start, b.end)


def test_basecall_strings_and_formats_equal():
    rng = np.random.default_rng(3)
    path = rng.integers(0, 8, size=301).astype(np.int8)
    qpath = rng.normal(-0.5, 0.6, size=301).astype(np.float32)
    qbytes = j_seq.phred_chars(np.exp(qpath, dtype=np.float32))
    for q in (qpath, qbytes):
        assert t_seq.path_to_basecall(path, q, 300, 4) == j_seq.path_to_basecall(path, q, 300, 4)
    seq, qual = t_seq.path_to_basecall(path, qpath, 300, 4)
    args = dict(uuid="u-1", score=-123.456, basecall=seq, quality=qual, nblock=300,
                nsample=1600, trim_start=200, trim_end=1590)
    for fmt in t_fastx.OUTFORMATS:
        for uuid_primary in (True, False):
            assert t_fastx.format_read(
                fmt, "u-1", "r.fast5", uuid_primary, "p_", t_fastx.BasecallResult(**args)
            ) == j_fastx.format_read(
                fmt, "u-1", "r.fast5", uuid_primary, "p_", j_fastx.BasecallResult(**args))


def test_minimal_hdf5_codec_round_trips_with_h5py(tmp_path, monkeypatch):
    """Without h5py the port reads and writes single-read fast5 through
    its own minimal HDF5 codec: files it writes read back through h5py
    (JAX reader) identically, and it reads h5py-written files."""
    adc = synthetic_adc(7000, np.random.default_rng(12))
    j_fast5.write_single_read_fast5(str(tmp_path / "h5py.fast5"), adc, "read-x")
    want = j_fast5.read_raw(str(tmp_path / "h5py.fast5"))
    monkeypatch.setattr(t_fast5, "h5py", None)
    t_fast5.write_single_read_fast5(str(tmp_path / "min.fast5"), adc, "read-x")
    for got in (t_fast5.read_raw(str(tmp_path / "h5py.fast5")),
                t_fast5.read_raw(str(tmp_path / "min.fast5")),
                j_fast5.read_raw(str(tmp_path / "min.fast5"))):
        assert (got.uuid, got.n, got.cal) == (want.uuid, want.n, want.cal)
        np.testing.assert_array_equal(got.raw, want.raw)
        np.testing.assert_array_equal(got.adc, want.adc)
    (tmp_path / "bad.fast5").write_bytes(b"\x89HDF\r\n\x1a\n" + bytes(100))
    assert t_fast5.read_raw(str(tmp_path / "bad.fast5")).raw is None
