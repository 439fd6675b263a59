"""PyTorch port on the CPU: the ``--trace`` HDF5 file and trace_view,
against the JAX package.

- ``signal/hdf5_min.py`` writes chunked gzip+shuffle datasets (float32
  and uint8, deflate levels 1 and 9, lengths on and off the chunk grid,
  length 0) and groups of any size that h5py reads back equal, with the
  chunking and filters h5py reports for its own files; it reads the
  files that h5py (the JAX TraceWriter) wrote, and h5py can append to
  the files it wrote;
- the port's ``TraceWriter``, through h5py and with the port's ``h5py``
  patched to None (hdf5_min), writes what the JAX one writes: the same
  groups, datasets, chunks and filters, contiguous datasets at
  compression 0, and an existing file's groups kept and replaced (last
  write wins);
- ``flappie_tpu_torch.cli.flappie --trace`` against the JAX CLI on
  seeded synthetic reads (chunked and bucketed, fb and ``--viterbi``):
  FASTQ bytes equal but for the score's last digit, ``signal`` equal,
  ``trace`` within one count (the JAX package's own contract against the
  C oracle, tests/test_reference_parity.py), and each trace row after
  the first summing to 255 +- 4 in fb (8 posteriors, each rounded by at
  most 0.5; --viterbi's trace exponentiates unnormalised weights);
- ``trace_view.iter_traces`` equal to JAX's on a flappie trace file and
  on Guppy single- and multi-read fast5 layouts, through h5py and
  through hdf5_min; ``main`` plotting two PNGs.
"""

from __future__ import annotations

import sys

import h5py
import numpy as np
import pytest
import torch

from flappie_tpu.cli import trace_view as j_view
from flappie_tpu.cli.flappie import main as j_main
from flappie_tpu.io import trace_h5 as j_trace_h5
from flappie_tpu.io.fastx import BasecallResult as JResult

from flappie_tpu_torch.cli import trace_view as p_view
from flappie_tpu_torch.cli.flappie import main as p_main
from flappie_tpu_torch.io import trace_h5 as p_trace_h5
from flappie_tpu_torch.io.fastx import BasecallResult
from flappie_tpu_torch.signal import hdf5_min
from flappie_tpu_torch.signal.fast5 import write_single_read_fast5
from flappie_tpu_torch.signal.synthetic import synthetic_adc

from test_torch_e2e import CHUNK_ARGS, _assert_same_output, _run
from test_torch_serve import write_multi_min

WRITERS = ["h5py", "hdf5_min"]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """As in test_torch_models.py: the CPU path's thousands of tiny
    recurrence steps run faster on one intra-op thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def writer(request, monkeypatch):
    """The port's TraceWriter backend: h5py, or hdf5_min with the port's
    ``h5py`` patched to None, as on a host without it."""
    if request.param == "hdf5_min":
        monkeypatch.setattr(p_trace_h5, "h5py", None)
    return request.param


def _h5py_meta(ds) -> tuple:
    return ds.dtype, ds.shape, ds.chunks, ds.compression, ds.compression_opts, ds.shuffle


# -- hdf5_min: chunked, filtered datasets and groups of any size ----------------


@pytest.mark.parametrize("n", [400, 450, 0])
@pytest.mark.parametrize("level", [1, 9])
@pytest.mark.parametrize("kind", ["signal", "trace"])
def test_hdf5_min_chunked_round_trip_read_by_h5py(tmp_path, kind, level, n):
    """A chunked gzip+shuffle dataset (edge chunks padded to the full
    chunk shape, an empty one without chunks) reads back equal through
    h5py, with the filters h5py reports for the same dataset it wrote
    itself, and through hdf5_min with its layout kept."""
    rng = np.random.default_rng(n + level)
    if kind == "signal":
        data = rng.normal(size=n).astype(np.float32)
        chunks = (min(200, max(n, 1)),)
    else:
        data = rng.integers(0, 256, (n, 8)).astype(np.uint8)
        chunks = (min(200, max(n, 1)), 8)
    path = tmp_path / "min.h5"
    hdf5_min.write(str(path), hdf5_min.Node(children={"ds": hdf5_min.Node(
        data=data, chunks=chunks, compression=level, shuffle=True)}))
    with h5py.File(path, "r") as f:
        ds = f["ds"]
        np.testing.assert_array_equal(ds[()], data)
        assert _h5py_meta(ds) == (data.dtype, data.shape, chunks, "gzip", level, True)
    if n:  # h5py refuses a chunk larger than an empty dataset's shape
        ref = tmp_path / "ref.h5"
        with h5py.File(ref, "w") as f:
            f.create_dataset("ds", data=data, chunks=chunks, compression="gzip",
                             compression_opts=level, shuffle=True)
        with h5py.File(ref, "r") as f, h5py.File(path, "r") as g:
            assert _h5py_meta(f["ds"]) == _h5py_meta(g["ds"])
    back = hdf5_min.read(str(path)).children["ds"]
    np.testing.assert_array_equal(back.data, data)
    assert back.data.dtype == data.dtype
    assert (back.chunks, back.compression, back.shuffle) == (chunks, level, True)


def test_hdf5_min_group_of_300_entries(tmp_path):
    """Groups past one symbol-table node (8 entries) and past one B-tree
    node (256 entries): h5py lists and opens every entry, appends to the
    file (libhdf5 splitting the nodes hdf5_min wrote), and hdf5_min reads
    the result back in name order."""
    rng = np.random.default_rng(3)
    names = [f"read-{k:04d}" for k in rng.permutation(300)]
    data = {n: rng.normal(size=int(rng.integers(1, 500))).astype(np.float32) for n in names}
    root = hdf5_min.Node(children={n: hdf5_min.Node(children={"signal": hdf5_min.Node(
        data=d, chunks=(min(200, d.size),), compression=1, shuffle=True)}) for n, d in data.items()})
    path = tmp_path / "big.h5"
    hdf5_min.write(str(path), root)
    with h5py.File(path, "a") as f:
        assert list(f.keys()) == sorted(names)
        for n in names:
            np.testing.assert_array_equal(f[n]["signal"][()], data[n])
        del f[names[0]]
        for k in range(40):
            f.create_dataset(f"zz-{k:02d}", data=np.arange(k + 1, dtype=np.int16))
    back = hdf5_min.read(str(path))
    assert list(back.children) == sorted(names[1:] + [f"zz-{k:02d}" for k in range(40)])
    for n in names[1:]:
        np.testing.assert_array_equal(back.children[n].children["signal"].data, data[n])
    np.testing.assert_array_equal(back.children["zz-39"].data, np.arange(40, dtype=np.int16))


def _results(seed: int, lengths, stride: int = 5):
    """Seeded BasecallResults: a trimmed signal and a trace of nblock + 1
    rows for each length (uuid ``res-<k>``), in both packages' types."""
    rng = np.random.default_rng(seed)
    out = []
    for k, n in enumerate(lengths):
        nblock = -(-n // stride)
        fields = dict(uuid=f"res-{k}", score=1.0, basecall="ACGT", quality="!!!!", nblock=nblock,
                      nsample=n + 210, trim_start=200, trim_end=n + 200,
                      trace=rng.integers(0, 256, (nblock + 1, 8)).astype(np.uint8),
                      signal=rng.normal(size=n).astype(np.float32))
        out.append((BasecallResult(**fields), JResult(**fields)))
    return out


@pytest.mark.parametrize("level", [0, 1, 9])
@pytest.mark.parametrize("writer", WRITERS, indirect=True)
def test_trace_writer_matches_jax(tmp_path, writer, level):
    """Equal group names and datasets, and the chunks and filters h5py
    reports; contiguous datasets at compression 0."""
    results = _results(5, [1, 150, 200, 999, 4321])
    for path, mod, pick in ((tmp_path / "jax.h5", j_trace_h5, 1), (tmp_path / "port.h5",
                                                                     p_trace_h5, 0)):
        with mod.TraceWriter(str(path), 200, level) as w:
            for pair in results:
                w.write(pair[pick].uuid, pair[pick])
    with h5py.File(tmp_path / "jax.h5", "r") as a, h5py.File(tmp_path / "port.h5", "r") as b:
        assert list(a.keys()) == list(b.keys()) == [f"res-{k}" for k in range(5)]
        for g in a:
            assert list(a[g].keys()) == list(b[g].keys()) == ["signal", "trace"]
            for d in ("signal", "trace"):
                np.testing.assert_array_equal(a[g][d][()], b[g][d][()])
                assert _h5py_meta(a[g][d]) == _h5py_meta(b[g][d])
                assert (a[g][d].chunks is None) == (level == 0)


@pytest.mark.parametrize("first,second", [("h5py", "h5py"), ("hdf5_min", "hdf5_min"),
                                          ("h5py", "hdf5_min"), ("hdf5_min", "h5py")])
def test_trace_writer_appends_last_write_wins(tmp_path, monkeypatch, first, second):
    """A second run into an existing file keeps the groups it does not
    write and replaces the ones it does, whichever backend wrote the file."""
    path = tmp_path / "t.h5"
    old = _results(7, [300, 420, 90])
    new = _results(8, [610, 75])
    for backend, batch, names in ((first, old, ["a", "b", "c"]), (second, new, ["b", "d"])):
        monkeypatch.setattr(p_trace_h5, "h5py", h5py if backend == "h5py" else None)
        with p_trace_h5.TraceWriter(str(path), 200, 1) as w:
            for name, (res, _) in zip(names, batch):
                w.write(name, res)
    want = {"a": old[0][0], "b": new[0][0], "c": old[2][0], "d": new[1][0]}
    with h5py.File(path, "r") as f:
        assert list(f.keys()) == sorted(want)
        for name, res in want.items():
            np.testing.assert_array_equal(f[name]["signal"][()], res.signal)
            np.testing.assert_array_equal(f[name]["trace"][()], res.trace)


def test_trace_writer_without_h5py_refuses_an_unreadable_file(tmp_path, monkeypatch):
    """A file hdf5_min cannot read (not HDF5, or a filter outside shuffle
    and deflate) raises and is left as it was."""
    monkeypatch.setattr(p_trace_h5, "h5py", None)
    junk = tmp_path / "junk.h5"
    junk.write_bytes(b"not an hdf5 file")
    lzf = tmp_path / "lzf.h5"
    with h5py.File(lzf, "w") as f:
        f.create_dataset("x/signal", data=np.ones(300, np.float32), chunks=(100,),
                         compression="lzf")
    for path in (junk, lzf):
        before = path.read_bytes()
        with pytest.raises(ValueError):
            p_trace_h5.TraceWriter(str(path))
        assert path.read_bytes() == before


def test_hdf5_min_reads_the_jax_trace_writer(tmp_path):
    """The JAX TraceWriter's h5py files, chunked and contiguous, read by
    hdf5_min with their layout."""
    results = _results(11, [45, 650, 2000])
    for level in (0, 1):
        path = tmp_path / f"jax{level}.h5"
        with j_trace_h5.TraceWriter(str(path), 200, level) as w:
            for _, res in results:
                w.write(res.uuid, res)
        root = hdf5_min.read(str(path))
        assert list(root.children) == [res.uuid for _, res in results]
        for _, res in results:
            grp = root.children[res.uuid]
            for d, want in (("signal", res.signal), ("trace", res.trace)):
                node = grp.children[d]
                np.testing.assert_array_equal(node.data, want)
                assert node.data.dtype == want.dtype
                assert (node.compression, node.shuffle) == (level, level > 0)
                assert (node.chunks is None) == (level == 0)


# -- the CLIs ----------------------------------------------------------------------


@pytest.fixture(scope="module")
def reads(tmp_path_factory):
    """Three single-read files (the second chunked under CHUNK_ARGS) and a
    multi-read file of two reads."""
    d = tmp_path_factory.mktemp("trace_reads")
    rng = np.random.default_rng(31)
    for k, n in enumerate([3000, 5200, 2600]):
        write_single_read_fast5(str(d / f"t{k}.fast5"), synthetic_adc(n, rng), f"tread-{k}")
    multi = tmp_path_factory.mktemp("trace_multi") / "m.fast5"
    write_multi_min(multi, [("mread-a", synthetic_adc(2800, rng)),
                            ("mread-b", synthetic_adc(4600, rng))])
    return d, multi


def _assert_same_traces(ours, theirs, nreads: int, posterior: bool):
    """Groups equal, signal equal, trace within one count, each row after
    the first summing to 255 +- 4 where the trace is a posterior's (fb;
    --viterbi's exponentiates unnormalised weights, clipped to a byte);
    returns the number of trace bytes that differ."""
    ndiff = 0
    with h5py.File(ours, "r") as a, h5py.File(theirs, "r") as b:
        assert list(a.keys()) == list(b.keys()) and len(a) == nreads
        for g in a:
            np.testing.assert_array_equal(a[g]["signal"][()], b[g]["signal"][()])
            x, y = a[g]["trace"][()].astype(int), b[g]["trace"][()].astype(int)
            assert x.shape == y.shape and np.abs(x - y).max() <= 1
            ndiff += int((x != y).sum())
            if posterior:
                sums = x[1:].sum(axis=1)
                assert sums.min() >= 251 and sums.max() <= 259
            for d in ("signal", "trace"):
                assert _h5py_meta(a[g][d]) == _h5py_meta(b[g][d])
    return ndiff


_JAX_RUNS: dict = {}


@pytest.mark.parametrize("case", ["fb", "viterbi", "multi-no-uuid"])
@pytest.mark.parametrize("writer", WRITERS, indirect=True)
def test_cli_trace_matches_jax_cli(reads, tmp_path, writer, case):
    """FASTQ bytes equal (but the score's last digit), the trace files'
    groups, signals and filters equal and traces within one count, under
    fb and --viterbi on chunked and bucketed reads, and under --multi
    --no-uuid, where the reads of one file share a group name and the
    last one's group wins in both packages."""
    single, multi = reads
    args = {"fb": [str(single)], "viterbi": [str(single), "--viterbi"],
            "multi-no-uuid": [str(single / "t0.fast5"), str(multi), "--multi", "--no-uuid"],
            }[case] + CHUNK_ARGS
    if case not in _JAX_RUNS:
        jax_h5 = tmp_path / "jax.h5"
        _JAX_RUNS[case] = (_run(j_main, args + ["--trace", str(jax_h5)], tmp_path / "jax.fq"),
                           jax_h5)
    theirs, jax_h5 = _JAX_RUNS[case]
    port_h5 = tmp_path / "port.h5"
    ours = _run(p_main, args + ["--trace", str(port_h5), "--device", "cpu"], tmp_path / "port.fq")
    _assert_same_output(ours, theirs)
    assert ours == _run(p_main, args + ["--device", "cpu"], tmp_path / "plain.fq")
    ndiff = _assert_same_traces(port_h5, jax_h5, 2 if case == "multi-no-uuid" else 3,
                                posterior=case != "viterbi")
    # the rounding of posterior x 255 at a half: 1 byte of ~17,600 in fb
    assert ndiff <= {"fb": 1, "viterbi": 1, "multi-no-uuid": 1}[case], ndiff


# -- trace_view ---------------------------------------------------------------------


def _guppy_files(tmp_path):
    """Guppy basecalled fast5s written by h5py: a single-read file and a
    multi-read file of two reads (one without a Trace table)."""
    rng = np.random.default_rng(41)

    def fill(grp, n, trace=True):
        seg = grp.create_group("Analyses/Segmentation_000/Summary/segmentation")
        seg.attrs["first_sample_template"] = np.int64(7)
        seg.attrs["duration_template"] = np.int64(n - 20)
        if trace:
            grp.create_dataset("Analyses/Basecall_1D_000/BaseCalled_template/Trace",
                               data=rng.integers(0, 256, (n // 5, 8)).astype(np.uint8))

    single = tmp_path / "guppy_single.fast5"
    with h5py.File(single, "w") as f:
        f.attrs["file_version"] = np.bytes_("1.0")
        f.create_dataset("Raw/Reads/Read_12/Signal", data=rng.integers(0, 900, 600).astype(np.int16))
        fill(f, 600)
    multi = tmp_path / "guppy_multi.fast5"
    with h5py.File(multi, "w") as f:
        f.attrs["file_version"] = np.bytes_("2.0")
        for k, n in enumerate([500, 700]):
            grp = f.create_group(f"read_{k}")
            grp.create_dataset("Raw/Signal", data=rng.integers(0, 900, n).astype(np.int16))
            fill(grp, n, trace=k == 0)
    return single, multi


def _view(module, h5, path):
    return [(r, s.copy(), t.copy()) for r, s, t in module.iter_traces(h5, str(path), 0)]


@pytest.mark.parametrize("reader", ["h5py", "hdf5_min"])
def test_iter_traces_matches_jax(tmp_path, reader, capsys):
    results = _results(13, [420, 1100])
    trace = tmp_path / "trace.h5"
    with j_trace_h5.TraceWriter(str(trace)) as w:
        for _, res in results:
            w.write(res.uuid, res)
    single, multi = _guppy_files(tmp_path)
    for path, kind, n in ((trace, "flappie_trace", 2), (single, "single_read_fast5", 1),
                          (multi, "multi_read_fast5", 1)):
        with h5py.File(path, "r") as f:
            want = _view(j_view, f, path)
            assert j_view.classify(f) == kind
        want_err = capsys.readouterr().err
        if reader == "h5py":
            with h5py.File(path, "r") as f:
                got = _view(p_view, f, path)
                assert p_view.classify(f) == kind
        else:
            h5 = p_view.MinFile(hdf5_min.read(str(path)))
            got = _view(p_view, h5, path)
            assert p_view.classify(h5) == kind
        assert capsys.readouterr().err == want_err
        assert len(got) == len(want) == n
        for (r, s, t), (r2, s2, t2) in zip(got, want):
            assert r == r2
            np.testing.assert_array_equal(s, s2)
            np.testing.assert_array_equal(t, t2)
            assert s.dtype == s2.dtype and t.dtype == t2.dtype


@pytest.mark.parametrize("reader", ["h5py", "hdf5_min"])
def test_trace_view_main_writes_pngs(tmp_path, monkeypatch, capsys, reader):
    pytest.importorskip("matplotlib")
    if reader == "hdf5_min":
        monkeypatch.setitem(sys.modules, "h5py", None)  # import h5py raises
    path = tmp_path / "trace.h5"
    monkeypatch.setattr(p_trace_h5, "h5py", None)
    with p_trace_h5.TraceWriter(str(path)) as w:
        for res, _ in _results(17, [900, 1200, 1500]):
            w.write(res.uuid, res)
    prefix = tmp_path / "plots" / "p-"
    prefix.parent.mkdir()
    assert p_view.main(["--output", str(prefix), "--limit", "2", str(path)]) == 0
    pngs = sorted(p.name for p in prefix.parent.iterdir())
    assert pngs == ["p-res-0.png", "p-res-1.png"]
    assert capsys.readouterr().out.count("wrote ") == 2
