"""PyTorch port on the CPU: ``--mesh``, the mesh, the dispatch threads,
the launch counters under threads, and ``--jax-profile``.

- ``flappie --mesh 2 --device cpu`` (two replicas, two dispatch threads)
  against the JAX CLI's ``--mesh 2`` on conftest's virtual CPU devices,
  fb and ``--viterbi``, chunked and ``--chunk 0``, with ``--trace``: the
  FASTQ bytes equal but for the score's last digit, the traces within one
  count (test_torch_trace.py's contract), the ``flappie-mesh:`` summary
  with JAX's programs and keys; and against the port's own one-device
  run, byte for byte, trace included, over shards of unequal size (a
  bucket batch of five reads: three and two);
- the mesh (``make_mesh``, ``batch_sharding``, ``shard_params``,
  ``shard_batch``), its refusals and a ``(1, 2)`` mesh's shape (the
  model axis itself: test_torch_tp.py);
- each shard launched on a thread whose current device is the shard's
  (a fake device context, as this host has no card);
- ``cuda_build.count`` under many threads, with the switch interval
  shortened: no launch count is lost;
- ``--jax-profile DIR`` writes a Chrome trace and leaves the bytes as
  they are.
"""

from __future__ import annotations

import contextlib
import io
import json
import sys
import threading

import h5py
import numpy as np
import pytest
import torch

from flappie_tpu.cli.flappie import main as jax_main

from flappie_tpu_torch.cli.flappie import main as port_main
from flappie_tpu_torch.ops import cuda_build
from flappie_tpu_torch.parallel import mesh as p_mesh
from flappie_tpu_torch.parallel import pipeline
from flappie_tpu_torch.signal.fast5 import write_single_read_fast5
from flappie_tpu_torch.signal.synthetic import synthetic_adc

from test_torch_e2e import CHUNK_ARGS, _assert_same_output
from test_torch_trace import _assert_same_traces


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """As in test_torch_models.py: the CPU path's thousands of tiny
    recurrence steps run faster on one intra-op thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# two reads above --chunk 4000 (one chunk batch of 8 rows: four chunks and
# four dummies) and five short ones in bucket 4096 (3 + 2 rows over 2
# devices); under --chunk 0 the long two make a bucket of their own
SIZES = [5400, 3000, 2700, 3900, 6100, 3300, 2500]


@pytest.fixture(scope="module")
def reads(tmp_path_factory):
    d = tmp_path_factory.mktemp("mesh_reads")
    rng = np.random.default_rng(11)
    for k, n in enumerate(SIZES):
        write_single_read_fast5(str(d / f"r{k}.fast5"), synthetic_adc(n, rng), f"read-{k}")
    return d


def _run(main, args, out):
    """(output text, the flappie-mesh summary or None)."""
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        assert main(args + ["-o", str(out)]) == 0
    lines = [ln for ln in err.getvalue().splitlines() if ln.startswith("flappie-mesh: ")]
    return out.read_text(), (json.loads(lines[-1][len("flappie-mesh: "):]) if lines else None)


def _same_trace_files(a, b) -> None:
    with h5py.File(a, "r") as x, h5py.File(b, "r") as y:
        assert list(x) == list(y)
        for g in x:
            for d in ("signal", "trace"):
                np.testing.assert_array_equal(x[g][d][()], y[g][d][()])
                assert x[g][d].chunks == y[g][d].chunks


@pytest.mark.parametrize("chunk", ["chunked", "unchunked"])
@pytest.mark.parametrize("mode", ["fb", "viterbi"])
def test_mesh_cli_matches_jax_mesh_and_one_device(reads, tmp_path, mode, chunk):
    args = [str(reads)] + (CHUNK_ARGS if chunk == "chunked" else ["--chunk", "0"])
    args += ["--viterbi"] if mode == "viterbi" else []
    theirs, j_wire = _run(jax_main, args + ["--mesh", "2", "--trace", str(tmp_path / "j.h5")],
                          tmp_path / "jax.fq")
    ours, p_wire = _run(port_main, args + ["--device", "cpu", "--mesh", "2",
                                           "--trace", str(tmp_path / "p.h5")],
                        tmp_path / "port.fq")
    one, none = _run(port_main, args + ["--device", "cpu", "--trace", str(tmp_path / "1.h5")],
                     tmp_path / "one.fq")
    assert none is None and ours.count("@read-") == len(SIZES)
    _assert_same_output(ours, theirs)
    _assert_same_traces(tmp_path / "p.h5", tmp_path / "j.h5", len(SIZES),
                        posterior=mode == "fb")
    assert ours == one
    _same_trace_files(tmp_path / "p.h5", tmp_path / "1.h5")
    # JAX's programs and keys; JAX pads the five-read bucket to six rows
    assert sorted(p_wire) == sorted(j_wire)
    for name, ent in p_wire.items():
        assert sorted(ent) == sorted(j_wire[name]) == ["devices", "dispatches", "rows"]
        assert ent["dispatches"] == j_wire[name]["dispatches"]
    if chunk == "chunked":
        assert p_wire["_device_basecall_chunk_packed_i16[int16]"] == {
            "dispatches": 1, "devices": [2], "rows": 8}
        assert p_wire["_device_basecall_packed_i16[int16]"] == {
            "dispatches": 1, "devices": [2], "rows": 5}
    else:  # buckets 4096 (5 reads: 3 + 2) and 8192 (2 reads: 1 + 1)
        assert p_wire["_device_basecall_packed_i16[int16]"] == {
            "dispatches": 2, "devices": [2], "rows": 7}


def test_mesh_shards_unequal_and_in_order(reads):
    """Over three devices the chunk batch of 8 rows splits 3 + 3 + 2 and
    the five-read bucket batch 2 + 2 + 1 (a one-row shard), and the
    records come back in input order, equal to one device's."""
    from flappie_tpu_torch.basecall import Basecaller

    kw = dict(chunk=4000, overlap=800)
    mesh = p_mesh.make_mesh(3, devices=["cpu"] * 3)
    caller = pipeline.DistributedBasecaller(mesh=mesh, **kw)
    try:
        from flappie_tpu_torch.signal.fast5 import read_raw

        raws = [read_raw(str(reads / f"r{k}.fast5")) for k in range(len(SIZES))]
        got = caller.basecall_raw_tables(raws)
        want = Basecaller(device="cpu", **kw).basecall_raw_tables(raws)
        shards = sorted((rec["program"], tuple(rec["shard_rows"])) for rec in caller.wire_log)
        assert shards == [("_device_basecall_chunk_packed_i16", (3, 3, 2)),
                          ("_device_basecall_packed_i16", (2, 2, 1))]
    finally:
        caller.close()
    assert [r.uuid for r in got] == [f"read-{k}" for k in range(len(SIZES))]
    for a, b in zip(got, want):
        assert (a.basecall, a.quality, a.score, a.nblock) == (b.basecall, b.quality, b.score,
                                                              b.nblock)
        np.testing.assert_array_equal(a.trace, b.trace)


# -- the mesh --------------------------------------------------------------------


@pytest.mark.parametrize("rows,n,want", [
    (1, 2, [(0, 1)]), (2, 2, [(0, 1), (1, 2)]), (3, 2, [(0, 2), (2, 3)]),
    (5, 2, [(0, 3), (3, 5)]), (8, 3, [(0, 3), (3, 6), (6, 8)]),
    (2, 3, [(0, 1), (1, 2)]), (256, 2, [(0, 128), (128, 256)]),
])
def test_batch_sharding(rows, n, want):
    """Contiguous, in order, torch.tensor_split's sizes; no empty shard."""
    mesh = p_mesh.make_mesh(n, devices=["cpu"] * n)
    assert p_mesh.batch_sharding(mesh, rows) == want
    sizes = [len(t) for t in torch.tensor_split(torch.arange(rows), n)]
    assert [hi - lo for lo, hi in want] == [k for k in sizes if k]


def test_make_mesh_and_placement():
    mesh = p_mesh.make_mesh(2, devices=["cpu", "cpu", "cpu"])
    assert mesh.shape == {"data": 2, "model": 1} and len(mesh) == 2
    assert mesh.devices == (torch.device("cpu"),) * 2
    assert len(p_mesh.make_mesh(devices=["cpu"] * 3)) == 3
    tp = p_mesh.make_mesh(1, n_model=2, devices=["cpu", "cpu"])
    assert tp.shape == {"data": 1, "model": 2} and len(tp) == 1
    assert tp.grid == ((torch.device("cpu"),) * 2,)
    with pytest.raises(ValueError):
        p_mesh.make_mesh(4, devices=["cpu"] * 3)
    cards = torch.cuda.device_count()
    with pytest.raises(ValueError, match=f"{cards} are visible"):
        p_mesh.make_mesh(cards + 1)
    params = {"rnn0": {"iW": torch.arange(6.0).reshape(2, 3), "b": torch.ones(3)}}
    reps = p_mesh.shard_params(params, mesh)
    assert len(reps) == 2
    for rep in reps:
        assert torch.equal(rep["rnn0"]["iW"], params["rnn0"]["iW"])
        assert rep["rnn0"]["iW"].data_ptr() != params["rnn0"]["iW"].data_ptr()
    assert reps[0]["rnn0"]["b"].data_ptr() != reps[1]["rnn0"]["b"].data_ptr()
    x, y = p_mesh.shard_batch(mesh, np.arange(10).reshape(5, 2), np.arange(5))
    assert [t.tolist() for t in y] == [[0, 1, 2], [3, 4]]
    assert torch.equal(torch.cat(x), torch.arange(10).reshape(5, 2))


def test_distributed_basecaller_takes_devices_from_the_mesh():
    with pytest.raises(TypeError, match="from the mesh"):
        pipeline.DistributedBasecaller(mesh=p_mesh.make_mesh(devices=["cpu"]), device="cpu")
    assert pipeline.init_distributed() is None
    assert pipeline.init_distributed(num_processes=1) is None
    with pytest.raises(ValueError, match="coordinator"):
        pipeline.init_distributed(num_processes=2)


def test_dispatch_threads_make_their_device_current(monkeypatch):
    """Each shard runs on its device's own thread, inside that device's
    context.  The host has no card, so the mesh is of two CPU device
    labels and the context is a fake that records the device it makes
    current on its thread."""
    current = threading.local()

    @contextlib.contextmanager
    def fake_on_device(device):
        before = getattr(current, "device", None)
        current.device = device
        try:
            yield
        finally:
            current.device = before

    monkeypatch.setattr(pipeline, "_on_device", fake_on_device)
    mesh = p_mesh.Mesh(["cpu:0", "cpu:1"])
    caller = pipeline.DistributedBasecaller(mesh=mesh, chunk=0)
    seen = []

    def program(params, dev, *rest):
        seen.append((threading.current_thread().name, current.device, dev.shape[0],
                     params is caller.replicas[0]))
        return dev[:, :3].to(torch.uint8)

    try:
        for rows in (5, 4, 7):
            buf = np.arange(rows * 6, dtype=np.float32).reshape(rows, 6)
            out = caller._dispatch(program, buf).result()
            np.testing.assert_array_equal(out, buf[:, :3].astype(np.uint8))
    finally:
        caller.close()
    assert len(seen) == 6
    for name, dev, _rows, first_replica in seen:
        slot = int(name.split("flappie-shard")[1].split("_")[0])
        assert dev == mesh.devices[slot]
        assert first_replica == (slot == 0)
    assert {name.split("_")[0] for name, *_ in seen} == {"flappie-shard0", "flappie-shard1"}
    assert sorted(r for *_, r, _ in seen) == [2, 2, 2, 3, 3, 4]
    assert [rec["shard_rows"] for rec in caller.wire_log] == [[3, 2], [2, 2], [4, 3]]
    assert [rec["devices"] for rec in caller.wire_log] == [2, 2, 2]


def test_launch_counts_are_not_lost_across_threads():
    """cuda_build.count under 16 threads with a short switch interval: a
    read-modify-write without the lock drops counts here."""
    counter = type("Counter", (), {"launches": 0})
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def bump():
            for _ in range(5000):
                cuda_build.count(counter)

        threads = [threading.Thread(target=bump) for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    assert counter.launches == 16 * 5000


def test_jax_profile_writes_a_trace_and_keeps_the_bytes(reads, tmp_path):
    args = [str(reads / "r1.fast5"), "--device", "cpu"]
    prof = tmp_path / "prof"
    plain, _ = _run(port_main, args, tmp_path / "plain.fq")
    profiled, _ = _run(port_main, args + ["--jax-profile", str(prof)], tmp_path / "prof.fq")
    assert profiled == plain
    traces = list(prof.glob("flappie.*.pt.trace.json"))
    assert len(traces) == 1
    events = json.loads(traces[0].read_text())["traceEvents"]
    names = {e.get("name") for e in events}
    assert any(str(n).startswith("aten::") for n in names)
