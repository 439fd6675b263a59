"""PyTorch port on the CPU: multi-read fast5 input, the flappie CLI's
--multi and --qcal, and flappie-serve, against the JAX package.

- ``iter_reads`` / ``list_read_ids`` on the single- and multi-read
  layouts equal JAX's, through h5py and through the port's minimal HDF5
  reader (the port's ``h5py`` patched to None, as on a host without it);
- the port's flappie CLI under ``--multi``, ``--qcal a:b`` and ``--qcal
  file`` gives the JAX CLI's bytes;
- the port's flappie-serve (stdin and watch mode) gives the JAX server's
  records and ack lines, ``wall=`` masked;
- the server's pure parts (``watch_scan``, ``handle_to_dest``) and its
  refusals behave alike in both packages.

Bytes equal the JAX package's, except that a header's
``normalised_score`` may differ in its last printed digit, as in
test_torch_e2e.py.  Reads are seeded synthetic ADC (the JAX serve tests
read the reference checkout's fixtures); weights are the synthetic default.
"""

from __future__ import annotations

import io
import json
import os
import re
import shutil
import sys
import threading
import time
import types

import h5py
import numpy as np
import pytest
import torch

from flappie_tpu.cli import flappie as j_flappie
from flappie_tpu.cli import serve as j_serve
from flappie_tpu.signal import fast5 as j_fast5

from flappie_tpu_torch.cli import flappie as p_flappie
from flappie_tpu_torch.cli import serve as p_serve
from flappie_tpu_torch.qcal import apply_calibration, apply_calibration_lut, parse_qcal
from flappie_tpu_torch.signal import fast5 as p_fast5
from flappie_tpu_torch.signal import hdf5_min
from flappie_tpu_torch.signal.synthetic import synthetic_adc

from test_torch_e2e import CHUNK_ARGS, _assert_same_output

SERVES = {"jax": j_serve, "port": p_serve}
_WALL_RE = re.compile(r"wall=\d+\.\d\ds")
CHANNEL = {"digitisation": 8192.0, "offset": 16.0, "range": 1373.41, "sampling_rate": 4000.0}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """As in test_torch_models.py: the CPU path's thousands of tiny
    recurrence steps run faster on one intra-op thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def write_multi_min(path, reads, bad: str | None = None):
    """A multi-read fast5 as an hdf5_min node tree: ``reads`` [(uuid,
    adc)]; a uuid starting with "noid" has no read_id attribute; ``bad``
    names a read_ group without a Signal dataset."""
    children = {}
    for uuid, adc in reads:
        raw_attrs = {} if uuid.startswith("noid") else {"read_id": np.bytes_(uuid)}
        children[f"read_{uuid}"] = hdf5_min.Node(children={
            "Raw": hdf5_min.Node(attrs=raw_attrs, children={
                "Signal": hdf5_min.Node(data=np.asarray(adc, np.int16))}),
            "channel_id": hdf5_min.Node(attrs={k: np.float64(v) for k, v in CHANNEL.items()}),
        })
    if bad:
        children[f"read_{bad}"] = hdf5_min.Node(children={"Raw": hdf5_min.Node()})
    hdf5_min.write(str(path), hdf5_min.Node(attrs={"file_version": np.bytes_("2.0")},
                                            children=children))


def write_multi_h5py(path, reads, bad: str | None = None):
    """The same layout written by h5py."""
    with h5py.File(path, "w") as f:
        f.attrs["file_version"] = np.bytes_("2.0")
        for uuid, adc in reads:
            grp = f.create_group(f"read_{uuid}")
            rg = grp.create_group("Raw")
            if not uuid.startswith("noid"):
                rg.attrs["read_id"] = np.bytes_(uuid)
            rg.create_dataset("Signal", data=np.asarray(adc, np.int16))
            ch = grp.create_group("channel_id")
            for k, v in CHANNEL.items():
                ch.attrs[k] = np.float64(v)
        if bad:
            f.create_group(f"read_{bad}/Raw")


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """``run1/``: two single-read files (after the 200:10 trim the second
    is longer than --chunk 4000 and is chunked); ``multi/m.fast5``: three
    reads (hdf5_min writer) and one group without a Signal; ``qcal.json``:
    an isotonic table for r941_native."""
    d = tmp_path_factory.mktemp("serve")
    rng = np.random.default_rng(23)
    run1 = d / "run1"
    run1.mkdir()
    for k, n in enumerate([3000, 5200]):
        p_fast5.write_single_read_fast5(str(run1 / f"s{k}.fast5"), synthetic_adc(n, rng),
                                        f"sread-{k}")
    multi = d / "multi"
    multi.mkdir()
    reads = [("mread-b", synthetic_adc(4700, rng)), ("mread-a", synthetic_adc(2600, rng)),
             ("noid-c", synthetic_adc(3100, rng))]
    write_multi_min(multi / "m.fast5", reads, bad="broken")
    lut = np.clip(np.arange(94) * 3 // 4 + 2, 0, 93)
    qcal = d / "qcal.json"
    qcal.write_text(json.dumps({"models": {"r941_native": {"lut": lut.tolist()}}}))
    return types.SimpleNamespace(root=d, run1=str(run1), multi=str(multi / "m.fast5"),
                                 qcal=str(qcal))


# -- iter_reads / list_read_ids ------------------------------------------------


def _assert_same_reads(got, want):
    assert [r.uuid for r in got] == [r.uuid for r in want]
    for g, w in zip(got, want):
        assert (g.n, g.start, g.end, g.cal) == (w.n, w.start, w.end, w.cal)
        np.testing.assert_array_equal(g.raw, w.raw)
        np.testing.assert_array_equal(g.adc, w.adc)


@pytest.mark.parametrize("reader", ["h5py", "hdf5_min"])
@pytest.mark.parametrize("layout", ["single", "multi-min", "multi-h5py", "multi-h5py-40"])
def test_iter_reads_match_jax(tmp_path, monkeypatch, layout, reader):
    rng = np.random.default_rng(5)
    path = tmp_path / "f.fast5"
    if layout == "single":
        p_fast5.write_single_read_fast5(str(path), synthetic_adc(2500, rng), "one-read")
    else:
        # 40 reads: more than one symbol-table node and a deeper group tree
        n = 40 if layout.endswith("40") else 3
        reads = [(f"r{k:02d}" if k % 5 else f"noid{k}", synthetic_adc(300 + k, rng))
                 for k in range(n)][::-1]
        (write_multi_min if layout == "multi-min" else write_multi_h5py)(path, reads, "bad")
    want = list(j_fast5.iter_reads(str(path)))
    want_ids = j_fast5.list_read_ids(str(path))
    if reader == "hdf5_min":
        monkeypatch.setattr(p_fast5, "h5py", None)
    got = list(p_fast5.iter_reads(str(path)))
    _assert_same_reads(got, want)
    assert p_fast5.list_read_ids(str(path)) == want_ids
    assert len(want_ids) == (1 if layout == "single" else 40 if "40" in layout else 3)
    unscaled = list(p_fast5.iter_reads(str(path), scale_to_pA=False))
    _assert_same_reads(unscaled, list(j_fast5.iter_reads(str(path), scale_to_pA=False)))


@pytest.mark.parametrize("reader", ["h5py", "hdf5_min"])
def test_iter_reads_failures_match_jax(tmp_path, monkeypatch, reader):
    """A single-read file without a valid read yields nothing; a file
    that is not HDF5 raises in both packages."""
    empty = tmp_path / "empty.fast5"
    with h5py.File(empty, "w") as f:
        f.create_group("Raw/Reads")
    junk = tmp_path / "junk.fast5"
    junk.write_bytes(b"not an hdf5 file")
    with pytest.raises(OSError):
        list(j_fast5.iter_reads(str(junk)))
    if reader == "hdf5_min":
        monkeypatch.setattr(p_fast5, "h5py", None)
    assert list(p_fast5.iter_reads(str(empty))) == list(j_fast5.iter_reads(str(empty))) == []
    with pytest.raises(OSError if reader == "h5py" else ValueError):
        list(p_fast5.iter_reads(str(junk)))


def test_without_h5py_a_chunked_signal_fails_the_file(tmp_path, monkeypatch):
    """The minimal reader's documented limit: it reads a gzip-chunked
    Signal (h5py's deflate filter) as h5py does, but a Signal chunked
    under a filter it does not have (lzf, which h5py and so JAX read)
    makes the whole file unreadable, and the CLI reports it instead of
    basecalling part of it."""
    rng = np.random.default_rng(9)
    for filt in ("gzip", "lzf"):
        path = tmp_path / f"chunked_{filt}.fast5"
        write_multi_h5py(path, [("r0", synthetic_adc(400, rng))])
        with h5py.File(path, "a") as f:
            rg = f.create_group("read_r1/Raw")
            rg.attrs["read_id"] = np.bytes_("r1")
            rg.create_dataset("Signal", data=synthetic_adc(400, rng), chunks=(100,),
                              compression=filt)
            ch = f.create_group("read_r1/channel_id")
            for k, v in CHANNEL.items():
                ch.attrs[k] = np.float64(v)
        want = list(j_fast5.iter_reads(str(path)))
        assert p_fast5.list_read_ids(str(path)) == [r.uuid for r in want] == ["r0", "r1"]
        with monkeypatch.context() as m:
            m.setattr(p_fast5, "h5py", None)
            if filt == "gzip":
                _assert_same_reads(list(p_fast5.iter_reads(str(path))), want)
                continue
            with pytest.raises(ValueError, match="unsupported filter 32000"):
                list(p_fast5.iter_reads(str(path)))
            assert p_flappie.expand_reads([str(path)], multi=True)[0][0].raw is None


# -- the flappie CLI: --multi, --qcal --------------------------------------------


def _cli(main, args, out):
    assert main(args + ["-o", str(out)]) == 0
    return out.read_text()


@pytest.mark.parametrize("case", ["multi", "multi-hdf5_min", "qcal-pair", "qcal-file",
                                  "multi-qcal-limit"])
def test_cli_multi_and_qcal_match_jax(data, tmp_path, monkeypatch, case):
    inputs = [data.run1]
    flags = []
    if case.startswith("multi"):
        inputs.append(data.multi)
        flags.append("--multi")
    qcal = {"qcal-pair": "1.1:-0.5", "qcal-file": data.qcal, "multi-qcal-limit": "2.5:1"}.get(case)
    if qcal:
        flags += ["--qcal", qcal]
    if "limit" in case:
        flags += ["--limit", "4"]  # files first (3 of 3), then reads (4 of 5)
    args = inputs + flags + CHUNK_ARGS
    theirs = _cli(j_flappie.main, args, tmp_path / "jax.out")
    if case == "multi-hdf5_min":
        monkeypatch.setattr(p_fast5, "h5py", None)
    ours = _cli(p_flappie.main, args + ["--device", "cpu"], tmp_path / "port.out")
    _assert_same_output(ours, theirs)
    heads = [line.split()[0] for line in ours.splitlines()[::4]]
    if case.startswith("multi"):
        # the multi file's reads in sorted group order, the broken group skipped
        want = ["@sread-0", "@sread-1", "@mread-a", "@mread-b", "@noid-c"]
        assert heads == want[:4] if "limit" in case else heads == want
    else:
        assert heads == ["@sread-0", "@sread-1"]
    if qcal:
        plain = _cli(p_flappie.main, [a for a in args if a not in ("--qcal", qcal)]
                     + ["--device", "cpu"], tmp_path / "plain.out").splitlines()
        got = ours.splitlines()
        assert got[1::4] == plain[1::4]  # same bases, remapped qualities
        table = parse_qcal(qcal, "r941_native")
        want = [apply_calibration(q, *table) if isinstance(table, tuple)
                else apply_calibration_lut(q, table) for q in plain[3::4]]
        assert got[3::4] == want
        if case != "qcal-pair":  # 1.1:-0.5 leaves the synthetic model's 0-2 alone
            assert want != plain[3::4]


def test_cli_refusals_and_malformed_qcal(data, tmp_path, capsys):
    """--mesh 2 runs on the CPU (two replicas) and gives the one-device
    records; --mesh beyond the visible cards returns 1 with the JAX CLI's
    message (test_torch_mesh.py holds the rest); a malformed --qcal is a
    usage error before any file is read, as in the JAX CLI, --fast or
    not."""
    args = [data.run1, "--device", "cpu"] + CHUNK_ARGS
    assert (_cli(p_flappie.main, args + ["--mesh", "2"], tmp_path / "mesh.out")
            == _cli(p_flappie.main, args, tmp_path / "one.out"))
    assert "flappie-mesh: " in capsys.readouterr().err
    cards = torch.cuda.device_count()
    n = max(2, cards + 1)
    assert p_flappie.main([data.run1, "--mesh", str(n)]) == 1
    assert (f"--mesh {n} exceeds the {cards} visible devices"
            in capsys.readouterr().err)
    for main, extra in ((j_flappie.main, []), (p_flappie.main, ["--device", "cpu"]),
                        (p_flappie.main, ["--device", "cpu", "--fast"])):
        with pytest.raises(SystemExit) as exc:
            main(["--qcal", "1.5", "/does/not/exist.fast5"] + extra)
        assert exc.value.code == 2
        err = capsys.readouterr().err
        assert "--qcal should be of form slope:offset or a QCAL JSON file" in err
        assert "does not exist" not in err


# -- flappie-serve ---------------------------------------------------------------


def _serve(pkg, args, requests, capsys, monkeypatch):
    """Run one package's server main in-process on ``requests`` (stdin
    lines); returns (stdout, stderr lines with wall= masked)."""
    if pkg == "port":
        args = args + ["--device", "cpu"]
    capsys.readouterr()
    monkeypatch.setattr(sys, "stdin", io.StringIO("".join(r + "\n" for r in requests)))
    assert SERVES[pkg].main(args) == 0
    out, err = capsys.readouterr()
    return out, [_WALL_RE.sub("wall=X", line) for line in err.splitlines()]


@pytest.mark.parametrize("case", ["stdout", "output-dir-multi-qcal"])
def test_serve_stdin_matches_jax(data, tmp_path, capsys, monkeypatch, case):
    """A directory, the same directory again, a missing path (and, with
    --output-dir, the multi-read file and another directory of the first
    one's name): the records and the ack lines of the JAX server; the
    repeat gives the first request's records."""
    missing = str(data.root / "missing")
    requests = [data.run1, data.run1, missing]
    flags = ["--warmup"] + CHUNK_ARGS
    if case != "stdout":
        other = data.root / "other" / "run1"
        if not other.exists():
            other.mkdir(parents=True)
            shutil.copy(os.path.join(data.run1, "s1.fast5"), other)
        requests += [data.multi, str(other)]
        flags += ["--multi", "--qcal", "1.1:-0.5"]
    results = {}
    for pkg in SERVES:
        outdir = tmp_path / pkg
        extra = [] if case == "stdout" else ["--output-dir", str(outdir)]
        out, acks = _serve(pkg, flags + extra, requests, capsys, monkeypatch)
        files = {p.name: p.read_text() for p in sorted(outdir.iterdir())} if extra else {}
        results[pkg] = (out, [a.replace(str(outdir), "OUT") for a in acks], files)
    (out_p, acks_p, files_p), (out_j, acks_j, files_j) = results["port"], results["jax"]
    assert acks_p == acks_j
    assert acks_p[0] == "flappie-serve: ready"
    done = [a for a in acks_p if a.startswith("flappie-serve: done")]
    assert len(done) == len(requests)
    assert "reads=2 called=2" in done[0] and "reads=2 called=2" in done[1]
    assert "reads=0 called=0" in done[2]
    assert f'File or directory "{missing}" does not exist' in "\n".join(acks_p)
    _assert_same_output(out_p, out_j)
    assert sorted(files_p) == sorted(files_j)
    for name in files_j:
        _assert_same_output(files_p[name], files_j[name])
    if case == "stdout":
        half = len(out_p) // 2
        assert out_p[:half] == out_p[half:] and out_p.count("@sread-") == 4
    else:
        assert out_p == "" and "reads=3 called=3" in done[3]
        # the two directories named run1: the second request gets the
        # sha1-suffixed name
        assert [n for n in files_p if n.startswith("run1")] == ["run1-" + __import__(
            "hashlib").sha1(str(other).encode()).hexdigest()[:8] + ".fastq", "run1.fastq"]
        plain = _cli(p_flappie.main, [data.run1, "--device", "cpu"] + CHUNK_ARGS,
                     tmp_path / "plain.out")
        got = files_p["run1.fastq"].splitlines()
        assert got[3::4] == [apply_calibration(q, 1.1, -0.5) for q in plain.splitlines()[3::4]]


def _watch(pkg, tmp_path, drop, flags):
    """Run one package's serve_watch in a thread: drop files in (atomic
    renames), wait until their outputs or final acks appear, then STOP."""
    watch, outdir = tmp_path / pkg / "in", tmp_path / pkg / "out"
    watch.mkdir(parents=True)
    args = SERVES[pkg].build_parser().parse_args(
        flags + ["--watch", str(watch), "--output-dir", str(outdir), "--poll", "0.05"]
        + (["--device", "cpu"] if pkg == "port" else []))
    server = SERVES[pkg].Server(args)
    err = io.StringIO()
    rc = []

    def run():
        real = sys.stderr
        sys.stderr = err  # serve_watch acks on sys.stderr
        try:
            rc.append(SERVES[pkg].serve_watch(server))
        finally:
            sys.stderr = real

    th = threading.Thread(target=run)
    th.start()
    try:
        for src, name in drop:
            shutil.copy(src, watch / f".{name}.part")
            os.replace(watch / f".{name}.part", watch / name)
        deadline = time.monotonic() + 240
        while err.getvalue().count(" done ") < len(drop) and time.monotonic() < deadline:
            assert th.is_alive(), err.getvalue()
            time.sleep(0.05)
    finally:
        (watch / "STOP").touch()
        th.join(timeout=60)
    assert not th.is_alive() and rc == [0], err.getvalue()
    acks = [_WALL_RE.sub("wall=X", a).replace(str(tmp_path / pkg), "DIR")
            for a in err.getvalue().splitlines() if a.startswith("flappie-serve:")]
    return acks, {p.name: p.read_text() for p in sorted(outdir.iterdir())}


def test_serve_watch_matches_jax(data, tmp_path):
    """--watch --multi --qcal --output-dir: the multi-read file is
    published once with calibrated qualities; a corrupt file is retried
    twice and then published empty; STOP ends the server."""
    junk = tmp_path / "junk.fast5"
    junk.write_bytes(b"not an hdf5 file")
    drop = [(data.multi, "m.fast5"), (str(junk), "x.fast5")]
    flags = ["--multi", "--qcal", "1.1:-0.5"] + CHUNK_ARGS
    acks_p, files_p = _watch("port", tmp_path, drop, flags)
    acks_j, files_j = _watch("jax", tmp_path, drop, flags)
    assert sorted(acks_p) == sorted(acks_j)  # the two files' acks may interleave
    assert acks_p[-1] == "flappie-serve: stopping (stop file present)"
    assert sum(a.startswith("flappie-serve: retry DIR/in/x.fast5") for a in acks_p) == 2
    assert "flappie-serve: done DIR/in/m.fast5 reads=3 called=3 wall=X output=DIR/out/m.fastq" \
        in acks_p
    assert sorted(files_p) == sorted(files_j) == ["m.fastq", "x.fastq"]
    for name in files_j:
        _assert_same_output(files_p[name], files_j[name])
    assert files_p["x.fastq"] == ""
    plain = _cli(p_flappie.main, [data.multi, "--multi", "--device", "cpu"] + CHUNK_ARGS,
                 tmp_path / "plain.out")
    got, want = files_p["m.fastq"].splitlines(), plain.splitlines()
    assert got[1::4] == want[1::4]
    assert got[3::4] == [apply_calibration(q, 1.1, -0.5) for q in want[3::4]]


# -- the server's pure parts, each package -----------------------------------------


@pytest.mark.parametrize("pkg", SERVES)
def test_watch_scan_stability_gating(pkg):
    """A file is ready only after its (size, mtime) signature has been
    stable for min_age of wall time; a growing file waits."""
    watch_scan = SERVES[pkg].watch_scan
    AGE = 1.0
    seen, pending = set(), {}
    assert watch_scan([("a", (100, 1))], seen, pending, 0.0, AGE) == []
    assert watch_scan([("a", (100, 1))], seen, pending, 0.01, AGE) == []
    assert watch_scan([("a", (100, 1))], seen, pending, 1.2, AGE) == ["a"]
    assert "a" in seen and "a" not in pending
    assert watch_scan([("a", (100, 1))], seen, pending, 2.0, AGE) == []
    assert watch_scan([("b", (50, 5))], seen, pending, 2.0, AGE) == []
    assert watch_scan([("b", (80, 6))], seen, pending, 3.5, AGE) == []
    assert watch_scan([("b", (80, 7))], seen, pending, 5.0, AGE) == []
    assert watch_scan([("b", (80, 7))], seen, pending, 5.5, AGE) == []
    assert watch_scan([("b", (80, 7))], seen, pending, 6.1, AGE) == ["b"]
    assert watch_scan([("c", (1, 1)), ("d", (2, 1))], seen, pending, 10.0, AGE) == []
    assert watch_scan([("c", (1, 1)), ("d", (9, 2))], seen, pending, 11.1, AGE) == ["c"]
    assert watch_scan([("d", (9, 2))], seen, pending, 12.2, AGE) == ["d"]
    assert SERVES[pkg].MAX_WATCH_RETRIES == 2


def _bare_server(pkg, tmp_path, handle):
    srv = SERVES[pkg].Server.__new__(SERVES[pkg].Server)  # no Basecaller
    srv._dest_owner = {}
    srv.args = types.SimpleNamespace(output_dir=str(tmp_path), format="fastq")
    srv.handle = handle
    return srv


@pytest.mark.parametrize("pkg", SERVES)
def test_handle_to_dest_collision_and_tmp_cleanup(pkg, tmp_path):
    """Different requests sharing a basename get distinct outputs (the
    sha1-suffixed name); a repeat keeps its name; a failing request
    leaves no .tmp file."""

    def handle(request, out):
        out.write(f"rec:{request}\n")
        return 1, 1

    srv = _bare_server(pkg, tmp_path, handle)
    _, _, d1 = srv.handle_to_dest("/run1/a.fast5")
    _, _, d2 = srv.handle_to_dest("/run2/a.fast5")
    assert os.path.basename(d1) == "a.fastq"
    assert os.path.basename(d2) == "a-" + __import__("hashlib").sha1(
        b"/run2/a.fast5").hexdigest()[:8] + ".fastq"
    with open(d2) as fh:
        assert fh.read() == "rec:/run2/a.fast5\n"
    assert srv.handle_to_dest("/run1/a.fast5")[2] == d1

    def boom(request, out):
        out.write("partial")
        raise RuntimeError("injected")

    srv.handle = boom
    with pytest.raises(RuntimeError):
        srv.handle_to_dest("/run3/b.fast5")
    assert [p.name for p in tmp_path.iterdir() if p.name.endswith(".tmp")] == []


@pytest.mark.parametrize("pkg", SERVES)
def test_handle_to_dest_defers_publish_on_retry(pkg, tmp_path):
    """A zero-read attempt that will be retried publishes nothing."""
    srv = _bare_server(pkg, tmp_path, lambda request, out: (1, 0))
    assert srv.handle_to_dest("/run/x.fast5", publish_if=lambda n_, c_: c_ > 0) == (1, 0, None)
    assert list(tmp_path.iterdir()) == []

    def good(request, out):
        out.write("rec\n")
        return 1, 1

    srv.handle = good
    n, called, dest = srv.handle_to_dest("/run/x.fast5", publish_if=lambda n_, c_: c_ > 0)
    assert called == 1 and os.path.exists(dest)


@pytest.mark.parametrize("pkg", SERVES)
def test_serve_stdin_isolates_a_failing_request(pkg, tmp_path, capsys, monkeypatch):
    """A request that raises becomes an error ack; blank lines are
    skipped and the next request is served."""

    def handle(request, out):
        if request == "bad":
            raise RuntimeError("injected")
        out.write(f"rec:{request}\n")
        return 1, 1

    srv = _bare_server(pkg, tmp_path, handle)
    srv.args.output_dir = None
    monkeypatch.setattr(sys, "stdin", io.StringIO("a\nbad\n\nb\n"))
    capsys.readouterr()
    assert SERVES[pkg].serve_stdin(srv) == 0
    out, err = capsys.readouterr()
    assert out == "rec:a\nrec:b\n"
    assert [_WALL_RE.sub("wall=X", line) for line in err.splitlines()] == [
        "flappie-serve: done a reads=1 called=1 wall=X",
        "flappie-serve: error bad (injected)",
        "flappie-serve: done b reads=1 called=1 wall=X",
    ]


def test_serve_failed_batches_do_not_poison_the_next_request(data, tmp_path, capsys,
                                                             monkeypatch):
    """Every dispatch of one request fails (fault injection): its reads
    are reported, and the same server's next request gives the CLI's
    records."""
    server = p_serve.Server(p_serve.build_parser().parse_args(CHUNK_ARGS + ["--device", "cpu"]))
    monkeypatch.setenv("FLAPPIE_TPU_CHAOS_DISPATCH", "1.0")
    capsys.readouterr()
    assert server.handle_to_dest(data.run1) == (2, 0, "-")
    out, err = capsys.readouterr()
    assert out == "" and err.count("No basecall returned for") == 2
    monkeypatch.delenv("FLAPPIE_TPU_CHAOS_DISPATCH")
    assert server.handle_to_dest(data.run1) == (2, 2, "-")
    out = capsys.readouterr().out
    assert out == _cli(p_flappie.main, [data.run1, "--device", "cpu"] + CHUNK_ARGS,
                       tmp_path / "cli.out")


@pytest.mark.parametrize("pkg", SERVES)
def test_serve_rejects_bad_model(pkg, capsys):
    assert SERVES[pkg].main(["--model", "nope"]) == 1
    assert 'Invalid Flappie model "nope".' in capsys.readouterr().out


@pytest.mark.parametrize("pkg", SERVES)
def test_serve_malformed_qcal_fails_before_basecalling(pkg, capsys):
    for bad in ("1.5", "a:b"):
        with pytest.raises(SystemExit) as exc:
            SERVES[pkg].main(["--qcal", bad])
        assert exc.value.code == 2
        assert "--qcal should be of form slope:offset" in capsys.readouterr().err


def test_serve_needs_a_gpu_unless_asked_for_the_cpu(monkeypatch):
    """No quiet fallback: without a GPU the default device raises before
    the server acks ready."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(sys, "stdin", io.StringIO(""))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        p_serve.main([])
