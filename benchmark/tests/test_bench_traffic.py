"""The traffic generator: reproducible from a seed, the same sizes for
every seed, files the program reads back."""

import numpy as np
import pytest

from benchmark.harness import spec, traffic
from benchmark.tests.conftest import shrink


def _mix(per_file, reads=8):
    """The offline mix at a test's size, ``per_file`` reads a file."""
    cell = spec.load("r941_native.offline")
    shrink(cell, reads=reads)
    cell.traffic["files"]["reads_per_file"] = per_file
    return cell.traffic


@pytest.mark.parametrize("per_file", [1, 2])
def test_same_seed_same_inputs(tmp_path, per_file):
    mix = _mix(per_file)
    a = traffic.make(mix, 123456789012, str(tmp_path / "a"))
    b = traffic.make(mix, 123456789012, str(tmp_path / "b"))
    assert [r.uuid for r in a.reads] == [r.uuid for r in b.reads]
    for ra, rb in zip(a.reads, b.reads):
        assert np.array_equal(ra.adc, rb.adc)
    for fa, fb in zip(a.files, b.files):
        assert fa.reads == fb.reads
        with open(fa.path, "rb") as x, open(fb.path, "rb") as y:
            assert x.read() == y.read()


@pytest.mark.parametrize("per_file", [1, 2])
def test_seeds_share_sizes_and_order_not_signal(tmp_path, per_file):
    mix = _mix(per_file)
    a = traffic.make(mix, 1, str(tmp_path / "a"))
    b = traffic.make(mix, 2, str(tmp_path / "b"))
    assert [[a.reads[i].adc.size for i in f.reads] for f in a.files] == \
        [[b.reads[i].adc.size for i in f.reads] for f in b.files]
    assert a.dir_files == b.dir_files
    assert not np.array_equal(a.reads[0].adc, b.reads[0].adc)


def test_lengths_follow_the_mix():
    mix = spec.load("r941_native.offline").traffic
    n = traffic.lengths(mix)
    assert len(n) == mix["reads"]["count"]
    assert n.min() >= mix["reads"]["min_samples"] and n.max() <= mix["reads"]["max_samples"]
    assert abs(np.median(n) / mix["reads"]["median_samples"] - 1) < 0.1


@pytest.mark.parametrize("per_file", [1, 2])
def test_program_reads_the_files(tmp_path, per_file):
    from flappie_tpu_torch.signal import fast5

    mix = _mix(per_file)
    got = traffic.make(mix, 77, str(tmp_path))
    for f in got.files:
        rts = list(fast5.iter_reads(f.path))
        assert [rt.uuid for rt in rts] == sorted(got.reads[i].uuid for i in f.reads)
        by_id = {got.reads[i].uuid: got.reads[i].adc for i in f.reads}
        for rt in rts:
            assert np.array_equal(rt.adc, by_id[rt.uuid])


def test_program_reads_without_h5py(tmp_path, monkeypatch):
    from flappie_tpu_torch.signal import fast5

    monkeypatch.setattr(fast5, "h5py", None)
    got = traffic.make(_mix(2), 78, str(tmp_path))
    rts = list(fast5.iter_reads(got.files[0].path, scale_to_pA=False))
    assert len(rts) == len(got.files[0].reads)
