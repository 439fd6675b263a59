"""The metric arithmetic against hand counts: model operations, launch
shapes, roofline bounds, the profile's reduction of names."""

import math
from types import SimpleNamespace

import pytest

from benchmark.harness import profile, spec, yardstick

NATIVE = spec.load("r941_native.offline").config
MC = spec.load("r941_5mC.offline").config
PEAK = yardstick.PEAKS["sxm"]


def test_model_ops_by_hand():
    # r941_native on 100 samples: 100 columns through the two stride-1
    # convs, 20 blocks after the stride-5 conv
    want = (100 * 2 * 5 * 1 * 4 + 100 * 2 * 5 * 4 * 16 + 20 * 2 * 19 * 16 * 256
            + 5 * 20 * 2 * (256 + 256) * 1024 + 20 * 2 * 256 * 40)
    assert yardstick.model_ops(NATIVE["widths"], 100) == want == 108_448_160
    # r941_5mC on 100 samples: 50 blocks
    want5 = 50 * 2 * 19 * 256 + 5 * 50 * 2 * 512 * 768 + 50 * 2 * 256 * 60
    assert yardstick.model_ops(MC["widths"], 100) == want5
    # about 1.08 and 1.99 MFLOP a sample at length
    assert yardstick.model_ops(NATIVE["widths"], 1_000_000) / 1e12 == pytest.approx(1.0845, abs=1e-3)
    assert yardstick.model_ops(MC["widths"], 1_000_000) / 1e12 == pytest.approx(1.986, abs=1e-3)


def test_launch_shapes_by_hand():
    got = yardstick.launches([30000, 1000, 3000], NATIVE["widths"], NATIVE["decode"])
    # 30000 samples: chunks at 0, 11200, 22400 of 12800, 12800, 7600 samples
    assert got == [yardstick.Launch(3, 2560 + 2560 + 1520), yardstick.Launch(1, 200),
                   yardstick.Launch(1, 600)]
    # 300 reads of 20000 samples: 600 chunks in batches of 256, 256, 88
    many = yardstick.launches([20000] * 300, NATIVE["widths"], NATIVE["decode"])
    assert [ln.rows for ln in many] == [256, 256, 88]
    # 40 short reads of one bucket: batches of 32 and 8
    short = yardstick.launches([5000] * 40, NATIVE["widths"], NATIVE["decode"])
    assert [ln.rows for ln in short] == [32, 8]


def test_rnn_bound_by_hand():
    ln = [yardstick.Launch(2, 1000)]
    G, H = 1024, 256
    per_layer = max(4 * (1000 * 256 + 256 * G + G + H * G + 2 + 1000 * H) / PEAK["bytes"],
                    2 * 1000 * (256 + H) * G / PEAK["f32_ops"])
    assert yardstick.rnn_bound_s(ln, NATIVE["widths"], PEAK) == pytest.approx(5 * per_layer)
    # operations bound it: 5 layers x 2 x 512 x 1024 x 1000 at 67 TFLOP/s
    assert 5 * per_layer == pytest.approx(5 * 2 * 512 * 1024 * 1000 / 67e12)


def test_crf_bound_by_hand():
    ln = [yardstick.Launch(1, 100)]
    S = 8
    scan = max((4 * 100 * 64 + 400 + 4 * 101 * 8) / 3.35e12, 100 * (5 * 64 + 40) / 67e12)
    vit = max((4 * 100 * 64 + 400 + 4 * 64 + 4 * 100 * 8 + 4 * 8) / 3.35e12,
              100 * (4 * 64 + 24) / 67e12)
    tb = max((4 * 100 * 8 + 400 + 4 + 4 * 101) / 3.35e12, 100 * S / 67e12)
    assert yardstick.crf_bound_s(ln, NATIVE["widths"], PEAK) == pytest.approx(3 * scan + vit + tb)


def test_kernel_short_names():
    assert profile.short_name("void cluster_rnn_kernel<4, 8, false, float>(float const*, int)") \
        == "cluster_rnn_kernel"
    assert profile.short_name("crf_sum_kernel(float const*, int)") == "crf_sum_kernel"
    assert profile.short_name("void traceback_kernel<BmTrace<8> >(BmTrace<8>, int const*)") \
        == "traceback_kernel"
    assert profile.short_name("Memcpy HtoD (Pinned -> Device)") == "Memcpy HtoD"
    assert profile.short_name("void at::native::(anonymous namespace)::reduce_kernel<512, 1>"
                              "(at::native::ReduceOp<float>)") == "at::native::reduce_kernel"
    red = {"device_s": {"flappie::cluster_rnn_kernel": 2.0, "flappie::affine_kernel": 0.5,
                        "crf_sum_kernel": 0.25}}
    assert profile.kernel_s(red, ("cluster_rnn_kernel", "affine_kernel")) == 2.5


def test_peaks_follow_the_part():
    assert yardstick.peaks("NVIDIA H100 80GB HBM3") is yardstick.PEAKS["sxm"]
    assert yardstick.peaks("NVIDIA H100 PCIe") is yardstick.PEAKS["pcie"]
    assert math.isclose(yardstick.bound_s(3.35e12, 0, PEAK), 1.0)


def test_profile_reduction_by_hand():
    """Busy time is the union of device intervals (the marker's own
    device copy left out); an idle gap takes the name of the innermost
    host phase open at its middle, on any thread."""
    from types import SimpleNamespace

    from torch.autograd import DeviceType

    def ev(name, t0, t1, dev):
        return SimpleNamespace(name=name, device_type=dev, time_range=SimpleNamespace(start=t0, end=t1))

    cpu, cuda = DeviceType.CPU, DeviceType.CUDA
    events = [ev(profile.WINDOW_MARK, 1000.0, 2000.0, cpu), ev(profile.WINDOW_MARK, 1000.0, 2000.0, cuda),
              ev("void flappie::cluster_rnn_kernel<4>(float*)", 1100.0, 1300.0, cuda),
              ev("crf_sum_kernel(float*)", 1250.0, 1400.0, cuda),
              ev("crf_sum_kernel(float*)", 1600.0, 1700.0, cuda)]
    # host clock: the window opened at t0 = 10.0 s; phases in seconds
    holder = SimpleNamespace(prof=SimpleNamespace(events=lambda: events), t0=10.0, spans=[
        (10.0, 10.001, "dispatch"), (10.0004, 10.0006, "preprocess"),
        (10.0001, 10.0009, "collect_wait")])
    red = profile.reduce(holder)
    assert red["window_s"] == pytest.approx(1e-3)
    assert red["busy_s"] == pytest.approx(400e-6)  # 1100-1400 and 1600-1700
    assert red["device_s"]["flappie::cluster_rnn_kernel"] == pytest.approx(200e-6)
    assert red["device_s"]["crf_sum_kernel"] == pytest.approx(250e-6)
    # gaps: 1000-1100 (mid 1050: dispatch alone), 1400-1600 (mid 1500:
    # preprocess, the latest to start), 1700-2000 (mid 1850: collect_wait)
    assert red["idle_gaps"]["dispatch"] == pytest.approx(100e-6)
    assert red["idle_gaps"]["collect_wait"] == pytest.approx(300e-6)
    assert red["idle_gaps"]["preprocess"] == pytest.approx(200e-6)
    assert profile.breakdown(red)["device_ops"][0][0] == "crf_sum_kernel"


def test_rate_counts_every_sample_of_every_job_over_their_span(monkeypatch):
    """The closed loop's msamples_per_s: every sample of every job run,
    the last one past the window's close included, over the first job's
    start to the last job's end; a read left uncalled counts as failed."""
    import numpy as np

    from benchmark.harness.traffic import File, Inputs, Read
    from benchmark.loops import closed

    reads = [Read(i, f"r{i}", np.zeros(n, np.int16)) for i, n in enumerate([100, 200, 300])]
    loop = closed.Loop.__new__(closed.Loop)
    loop.inputs = Inputs(reads, [File("a", [0]), File("b", [1, 2])], ["d0", "d1"], [[0], [1]])
    loop.jobs = []
    clock = iter([0.0, 0.5, 2.5, 2.5, 6.0])  # the window's start, then each job's start and end
    monkeypatch.setattr(closed, "time", SimpleNamespace(perf_counter=lambda: next(clock)))
    n_called = {0: (1, 1), 1: (2, 1)}  # directory -> (reads, called)
    loop.job = n_called.__getitem__
    win = loop.window(5.0)
    assert win["window_s"] == 5.5
    assert win["e2e"]["msamples_per_s"] == 600 / 5.5 / 1e6
    assert (win["attempted"], win["failed"]) == (3, 1)
    assert win["job_reads"] == [[0], [1, 2]]
