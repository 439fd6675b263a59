"""Shared helpers of the benchmark's tests: the cells shrunk to sizes a
CPU test can hold (short reads, chunks of 400 blocks)."""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def shrink(cell, reads: int = 8):
    """The cell at a test's size: ``reads`` reads of 1.5k-20k samples
    (median 5k) in 2 directories, chunks of 400 blocks with a 400-sample
    overlap, a sample of 4 reads, one traced job."""
    cell.traffic["reads"].update(count=reads, median_samples=5000, sigma=0.5, min_samples=1500,
                                 max_samples=20000)
    cell.traffic["files"]["dirs"] = 2
    cell.traffic["check"] = {"reads": 4, "short_reads": 1}
    cell.traffic["trace"] = 1
    stride = 1
    for c in cell.config["widths"]["convs"]:
        stride *= c["stride"]
    chunk = 400 * stride
    cell.config["flags"] = cell.config["flags"] + ["--chunk", str(chunk), "--overlap", "400"]
    cell.config["decode"].update(chunk_samples=chunk, overlap=400)


@pytest.fixture(autouse=True)
def _one_thread():
    """The CPU path's recurrences are thousands of tiny steps: torch's
    intra-op threads only slow them under several test workers."""
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def card():
    """Skips the test on a host without a CUDA device."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.cuda.get_device_name(0)
