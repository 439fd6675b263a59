"""The batch-minor chain scans' plan (flappie_tpu_torch/ops/crf_bm_cuda.py
``_scan_plan``, mirrored by ``scan_plan`` in csrc/crf_scan.cu): every read
in exactly one chain warp, at most 32 lanes a warp, one CTA's rings within
an SM's 227 KB, for the batches the paths run and their ragged edges.
Pure arithmetic: runs on the CPU; the card holds the C side to it
(chip_smoke.py, tests/test_torch_cuda.py).
"""

from __future__ import annotations

import pytest
import torch

from flappie_tpu_torch.ops.crf_bm_cuda import SCAN_KT, SCAN_RING, _scan_plan

SMEM_PER_CTA = 232_448  # 227 KB: the most shared memory one block may use
BATCHES = [1, 2, 3, 4, 5, 24, 31, 32, 33, 255, 256, 257]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Pin torch to one intra-op thread for this module (see
    tests/test_torch_models.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("B", BATCHES)
@pytest.mark.parametrize("S", [8, 10])
def test_covers_every_read_once(S, B):
    """Chain warp g of the grid holds reads g*R ... g*R + R - 1: over
    ``ctas`` CTAs of W warps each read is held once, and no CTA is
    empty."""
    R, W, ctas, _ = _scan_plan(S, B)
    held = [g * R + r for g in range(ctas * W) for r in range(R) if g * R + r < B]
    assert held == list(range(B))
    assert (ctas - 1) * W * R < B  # the last CTA holds a read


@pytest.mark.parametrize("B", BATCHES)
@pytest.mark.parametrize("S", [8, 10])
def test_lanes_and_shared_memory(S, B):
    """R reads of S states fill at most the warp's 32 lanes; a CTA's W
    chain warps (at most 4 besides the producer warp: 160 threads) keep
    their rings within one SM."""
    R, W, _, smem = _scan_plan(S, B)
    assert R * S <= 32 and 32 - R * S < S  # no room for one more read
    assert 1 <= W <= 4
    assert smem <= SMEM_PER_CTA
    assert smem % 16 == 0  # each ring stays 16-byte aligned


def test_ring_size_and_defaults():
    """A warp's ring at S=8: 4 tiles of 8 steps of a 1 KiB slice and its
    valid flags, 8 barriers, two staged tiles of outputs; the CTA sizes
    (1 chain warp at S=8, 2 at S=10) and the 24-read runnie batch on 6
    warps."""
    assert (SCAN_KT, SCAN_RING) == (8, 4)
    assert _scan_plan(8, 256) == (4, 1, 64, 16 * 4 + 4 * (4 * 8 * (256 + 4) + 2 * 8 * 8 * 4))
    assert _scan_plan(10, 256)[:3] == (3, 2, 43)
    assert _scan_plan(8, 24)[:3] == (4, 1, 6)
