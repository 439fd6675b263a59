"""The chain scans' plans: the batch-minor K3/K4, K9 and K5
(flappie_tpu_torch/ops/crf_bm_cuda.py ``_scan_plan``, mirrored by
``scan_plan`` in csrc/crf_scan.cu) and K11's batch-major forward and
Viterbi scans (ops/crf_cuda.py ``_bt_plan``, mirrored by ``bt_plan`` in
csrc/crf_bt.cu): every read in exactly one chain warp, at most 32 lanes a
warp, one CTA's rings within an SM's 227 KB, for the batches the paths run
and their ragged edges; K11's ring slots and 16-byte copies aligned and
its read stride spreading a warp's loads over the banks, at S = 4 (the V1
run-length chain: 8 reads a warp, a tile's 64 valid flags two a producer
lane), 8 and 10.  Pure
arithmetic: runs on the CPU; the card holds the C sides to them
(chip_smoke.py, tests/test_torch_cuda.py).
"""

from __future__ import annotations

from collections import Counter

import pytest
import torch

from flappie_tpu_torch.ops.crf_bm_cuda import SCAN_KT, SCAN_RING, _scan_plan
from flappie_tpu_torch.ops.crf_cuda import BT_KT, BT_RING, _bt_plan

SMEM_PER_CTA = 232_448  # 227 KB: the most shared memory one block may use
BATCHES = [1, 2, 3, 4, 5, 24, 31, 32, 33, 255, 256, 257]
# (source, S, B): crf_scan.cu's cases keep their ids
GRID = [pytest.param(src, S, B, id=f"{S}-{B}" if src == "crf_scan" else f"{src}-{S}-{B}")
        for src in ("crf_scan", "crf_bt") for S in (8, 10, 4) for B in BATCHES]


def _plan(src: str, S: int, B: int):
    """(reads a warp, chain warps a CTA, CTAs, shared bytes a CTA) of a
    source's chain scans."""
    return _scan_plan(S, B) if src == "crf_scan" else _bt_plan(S, B)[:4]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Pin torch to one intra-op thread for this module (see
    tests/test_torch_models.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("src, S, B", GRID)
def test_covers_every_read_once(src, S, B):
    """Chain warp g of the grid holds reads g*R ... g*R + R - 1: over
    ``ctas`` CTAs of W warps each read is held once, and no CTA is
    empty."""
    R, W, ctas, _ = _plan(src, S, B)
    held = [g * R + r for g in range(ctas * W) for r in range(R) if g * R + r < B]
    assert held == list(range(B))
    assert (ctas - 1) * W * R < B  # the last CTA holds a read


@pytest.mark.parametrize("src, S, B", GRID)
def test_lanes_and_shared_memory(src, S, B):
    """R reads of S states fill at most the warp's 32 lanes; a CTA's W
    chain warps (at most 4 besides the producer warp: 160 threads) keep
    their rings within one SM.  K11's ring (barriers, then the blocks
    [RING][KT][R * P] floats, then the valid flags): every slot, step and
    read's block starts on a 16-byte boundary, where the producer's 16-byte
    copies land one read's S*S block of a step (S*S*4 bytes, a whole number
    of copies, from a 16-byte aligned source: (t*B + b)*S*S floats of the
    dense input)."""
    R, W, _, smem = _plan(src, S, B)
    assert R * S <= 32 and 32 - R * S < S  # no room for one more read
    assert 1 <= W <= 4
    assert smem <= SMEM_PER_CTA
    assert smem % 16 == 0  # each ring stays 16-byte aligned
    if src == "crf_bt":
        P = _bt_plan(S, B)[4]
        ring = smem // W
        assert ring * W == smem and ring % 16 == 0  # each chain warp's ring is aligned
        m0 = 16 * BT_RING  # full[RING], empty[RING]
        for slot in range(BT_RING):
            for k in range(BT_KT):
                for r in range(R):
                    assert (m0 + 4 * ((slot * BT_KT + k) * R * P + r * P)) % 16 == 0
        assert P >= S * S  # a block does not run into the next read's
        assert m0 + 4 * BT_RING * BT_KT * (R * P + R) <= ring  # blocks and valid flags fit
        assert (4 * S * S) % 16 == 0  # a block is whole copies, every source offset aligned


def test_ring_size_and_defaults():
    """A warp's ring at S=8: 4 tiles of 8 steps of a 1 KiB slice and its
    valid flags, 8 barriers, two staged tiles of outputs; the CTA sizes
    (1 chain warp at S=8, 2 at S=10) and the 24-read runnie batch on 6
    warps."""
    assert (SCAN_KT, SCAN_RING) == (8, 4)
    assert _scan_plan(8, 256) == (4, 1, 64, 16 * 4 + 4 * (4 * 8 * (256 + 4) + 2 * 8 * 8 * 4))
    assert _scan_plan(10, 256)[:3] == (3, 2, 43)
    assert _scan_plan(8, 24)[:3] == (4, 1, 6)
    # S = 4: a 512-byte slice a step for 8 reads, B=256 on 32 CTAs
    assert _scan_plan(4, 256) == (8, 1, 32, 16 * 4 + 4 * (4 * 8 * (128 + 8) + 2 * 8 * 4 * 8))


def _worst_conflict(S: int, P: int) -> int:
    """The most distinct words one bank serves in one of a K11 chain warp's
    loads: lane (r, to) reads word r*P + f*S + to of a step's blocks for
    from-state f; the idle lanes 30-31 at S=10 read read 0's words."""
    R = 32 // S
    worst = 0
    for f in range(S):
        words = {(lane // S if lane // S < R else 0) * P + f * S + lane % S for lane in range(32)}
        worst = max(worst, max(Counter(w % 32 for w in words).values()))
    return worst


@pytest.mark.parametrize("S", [8, 10, 4])
def test_bt_ring_stride_spreads_the_banks(S):
    """K11's padded stride serves each load in one pass at S=8 (the packed
    blocks, P = S*S, put the 4 reads on one bank: 4 passes) and at S=4
    (P = 20: the 8 reads' rows on banks 0, 20, 8, 28, 16, 4, 24, 12;
    packed, P = 16: 4 passes), and in two at S=10, where no 16-byte
    aligned stride separates three runs of 10 banks (packed: 3)."""
    P = _bt_plan(S, 1)[4]
    assert _worst_conflict(S, P) == {4: 1, 8: 1, 10: 2}[S]
    assert _worst_conflict(S, S * S) == {4: 4, 8: 4, 10: 3}[S]
    if S == 4:
        assert sorted(r * P % 32 for r in range(8)) == [0, 4, 8, 12, 16, 20, 24, 28]
    if S == 10:  # no 16-byte aligned stride does better
        assert min(_worst_conflict(S, q) for q in range(S * S, S * S + 64, 4)) == 2


def test_bt_ring_size_and_defaults():
    """K11's ring at S=8: 4 tiles of 8 steps of 4 reads' blocks at a stride
    of 72 floats and their valid flags, 8 barriers; one chain warp a CTA at
    both S, and runnie's 24-read batch on 6 warps."""
    assert (BT_KT, BT_RING) == (8, 4)
    assert _bt_plan(8, 256) == (4, 1, 64, 16 * 4 + 4 * 4 * 8 * (4 * 72 + 4), 72)
    assert _bt_plan(10, 256)[:3] == (3, 1, 86)
    assert _bt_plan(8, 24)[:3] == (4, 1, 6)
    # S = 4: 8 reads' blocks of 64 bytes at a stride of 20 floats (80
    # bytes), one chain warp a CTA, B=256 on 32 CTAs
    assert _bt_plan(4, 256) == (8, 1, 32, 16 * 4 + 4 * 4 * 8 * (8 * 20 + 8), 20)


@pytest.mark.parametrize("S", [8, 10, 4])
def test_a_tiles_copies_take_at_most_two_lane_turns(S):
    """A ring tile holds SCAN_KT steps of R = 32 // S reads: its KT * R
    valid flags (crf_scan.cu's Copier and crf_bt.cu's producer) take one
    turn of the producer warp's 32 lanes at S = 8 and 10, two at S = 4
    (the static_asserts' bound), and the 16-byte copy of 4 reads divides a
    warp's reads where R is a multiple of 4.  K11's producer brings a
    tile's KT * R blocks of S*S floats in 8, 16 and 19 turns of 16-byte
    copies at S = 4, 8, 10 (a step's 512, 1024 and 1200 bytes)."""
    R = 32 // S
    turns = -(-SCAN_KT * R // 32)
    assert turns == (2 if S == 4 else 1) and BT_KT == SCAN_KT
    assert -(-BT_KT * R * S * S // 4 // 32) == {4: 8, 8: 16, 10: 19}[S]
    assert (R % 4 == 0) == (S in (4, 8))
