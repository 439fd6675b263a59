"""K10's plan (flappie_tpu_torch/ops/conv_cuda.py ``_conv12_plan``, mirrored
by ``conv12_plan`` in csrc/conv12.cu): the persistent grid walks every
(read, tile) item once, the tiles cover each read's [0, T) once, a tile's
threads hold every (channel, sample) of y2 once and every y1 position on
the tile +- 2 once, and a CTA's shared memory fits the static limit at
the CTAs an SM the register cap asks for.  Pure arithmetic: runs on the
CPU; the card holds the C side to it (chip_smoke.py,
tests/test_torch_cuda.py ``test_conv12_info_matches_plan``).
"""

from __future__ import annotations

import pytest
import torch

from flappie_tpu_torch.ops.conv_cuda import (CONV12_GROUPS, CONV12_N, CONV12_THREADS,
                                             _conv12_plan)

SMEM_STATIC = 48 * 1024  # the most static shared memory a block may use
SMEM_PER_SM = 233_472  # 228 KB: an SM's shared memory, 1 KB of it reserved a CTA
# CTAs an SM by channel groups, as the H100 reports them for the register
# cap (csrc/conv12.cu kMinBlocks), and its SMs
H100 = ({1: 4, 4: 5}, 132)
# (B, T): the main paths' shapes (r941_native's chunk batch, runnie's
# heaviest bucket, the training batch) and the edges of each plan
SHAPES = [(256, 12800), (24, 65_536), (32, 2560), (1, 1), (2, 3), (5, 127), (1, 129),
          (200, 511), (200, 513), (264, 511), (300, 1023), (256, 1025), (300, 2560)]
CARDS = [H100, ({1: 1, 4: 1}, 1), ({1: 3, 4: 5}, 132), ({1: 4, 4: 5}, 114)]
GRID = [pytest.param(B, T, per_sm, sms, id=f"{B}x{T}-{sms}sm{per_sm[1]}")
        for B, T in SHAPES for per_sm, sms in CARDS]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Pin torch to one intra-op thread for this module (see
    tests/test_torch_models.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("B, T, per_sm, sms", GRID)
def test_every_item_once(B, T, per_sm, sms):
    """CTA k walks items k, k + ctas, ...: each (read, tile) once, no CTA
    idle, and the tiles of a read cover [0, T) once."""
    G, tile, threads, ntiles, items, ctas, _ = _conv12_plan(B, T, per_sm, sms)
    assert threads == CONV12_THREADS and tile == CONV12_N * threads // G
    assert items == B * ntiles and (ntiles - 1) * tile < T <= ntiles * tile
    assert 1 <= ctas <= items
    walked = sorted(i for k in range(ctas) for i in range(k, items, ctas))
    assert walked == list(range(items))
    for b in range(B):
        starts = [(i % ntiles) * tile for i in range(items) if i // ntiles == b]
        covered = [t for t0 in starts for t in range(t0, min(t0 + tile, T))]
        assert covered == list(range(T))


@pytest.mark.parametrize("B, T, per_sm, sms", GRID)
def test_groups_fill_the_card(B, T, per_sm, sms):
    """G is 1 when its items fill the resident CTAs, else 4; the grid is
    the resident CTAs or the items."""
    G, _, _, _, items, ctas, _ = _conv12_plan(B, T, per_sm, sms)
    assert G == (1 if B * -(-T // (CONV12_N * CONV12_THREADS)) >= per_sm[1] * sms else 4)
    assert ctas == min(items, per_sm[G] * sms)


@pytest.mark.parametrize("G", CONV12_GROUPS)
def test_threads_hold_a_tile_once(G):
    """Thread j = g * SB + sb holds channels g * 16/G .. and samples 4 * sb
    .. 4 * sb + 3 of the tile (a warp one channel group), and y1 positions
    i = 4 + P*j .. (P = 4 / G) beside the halo's 16 (i, c) lanes: each
    (channel, sample) of y2 and each of y1's 4 x (tile + 4) values once."""
    tile = CONV12_N * CONV12_THREADS // G
    sb_n, og, p_n = CONV12_THREADS // G, 16 // G, CONV12_N // G
    assert sb_n % 32 == 0
    y2 = sorted((g * og + q, CONV12_N * sb + n) for j in range(CONV12_THREADS)
                for g, sb in [divmod(j, sb_n)] for q in range(og) for n in range(CONV12_N))
    assert y2 == [(o, t) for o in range(16) for t in range(tile)]
    for w in range(CONV12_THREADS // 32):
        assert len({j // sb_n for j in range(32 * w, 32 * w + 32)}) == 1
    y1 = sorted([(c, 4 + p_n * j + p) for j in range(CONV12_THREADS) for c in range(4)
                 for p in range(p_n)] + [(lane & 3, lane >> 2) for lane in range(16)])
    assert y1 == [(c, i) for c in range(4) for i in range(tile + 4)]


@pytest.mark.parametrize("G", CONV12_GROUPS)
def test_shared_memory_fits(G):
    """A CTA's staging tile, zero row, y1 and weights (the plan's bytes for
    a plan that takes G groups) fit the static limit, and the CTAs an SM
    the register cap asks for (H100) fit the SM; every row a bulk copy
    reads or a 16-byte load touches starts on the 16-byte grid."""
    tile = CONV12_N * CONV12_THREADS // G
    per_sm = {1: 1 if G == 1 else 1 << 10, 4: 1}  # the 1-group plan fills the card or not
    plan = _conv12_plan(1, tile, per_sm, 1)
    assert plan[:2] == (G, tile)
    smem = plan[6]
    assert smem == 4 * (17 * tile + 4 * (tile + 4) + 360) <= SMEM_STATIC
    assert H100[0][G] * (smem + 1024) <= SMEM_PER_SM
    # out [16][tile], zero [tile], y1 [4][tile + 4], then w2, w1, b1, b2
    assert (4 * tile) % 16 == 0 and (4 * (tile + 4)) % 16 == 0
    assert 4 * (320 + 20 + 4) % 16 == 0  # b2's offset after w2, w1, b1


def test_production_plans():
    """On an H100 (4 and 5 CTAs an SM, 132 SMs): r941_native's chunk
    batch and runnie's heaviest bucket take one channel group and the
    persistent grid walks 12-13 and 5-6 items a CTA; the training batch
    takes four groups, 640 items of 128 samples on 640 CTAs."""
    per_sm, sms = H100
    assert _conv12_plan(256, 12800, per_sm, sms)[:6] == (1, 512, 128, 25, 6400, 528)
    assert _conv12_plan(24, 65_536, per_sm, sms)[:6] == (1, 512, 128, 128, 3072, 528)
    assert _conv12_plan(32, 2560, per_sm, sms)[:6] == (4, 128, 128, 20, 640, 640)
