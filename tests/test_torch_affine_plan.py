"""Both block affines' plans (flappie_tpu_torch/ops/rnn_cuda.py
``_affine_plan``, mirrored by ``affine_plan`` in csrc/affine.cuh): which
path a shape takes (the f32 SGEMM; the bf16 affine on wgmma + TMA, or on
wmma off the TMA grid), that every output tile is computed once, and that
each CTA's shared memory, TMA boxes and strides and the wgmma width fit
the H100.  Pure arithmetic: runs on the CPU; the card holds the C side to
it (chip_smoke.py ``log_affine_plans``, tests/test_torch_cuda.py
``test_affine_info_matches_plan``).
"""

from __future__ import annotations

import pytest
import torch

from flappie_tpu_torch.ops.rnn_cuda import (AFFINE_F32, AFFINE_WGMMA, AFFINE_WMMA, H100_SMS,
                                            PATH_F32, PATH_WGMMA, PATH_WMMA, WGMMA_KMAX,
                                            _affine_plan)

SMEM_OPTIN = 232_448  # 227 KB: the most dynamic shared memory a block may use
SMEM_STATIC = 48 * 1024  # the most static shared memory a block may use
# (M, K, N): the model shapes (a chunk batch's layer at G = 4H and 3H,
# runnie's heaviest program, the training batch), M = 1, ragged M, the
# card tests' shapes, and the edges of the grid: N tiles that do not
# divide the SMs, one partial N tile, more N tiles than SMs
MODEL_SHAPES = [(655_360, 256, 1024), (655_360, 256, 768), (314_592, 256, 1024),
                (16_384, 256, 1024)]
SHAPES = MODEL_SHAPES + [(1, 256, 1024), (13_108, 256, 1024), (129, 32, 48), (37, 8, 64),
                         (1000, 96, 1024), (4096, 256, 768), (5000, 256, 1024), (2000, 256, 768),
                         (127, 256, 1280), (300, 8, 8), (640, 64, 256 * 140), (257, 256, 520)]
OFF_GRID = [(300, 12, 40), (37, 10, 64), (64, 256, 1020), (64, 264, 1024), (64, 512, 256),
            (10, 0, 64), (0, 256, 64), (5, 6, 7)]
CARDS = [H100_SMS, 1, 114, 7]
GRID = [pytest.param(M, K, N, sms, id=f"{M}x{K}x{N}-{sms}sm")
        for M, K, N in SHAPES for sms in CARDS]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Pin torch to one intra-op thread for this module (see
    tests/test_torch_models.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _walk(M, N, K, sms):
    """The output tiles (M block, N tile) of the wgmma path's persistent
    grid, as the kernel walks them: CTA c keeps N tile c % nN and takes M
    blocks c // nN, c // nN + groups, ..."""
    _, bm, bn, _, _, _, ctas, tiles = _affine_plan(M, N, K, True, sms)
    nN, mblocks = -(-N // bn), -(-M // bm)
    groups = ctas // nN
    assert ctas == groups * nN and tiles == mblocks * nN
    return [(m, c % nN) for c in range(ctas) for m in range(c // nN, mblocks, groups)]


@pytest.mark.parametrize("M, K, N, sms", GRID)
def test_every_output_tile_once(M, K, N, sms):
    """Each (M block, N tile) of the persistent grid once, no CTA idle,
    at most one CTA an SM unless the N tiles alone outnumber the SMs."""
    walked = _walk(M, N, K, sms)
    _, bm, bn, _, _, _, ctas, _ = _affine_plan(M, N, K, True, sms)
    nN, mblocks = -(-N // bn), -(-M // bm)
    assert sorted(walked) == [(m, n) for m in range(mblocks) for n in range(nN)]
    assert {c // nN for c in range(ctas)} == set(range(ctas // nN))
    assert ctas <= max(sms, nN)
    # every CTA has a tile: its first M block exists
    assert ctas // nN <= mblocks


@pytest.mark.parametrize("M, K, N", SHAPES)
def test_rows_cover_ragged_m_once(M, K, N):
    """The tiles' rows cover [0, M) once in each N tile (the last block
    ragged, clipped by the TMA store), their columns [0, N) once."""
    walked = _walk(M, N, K, H100_SMS)
    _, bm, bn = _affine_plan(M, N, K, True)[:3]
    for n in {n for _, n in walked}:
        rows = sorted(r for m, nn in walked if nn == n for r in range(m * bm, min(m * bm + bm, M)))
        assert rows == list(range(M))
    cols = sorted(c for n in {n for _, n in walked} for c in range(n * bn, min(n * bn + bn, N)))
    assert cols == list(range(N))


@pytest.mark.parametrize("M, K, N", SHAPES + OFF_GRID)
@pytest.mark.parametrize("bf16", [False, True])
def test_shared_memory_fits(M, K, N, bf16):
    """A CTA's shared memory within the card's 227 KB (the wmma kernel's,
    static, within 48 KB); the wgmma path's resident W, two A rings,
    staged boxes, bias and barriers with room to align the base to 1024
    bytes."""
    path, bm, bn, bk, stages, smem = _affine_plan(M, N, K, bf16)[:6]
    assert smem <= (SMEM_STATIC if path == PATH_WMMA else SMEM_OPTIN)
    if path == PATH_WGMMA:
        parts = 4 * WGMMA_KMAX * 128 + stages * bm * bk * 2 + 2 * 2 * 64 * 64 * 2 + bn * 4
        assert smem >= parts + (4 * stages + 1) * 8 + 1023
        # the ring's slots, W's slabs and the output boxes start on the
        # 1024-byte swizzle atom
        assert (4 * WGMMA_KMAX * 128) % 1024 == 0 and (bm * bk * 2) % 1024 == 0
        assert (64 * 64 * 2) % 1024 == 0


@pytest.mark.parametrize("M, K, N", SHAPES)
def test_tma_boxes_and_strides_aligned(M, K, N):
    """On the wgmma path: A, W and C's row strides are multiples of 16
    bytes, every box's inner extent is 128 bytes (the 128B swizzle's
    span) and every box dimension at most 256."""
    path, bm, bn, bk = _affine_plan(M, N, K, True)[:4]
    assert path == PATH_WGMMA
    for inner in (K, N):
        assert (inner * 2) % 16 == 0
    krows = -(-K // bk) * bk
    boxes = {"A": (bk, bm), "W": (64, krows), "C": (64, 64)}
    for inner, outer in boxes.values():
        assert inner * 2 == 128 and 0 < outer <= 256
    assert krows <= WGMMA_KMAX and bn % 64 == 0


def test_wgmma_shape():
    """The instruction m64nNk16: 64 rows a consumer warpgroup (two of them
    a 128-row tile), N a multiple of 8 and at most 256, k steps of 16
    inside the 64-deep stage."""
    bm, bn, bk, stages = AFFINE_WGMMA
    assert bm == 2 * 64 and bn % 8 == 0 and 8 <= bn <= 256 and bk % 16 == 0
    assert 3 <= stages <= 4


@pytest.mark.parametrize("M, K, N", MODEL_SHAPES)
def test_model_shapes_take_wgmma(M, K, N):
    assert _affine_plan(M, N, K, True)[0] == PATH_WGMMA


@pytest.mark.parametrize("M, K, N", OFF_GRID)
def test_off_grid_shapes_take_wmma(M, K, N):
    """K or N off the 8-element grid, K past the resident slice, or an
    empty operand: the wmma kernel, one CTA a 128x128 tile."""
    path, bm, bn, bk, stages, _, ctas, tiles = _affine_plan(M, N, K, True)
    assert (path, bm, bn, bk, stages) == (PATH_WMMA, *AFFINE_WMMA)
    assert ctas == tiles == -(-M // bm) * -(-N // bn)


@pytest.mark.parametrize("M, K, N", SHAPES + OFF_GRID)
def test_f32_plan(M, K, N):
    """The f32 SGEMM at any shape: one CTA a 128x128 tile, K 16 a stage
    in a 3-stage ring, two CTAs an SM within the SM's shared memory."""
    path, bm, bn, bk, stages, smem, ctas, tiles = _affine_plan(M, N, K, False)
    assert (path, bm, bn, bk, stages) == (PATH_F32, *AFFINE_F32)
    assert ctas == tiles == -(-M // bm) * -(-N // bn)
    assert smem == stages * (bm * (bk + 4) + bk * bn) * 4 and 2 * smem <= 233_472
    # A's rows keep 16-byte cp.async destinations at the padded stride
    assert ((bk + 4) * 4) % 16 == 0
