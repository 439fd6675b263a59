"""The cluster recurrence's plan (flappie_tpu_torch/ops/rnn_cuda.py
``_cluster_plan``, mirrored by ``cluster_rows`` / ``cluster_smem`` in
csrc/cluster_rnn.cuh): rows a cluster and clusters for the batches the
main paths run, one CTA's shared memory within an SM's 227 KB, and the
H the kernel refuses; and the layout of the one-pass step on the tensor
cores, the LSTM's and GRU-mod's, at one pass and at three (``_mma_plan``,
mirroring mma_warps / mma_rows / mma_lo_lines / cluster_mma_smem in
csrc/cluster_rnn_mma.cuh, and ``_mma_gate_rows``, its gate-to-row map).  Pure arithmetic: runs on the
CPU; the card holds the C side to it (chip_smoke.py).
"""

from __future__ import annotations

import pytest

from flappie_tpu_torch.ops.rnn_cuda import (ROWS, _INFO, _cluster_plan, _mma_gate_rows, _mma_plan,
                                            info_plan)

SMEM_PER_CTA = 232_448  # 227 KB: the most shared memory one block may use


@pytest.mark.parametrize("B,R,clusters", [
    (1, 1, 1),      # one read: one cluster of 8 SMs
    (16, 2, 8),     # 16 clusters of one row would run in two waves
    (24, 2, 12),    # runnie's heaviest program
    (32, 4, 8),     # a training batch
    (256, 20, 13),  # a chunk batch: 16 clusters of 16 rows would not all fit
    (257, 20, 13),  # the last cluster partly filled
])
@pytest.mark.parametrize("gates", [4, 3])
def test_rows_and_clusters(B, R, clusters, gates):
    got = _cluster_plan(B, 256, gates)
    assert got[:2] == (R, clusters)
    assert R * clusters >= B > R * (clusters - 1)
    assert clusters <= 15  # every cluster resident at once on the H100


@pytest.mark.parametrize("H", [16, 256])
@pytest.mark.parametrize("gates", [4, 3])
def test_shared_memory_fits_one_sm(H, gates):
    """Every R the plan can pick: sW's eighth, h by step parity and the
    partial sums within one block's limit."""
    sizes = {}
    for B in (1, 16, 32, 100, 150, 240, 256, 4096):
        R, _, smem = _cluster_plan(B, H, gates)
        sizes[R] = smem
    assert sorted(sizes) == [1, 2, 4, 8, 12, 16, 20]
    assert max(sizes.values()) < SMEM_PER_CTA
    cols = gates * H // 8
    assert sizes[20] == 4 * (H * cols + 2 * H * 20 + 4 * 20 * cols)


def test_sw_slice_sizes_at_full_width():
    """The slice of sW a CTA keeps: 128 KiB (LSTM), 96 KiB (GRU-mod)."""
    for gates, kib in ((4, 128), (3, 96)):
        R, _, smem = _cluster_plan(1, 256, gates)
        assert smem - 4 * (2 * 256 * R + 4 * R * gates * 32) == kib * 1024


@pytest.mark.parametrize("H", [512, 24, 0])
def test_refuses_unsupported_h(H):
    with pytest.raises(ValueError, match="H % 16 == 0 and H <= 256"):
        _cluster_plan(8, H, 4)


@pytest.mark.parametrize("kind,twin", [("lstm_layer_bf16", "lstm_layer"),
                                       ("grumod_layer_bf16", "grumod_layer")])
def test_bf16_layers_are_variant_3_of_their_sources(kind, twin):
    """K1-bf16 and K7-bf16 ask their source's cluster_info for variant 3,
    whose plan is the f32 layer's (the stream type changes neither the
    rows nor the shared memory: xa and out never enter it); the card
    holds the two equal (test_torch_cuda.py)."""
    assert _INFO[kind] == (_INFO[twin][0], 3)
    assert len({v for v in _INFO.values()}) == len(_INFO)


@pytest.mark.parametrize("gates,kib", [(4, 64), (3, 48)])
def test_one_pass_slices_are_bf16(gates, kib):
    """The one-pass step product holds sW's slice in bf16, 64 KiB (LSTM)
    or 48 KiB (GRU-mod) a CTA at H=256, as the tensor-core step's A
    fragments in registers (128 words a thread at 4 gates, 96 not zero at
    3; 128 threads a CTA), so its shared memory is the exchanged bf16 h
    alone, whatever the cell."""
    for B in (1, 24, 32, 256):
        R, clusters, smem = _cluster_plan(B, 256, gates, passes=1)
        plan = _mma_plan(256, R, gates)
        assert plan["a_registers"] * 4 * 32 * plan["warps"] == kib * 1024
        assert plan["a_registers"] == 32 * gates
        assert smem == plan["smem"] == 2 * 256 * plan["rows"] * 2
        assert smem == _cluster_plan(B, 256, 7 - gates, passes=1)[2]


@pytest.mark.parametrize("R", ROWS)
@pytest.mark.parametrize("H", [16, 48, 128, 256])
def test_tensor_core_step_layout(H, R):
    """At every R and H: the rows padded to the fewest n-tiles of 8, the
    CTA's H/8 units in the fewest warps of 8 (at most 4: the kernel's 128
    threads), K padded to 8 chunks of 8 units a warp (64 a warp: whole
    k-tiles of 16), two h buffers of a 16-byte line a chunk and row within
    one block's shared memory."""
    p = _mma_plan(H, R)
    assert p["rows"] == 8 * p["n_tiles"] and p["rows"] - 8 < R <= p["rows"]
    assert 8 * (p["warps"] - 1) < H // 8 <= 8 * p["warps"] <= 32
    assert p["chunks"] == 8 * p["warps"] and p["k_tiles"] * 16 == p["chunks"] * 8 >= H
    assert p["smem"] == 2 * p["chunks"] * p["rows"] * 16 < SMEM_PER_CTA
    assert p["a_registers"] == 8 * p["k_tiles"] <= 128


@pytest.mark.parametrize("R,n_tiles", [(1, 1), (2, 1), (4, 1), (8, 1), (12, 2), (16, 2), (20, 3)])
def test_tensor_core_step_at_full_width(R, n_tiles):
    """H=256: 4 warps, 32 chunks, 16 k-tiles, no padding in K; at R=20 three
    n-tiles of 8 (24 rows, 4 of them padding) and 24 KiB of shared memory,
    against the CUDA-core one-pass step's 64 KiB slice plus 40 KiB of h and
    80 KiB of partial sums."""
    assert _mma_plan(256, R) == dict(warps=4, chunks=32, k_tiles=16, n_tiles=n_tiles,
                                      rows=8 * n_tiles, smem=8192 * n_tiles, a_registers=128)


@pytest.mark.parametrize("B,R,clusters", [
    (1, 1, 1), (16, 1, 16), (17, 2, 9),
    (24, 2, 12),    # runnie's heaviest program: R=2 as the f32 recurrence's
    (32, 2, 16),    # a training batch
    (33, 4, 9), (100, 8, 13), (150, 12, 13), (240, 16, 15),
    (256, 16, 16),  # a chunk batch: two n-tiles, not the f32 recurrence's R=20 (three)
    (257, 20, 13), (321, 20, 17),
])
@pytest.mark.parametrize("gates", [4, 3])
def test_tensor_core_step_rows(B, R, clusters, gates):
    """The tensor-core step's rows rule (mma_cluster_rows), the LSTM's and
    GRU-mod's: the fewest rows of ROWS that keep the clusters within 16
    (one CTA an SM for 128 of the H100's 132), else the most."""
    assert _cluster_plan(B, 256, gates, passes=1)[:2] == (R, clusters)
    assert clusters <= 16 or R == ROWS[-1]


@pytest.mark.parametrize("B", [1, 16, 24, 32, 100, 150, 240, 256, 257])
@pytest.mark.parametrize("kind", ["lstm_layer_p1", "lstm_layer_train_p1", "lstm_layer_bf16_p1",
                                  "lstm_layer_train_bf16_p1"])
def test_one_pass_lstm_plans_are_the_tensor_core_steps(kind, B):
    """The four one-pass LSTM variants of lstm_p1.cu (K1-default, K8-default
    and their bf16-stream twins) plan the tensor-core step: its rows rule,
    the exchanged h's shared bytes."""
    R, clusters, smem = info_plan(kind, B)
    assert (R, clusters) == (R, -(-B // R)) == _cluster_plan(B, 256, 4, passes=1)[:2]
    assert R == next(r for r in ROWS if -(-B // r) <= 16)
    assert smem == _mma_plan(256, R)["smem"]


@pytest.mark.parametrize("B", [1, 16, 24, 32, 100, 150, 240, 256, 257])
@pytest.mark.parametrize("kind", ["grumod_layer_p1", "grumod_layer_bf16_p1"])
def test_one_pass_grumod_plans_are_the_tensor_core_steps(kind, B):
    """GRU-mod's two one-pass variants of grumod_p1.cu (K7-default and its
    bf16-stream twin) plan the tensor-core step, as the LSTM's do: its rows
    rule, its clusters, the exchanged h's shared bytes (no sW slice, no
    partial sums)."""
    R, clusters, smem = info_plan(kind, B)
    assert (R, clusters) == (R, -(-B // R)) == _cluster_plan(B, 256, 3, passes=1)[:2]
    assert R == next(r for r in ROWS if -(-B // r) <= 16)
    assert smem == _mma_plan(256, R, 3)["smem"] == _mma_plan(256, R)["smem"]
    assert info_plan(kind, B) == info_plan("lstm_layer_p1", B)


@pytest.mark.parametrize("gates", [4, 3])
def test_mma_gate_rows_meet_in_one_lane_group(gates):
    """Every gate of a unit slot lands in one lane group: the accumulator
    rows g and g + 8 of the two m-tiles, which lanes 4 g ... 4 g + 3 hold,
    carry all ``gates`` gates of unit slot g and nothing of another unit;
    each gate of each of the 8 slots appears once."""
    rows = _mma_gate_rows(gates)
    assert len(rows) == 2 and all(len(r) == 16 for r in rows)
    for g in range(8):
        held = [rows[mt][m] for mt in range(2) for m in (g, g + 8)]
        assert {cell[1] for cell in held if cell} == {g}
        assert sorted(cell[0] for cell in held if cell) == list(range(gates))
    cells = [cell for r in rows for cell in r if cell]
    assert len(cells) == len(set(cells)) == 8 * gates


def test_mma_zero_rows_are_grumods_m_tile_1_high_half():
    """GRU-mod's zero rows (gate 3, a compile-time zero) are exactly rows
    8-15 of m-tile 1; its m-tile 0 holds z | r and m-tile 1's low half the
    candidate; the LSTM has no zero row."""
    rows = _mma_gate_rows(3)
    zero = [(mt, m) for mt in range(2) for m in range(16) if rows[mt][m] is None]
    assert zero == [(1, m) for m in range(8, 16)]
    assert [rows[0][m][0] for m in range(16)] == [0] * 8 + [1] * 8
    assert [rows[1][m][0] for m in range(8)] == [2] * 8
    assert all(cell is not None for r in _mma_gate_rows(4) for cell in r)


def test_lstm_gate_rows_are_as_before():
    """The LSTM's map as it was: row m of m-tile mt is gate 2 mt + m // 8
    (u | f, then g | o) of unit slot m % 8."""
    assert _mma_gate_rows(4) == [[(2 * mt + m // 8, m % 8) for m in range(16)]
                                 for mt in range(2)]


@pytest.mark.parametrize("kind,source,variant", [
    ("lstm_layer_train_bf16", "lstm", 4),
    ("lstm_layer_p1", "lstm_p1", 0), ("lstm_layer_train_p1", "lstm_p1", 1),
    ("lstm_layer_bf16_p1", "lstm_p1", 3), ("lstm_layer_train_bf16_p1", "lstm_p1", 4),
    ("grumod_layer_p1", "grumod_p1", 0), ("grumod_layer_bf16_p1", "grumod_p1", 3),
])
def test_new_variants_of_their_sources(kind, source, variant):
    """K8-bf16 is variant 4 of lstm.cu; the rnn-``default`` recurrences
    keep their f32 twins' numbers in lstm_p1.cu / grumod_p1.cu, whose
    plans ``info_plan`` reads with the bf16 slice (the card holds the C
    side to it: chip_smoke.py, test_torch_cuda.py)."""
    assert _INFO[kind] == (source, variant)
    gates = 4 if source.startswith("lstm") else 3
    for B in (1, 100, 256):
        assert info_plan(kind, B) == _cluster_plan(B, 256, gates, source.endswith("_p1"))


@pytest.mark.parametrize("R", ROWS)
@pytest.mark.parametrize("gates,lo_kib", [(4, 64), (3, 48)])
def test_three_pass_step_layout(gates, lo_kib, R):
    """The three-pass step (rnn ``high`` on the card) keeps the one-pass
    step's warps, k-tiles and sW_hi registers, exchanges h in two parts
    (hi, lo: twice the h buffer) and holds sW_lo's A fragments in shared
    memory: 64 KiB a CTA for the LSTM, 48 KiB for GRU-mod (m-tile 1's zero
    rows not stored), so at R=16 a CTA takes 96 or 80 KiB and two of them
    still share an SM's 228 KB."""
    one, three = _mma_plan(256, R, gates), _mma_plan(256, R, gates, 3)
    assert {k: v for k, v in three.items() if k != "smem"} == \
        {k: v for k, v in one.items() if k != "smem"}
    assert three["smem"] == 2 * one["smem"] + lo_kib * 1024
    assert three["smem"] == 2 * 2 * 256 * three["rows"] * 2 + three["warps"] * 16 * (
        32 + (32 if gates == 4 else 16)) * 16
    assert 2 * three["smem"] + 2 * 1024 <= 233_472
    if R == 16:
        assert three["smem"] == {4: 96, 3: 80}[gates] * 1024


@pytest.mark.parametrize("B", [1, 16, 24, 32, 100, 150, 240, 256, 257])
@pytest.mark.parametrize("kind,source,variant", [
    ("lstm_layer_h3", "lstm_h3", 0), ("lstm_layer_train_h3", "lstm_h3", 1),
    ("lstm_layer_bf16_h3", "lstm_h3", 3), ("lstm_layer_train_bf16_h3", "lstm_h3", 4),
    ("grumod_layer_h3", "grumod_h3", 0), ("grumod_layer_bf16_h3", "grumod_h3", 3),
])
def test_three_pass_plans_are_the_tensor_core_steps(kind, source, variant, B):
    """The six rnn-``high`` variants of lstm_h3.cu / grumod_h3.cu keep their
    f32 twins' variant numbers and plan the tensor-core step at three
    passes: the one-pass step's rows rule and clusters, its own shared
    bytes (the card holds the C side to it: chip_smoke.py,
    test_torch_cuda.py)."""
    assert _INFO[kind] == (source, variant)
    gates = 4 if source.startswith("lstm") else 3
    R, clusters, smem = info_plan(kind, B)
    assert (R, clusters) == info_plan(f"{kind[:-3]}_p1", B)[:2]
    assert (R, clusters, smem) == _cluster_plan(B, 256, gates, 3)
    assert smem == _mma_plan(256, R, gates, 3)["smem"]
