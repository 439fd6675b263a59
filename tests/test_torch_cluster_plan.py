"""The cluster recurrence's plan (flappie_tpu_torch/ops/rnn_cuda.py
``_cluster_plan``, mirrored by ``cluster_rows`` / ``cluster_smem`` in
csrc/cluster_rnn.cuh): rows a cluster and clusters for the batches the
main paths run, one CTA's shared memory within an SM's 227 KB, and the
H the kernel refuses.  Pure arithmetic: runs on the CPU; the card holds
the C side to it (chip_smoke.py).
"""

from __future__ import annotations

import pytest

from flappie_tpu_torch.ops.rnn_cuda import _INFO, _cluster_plan, info_plan

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
    """The one-pass step product (DOT1) holds sW's slice in bf16: 64 KiB
    (LSTM) or 48 KiB (GRU-mod) a CTA at H=256, the rest of the shared
    memory as the f32 recurrence's, and the same rows and clusters."""
    for B in (1, 24, 32, 256):
        R, clusters, smem = _cluster_plan(B, 256, gates, dot1=True)
        assert (R, clusters) == _cluster_plan(B, 256, gates)[:2]
        assert smem - 4 * (2 * 256 * R + 4 * R * gates * 32) == kib * 1024
        assert _cluster_plan(B, 256, gates)[2] - smem == kib * 1024


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
