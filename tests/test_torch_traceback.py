"""PyTorch port: the tracebacks' time-parallel algorithm on the CPU.

K6 (ops/crf_bm_cuda.py ``traceback``) and K11's traceback (ops/crf_cuda.py
``traceback_bt``) are one kernel, csrc/traceback.cuh: the walk cut into
segments of L steps, each walked from every start state at once, the
segments' maps composed (within a CTA, then across a cluster's CTAs, then
over rounds), each step's state the candidate of the start state that is
its segment's entry.  ``traceback_segmented_plain`` (both modules) repeats
that plan step by step; here it is held bit-equal to the serial plain walk
and to the JAX package's ``traceback_pallas`` in interpret mode (both
layouts), on uniformly random backpointers (paths that rarely merge, where
a composition error would show) and on Viterbi's, at S = 4 (the V1
run-length chain, 8 reads a warp), 8 and 10, walk
lengths around a segment's and a round's edges, batches that fill a warp's
reads partly, and reads with no valid step and with every step valid.  The
plan mirror (``_tb_plan``) is held to what the kernel needs.  Integer
outputs: no tolerance.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from flappie_tpu.ops import crf_bm_pallas as j_pal
from flappie_tpu.ops import crf_pallas as j_bt_pal
from flappie_tpu.ops.crf import flipflop_index

from flappie_tpu_torch.ops import crf_bm_cuda, crf_cuda
from flappie_tpu_torch.decode.runlength import rle_v1_index
from flappie_tpu_torch.ops.crf_bm_cuda import (TB_BUDGET, TB_CLUSTER, TB_CTAS, TB_MAX_R,
                                               TB_WARPS, _tb_plan, _tb_slots, _tb_words)
from flappie_tpu_torch.ops.crf_cuda import _tb_bt_plan, _tb_bt_words


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Pin torch to one intra-op thread for this module (see
    tests/test_torch_models.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _plan(T, L, W, C):
    """A plan of segments of L steps, W a CTA, C CTAs a cluster, with the
    rounds that cover T steps (the other fields are not read)."""
    return L, W, C, 0, max(1, -(-T // (L * W * C))), 0


def _inputs(T, S, B, seed, viterbi=False):
    """Batch-minor backpointers [T, S, B] int32 (uniformly random, or K5's
    plain Viterbi's over random weights), valid [T, B] with read 0 valid
    throughout and the last read never, last states [B]."""
    rng = np.random.default_rng(seed)
    nblocks = rng.integers(0, T + 1, B)
    nblocks[0] = T
    if B > 1:
        nblocks[-1] = 0
    valid = np.arange(T)[:, None] < nblocks[None, :]
    if viterbi:
        idx = rle_v1_index(4) if S == 4 else flipflop_index(S // 2)
        trans = rng.normal(0, 2, (T, idx.nparam, B)).astype(np.float32)
        from flappie_tpu_torch.ops.crf_bm import _dense_tm

        dense = _dense_tm(torch.from_numpy(trans), idx)
        alpha, bp = crf_bm_cuda.viterbi_fwd_plain(dense, torch.from_numpy(valid), idx.tie_rank)
        return bp.numpy(), valid, alpha.argmax(dim=0).to(torch.int32).numpy()
    return (rng.integers(0, S, (T, S, B)).astype(np.int32), valid,
            rng.integers(0, S, B).astype(np.int32))


def _both(bp, valid, last, plan_bm=None, plan_bt=None):
    """The serial walks and the segmented twins of both layouts: (K6 path
    [T+1, B], its twin's, K11 states [T, B], its twin's)."""
    bp_t, v_t, last_t = (torch.from_numpy(a) for a in (bp, valid, last))
    bp_rev = torch.from_numpy(bp.transpose(0, 2, 1)[::-1].astype(np.int8))
    v_rev = torch.from_numpy(valid[::-1].copy())
    return (crf_bm_cuda.traceback_plain(bp_t, v_t, last_t),
            crf_bm_cuda.traceback_segmented_plain(bp_t, v_t, last_t, plan_bm),
            crf_cuda.traceback_bt_plain(bp_rev, v_rev, last_t),
            crf_cuda.traceback_bt_segmented_plain(bp_rev, v_rev, last_t, plan_bt))


# segments of 16 steps, 2 a CTA, 3 CTAs a cluster: 96 steps a round
L, W, C = 16, 2, 3
LENGTHS = [1, L - 1, L, L + 1, 5 * L + 3, 2 * L * W * C + 7]


@pytest.mark.parametrize("viterbi", [False, True], ids=["random", "viterbi"])
@pytest.mark.parametrize("T", LENGTHS)
@pytest.mark.parametrize("S,B", [(8, 5), (10, 5), (10, 7), (4, 5), (4, 11)])
def test_segmented_bit_equal_to_serial_walk(S, B, T, viterbi):
    """At a small plan whose segments, CTAs, cluster and rounds all show
    at these lengths; B leaves the last warp's reads partly filled."""
    bp, valid, last = _inputs(T, S, B, seed=T * S + B, viterbi=viterbi)
    path, path_seg, states, states_seg = _both(bp, valid, last, _plan(T, L, W, C),
                                               _plan(T, L, W, C))
    assert path.shape == (T + 1, B) and states.shape == (T, B)
    assert torch.equal(path_seg, path)
    assert torch.equal(states_seg, states)
    assert torch.equal(states, path[:T].flip(0))


@pytest.mark.parametrize("T,B", [(1, 1), (300, 5), (2560, 3), (13_108, 24)])
@pytest.mark.parametrize("S", [8, 10, 4])
def test_segmented_at_the_kernels_plans(S, T, B):
    """At the plans the kernels launch (``_tb_plan``, ``_tb_bt_plan``):
    one step a segment, the real segment lengths at T=2560, and runnie's
    heaviest program (T=13,108, B=24: several rounds)."""
    bp, valid, last = _inputs(T, S, B, seed=T + S)
    path, path_seg, states, states_seg = _both(bp, valid, last)
    assert torch.equal(path_seg, path)
    assert torch.equal(states_seg, states)


def test_no_valid_step_stays_at_last():
    """nblocks 0 for every read: every state is the read's last state."""
    T, S, B = 40, 8, 6
    bp, _, last = _inputs(T, S, B, seed=3)
    valid = np.zeros((T, B), bool)
    path, path_seg, states, states_seg = _both(bp, valid, last, _plan(T, 4, 2, 2),
                                               _plan(T, 4, 2, 2))
    want = torch.from_numpy(last)[None].expand(T + 1, B)
    assert torch.equal(path_seg, want) and torch.equal(path, want)
    assert torch.equal(states_seg, want[:T]) and torch.equal(states, want[:T])


@pytest.mark.parametrize("T", [1, 75, 2 * L * W * C + 7])
@pytest.mark.parametrize("S", [8, 10, 4])
def test_segmented_matches_pallas_batch_minor(S, T, monkeypatch):
    """K6's twin against crf_bm_pallas.traceback_pallas in interpret mode
    (random backpointers, time blocks of 8 and its padded tail)."""
    B = 5
    bp, valid, last = _inputs(T, S, B, seed=100 + T + S)
    monkeypatch.setattr(j_pal, "TIME_BLOCK", 8)
    want = np.asarray(j_pal.traceback_pallas(jnp.asarray(bp), jnp.asarray(valid),
                                             jnp.asarray(last), interpret=True))
    args = [torch.from_numpy(a) for a in (bp, valid, last)]
    for plan in (_plan(T, L, W, C), None):
        got = crf_bm_cuda.traceback_segmented_plain(*args, plan)
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("T", [1, 75, 2 * L * W * C + 7])
@pytest.mark.parametrize("S", [8, 10, 4])
def test_segmented_matches_pallas_batch_major(S, T, monkeypatch):
    """K11's traceback's twin against crf_pallas.traceback_pallas in
    interpret mode (time-reversed int8 backpointers, time blocks of 8)."""
    B = 7
    bp, valid, last = _inputs(T, S, B, seed=200 + T + S)
    bp_rev = bp.transpose(0, 2, 1)[::-1].astype(np.int8)
    v_rev = valid[::-1].copy()
    monkeypatch.setattr(j_bt_pal, "TIME_BLOCK", 8)
    want = np.asarray(j_bt_pal.traceback_pallas(jnp.asarray(bp_rev), jnp.asarray(v_rev),
                                                jnp.asarray(last), interpret=True))
    args = [torch.from_numpy(a) for a in (bp_rev, v_rev, last)]
    for plan in (_plan(T, L, W, C), None):
        got = crf_cuda.traceback_bt_segmented_plain(*args, plan)
        np.testing.assert_array_equal(got.numpy(), want)


def test_twin_refuses_a_plan_short_of_the_walk():
    bp, valid, last = _inputs(50, 8, 2, seed=5)
    with pytest.raises(ValueError):
        crf_bm_cuda.traceback_segmented_plain(
            *(torch.from_numpy(a) for a in (bp, valid, last)), (4, 2, 2, 0, 1, 0))


PLAN_SHAPES = [(T, S, B) for S in (8, 10, 4) for B in (1, 3, 24, 256, 257, 1100)
               for T in (0, 1, 65, 2560, 4609, 13_108, 100_000)]


@pytest.mark.parametrize("kernel", ["K6", "K11"])
@pytest.mark.parametrize("T,S,B", PLAN_SHAPES)
def test_plan_covers_the_walk(kernel, T, S, B):
    """Every step in a segment, no round empty, at most TB_BUDGET bytes of
    staged steps a CTA (two CTAs an SM fit its 228 KB), every read group a
    cluster of at most TB_CLUSTER CTAs, and no more CTAs than two an SM
    unless the read groups alone outnumber them."""
    words = _tb_words(S) if kernel == "K6" else _tb_bt_words(S)
    Lp, Wp, Cp, ctas, rounds, smem = (_tb_plan if kernel == "K6" else _tb_bt_plan)(T, S, B)
    assert _tb_plan(T, S, B, words) == (Lp, Wp, Cp, ctas, rounds, smem)
    groups = -(-B // (32 // S))
    assert Wp == TB_WARPS and 1 <= Cp <= TB_CLUSTER and ctas == groups * Cp
    assert ctas <= max(TB_CTAS, groups)
    assert 32 // S <= _tb_slots(S) <= TB_MAX_R  # a warp's reads' flags fit a step's slots
    step = 4 * words + 4 * _tb_slots(S) + 32
    assert Wp * Lp * step <= TB_BUDGET and 2 * (smem + 1024) <= 233_472
    if T == 0:
        assert rounds == 0
    else:
        assert rounds * Cp * Wp * Lp >= T > (rounds - 1) * Cp * Wp * Lp
        assert rounds * Cp * Wp * (Lp - 1) < T  # L as short as the rounds allow


def test_plans_at_the_main_shapes():
    """The plans the main path's shapes get (csrc/traceback.cuh tb_plan):
    (L, W, C, CTAs, rounds, shared bytes)."""
    assert (_tb_words(8), _tb_words(10), _tb_bt_words(8), _tb_bt_words(10)) == (32, 30, 9, 9)
    assert _tb_plan(2560, 8, 256) == (40, 8, 4, 256, 2, 57_312)
    assert _tb_plan(2560, 10, 256) == (54, 8, 3, 258, 2, 73_568)
    assert _tb_plan(13_108, 8, 24) == (52, 8, 8, 48, 4, 74_208)
    assert _tb_bt_plan(2560, 8, 256) == (80, 8, 4, 256, 1, 54_752)
    assert _tb_bt_plan(13_108, 8, 24) == (103, 8, 8, 48, 2, 70_208)
    # the V1 chain (S = 4, 8 reads a warp and 8 flag slots a step): one
    # round of a cluster of 8 CTAs for each of the 32 read groups
    assert (_tb_words(4), _tb_bt_words(4)) == (32, 9)
    assert _tb_plan(2560, 4, 256) == (40, 8, 8, 256, 1, 62_592)
    assert _tb_bt_plan(2560, 4, 256) == (40, 8, 8, 256, 1, 33_152)
