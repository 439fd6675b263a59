"""PyTorch port on the CPU: the CRF functions of ops/crf.py under each
FLAPPIE_TPU_CRF_IMPL, against the JAX package's flappie_tpu/ops/crf.py
under the same setting (both read the variable at call time).

``scanb`` runs the port's batch-minor kernels K3/K4, K5, K6 and JAX's
batch-minor scans; ``pallas`` runs the port's batch-major K11 and JAX's
crf_pallas.py kernels in interpret mode (as tests/test_ops.py:466 runs
them).  On the CPU every kernel wrapper takes its plain version.

- ``crf_transpost``, ``crf_viterbi`` and ``crf_decode_fused``, for the
  flip-flop and the run-length structure: posteriors and scores within
  1e-5, qpath within 1e-6 (1e-5 where it is read from the posterior),
  paths equal, trace bytes within one count (the rounding of
  255*occupancy); run-length ties resolve as JAX's;
- the flappie CLI under ``pallas`` (K11 for the head's partition and the
  whole decode) and under ``FLAPPIE_TPU_SCANB_FB=fused`` (K9 for the
  posterior) gives the default run's output, the score's last printed
  digit aside (test_torch_e2e.py's rule);
- an unknown setting raises (``seg`` and ``scan`` run: test_torch_crf_seg.py).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from flappie_tpu.ops import crf as j_crf
from flappie_tpu.ops import crf_pallas as j_crf_pal

from flappie_tpu_torch.cli.flappie import main as t_flappie_main
from flappie_tpu_torch.ops import crf as t_crf
from flappie_tpu_torch.signal.fast5 import write_single_read_fast5
from flappie_tpu_torch.signal.synthetic import synthetic_adc

from test_torch_e2e import CHUNK_ARGS, _assert_same_output, _run

IMPLS = ["scanb", "pallas"]
INDEX = {"flipflop": (j_crf.flipflop_index, t_crf.flipflop_index),
         "rle": (j_crf.rle_index, t_crf.rle_index)}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """As in test_torch_models.py: the CPU path's thousands of tiny scan
    and recurrence steps run far slower on torch's intra-op pool when the
    test runner's workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def impl(request, monkeypatch):
    """FLAPPIE_TPU_CRF_IMPL for both packages (each reads it at call
    time); the JAX Pallas kernels with a small time block, since
    interpret mode traces every step of a block."""
    monkeypatch.setenv("FLAPPIE_TPU_CRF_IMPL", request.param)
    monkeypatch.setattr(j_crf_pal, "TIME_BLOCK", 8)
    return request.param


def _trans(B, T, nparam, seed, dyadic=False):
    rng = np.random.default_rng(seed)
    trans = rng.normal(0, 2, size=(B, T, nparam)).astype(np.float32)
    if dyadic:
        trans = np.round(trans * 8.0) / 8.0
    trans[:, 5, 9] = trans[:, 5, 8]  # exact repeats to probe tie order
    nblocks = np.array([T, T - 12, 20, 1][:B], np.int32)
    return trans, nblocks


@pytest.mark.parametrize("impl", IMPLS, indirect=True)
@pytest.mark.parametrize("kind", ["flipflop", "rle"])
def test_crf_functions_match_jax(impl, kind):
    idx_j, idx_t = (f(4) for f in INDEX[kind])
    trans, nblocks = _trans(4, 45, idx_t.nparam, seed=21)
    j_args = (jnp.asarray(trans), jnp.asarray(nblocks), 4)
    t_args = (torch.from_numpy(trans), torch.from_numpy(nblocks), 4)
    want_tp = np.asarray(j_crf.crf_transpost(*j_args, idx=idx_j))
    got_tp = t_crf.crf_transpost(*t_args, idx=idx_t).numpy()
    np.testing.assert_allclose(got_tp, want_tp, rtol=1e-5, atol=1e-5)
    j_v = [np.asarray(v) for v in j_crf.crf_viterbi(*j_args, idx=idx_j)]
    t_v = [v.numpy() for v in t_crf.crf_viterbi(*t_args, idx=idx_t)]
    np.testing.assert_allclose(t_v[0], j_v[0], rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(t_v[1], j_v[1])  # paths
    np.testing.assert_allclose(t_v[2][:, 1:], j_v[2][:, 1:], rtol=1e-6, atol=1e-6)
    # the forward pass and the traceback on their own
    j_f = j_crf.crf_viterbi_forward(*j_args, idx=idx_j)
    t_f = t_crf.crf_viterbi_forward(*t_args, idx=idx_t)
    np.testing.assert_array_equal(t_f[1].numpy(), np.asarray(j_f[1]))  # last states
    np.testing.assert_array_equal(t_f[2].numpy(), np.asarray(j_f[2]))  # int8 backpointers
    path = t_crf.viterbi_traceback(t_f[2], t_f[1], t_args[1]).numpy()
    want = j_crf.viterbi_traceback(j_f[2], j_f[1], j_args[1])
    np.testing.assert_array_equal(path, np.asarray(want))


@pytest.mark.parametrize("impl", IMPLS, indirect=True)
@pytest.mark.parametrize("viterbi_only", [False, True])
def test_crf_decode_fused_matches_jax(impl, viterbi_only):
    trans, nblocks = _trans(3, 40, 40, seed=22)
    want = [np.asarray(v) for v in j_crf.crf_decode_fused(
        jnp.asarray(trans), jnp.asarray(nblocks), 4, viterbi_only, True)]
    got = [v.numpy() for v in t_crf.crf_decode_fused(
        torch.from_numpy(trans), torch.from_numpy(nblocks), 4, viterbi_only, True)]
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(got[1], want[1])
    # in fb mode qpath is read from the posterior, so it carries its band
    band = 1e-6 if viterbi_only else 1e-5
    np.testing.assert_allclose(got[2][:, 1:], want[2][:, 1:], rtol=band, atol=band)
    assert got[3].shape == want[3].shape
    assert np.abs(got[3].astype(int) - want[3].astype(int)).max() <= 1


@pytest.mark.parametrize("impl", IMPLS, indirect=True)
def test_viterbi_ties_resolve_as_jax_for_rle(impl):
    """All-equal weights: every path ties, so only tie_rank decides (the
    run-length order prefers the move into stay states)."""
    trans = np.zeros((2, 12, 32), np.float32)
    nblocks = np.array([12, 7], np.int32)
    idx_j, idx_t = j_crf.rle_index(4), t_crf.rle_index(4)
    want = np.asarray(j_crf.crf_viterbi(jnp.asarray(trans), jnp.asarray(nblocks), 4,
                                        idx=idx_j)[1])
    got = t_crf.crf_viterbi(torch.from_numpy(trans), torch.from_numpy(nblocks), 4,
                            idx=idx_t)[1].numpy()
    np.testing.assert_array_equal(got, want)


def test_rle_index_equal():
    a, b = j_crf.rle_index(4), t_crf.rle_index(4)
    for field in a._fields:
        np.testing.assert_array_equal(np.asarray(getattr(b, field)), np.asarray(getattr(a, field)))


@pytest.mark.parametrize("knob", [("FLAPPIE_TPU_CRF_IMPL", "pallas"),
                                  ("FLAPPIE_TPU_SCANB_FB", "fused")], ids=["pallas", "fused"])
def test_flappie_cli_same_bytes_under_each_knob(tmp_path, monkeypatch, knob):
    d = tmp_path / "reads"
    d.mkdir()
    rng = np.random.default_rng(33)
    for k, n in enumerate([2600, 4700]):
        write_single_read_fast5(str(d / f"f{k}.fast5"), synthetic_adc(n, rng), f"fread-{k}")
    args = [str(d), "--device", "cpu"] + CHUNK_ARGS
    default = _run(t_flappie_main, args, tmp_path / "default.fq")
    monkeypatch.setenv(*knob)
    _assert_same_output(_run(t_flappie_main, args, tmp_path / "knob.fq"), default)


@pytest.mark.parametrize("value", ["bogus"])
def test_unported_crf_impl_raises(monkeypatch, value):
    monkeypatch.setenv("FLAPPIE_TPU_CRF_IMPL", value)
    trans, nblocks = _trans(2, 10, 40, seed=1)
    with pytest.raises(ValueError, match="'seg' \\(segmented scans\\)"):
        t_crf.crf_forward(torch.from_numpy(trans), torch.from_numpy(nblocks), 4)
