"""PyTorch port on the CPU: the ``seg`` and ``scan`` CRF impls
(FLAPPIE_TPU_CRF_IMPL=seg / =scan, ops/crf_seg.py and the sequential
plain formulation in ops/crf.py) against the JAX package under the same
setting, and against each other as tests/test_crf_seg.py holds JAX's.

- ``seg`` against JAX's ``seg`` (both group time in SEG_L = 128 steps
  and associate the products in the same order): alphas, betas and logZ
  within 1e-6 relative (measured: 2e-7), transition posteriors within
  2e-4 absolute on states of a few thousand (measured: 1.2e-4), Viterbi
  scores bit-equal, paths, backpointers and tracebacks equal;
- ``seg`` against the port's ``scan``: the sums within JAX's own band
  (rtol 2e-5, atol 2e-3), the frozen tail constant, Viterbi exact on
  dyadic inputs (every max-plus sum exact) for the flip-flop over 4 and
  5 bases and the run-length structure, the traceback exact for any
  backpointers;
- ``scan`` against JAX's ``scan`` and the port's ``scanb``: max-plus
  bit-equal, the scans' sums within 5e-6 relative, the posteriors (a
  difference of states of a few thousand) within 2e-4 absolute;
- the V1 run-length decode (S = 4) under both impls against JAX's;
- the flappie CLI under ``seg`` and ``scan`` and runnie under ``seg``
  against the JAX CLIs under the same knob: bytes equal but the score's
  last printed digit (runnie: the .run rule of test_torch_runnie.py).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from flappie_tpu.cli.flappie import main as j_flappie_main
from flappie_tpu.cli.runnie import main as j_runnie_main
from flappie_tpu.decode import runlength as j_rl
from flappie_tpu.ops import crf as j_crf

from flappie_tpu_torch.cli.flappie import main as t_flappie_main
from flappie_tpu_torch.cli.runnie import main as t_runnie_main
from flappie_tpu_torch.decode import runlength as t_rl
from flappie_tpu_torch.ops import crf as t_crf
from flappie_tpu_torch.ops import crf_seg
from flappie_tpu_torch.signal.fast5 import write_single_read_fast5
from flappie_tpu_torch.signal.synthetic import synthetic_adc

from test_torch_e2e import CHUNK_ARGS, _assert_same_output, _run
from test_torch_runnie import _assert_same_runs


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """As in test_torch_models.py: the CPU path's thousands of tiny scan
    steps run far slower on torch's intra-op pool when the test runner's
    workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


LENGTH_SETS = [
    (3, 300, [300, 257, 123]),  # T not a multiple of SEG_L
    (2, 256, [256, 200]),  # T == 2 * SEG_L
    (2, 50, [50, 17]),  # T < SEG_L
]
STRUCTS = {"ff4": ("flipflop_index", 4), "ff5": ("flipflop_index", 5), "rle4": ("rle_index", 4)}


def _indices(struct):
    name, nbase = STRUCTS[struct]
    return getattr(j_crf, name)(nbase), getattr(t_crf, name)(nbase), nbase


def _trans(B, T, nparam, seed, dyadic=False):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-4, 4, size=(B, T, nparam)).astype(np.float32)
    if dyadic:
        x = np.round(x * 8.0) / 8.0
    return x


def _both(monkeypatch, impl, j_fn, t_fn, trans, nblocks, nbase, **kw):
    """(JAX's result, the port's) of the same function under ``impl``."""
    monkeypatch.setenv("FLAPPIE_TPU_CRF_IMPL", impl)
    want = j_fn(jnp.asarray(trans), jnp.asarray(nblocks), nbase, idx=kw["j_idx"])
    got = t_fn(torch.from_numpy(trans), torch.from_numpy(nblocks), nbase, idx=kw["t_idx"])
    return want, got


def _port(monkeypatch, impl, fn, *args, **kw):
    monkeypatch.setenv("FLAPPIE_TPU_CRF_IMPL", impl)
    return fn(*args, **kw)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want) / np.maximum(np.abs(want), 1.0)))


@pytest.mark.parametrize("struct", list(STRUCTS))
@pytest.mark.parametrize("B,T,nblocks", LENGTH_SETS)
def test_seg_matches_jax_seg(monkeypatch, struct, B, T, nblocks):
    j_idx, t_idx, nbase = _indices(struct)
    trans = _trans(B, T, t_idx.nparam, seed=B * T + nbase)
    nb = np.array(nblocks, np.int32)
    kw = dict(j_idx=j_idx, t_idx=t_idx)
    (a_j, z_j), (a_t, z_t) = _both(monkeypatch, "seg", j_crf.crf_forward, t_crf.crf_forward,
                                   trans, nb, nbase, **kw)
    assert _rel(a_t.numpy(), a_j) < 1e-6 and _rel(z_t.numpy(), z_j) < 1e-6
    b_j, b_t = _both(monkeypatch, "seg", j_crf.crf_backward, t_crf.crf_backward, trans, nb,
                     nbase, **kw)
    assert _rel(b_t.numpy(), b_j) < 1e-6
    p_j, p_t = _both(monkeypatch, "seg", j_crf.crf_transpost, t_crf.crf_transpost, trans, nb,
                     nbase, **kw)
    for b in range(B):
        n = nblocks[b]
        np.testing.assert_allclose(p_t.numpy()[b, :n], np.asarray(p_j)[b, :n], rtol=0, atol=2e-4)
    f_j, f_t = _both(monkeypatch, "seg", j_crf.crf_viterbi_forward, t_crf.crf_viterbi_forward,
                     trans, nb, nbase, **kw)
    np.testing.assert_array_equal(f_t[0].numpy(), np.asarray(f_j[0]))  # scores
    np.testing.assert_array_equal(f_t[1].numpy(), np.asarray(f_j[1]))  # last states
    np.testing.assert_array_equal(f_t[2].numpy(), np.asarray(f_j[2]))  # int8 backpointers
    path_t = _port(monkeypatch, "seg", t_crf.viterbi_traceback, f_t[2], f_t[1],
                   torch.from_numpy(nb))
    path_j = j_crf.viterbi_traceback(f_j[2], f_j[1], jnp.asarray(nb))
    np.testing.assert_array_equal(path_t.numpy(), np.asarray(path_j))
    v_j, v_t = _both(monkeypatch, "seg", j_crf.crf_viterbi, t_crf.crf_viterbi, trans, nb, nbase,
                     **kw)
    np.testing.assert_array_equal(v_t[0].numpy(), np.asarray(v_j[0]))
    np.testing.assert_array_equal(v_t[1].numpy(), np.asarray(v_j[1]))


@pytest.mark.parametrize("B,T,nblocks", LENGTH_SETS)
def test_seg_forward_backward_transpost_match_scan(monkeypatch, B, T, nblocks):
    idx = t_crf.flipflop_index(4)
    trans = torch.from_numpy(_trans(B, T, idx.nparam, seed=B * T))
    nb = torch.tensor(nblocks, dtype=torch.int32)
    a_scan, z_scan = _port(monkeypatch, "scan", t_crf.crf_forward, trans, nb, 4)
    a_seg, z_seg = _port(monkeypatch, "seg", t_crf.crf_forward, trans, nb, 4)
    np.testing.assert_allclose(z_seg.numpy(), z_scan.numpy(), rtol=2e-6, atol=1e-4)
    np.testing.assert_allclose(a_seg.numpy(), a_scan.numpy(), rtol=2e-5, atol=2e-3)
    b_scan = _port(monkeypatch, "scan", t_crf.crf_backward, trans, nb, 4)
    b_seg = _port(monkeypatch, "seg", t_crf.crf_backward, trans, nb, 4)
    np.testing.assert_allclose(b_seg.numpy(), b_scan.numpy(), rtol=2e-5, atol=2e-3)
    a = a_seg.numpy()
    for b in range(B):  # the frozen tail: alphas past each read's end stay put
        n = nblocks[b]
        np.testing.assert_array_equal(a[b, n:], np.broadcast_to(a[b, n], a[b, n:].shape))
    p_scan = _port(monkeypatch, "scan", t_crf.crf_transpost, trans, nb, 4)
    p_seg = _port(monkeypatch, "seg", t_crf.crf_transpost, trans, nb, 4)
    for b in range(B):
        n = nblocks[b]
        np.testing.assert_allclose(p_seg.numpy()[b, :n], p_scan.numpy()[b, :n],
                                   rtol=2e-5, atol=2e-3)


@pytest.mark.parametrize("struct", list(STRUCTS))
@pytest.mark.parametrize("B,T,nblocks", LENGTH_SETS)
def test_seg_viterbi_exact_on_dyadic(monkeypatch, struct, B, T, nblocks):
    """Dyadic weights make every max-plus sum exact whatever the
    association, so scores, paths and the tie order (dyadic grids tie
    often) must be the sequential scan's bit for bit."""
    _, idx, nbase = _indices(struct)
    trans = torch.from_numpy(_trans(B, T, idx.nparam, seed=T + nbase, dyadic=True))
    nb = torch.tensor(nblocks, dtype=torch.int32)
    s_scan, p_scan, q_scan = _port(monkeypatch, "scan", t_crf.crf_viterbi, trans, nb, nbase,
                                   idx=idx)
    s_seg, p_seg, q_seg = _port(monkeypatch, "seg", t_crf.crf_viterbi, trans, nb, nbase, idx=idx)
    np.testing.assert_array_equal(s_seg.numpy(), s_scan.numpy())
    for b in range(B):
        n = nblocks[b]
        np.testing.assert_array_equal(p_seg.numpy()[b, : n + 1], p_scan.numpy()[b, : n + 1])
        np.testing.assert_array_equal(q_seg.numpy()[b, 1 : n + 1], q_scan.numpy()[b, 1 : n + 1])


def test_seg_traceback_exact_any_backptr(monkeypatch):
    """The composition traceback is integer gathers: exact against the
    sequential walk for any backpointers (the identity at invalid steps,
    the producers' contract), over several groups and a partial one."""
    rng = np.random.default_rng(3)
    B, T, S = 4, 415, 8
    backptr = rng.integers(0, S, size=(B, T, S)).astype(np.int8)
    nblocks = np.array([415, 301, 128, 1], np.int32)
    for b in range(B):
        backptr[b, nblocks[b]:] = np.arange(S, dtype=np.int8)
    last = torch.tensor([3, 7, 0, 5], dtype=torch.int32)
    args = (torch.from_numpy(backptr), last, torch.from_numpy(nblocks))
    p_scan = _port(monkeypatch, "scan", t_crf.viterbi_traceback, *args)
    p_seg = _port(monkeypatch, "seg", t_crf.viterbi_traceback, *args)
    np.testing.assert_array_equal(p_seg.numpy(), p_scan.numpy())
    assert crf_seg.SEG_L < T


@pytest.mark.parametrize("struct", list(STRUCTS))
def test_scan_matches_jax_scan_and_scanb(monkeypatch, struct):
    j_idx, t_idx, nbase = _indices(struct)
    B, T, nblocks = LENGTH_SETS[0]
    trans = _trans(B, T, t_idx.nparam, seed=41 + nbase)
    nb = np.array(nblocks, np.int32)
    kw = dict(j_idx=j_idx, t_idx=t_idx)
    t_args = (torch.from_numpy(trans), torch.from_numpy(nb), nbase)
    for fn in ("crf_forward", "crf_backward", "crf_transpost", "crf_viterbi"):
        want, got = _both(monkeypatch, "scan", getattr(j_crf, fn), getattr(t_crf, fn), trans, nb,
                          nbase, **kw)
        other = _port(monkeypatch, "scanb", getattr(t_crf, fn), *t_args, idx=t_idx)
        if fn == "crf_forward":
            want, got, other = want[0], got[0], other[0]
        if fn == "crf_viterbi":
            for k in range(3):  # score, path, qpath: max-plus, bit-equal
                sl = (slice(None), slice(1, None)) if k == 2 else slice(None)
                np.testing.assert_array_equal(got[k].numpy()[sl], np.asarray(want[k])[sl])
                np.testing.assert_array_equal(got[k].numpy()[sl], other[k].numpy()[sl])
            continue
        if fn == "crf_transpost":
            for b in range(B):  # past a read's end the posterior is normalised garbage
                n = nblocks[b]
                for ref in (np.asarray(want)[b, :n], other.numpy()[b, :n]):
                    np.testing.assert_allclose(got.numpy()[b, :n], ref, rtol=0, atol=2e-4)
            continue
        assert _rel(got.numpy(), want) < 5e-6 and _rel(got.numpy(), other.numpy()) < 5e-6
    f_j, f_t = _both(monkeypatch, "scan", j_crf.crf_viterbi_forward, t_crf.crf_viterbi_forward,
                     trans, nb, nbase, **kw)
    for k in range(3):
        np.testing.assert_array_equal(f_t[k].numpy(), np.asarray(f_j[k]))


@pytest.mark.parametrize("impl", ["seg", "scan"])
def test_rle_v1_decode_matches_jax(monkeypatch, impl):
    """The V1 run-length chain (S = 4) through rle_v1_viterbi and
    rle_v1_posterior under each impl in both packages."""
    rng = np.random.default_rng(7)
    B, T = 3, 140
    params = rng.normal(0, 2, size=(B, T, 16)).astype(np.float32)
    params[:, 5, 8:] = 0.0  # exact ties
    params[:, 6, :] = params[:, 5, :]
    nblocks = np.array([T, 97, 1], np.int32)
    monkeypatch.setenv("FLAPPIE_TPU_CRF_IMPL", impl)
    score_j, path_j = (np.asarray(a) for a in j_rl.rle_v1_viterbi(
        jnp.asarray(params), jnp.asarray(nblocks), 4))
    score_t, path_t = t_rl.rle_v1_viterbi(torch.from_numpy(params), torch.from_numpy(nblocks), 4)
    np.testing.assert_array_equal(path_t.numpy(), path_j)
    np.testing.assert_allclose(score_t.numpy(), score_j, rtol=0, atol=1e-5)
    want = np.asarray(j_rl.rle_v1_posterior(jnp.asarray(params), jnp.asarray(nblocks), 4))
    got = t_rl.rle_v1_posterior(torch.from_numpy(params), torch.from_numpy(nblocks), 4).numpy()
    for b in range(B):
        n = nblocks[b]
        np.testing.assert_allclose(got[b, :n], want[b, :n], rtol=1e-5, atol=1e-4)


@pytest.fixture(scope="module")
def reads(tmp_path_factory):
    """Two reads over --chunk 4000 (chunked) and two short (a bucket)."""
    d = tmp_path_factory.mktemp("seg_reads")
    rng = np.random.default_rng(44)
    for k, n in enumerate([5600, 4400, 3100, 2300]):
        write_single_read_fast5(str(d / f"s{k}.fast5"), synthetic_adc(n, rng), f"sread-{k}")
    return d


@pytest.mark.parametrize("impl,mode", [("seg", "fb"), ("seg", "viterbi"), ("scan", "fb")])
def test_flappie_cli_matches_jax_cli_under_impl(reads, tmp_path, monkeypatch, impl, mode):
    monkeypatch.setenv("FLAPPIE_TPU_CRF_IMPL", impl)
    args = [str(reads)] + CHUNK_ARGS + (["--viterbi"] if mode == "viterbi" else [])
    theirs = _run(j_flappie_main, args, tmp_path / "jax.fq")
    ours = _run(t_flappie_main, args + ["--device", "cpu"], tmp_path / "port.fq")
    assert all(f"sread-{k}" in ours for k in range(4))
    _assert_same_output(ours, theirs)


def test_runnie_cli_matches_jax_cli_under_seg(tmp_path, monkeypatch):
    d = tmp_path / "reads"
    d.mkdir()
    rng = np.random.default_rng(45)
    for k, n in enumerate([2600, 1900]):
        write_single_read_fast5(str(d / f"q{k}.fast5"), synthetic_adc(n, rng), f"rseg-{k}")
    monkeypatch.setenv("FLAPPIE_TPU_CRF_IMPL", "seg")
    theirs = _run(j_runnie_main, [str(d)], tmp_path / "jax.run")
    ours = _run(t_runnie_main, [str(d), "--device", "cpu"], tmp_path / "port.run")
    assert ours.count("# rseg-") == 2
    _assert_same_runs(ours, theirs)
