"""PyTorch port on the CPU: flappie_tpu_torch.qcal against flappie_tpu.qcal.

Every function of the port's quality calibration is held equal to the
JAX package's on the same seeded inputs: the tables and fits value for
value, the remapped quality strings byte for byte, and every ValueError
word for word (both CLIs print it as the ``--qcal`` usage message).
The JAX package's own qcal tests read the reference checkout's fixtures; these
cases are made from seeded synthetic data.
"""

from __future__ import annotations

import json

import numpy as np
import pytest

from flappie_tpu import qcal as jq
from flappie_tpu.io.fastx import BasecallResult as JResult

from flappie_tpu_torch import qcal as pq
from flappie_tpu_torch.io.fastx import BasecallResult as PResult


def _qstring(rng, n: int, lo: int = 0, hi: int = 94) -> str:
    return (rng.integers(lo, hi, n) + 33).astype(np.uint8).tobytes().decode()


def _tables(seed: int):
    """(quals, correct) drawn from q_emp = 0.6 q + 3, and the table."""
    rng = np.random.default_rng(seed)
    quals = rng.integers(2, 40, 20_000)
    p_err = 10 ** (-(0.6 * quals + 3.0) / 10.0)
    correct = rng.random(quals.size) >= p_err
    return quals, correct


def _assert_table_equal(a, b):
    for field in ("q", "n", "n_err", "q_emp"):
        np.testing.assert_array_equal(getattr(a, field), getattr(b, field))
    assert a.as_dict() == b.as_dict()


def test_phred_from_qstring_matches_jax():
    rng = np.random.default_rng(0)
    for n in (0, 1, 17, 500):
        q = _qstring(rng, n)
        np.testing.assert_array_equal(pq.phred_from_qstring(q), jq.phred_from_qstring(q))
    assert (pq.PHRED_OFFSET, pq.MAX_QCHAR) == (jq.PHRED_OFFSET, jq.MAX_QCHAR)


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_table_fit_and_error_match_jax(seed):
    quals, correct = _tables(seed)
    tj, tp = jq.calibration_table(quals, correct), pq.calibration_table(quals, correct)
    _assert_table_equal(tp, tj)
    assert pq.fit_calibration(tp) == jq.fit_calibration(tj)
    a, b = jq.fit_calibration(tj)
    assert abs(a - 0.6) < 0.1  # the fit recovers the line the data came from
    for pair in ((1.0, 0.0), (a, b), (0.5, 7.25)):
        assert pq.calibration_error(tp, *pair) == jq.calibration_error(tj, *pair)


@pytest.mark.parametrize("quals,correct", [
    ([7, 7, 7], [True, True, False]),  # one distinct score: identity
    ([], []),
], ids=["one-score", "empty"])
def test_degenerate_tables_match_jax(quals, correct):
    quals = np.asarray(quals, np.int64)
    tj = jq.calibration_table(quals, np.asarray(correct, bool))
    tp = pq.calibration_table(quals, np.asarray(correct, bool))
    _assert_table_equal(tp, tj)
    assert pq.fit_calibration(tp) == jq.fit_calibration(tj) == (1.0, 0.0)


@pytest.mark.parametrize("case", ["pava-violators", "seeded", "empty", "short-lut"])
def test_fit_isotonic_and_lut_match_jax(case):
    rng = np.random.default_rng(11)
    kw = {}
    if case == "pava-violators":
        table = (np.array([10, 20, 30]), np.array([100, 10, 100]), np.array([0, 0, 0]),
                 np.array([12.0, 8.0, 25.0]))
    elif case == "empty":
        table = tuple(np.array([], dt) for dt in (np.int64, np.int64, np.int64, np.float64))
    else:
        t = jq.calibration_table(*_tables(5))
        q_emp = t.q_emp + rng.normal(0, 3.0, t.q_emp.size)  # violators to pool
        table = (t.q, t.n, t.n_err, q_emp)
        if case == "short-lut":
            kw["qmax"] = 30
    lj = jq.fit_isotonic(jq.CalibrationTable(*table), **kw)
    lp = pq.fit_isotonic(pq.CalibrationTable(*table), **kw)
    np.testing.assert_array_equal(lp, lj)
    assert lp.dtype == lj.dtype
    for n in (0, 40, 300):
        q = _qstring(rng, n)
        assert pq.apply_calibration_lut(q, lp) == jq.apply_calibration_lut(q, lj)


@pytest.mark.parametrize("a,b", [
    (1.0, 0.0), (1.1, -0.5), (0.5, 0.0), (2.0, 1.0), (3.0, -5.0), (-1.0, 40.0), (0.25, 0.125),
])
def test_apply_calibration_matches_jax(a, b):
    """np.rint in float64 (half to even: a = 0.5 lands on .5 ties) and the
    clip to [0, 93], byte for byte."""
    rng = np.random.default_rng(3)
    for n in (0, 1, 50, 1000):
        q = _qstring(rng, n)
        got = pq.apply_calibration(q, a, b)
        assert got == jq.apply_calibration(q, a, b)
        assert len(got) == n


def _results(quality):
    kw = dict(uuid="r1", score=-1.5, basecall="ACGT" if quality else "", quality=quality,
              nblock=9, nsample=50, trim_start=2, trim_end=48)
    return PResult(**kw), JResult(**kw)


@pytest.mark.parametrize("qcal", [None, (1.1, -0.5), "lut"], ids=["none", "pair", "lut"])
def test_apply_qcal_matches_jax(qcal):
    if qcal == "lut":
        qcal = jq.fit_isotonic(jq.calibration_table(*_tables(7)))
    rp, rj = _results("".join(chr(33 + v) for v in (0, 9, 20, 41)))
    gp, gj = pq.apply_qcal(rp, qcal), jq.apply_qcal(rj, qcal)
    assert gp.quality == gj.quality
    assert (gp is rp) == (qcal is None) == (gj is rj)
    assert rp.quality == rj.quality  # the input record is never changed
    rp, rj = _results(None)  # no quality string: returned as it is
    assert pq.apply_qcal(rp, (2.0, 1.0)) is rp and jq.apply_qcal(rj, (2.0, 1.0)) is rj


def _both_raise(fn_p, fn_j, *args):
    with pytest.raises(ValueError) as ep:
        fn_p(*args)
    with pytest.raises(ValueError) as ej:
        fn_j(*args)
    assert str(ep.value) == str(ej.value)
    return str(ep.value)


@pytest.fixture
def qcal_file(tmp_path):
    doc = {"models": {
        "r941_native": {"lut": list(range(5, 99)), "fit": {"slope": 0.5, "offset": 1.0}},
        "r941_5mC": {"fit": {"slope": 0.8, "offset": 2.5}},
        "r103_native": {"fit": {"slope": 0.8}},
    }}
    path = tmp_path / "qcal.json"
    path.write_text(json.dumps(doc))
    return str(path)


def test_load_qcal_file_matches_jax(qcal_file):
    for model in ("r941_native", "r941_5mC"):
        got, want = pq.load_qcal_file(qcal_file, model), jq.load_qcal_file(qcal_file, model)
        if isinstance(want, tuple):
            assert got == want == (0.8, 2.5)
        else:
            np.testing.assert_array_equal(got, want)
            assert got.dtype == want.dtype == np.int32
    assert "has no calibration for model" in _both_raise(
        pq.load_qcal_file, jq.load_qcal_file, qcal_file, "r941_rna002")
    assert "neither a 'lut' nor a complete 'fit'" in _both_raise(
        pq.load_qcal_file, jq.load_qcal_file, qcal_file, "r103_native")


@pytest.mark.parametrize("arg", ["1.5:-0.25", "0.9:0.5", "1:3", "-2:1e2"])
def test_parse_qcal_pairs_match_jax(arg):
    assert pq.parse_qcal(arg) == jq.parse_qcal(arg)


@pytest.mark.parametrize("arg", ["a:b", "1.0:x", "nan:0", "1:inf", "1.0", "1:2:3", ""])
def test_parse_qcal_rejects_garbage_with_jax_message(arg):
    assert "slope" in _both_raise(pq.parse_qcal, jq.parse_qcal, arg)


def test_parse_qcal_file_matches_jax(qcal_file):
    np.testing.assert_array_equal(pq.parse_qcal(qcal_file), jq.parse_qcal(qcal_file))
    assert pq.parse_qcal(qcal_file, "r941_5mC") == jq.parse_qcal(qcal_file, "r941_5mC")
    _both_raise(pq.parse_qcal, jq.parse_qcal, qcal_file, "r941_rna002")
