"""The port's accuracy.py (a numpy copy) against the JAX package's: the
same alignment counts and per-base status on the same seeded sequences,
empty ones included, and the same tie order in the traceback (repeats
and near-repeats, where several alignments score the same)."""

from __future__ import annotations

from dataclasses import asdict

import numpy as np
import pytest

from flappie_tpu import accuracy as j_acc

from flappie_tpu_torch import accuracy as t_acc


def _pairs():
    """(call, truth) pairs: empty on either side or both, identical,
    random of unequal lengths, mutated copies, repeats (ties), and
    integer arrays."""
    rng = np.random.default_rng(14)
    bases = np.array(list("ACGT"))

    def rand(n):
        return "".join(rng.choice(bases, n))

    def mutate(s, rate):
        out = []
        for ch in s:
            u = rng.random()
            if u < rate / 3:
                continue  # deletion
            if u < 2 * rate / 3:
                out.append(rng.choice(bases))  # substitution
            else:
                out.append(ch)
            if rng.random() < rate / 3:
                out.append(rng.choice(bases))  # insertion
        return "".join(out)

    pairs = [("", ""), ("", "ACGT"), ("ACG", ""), ("A", "A"), ("A", "C"), ("ACGT", "ACGT"),
             ("AAAA", "AA"), ("ACACAC", "CACA"), ("GATTACA", "GCATGCT")]
    for n in (5, 17, 60, 200):
        t = rand(n)
        pairs += [(mutate(t, 0.1), t), (mutate(t, 0.3), t), (rand(n + 7), t)]
    pairs.append((rng.integers(0, 4, 50), rng.integers(0, 4, 45)))
    return pairs


PAIRS = _pairs()


@pytest.mark.parametrize("k", range(len(PAIRS)))
def test_align_identity_matches_jax(k):
    call, truth = PAIRS[k]
    got, want = t_acc.align_identity(call, truth), j_acc.align_identity(call, truth)
    assert asdict(got) == asdict(want)
    assert got.identity == want.identity and got.error_rate == want.error_rate


@pytest.mark.parametrize("k", range(len(PAIRS)))
def test_align_call_status_matches_jax(k):
    call, truth = PAIRS[k]
    got, want = t_acc.align_call_status(call, truth), j_acc.align_call_status(call, truth)
    assert got.dtype == np.bool_ and got.shape == (len(call),)
    np.testing.assert_array_equal(got, want)


def test_dp_matrix_matches_jax():
    a = t_acc._encode("ACGTTGCAAC")
    b = t_acc._encode("ACTTGCCAC")
    np.testing.assert_array_equal(t_acc._dp_matrix(a, b), j_acc._dp_matrix(a, b))
