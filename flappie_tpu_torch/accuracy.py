"""Basecall accuracy: alignment identity against a truth sequence.

A numpy copy of flappie_tpu/accuracy.py (the port imports nothing of the
JAX package): the same scores, the same tie order in the traceback, so
the two give the same counts on the same sequences.  The port uses it to
measure ``--fast``'s accuracy band against the exact stream.

``align_identity`` is a full Needleman-Wunsch global alignment with
linear gap penalties, vectorised row-by-row in numpy: the left-gap
recurrence H[i,j] = max(tmp[j], H[i,j-1] + gap) resolves in closed form
as a running maximum of tmp[k] + k (linear gaps make the candidate
score tmp[k] - gap*(j-k) separable), so each row is O(m) vector work.
Identity is BLAST-style: matches / alignment columns.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

MATCH = 2
MISMATCH = -3
GAP = -4  # linear


@dataclass(frozen=True)
class Alignment:
    matches: int
    mismatches: int
    insertions: int  # bases in the call absent from the truth
    deletions: int  # truth bases absent from the call
    columns: int

    @property
    def identity(self) -> float:
        return self.matches / self.columns if self.columns else 0.0

    @property
    def error_rate(self) -> float:
        return 1.0 - self.identity


def _encode(seq) -> np.ndarray:
    if isinstance(seq, str):
        seq = seq.encode()
    if isinstance(seq, (bytes, bytearray)):
        return np.frombuffer(bytes(seq), dtype=np.uint8)
    return np.asarray(seq, dtype=np.uint8)


def _dp_matrix(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    n, m = a.size, b.size
    H = np.empty((n + 1, m + 1), dtype=np.int32)
    H[0] = GAP * np.arange(m + 1, dtype=np.int32)
    H[:, 0] = GAP * np.arange(n + 1, dtype=np.int32)
    jj = np.arange(1, m + 1, dtype=np.int32)
    for i in range(1, n + 1):
        sub = np.where(b == a[i - 1], MATCH, MISMATCH).astype(np.int32)
        tmp = np.maximum(H[i - 1, :-1] + sub, H[i - 1, 1:] + GAP)
        # H[i, j] = max over k<=j of (cand[k] - GAP*(k - j)); with cand
        # carrying the resolved H[i, 0] at k=0 this IS the left-gap DP
        cand = np.concatenate(([H[i, 0]], tmp)) - GAP * np.arange(
            m + 1, dtype=np.int32
        )
        H[i, 1:] = (np.maximum.accumulate(cand) + GAP * np.arange(m + 1))[1:]
    return H


def align_identity(call, truth) -> Alignment:
    """Global alignment of ``call`` (rows) vs ``truth`` (cols).

    Accepts str/bytes (e.g. "ACGT...") or integer arrays; symbols
    compare by equality.  Returns per-column counts; empty inputs align
    as pure gaps.
    """
    a, b = _encode(call), _encode(truth)
    n, m = a.size, b.size
    if n == 0 or m == 0:
        return Alignment(0, 0, n, m, n + m)

    H = _dp_matrix(a, b)

    # traceback
    i, j = n, m
    matches = mismatches = ins = dels = 0
    while i > 0 and j > 0:
        s = MATCH if a[i - 1] == b[j - 1] else MISMATCH
        if H[i, j] == H[i - 1, j - 1] + s:
            matches += s == MATCH
            mismatches += s != MATCH
            i -= 1
            j -= 1
        elif H[i, j] == H[i - 1, j] + GAP:
            ins += 1
            i -= 1
        else:
            dels += 1
            j -= 1
    ins += i
    dels += j
    return Alignment(matches, mismatches, ins, dels,
                     matches + mismatches + ins + dels)


def align_call_status(call, truth) -> np.ndarray:
    """Per-called-base correctness under the same global alignment.

    Returns a bool array of ``len(call)``: True where the called base
    aligns to an identical truth base, False where it aligns to a
    different base or to a gap (an insertion).  Deletions have no
    called base and so do not appear; they still lower identity via
    ``align_identity``.  This is the per-base signal quality-score
    calibration needs (qcal.py).
    """
    a, b = _encode(call), _encode(truth)
    n, m = a.size, b.size
    status = np.zeros(n, dtype=bool)
    if n == 0 or m == 0:
        return status
    H = _dp_matrix(a, b)
    i, j = n, m
    while i > 0 and j > 0:
        s = MATCH if a[i - 1] == b[j - 1] else MISMATCH
        if H[i, j] == H[i - 1, j - 1] + s:
            status[i - 1] = s == MATCH
            i -= 1
            j -= 1
        elif H[i, j] == H[i - 1, j] + GAP:
            i -= 1  # insertion: stays False
        else:
            j -= 1  # deletion: no called base
    return status
