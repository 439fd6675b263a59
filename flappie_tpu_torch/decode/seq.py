"""Path -> sequence/quality conversion (host side, numpy).

Reference semantics:
- base_lookup = "ACGTZ" (src/decode.h:16-19)
- change_positions called with npos = nblock although the Viterbi path
  has nblock+1 entries, so the final entry never yields a base and
  position 0 only contributes via path[path_idx[0]]
  (src/flappie.c:284-297, src/decode.c:66-79) - replicated exactly.
- quality = phredf(expf(qpath[idx])): Phred+33 from the transition
  (posterior in fb mode, raw weight in viterbi mode), probability
  clipped at 0.99999, char capped at 126 (src/util.h:285-313).
"""

from __future__ import annotations

import numpy as np

BASE_LOOKUP = "ACGTZ"
M_LOG10E = 0.43429448190325182765  # glibc math.h

F32 = np.float32


def qscore_f32(p: np.ndarray) -> np.ndarray:
    """qscoref (src/util.h:286-291) vectorised, float32-faithful."""
    p = np.asarray(p, dtype=F32)
    p_clip = np.where(p < 0.99999, p, F32(0.99999))
    # C: -(10.0f * M_LOG10E) * log1pf(-p_clip) - the multiply happens in
    # double (M_LOG10E is double), log1pf in float.
    l1p = np.log1p(-p_clip, dtype=F32)
    return (-(10.0 * M_LOG10E) * l1p.astype(np.float64)).astype(F32)


def phred_chars(p: np.ndarray) -> np.ndarray:
    """phredf (src/util.h:299-304): round(33+q) capped at 126."""
    q = qscore_f32(p)
    ph = np.floor(F32(33.0) + q + F32(0.5)).astype(np.int32)  # roundf, q >= 0
    ph = np.minimum(ph, 126)
    return ph.astype(np.uint8)


def change_positions(path: np.ndarray, npos: int) -> np.ndarray:
    """Indices pos in [1, npos) where path[pos] != path[pos-1]."""
    path = np.asarray(path)[:npos]
    return np.nonzero(path[1:] != path[:-1])[0] + 1


def path_to_basecall(
    path: np.ndarray, qpath: np.ndarray, nblock: int, nbase: int
) -> tuple[str, str]:
    """Viterbi path + per-block weights -> (sequence, quality string).

    Mirrors src/flappie.c:283-297.  ``qpath`` may be the per-block
    transition log-weights (float) or precomputed Phred+33 bytes
    (uint8, from ops.crf.phred_from_qpath on device - bit-compatible
    with the float path here, which keeps the transfer small).
    """
    idx = change_positions(path, nblock)
    if idx.size == 0:
        return "", ""
    states = np.asarray(path)[idx].astype(np.int64) % nbase
    basecall = "".join(BASE_LOOKUP[s] for s in states)
    qpath = np.asarray(qpath)
    if qpath.dtype == np.uint8:
        qchars = qpath[idx]
    else:
        p = np.exp(qpath.astype(F32)[idx], dtype=F32)
        qchars = phred_chars(p)
    quality = qchars.tobytes().decode("ascii")
    return basecall, quality
