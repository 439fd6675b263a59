"""Empirical quality-score calibration (counterpart of flappie_tpu/qcal.py).

The reference ships UNCALIBRATED qualities: "derived directly from the
probabilistic model ... not calibrated" (reference README.md:231-234).
Given basecalls with known truth, per-base correctness (from an
alignment of each call to its truth) gives the empirical error rate at
each predicted phred score, and a weighted linear fit
q_emp ~= a*q_pred + b, or a monotone (isotonic) table, yields a remap
that is applied post-hoc (flappie CLI and flappie-serve ``--qcal``)
without touching the model or the byte-parity default path.

A numpy copy of the JAX package's module, function for function and
message for message: both CLIs route its ValueErrors to the ``--qcal``
usage message, and ``apply_calibration`` rounds with ``np.rint`` in
float64, so the remapped quality bytes are the JAX package's.  The
artifact it reads is the JSON that tools/qscore_calibrate.py writes.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

PHRED_OFFSET = 33
MAX_QCHAR = 126  # reference phredf cap (src/util.h:285-313)


def phred_from_qstring(quality: str) -> np.ndarray:
    """Phred+33 chars -> integer phred scores."""
    return np.frombuffer(quality.encode(), dtype=np.uint8).astype(np.int32) - PHRED_OFFSET


@dataclass(frozen=True)
class CalibrationTable:
    """Per-predicted-phred empirical error statistics."""

    q: np.ndarray  # predicted phred values present in the data
    n: np.ndarray  # bases observed at each q
    n_err: np.ndarray  # of which wrong (mismatch or insertion)
    q_emp: np.ndarray  # empirical phred at each q (Jeffreys-smoothed)

    def as_dict(self) -> dict:
        return {
            "q": self.q.tolist(),
            "n": self.n.tolist(),
            "n_err": self.n_err.tolist(),
            "q_emp": [round(float(x), 3) for x in self.q_emp],
        }


def calibration_table(quals: np.ndarray, correct: np.ndarray) -> CalibrationTable:
    """Bin per-base correctness by predicted phred.

    ``quals``: int phred per called base; ``correct``: bool per called
    base (True = aligned to an identical truth base).  The empirical
    error rate per bin uses Jeffreys smoothing (n_err + 0.5)/(n + 1) so
    bins with zero observed errors stay finite.
    """
    quals = np.asarray(quals)
    correct = np.asarray(correct, dtype=bool)
    assert quals.shape == correct.shape
    qs = np.unique(quals)
    n = np.array([(quals == q).sum() for q in qs])
    n_err = np.array([((quals == q) & ~correct).sum() for q in qs])
    p_err = (n_err + 0.5) / (n + 1.0)
    q_emp = -10.0 * np.log10(p_err)
    return CalibrationTable(qs, n, n_err, q_emp)


def fit_calibration(table: CalibrationTable) -> tuple[float, float]:
    """Weighted least-squares line q_emp = a*q + b (weights = counts).

    Falls back to identity when the table is degenerate (fewer than two
    distinct predicted scores).
    """
    if table.q.size < 2:
        return 1.0, 0.0
    w = table.n.astype(np.float64)
    x = table.q.astype(np.float64)
    y = table.q_emp.astype(np.float64)
    W = w.sum()
    xm = (w * x).sum() / W
    ym = (w * y).sum() / W
    den = (w * (x - xm) ** 2).sum()
    if den == 0.0:
        return 1.0, 0.0
    a = (w * (x - xm) * (y - ym)).sum() / den
    return float(a), float(ym - a * xm)


def calibration_error(table: CalibrationTable, a: float = 1.0, b: float = 0.0) -> float:
    """Count-weighted mean |q_emp - (a*q_pred + b)| in phred units.

    With the default identity map this measures how mis-calibrated the
    raw model qualities are; after fitting it measures the residual.
    """
    w = table.n.astype(np.float64)
    pred = a * table.q.astype(np.float64) + b
    return float((w * np.abs(table.q_emp - pred)).sum() / w.sum())


def fit_isotonic(table: CalibrationTable, qmax: int = MAX_QCHAR - PHRED_OFFSET) -> np.ndarray:
    """Count-weighted isotonic (PAVA) fit of q_emp as a nondecreasing
    function of predicted phred, expanded to an int LUT over [0, qmax].

    A monotone remap cannot reorder base confidences (a linear fit can,
    on degenerate data), and the LUT is clamped so every emitted char
    stays inside the reference's phred char range (phredf caps at 126,
    src/util.h:285-313).  Predicted scores between observed bins are
    linearly interpolated; beyond the observed range the end values
    extend flat.
    """
    q = np.asarray(table.q, np.float64)
    y = np.asarray(table.q_emp, np.float64)
    w = np.asarray(table.n, np.float64)
    if q.size == 0:
        return np.arange(qmax + 1)
    # pool adjacent violators: stack of [value, weight, count]
    stack: list[list[float]] = []
    for yi, wi in zip(y, w):
        stack.append([float(yi), float(wi), 1.0])
        while len(stack) > 1 and stack[-2][0] > stack[-1][0]:
            y2, w2, c2 = stack.pop()
            y1, w1, c1 = stack.pop()
            stack.append([(y1 * w1 + y2 * w2) / (w1 + w2), w1 + w2, c1 + c2])
    fitted = np.concatenate(
        [np.full(int(c), v) for v, _w, c in stack]
    )
    lut = np.interp(np.arange(qmax + 1, dtype=np.float64), q, fitted)
    return np.clip(np.rint(lut), 0, qmax).astype(np.int32)


def apply_calibration_lut(quality: str, lut) -> str:
    """Remap a phred+33 quality string through an int LUT (fit_isotonic)."""
    lut = np.asarray(lut)
    q = np.clip(phred_from_qstring(quality), 0, lut.size - 1)
    q2 = np.clip(lut[q], 0, MAX_QCHAR - PHRED_OFFSET).astype(np.uint8)
    return (q2 + PHRED_OFFSET).tobytes().decode()


def apply_calibration(quality: str, a: float, b: float) -> str:
    """Remap a phred+33 quality string by q' = round(a*q + b).

    Clipped to [0, MAX_QCHAR - 33] -- the reference's own char cap
    (phredf caps the emitted char at 126, src/util.h:285-313).  The
    identity map (a=1, b=0) returns the input unchanged.
    """
    if a == 1.0 and b == 0.0:
        return quality
    q = phred_from_qstring(quality).astype(np.float64)
    q2 = np.clip(np.rint(a * q + b), 0, MAX_QCHAR - PHRED_OFFSET).astype(np.uint8)
    return (q2 + PHRED_OFFSET).tobytes().decode()


def apply_qcal(res, qcal):
    """Remap a BasecallResult's quality by a parsed --qcal calibration:
    either a (slope, offset) pair or an isotonic LUT (ndarray/list).

    Shared by the one-shot CLI and flappie-serve so the two surfaces
    cannot drift.  No-op (returns ``res`` itself) when ``qcal`` is None
    or the record has no quality string.
    """
    if qcal is None or getattr(res, "quality", None) is None:
        return res
    import dataclasses

    if isinstance(qcal, tuple):
        quality = apply_calibration(res.quality, *qcal)
    else:
        quality = apply_calibration_lut(res.quality, qcal)
    return dataclasses.replace(res, quality=quality)


def load_qcal_file(path: str, model: str):
    """Load a per-model calibration from a QCAL artifact (the JSON
    tools/qscore_calibrate.py writes: {"models": {name: {"lut": [...],
    "fit": {"slope": a, "offset": b}}}}).

    Prefers the isotonic LUT; falls back to the linear pair.  Raises
    ValueError when the file carries no entry for ``model``.
    """
    import json

    with open(path) as fh:
        doc = json.load(fh)
    models = doc.get("models", {})
    ent = models.get(model)
    if ent is None:
        raise ValueError(
            f"--qcal file {path!r} has no calibration for model "
            f"{model!r} (has: {sorted(models)})"
        )
    if "lut" in ent:
        return np.asarray(ent["lut"], np.int32)
    fit = ent.get("fit", {})
    if "slope" not in fit or "offset" not in fit:
        # ValueError, not KeyError: the CLIs route ValueError to the
        # clean --qcal usage message
        raise ValueError(
            f"--qcal file {path!r} entry for model {model!r} has "
            "neither a 'lut' nor a complete 'fit' (slope+offset)"
        )
    return float(fit["slope"]), float(fit["offset"])


def parse_qcal(arg: str, model: str | None = None):
    """CLI ``--qcal`` value: either ``a:b`` (slope:offset) or the path
    of a QCAL JSON artifact carrying per-model isotonic tables (then
    ``model`` selects the entry).

    Non-numeric or non-finite parts raise a ValueError that names the
    expected form (not a bare float() conversion message)."""
    import os

    if os.path.isfile(arg):
        return load_qcal_file(arg, model or "r941_native")
    parts = arg.split(":")
    if len(parts) != 2:
        raise ValueError(
            "--qcal should be of form slope:offset or a QCAL JSON file"
        )
    try:
        a, b = float(parts[0]), float(parts[1])
    except ValueError:
        raise ValueError(
            f"--qcal should be of form slope:offset (got {arg!r})"
        ) from None
    if not (np.isfinite(a) and np.isfinite(b)):
        raise ValueError(
            f"--qcal slope and offset must be finite (got {arg!r})"
        )
    return a, b
