"""Log-normal read lengths, rounded and clipped.

Keys: ``count``, ``median_samples``, ``sigma``, ``min_samples``,
``max_samples``.
"""

from __future__ import annotations

import math

import numpy as np


def draw(p: dict, rng: np.random.Generator) -> np.ndarray:
    n = rng.lognormal(math.log(p["median_samples"]), p["sigma"], p["count"])
    return np.clip(np.round(n), p["min_samples"], p["max_samples"]).astype(np.int64)
