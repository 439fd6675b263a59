"""Seeded synthetic nanopore-like ADC signal.

The repository has no real reads (the reference's fast5 files are
git-LFS pointers), so tests and the GPU smoke run write squiggles made
here into fast5 files with ``fast5.write_single_read_fast5``: piecewise
constant event levels with geometric dwell times, plus Gaussian noise,
in int16 ADC counts around a typical open-pore-free baseline.
"""

from __future__ import annotations

import numpy as np


def synthetic_adc(n: int, rng: np.random.Generator, mean_dwell: float = 9.0) -> np.ndarray:
    """[n] int16 ADC counts."""
    nevent = int(n / mean_dwell) + 16
    dwell = rng.geometric(1.0 / mean_dwell, size=nevent)
    level = 500.0 + 60.0 * rng.standard_normal(nevent)
    sig = np.repeat(level, dwell)[:n]
    if sig.size < n:
        sig = np.concatenate([sig, np.full(n - sig.size, level[-1])])
    sig = sig + 12.0 * rng.standard_normal(n)
    return np.clip(np.round(sig), -32768, 32767).astype(np.int16)
