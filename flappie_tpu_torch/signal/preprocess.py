"""Host-side raw-signal preprocessing (float32-exact).

Re-implements the reference semantics with strict float32 arithmetic so
that outputs are bit-identical to the C code on the bundled goldens:

- quantile / median / MAD            (reference: src/util.c:100-196)
- med-MAD normalisation              (reference: src/util.c:198-213)
- shift/scale and delta (difference) (reference: src/util.c:215-297)
- variance-based trim + fixed trim   (reference: src/flappie_common.c:13-81)

These run on host (numpy): they are O(n log n) per read, trivially
data-parallel over reads, and feed fixed-shape batches to the device.

A copy of the JAX package's preprocess module, except that the chunk
MADs of the variance trim are computed in one vectorised pass
(chunk_mads_f32), bit-identical to its per-chunk loop.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Optional

import numpy as np

F32 = np.float32


@dataclass
class RawTable:
    """A raw read: signal plus the active [start, end) window.

    Mirrors the reference ``raw_table`` (src/flappie_structures.h:16-22)
    but owns a numpy array.

    ``adc``/``cal``/``norm`` support the halved-bytes device upload: when
    the read came from integral ADC counts (fast5), the original int16
    samples plus the (offset, raw_unit) calibration and the (med, mad)
    normalisation scalars let the device reconstruct the normalised f32
    signal on device from half the bytes (see basecall._unpack_i16).
    """

    uuid: Optional[str]
    n: int
    start: int
    end: int
    raw: Optional[np.ndarray]  # float32 [n]
    adc: Optional[np.ndarray] = None  # int16 [n] original ADC counts
    cal: Optional[tuple] = None  # (offset, raw_unit) float32
    norm: Optional[tuple] = None  # (med, mad) float32, set by normalise

    @property
    def valid(self) -> bool:
        return self.raw is not None and self.end > self.start

    def active(self) -> np.ndarray:
        return self.raw[self.start : self.end]


def quantile_f32(x: np.ndarray, p: float) -> np.float32:
    """Linear-interpolated quantile with float32 arithmetic.

    Matches reference quantilef (src/util.c:100-138): sort, then
    ``idx = truncate(p * (n-1))``, ``rem = p*(n-1) - idx`` computed in
    float32, result ``(1-rem)*x[idx] + rem*x[idx+1]``.
    """
    x = np.asarray(x, dtype=F32)
    n = x.size
    space = np.sort(x)
    pf = F32(p)
    prod = pf * F32(n - 1)
    idx = int(prod)  # C truncation of float->size_t
    rem = prod - F32(idx)
    if idx < n - 1:
        # C evaluates (1.0 - remf) in double then multiplies float operand,
        # storing into float p[i]; emulate with float64 intermediate.
        return F32(
            (np.float64(1.0) - np.float64(rem)) * np.float64(space[idx])
            + np.float64(rem) * np.float64(space[idx + 1])
        )
    return space[idx]


def median_f32(x: np.ndarray) -> np.float32:
    return quantile_f32(x, 0.5)


MAD_SCALE = F32(1.4826)


def mad_f32(x: np.ndarray, med: Optional[np.float32] = None) -> np.float32:
    """Median absolute deviation * 1.4826 (reference src/util.c:164-196)."""
    x = np.asarray(x, dtype=F32)
    if x.size == 1:
        return F32(0.0)
    if med is None:
        med = median_f32(x)
    absdiff = np.abs(x - med, dtype=F32)
    mad = median_f32(absdiff)
    return mad * MAD_SCALE  # float32 multiply, as in C


def chunk_mads_f32(x2d: np.ndarray) -> np.ndarray:
    """mad_f32 of every row of a [nchunk, n] float32 array (n >= 2), in
    one vectorised pass: the same sorts, the same float32 and float64
    steps as the per-row loop, hence bit-identical to it."""
    n = x2d.shape[1]
    prod = F32(0.5) * F32(n - 1)
    idx = int(prod)
    rem = np.float64(prod - F32(idx))

    def median_rows(a):
        srt = np.sort(a, axis=1)
        if idx >= n - 1:
            return srt[:, idx]
        return ((np.float64(1.0) - rem) * srt[:, idx].astype(np.float64)
                + rem * srt[:, idx + 1].astype(np.float64)).astype(F32)

    med = median_rows(x2d)
    return median_rows(np.abs(x2d - med[:, None], dtype=F32)) * MAD_SCALE


def medmad_normalise(x: np.ndarray):
    """(x - median) / mad, in-place semantics (src/util.c:198-213).

    Returns (x, med, mad); med/mad are None for the degenerate 1-sample
    case."""
    x = np.asarray(x, dtype=F32)
    if x.size == 1:
        x[0] = 0.0
        return x, None, None
    med = median_f32(x)
    mad = mad_f32(x, med)
    x -= med
    x /= mad
    return x, med, mad


def shift_scale(x: np.ndarray, shift: float, scale: float) -> np.ndarray:
    """x := (x - shift) / scale elementwise (src/util.c:215-224)."""
    x = np.asarray(x, dtype=F32)
    x -= F32(shift)
    x /= F32(scale)
    return x


def difference(x: np.ndarray) -> np.ndarray:
    """Sliding difference x[i] := x[i+1] - x[i]; last element zeroed.

    Reference: src/util.c:278-289.
    """
    x = np.asarray(x, dtype=F32)
    n = x.size
    if n:
        x[:-1] = x[1:] - x[:-1]
        x[n - 1] = 0.0
    return x


def trim_raw_by_mad(rt: RawTable, chunk_size: int, perc: float) -> RawTable:
    """Variance-based trim of leader/trailer (src/flappie_common.c:47-81).

    Chunked MAD over non-overlapping windows; the given quantile of the
    chunk MADs is the threshold; leading and trailing chunks at or below
    the threshold are trimmed.
    """
    if chunk_size < 2:
        raise ValueError(f"segmentation chunk must be at least 2, got {chunk_size}")
    nsample = rt.end - rt.start
    nchunk = nsample // chunk_size
    if nchunk == 0:
        # Shorter than one chunk: nothing to measure (the C code hits
        # undefined behaviour here; we propagate an invalid read).
        return RawTable(rt.uuid, rt.n, 0, 0, None)
    # Truncation of end to be consistent with Sloika (reference quirk).
    # The C writes `rt.end = nchunk * chunk_size` (flappie_common.c:54)
    # without adding rt.start - a latent bug that never fires there
    # because read_raw always yields start == 0.  For pre-windowed
    # reads the obvious generalisation (offset by the window start,
    # identical when start == 0) is used; the native path agrees.
    end = rt.start + nchunk * chunk_size
    start = rt.start

    # the per-chunk MADs in one vectorised pass (bit-identical to a loop
    # of mad_f32 over the chunks, which the JAX package's copy runs)
    win = rt.raw[rt.start : rt.start + nchunk * chunk_size]
    madarr = chunk_mads_f32(np.asarray(win, dtype=F32).reshape(nchunk, chunk_size))
    thresh = quantile_f32(madarr, perc)

    for i in range(nchunk):
        if madarr[i] > thresh:
            break
        start += chunk_size
    for i in range(nchunk, 0, -1):
        if madarr[i - 1] > thresh:
            break
        end -= chunk_size

    return replace(rt, start=start, end=end)


def trim_and_segment(
    rt: RawTable,
    trim_start: int = 200,
    trim_end: int = 10,
    varseg_chunk: int = 100,
    varseg_thresh: float = 0.0,
) -> RawTable:
    """MAD trim followed by fixed trims (src/flappie_common.c:13-28).

    Returns an invalid RawTable (raw=None) if nothing remains.
    """
    if rt.raw is None:
        return RawTable(rt.uuid, 0, 0, 0, None)
    rt = trim_raw_by_mad(rt, varseg_chunk, varseg_thresh)
    if rt.raw is None:
        return rt

    start = rt.start + trim_start if (rt.n - rt.start) > trim_start else rt.n
    end = rt.end - trim_end if rt.end > trim_end else 0

    if start >= end:
        return RawTable(rt.uuid, rt.n, 0, 0, None)
    return replace(rt, start=start, end=end)


def normalise_signal(rt: RawTable, delta: float = 0.0) -> RawTable:
    """Default med-MAD normalisation, or delta (difference) mode.

    Mirrors the per-read normalisation in the reference drivers
    (src/flappie.c:254-259): normalisation applies to the active
    [start, end) window in place.
    """
    seg = rt.raw[rt.start : rt.end]
    if delta == 0.0:
        _, med, mad = medmad_normalise(seg)
        # mad == 0 divides to inf/nan on host; keep the f32 upload there
        rt.norm = (med, mad) if med is not None and mad != 0.0 else None
    else:
        difference(seg)
        shift_scale(seg, 0.0, delta)
        rt.norm = None  # delta mode: device upload falls back to f32
    return rt
