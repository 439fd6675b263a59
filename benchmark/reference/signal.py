"""Host arithmetic of the plain reference: trimming, normalisation, the
chunk plan and the conversion of a decoded path into bases and Phred
characters.

Frozen copies (numpy, float32-exact), each from the file named above it,
so that the reference works everything out again from the ADC counts and
imports nothing of the program.  They follow the original flappie C code
(nanoporetech/flappie src/util.c, src/flappie_common.c, src/decode.c,
src/util.h), as the copied functions do.
"""

from __future__ import annotations

from typing import List, NamedTuple, Tuple

import numpy as np

F32 = np.float32
MAD_SCALE = F32(1.4826)
BASE_LOOKUP = "ACGTZ"
M_LOG10E = 0.43429448190325182765  # glibc math.h


# -- flappie_tpu_torch/signal/fast5.py _scale_signal (src/fast5_interface.c:297-303)

def scale_to_pA(adc: np.ndarray, offset: float, range_: float, digitisation: float) -> np.ndarray:
    """(adc + offset) * (range / digitisation), every step in float32."""
    raw_unit = F32(range_) / F32(digitisation)
    return (adc.astype(F32) + F32(offset)) * raw_unit


# -- flappie_tpu_torch/signal/preprocess.py (src/util.c:100-213, src/flappie_common.c:13-81)

def quantile_f32(x: np.ndarray, p: float) -> np.float32:
    x = np.asarray(x, dtype=F32)
    n = x.size
    space = np.sort(x)
    prod = F32(p) * F32(n - 1)
    idx = int(prod)
    rem = prod - F32(idx)
    if idx < n - 1:
        return F32((np.float64(1.0) - np.float64(rem)) * np.float64(space[idx])
                   + np.float64(rem) * np.float64(space[idx + 1]))
    return space[idx]


def mad_f32(x: np.ndarray, med) -> np.float32:
    x = np.asarray(x, dtype=F32)
    if x.size == 1:
        return F32(0.0)
    return quantile_f32(np.abs(x - med, dtype=F32), 0.5) * MAD_SCALE


def chunk_mads_f32(x2d: np.ndarray) -> np.ndarray:
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


def trim(raw: np.ndarray, trim_start: int, trim_end: int, varseg_chunk: int,
         varseg_thresh: float):
    """(start, end) of the active window, or None where nothing remains:
    the variance trim over chunks of ``varseg_chunk`` samples, then the
    fixed trims."""
    n = raw.size
    nchunk = n // varseg_chunk
    if nchunk == 0:
        return None
    start, end = 0, nchunk * varseg_chunk
    mads = chunk_mads_f32(np.asarray(raw[:end], F32).reshape(nchunk, varseg_chunk))
    thresh = quantile_f32(mads, varseg_thresh)
    for i in range(nchunk):
        if mads[i] > thresh:
            break
        start += varseg_chunk
    for i in range(nchunk, 0, -1):
        if mads[i - 1] > thresh:
            break
        end -= varseg_chunk
    start = start + trim_start if n - start > trim_start else n
    end = end - trim_end if end > trim_end else 0
    return (start, end) if start < end else None


def normalise(seg: np.ndarray) -> np.ndarray:
    """(x - median) / mad in float32 (a copy)."""
    x = np.array(seg, dtype=F32)
    if x.size == 1:
        x[0] = 0.0
        return x
    med = quantile_f32(x, 0.5)
    mad = mad_f32(x, med)
    x -= med
    x /= mad
    return x


# -- flappie_tpu_torch/parallel/chunking.py plan_chunks, chunk_records

class Chunk(NamedTuple):
    start: int  # first sample
    length: int  # valid samples
    g0: int  # global block of local block 0
    keep_lo: int  # global blocks [keep_lo, keep_hi) are this chunk's
    keep_hi: int
    qlo: int  # local score range [qlo, qhi)
    qhi: int
    last: bool


def plan_chunks(nsample: int, stride: int, chunk: int, overlap: int) -> Tuple[int, List[Chunk]]:
    """(total blocks, chunks) of one read: chunks of ``chunk`` samples
    every ``chunk - overlap``, cut at the overlaps' midpoints."""
    chunk -= chunk % stride
    step = chunk - overlap
    step -= step % stride
    if step <= 0:
        raise ValueError(f"overlap {overlap} must be smaller than chunk {chunk}")
    if nsample <= chunk:
        starts = [0]
    else:
        starts = list(range(0, nsample - overlap, step))
        if len(starts) > 1 and starts[-1] + overlap >= nsample:
            starts = starts[:-1]
    total = -(-nsample // stride)
    cuts = [0]
    for i in range(1, len(starts)):
        mid = starts[i] + (starts[i - 1] + chunk - starts[i]) // 2
        cuts.append(min(mid // stride, total))
    cuts.append(total)
    out = []
    for i, s in enumerate(starts):
        g0 = s // stride
        last = i == len(starts) - 1
        lo, hi = cuts[i], cuts[i + 1]
        out.append(Chunk(s, min(chunk, nsample - s), g0, lo, hi, max(1, lo - g0),
                         hi - g0 + (1 if last else 0), last))
    return total, out


# -- flappie_tpu_torch/decode/seq.py (src/util.h:285-313, src/flappie.c:283-297)

def phred_chars(q: np.ndarray) -> np.ndarray:
    """Phred+33 bytes of per-block log weights: p = expf(q) clipped at
    0.99999, -10 log10(1 - p) (the multiply in double), rounded, capped
    at 126."""
    p = np.exp(np.asarray(q, F32), dtype=F32)
    p = np.where(p < 0.99999, p, F32(0.99999))
    l1p = np.log1p(-p, dtype=F32)
    qs = (-(10.0 * M_LOG10E) * l1p.astype(np.float64)).astype(F32)
    ph = np.floor(F32(33.0) + qs + F32(0.5)).astype(np.int32)
    return np.minimum(ph, 126).astype(np.uint8)


def basecall(path: np.ndarray, qchar: np.ndarray, nblock: int, nbase: int) -> Tuple[str, str]:
    """Bases at the positions in [1, nblock) where the path changes
    state, and their quality characters."""
    p = np.asarray(path)[:nblock]
    idx = np.nonzero(p[1:] != p[:-1])[0] + 1
    if idx.size == 0:
        return "", ""
    seq = "".join(BASE_LOOKUP[s] for s in (p[idx].astype(np.int64) % nbase))
    return seq, np.asarray(qchar)[idx].tobytes().decode("ascii")
