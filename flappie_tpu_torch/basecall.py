"""End-to-end basecalling: raw reads -> BasecallResult.

Counterpart of flappie_tpu/basecall.py.  Reads are preprocessed on the
host (numpy, in waves on a background thread), long reads are cut into
overlapping chunks that are batched across reads through one fixed-shape
chunk program, short reads are bucketed to power-of-two lengths through
the full-read program, and each program runs the network forward, the
CRF forward-backward (unless viterbi-only) and the Viterbi decode with
traceback on the device.  Host code only converts paths to strings.

Decode-mode semantics (src/flappie.c:276-300):
- default (fb): Viterbi runs over the *normalised log posterior*, so
  qualities are posterior-derived;
- --viterbi: Viterbi runs over the raw transition weights.

Each program takes ONE packed input buffer and returns ONE byte matrix
(the JAX package's layouts, so the two can be compared byte for byte).
On the GPU a batch is uploaded from pinned host memory and its output
copied back into pinned memory asynchronously on the current stream; a
short queue of batches in flight lets the host pack the next batch while
the device computes.  The host's phases are bracketed with timing.phase
under the JAX package's names (fast5_read, preprocess, encode_d8, pack,
dispatch, dispatch_upload, dispatch_launch, upload_wait, collect_wait,
collect_bound_wait, collect_host) and the port's own: wave_wait (the
caller waiting for a preprocessing wave) and, inside dispatch_launch,
launch_network (the network's launches), launch_decode (the CRF decode,
the score and the output packing) and launch_copyback (the pinned
output, its copy and the completion event).  Each call is also a span
(timing.py) under the job's id (one ``basecall_raw_tables`` call) and
the batch's, which goes with the batch to whichever thread dispatches
and collects it; each batch's pack counts its rows, valid rows, slots
and owned samples, and on the GPU a pair of CUDA events gives its time
in flight (an ``on_device`` span).  FLAPPIE_TPU_PHASES dumps the walls
with the CPU seconds, the device's idle time by phase and the counters.

The JAX package's host knobs, read at call time (README's knob table has
each default beside JAX's):

- FLAPPIE_TPU_UPLOAD: the wire -- ``auto`` (default: i16 where the reads
  carry ADC, as JAX's off the TPU), ``f32``, ``i16`` or ``d8`` (int8
  deltas with exceptions, decoded on the device to the i16 buffer bit
  for bit; a batch whose rows overflow their exception slots takes i16);
- FLAPPIE_TPU_DISPATCH_GROUP: G consecutive same-wire chunk batches as
  one upload and one program over G slices (default 1);
- FLAPPIE_TPU_UPLOAD_THREADS: dispatches on a pool of this many threads
  (default 0: on the caller's thread);
- FLAPPIE_TPU_COLLECT_THREAD: collection on one FIFO background thread
  when set to anything but 0 (default: the caller's thread);
- FLAPPIE_TPU_PREPROCESS_WAVE: reads a preprocessing wave (default 16,
  0: one shot);
- FLAPPIE_TPU_PREWARM (cli/flappie.py): ``prewarm_chunked`` on a thread.

Each changes when or how bytes move, never the output bytes.
"""

from __future__ import annotations

import contextlib
import math
import os
import sys
import threading
import time
from concurrent.futures import Future, ThreadPoolExecutor
from dataclasses import replace
from types import SimpleNamespace
from typing import List, Optional, Sequence

import numpy as np
import torch

from . import resolve_device, timing
from .decode.seq import path_to_basecall
from .io.fastx import BasecallResult
from .models.config import ModelConfig, get_model_config
from .models.network import check_supported, stream_params, transitions
from .models.params import init_synthetic, load_npz, params_to_torch, validate
from .ops import precision
from .ops.crf import crf_decode_fused, phred_from_qpath
from .parallel.chunking import chunk_records, extract_chunks, plan_chunks, stitch_trans
from .signal.preprocess import RawTable, normalise_signal, trim_and_segment

F32 = np.float32

MIN_BUCKET = 2048

# Batches queued on the device before the oldest is collected.  Launches
# return at once, so batches in flight keep the device busy while the
# host packs the next batch and formats the last one.
PIPELINE_DEPTH = 2
# CUDA streams the batches rotate over.  The LSTM recurrence kernel
# fills only 32 SMs at 256 rows (8 rows per block), so batches on
# separate streams run concurrently on the rest of the card.
STREAMS = PIPELINE_DEPTH + 1


def bucket_length(n: int, min_bucket: int = MIN_BUCKET) -> int:
    """Pad target: next power-of-two bucket (bounds the program shapes)."""
    b = min_bucket
    while b < n:
        b *= 2
    return b


# Reads per preprocessing wave: wave k+1 is preprocessed on a background
# thread while wave k's chunks pack and dispatch, so the first batch
# leaves after one wave.  Outputs are identical for any wave size.
PREPROCESS_WAVE = 16


def _preprocess_wave() -> int:
    """FLAPPIE_TPU_PREPROCESS_WAVE: reads a preprocessing wave; 0 runs
    the preprocessing in one shot.  Default PREPROCESS_WAVE (the JAX
    package's is 64)."""
    v = os.environ.get("FLAPPIE_TPU_PREPROCESS_WAVE")
    return max(0, int(v)) if v else PREPROCESS_WAVE


def _upload_mode() -> str:
    """FLAPPIE_TPU_UPLOAD: ``auto`` (default), ``f32``, ``i16`` or ``d8``.
    ``auto`` resolves as the JAX package's does off the TPU: the i16 wire
    where every read of a batch carries ADC counts, else f32 (any value
    but f32 and d8 reads so, as in the JAX package)."""
    return os.environ.get("FLAPPIE_TPU_UPLOAD", "auto")


def _prefer_d8() -> bool:
    return _upload_mode() == "d8"


def _dispatch_group() -> int:
    """FLAPPIE_TPU_DISPATCH_GROUP: chunk batches a dispatch (default 1,
    the JAX package's default off the TPU)."""
    v = os.environ.get("FLAPPIE_TPU_DISPATCH_GROUP")
    return max(1, int(v)) if v else 1


def _upload_threads() -> int:
    """FLAPPIE_TPU_UPLOAD_THREADS: dispatch threads (default 0: the
    caller's thread, the JAX package's default off the TPU)."""
    v = os.environ.get("FLAPPIE_TPU_UPLOAD_THREADS")
    return max(0, int(v)) if v else 0


def _collect_threaded() -> bool:
    """FLAPPIE_TPU_COLLECT_THREAD: collect on one background thread when
    set to anything but 0; unset, on the caller's thread (the JAX
    package's default is the thread)."""
    v = os.environ.get("FLAPPIE_TPU_COLLECT_THREAD")
    return bool(v) and v != "0"


# -- fault injection (reference CHAOSMONKEY, src/flappie_stdlib.h:18-35) -----
#
# FLAPPIE_TPU_CHAOS_DEVICE=p corrupts each preprocessed read with
# probability p (alternating NaN signal / zero-length);
# FLAPPIE_TPU_CHAOS_DISPATCH=p fails each dispatch with probability p.
# Both degrade to "No basecall returned" for the affected reads only.


def _chaos_p(var: str) -> float:
    v = os.environ.get(var)
    return float(v) if v else 0.0


def _chaos_corrupt_reads(processed, counter: list) -> None:
    p = _chaos_p("FLAPPIE_TPU_CHAOS_DEVICE")
    if not p:
        return
    rng = np.random.default_rng()
    for rt in processed:
        if rt is None or rng.random() >= p:
            continue
        counter[0] += 1
        if counter[0] % 2 == 1 and rt.end > rt.start:
            rt.raw[rt.start : rt.end] = np.nan
            rt.adc = None  # corruption must reach the device either way
        else:
            rt.end = rt.start  # zero-length active window


def _chaos_maybe_fail_dispatch() -> None:
    p = _chaos_p("FLAPPIE_TPU_CHAOS_DISPATCH")
    if p and np.random.default_rng().random() < p:
        raise RuntimeError("chaos: injected dispatch failure")


def preprocess_batch(reads, trim_start=200, trim_end=10, varseg_chunk=100,
                     varseg_thresh=0.0, delta=0.0) -> List[Optional[RawTable]]:
    """Trim + normalise each read (numpy).  Inputs are never mutated;
    None where trimming consumed the read."""
    out: List[Optional[RawTable]] = []
    for rt in reads:
        if rt.raw is None:
            out.append(None)
            continue
        rt = replace(rt, raw=rt.raw.copy())  # callers keep their data
        rt = trim_and_segment(rt, trim_start, trim_end, varseg_chunk, varseg_thresh)
        out.append(normalise_signal(rt, delta) if rt.valid else None)
    return out


def _i16_capable(rt) -> bool:
    return rt.adc is not None and rt.cal is not None and rt.norm is not None


# -- device programs ---------------------------------------------------------


def _device_decode(trans, nblocks, nbase: int, nstate: int, viterbi_only: bool,
                   compute_trace: bool):
    """CRF decode of transition weights (fb posterior unless
    ``viterbi_only``) through ops/crf.py's impl dispatch: (score f32 [B],
    path int8 [B, T+1], qchar uint8 [B, T+1], trace uint8), one byte a
    block for the host.  ``nstate`` is the JAX program's static argument;
    the decode reads the states from ``nbase``."""
    score, path, qpath, trace = crf_decode_fused(trans, nblocks, nbase, viterbi_only,
                                                 compute_trace)
    return score, path.to(torch.int8), phred_from_qpath(qpath), trace


def _device_basecall(params, signal, lengths, cfg: ModelConfig, temperature: float,
                     viterbi_only: bool, compute_trace: bool, rnn_impl: str = "auto",
                     stream=torch.float32, packed: bool = False):
    """Full-read program: (score, path int8 [B, T+1], qchar uint8,
    nblocks, trace), or with ``packed`` their ``_pack_outputs`` byte
    matrix.  ``stream``: the recurrent stack's stream dtype."""
    with timing.phase("launch_network"):
        trans, nblocks = transitions(params, cfg, signal, lengths, temperature,
                                     rnn_impl=rnn_impl, stream=stream)
    with timing.phase("launch_decode"):
        score, path, qchar, trace = _device_decode(trans, nblocks, cfg.nbase, cfg.nstate,
                                                   viterbi_only, compute_trace)
        if packed:
            return _pack_outputs(score, path, qchar, nblocks, trace, compute_trace)
    return score, path, qchar, nblocks, trace


def _device_basecall_fwd(params, signal, lengths, cfg: ModelConfig, temperature: float,
                         rnn_impl: str = "auto", stream=torch.float32):
    """The network alone: (trans [B, T', P], nblocks [B])."""
    return transitions(params, cfg, signal, lengths, temperature, rnn_impl=rnn_impl,
                       stream=stream)


def _device_basecall_chunk(params, signal, lengths, qlo, qhi, cfg: ModelConfig,
                           temperature: float, viterbi_only: bool, compute_trace: bool,
                           rnn_impl: str = "auto", stream=torch.float32, packed: bool = False):
    """Chunk program: as _device_basecall, but the score is the masked
    sum of qpath over each chunk's OWNED local range [qlo, qhi), so chunk
    scores sum to the read's score."""
    with timing.phase("launch_network"):
        if viterbi_only:
            # Exact cross-chunk score: undo each chunk's own shift over the
            # owned range and subtract the owned partition increments, which
            # stitch the full-read logZ; the alpha0 log(nstate) constant
            # lands on the first chunk (qlo == 1).
            trans, nblocks, shift, incs = transitions(
                params, cfg, signal, lengths, temperature, return_norm=True, rnn_impl=rnn_impl,
                stream=stream)
        else:
            trans, nblocks = transitions(params, cfg, signal, lengths, temperature,
                                         rnn_impl=rnn_impl, stream=stream)
    with timing.phase("launch_decode"):
        _, path, qpath, trace = crf_decode_fused(trans, nblocks, cfg.nbase, viterbi_only,
                                                 compute_trace)
        t = torch.arange(qpath.shape[1], device=qpath.device)[None, :]
        keep = (t >= qlo[:, None]) & (t < qhi[:, None])
        score_part = torch.sum(torch.where(keep, qpath, torch.zeros_like(qpath)), dim=1)
        if viterbi_only:
            cnt = (qhi - qlo).to(trans.dtype)
            tr = torch.arange(incs.shape[1], device=incs.device)[None, :]
            keep_inc = (tr >= qlo[:, None] - 1) & (tr < qhi[:, None] - 1)
            owned_inc = torch.sum(torch.where(keep_inc, incs, torch.zeros_like(incs)), dim=1)
            first = (qlo == 1).to(trans.dtype)
            score_part = (score_part + shift * cnt - owned_inc
                          - first * float(np.float32(math.log(cfg.nstate))))
        out = (score_part, path.to(torch.int8), phred_from_qpath(qpath), nblocks, trace)
        return _pack_outputs(*out, compute_trace) if packed else out


def _pack_outputs(score, path, qchar, nblocks, trace, compute_trace: bool):
    """One byte matrix per batch:

        [B, (T+1)          path  (int8 states)
            + (T+1)        qchar (phred bytes)
            (+ (T+1)*S     trace bytes, when compute_trace)
            + 4            score f32, bitcast
            + 4 ]          nblocks i32, bitcast
    """
    B = path.shape[0]
    parts = [path.view(torch.uint8), qchar]
    if compute_trace:
        parts.append(trace.reshape(B, -1))
    parts.append(score.to(torch.float32).contiguous().view(torch.uint8).reshape(B, 4))
    parts.append(nblocks.to(torch.int32).contiguous().view(torch.uint8).reshape(B, 4))
    return torch.cat(parts, dim=1)


def _unpack_i16(buf):
    """Device prologue of the int16 wire: one [B, T+16] int16 buffer ->
    (normalised f32 signal [B, T], lengths, qlo, qhi).

    The 16 tail int16 are 8 bitcast f32: (length, qlo, qhi, offset,
    raw_unit, med, mad, unused).  The device replays the host pipeline
    -- pA = (adc + offset) * raw_unit (src/fast5_interface.c:297-303),
    then (pA - med) / mad (src/util.c:198-213) -- from the int16 ADC
    counts.  Each eager op rounds on its own, so nothing contracts into
    an FMA here; the mask stays between the multiply and the subtract as
    in the JAX version (basecall.py:434-441), where it is what keeps
    XLA from contracting them."""
    tail = buf[:, -16:].contiguous().view(torch.float32)  # [B, 8]
    lengths = tail[:, 0].to(torch.int32)
    qlo = tail[:, 1].to(torch.int32)
    qhi = tail[:, 2].to(torch.int32)
    offset, raw_unit = tail[:, 3:4], tail[:, 4:5]
    med, mad = tail[:, 5:6], tail[:, 6:7]
    x = buf[:, :-16].to(torch.float32)
    T = x.shape[1]
    mask = torch.arange(T, device=buf.device)[None, :] < lengths[:, None]
    zero = torch.zeros((), dtype=torch.float32, device=buf.device)
    x = (x + offset) * raw_unit
    x = torch.where(mask, x, zero)
    x = (x - med) / mad
    sig = torch.where(mask, x, zero)
    return sig, lengths, qlo, qhi


def _device_basecall_packed(params, buf, cfg, temperature, viterbi_only, compute_trace,
                            rnn_impl="auto", stream=torch.float32):
    """f32 bucket program: [B, bucket+4] (signal + float-encoded length)."""
    sig = buf[:, :-4]
    lengths = buf[:, -4].to(torch.int32)
    return _device_basecall(params, sig, lengths, cfg, temperature, viterbi_only, compute_trace,
                            rnn_impl, stream, packed=True)


def _device_basecall_chunk_packed(params, buf, cfg, temperature, viterbi_only, compute_trace,
                                  rnn_impl="auto", stream=torch.float32):
    """f32 chunk program: [CB, chunk+4] (signal + length, qlo, qhi, pad)."""
    sig = buf[:, :-4]
    meta = buf[:, -4:].to(torch.int32)
    return _device_basecall_chunk(params, sig, meta[:, 0], meta[:, 1], meta[:, 2], cfg,
                                  temperature, viterbi_only, compute_trace, rnn_impl, stream,
                                  packed=True)


def _device_basecall_packed_i16(params, buf, cfg, temperature, viterbi_only, compute_trace,
                                rnn_impl="auto", stream=torch.float32):
    """int16-wire bucket program (the short-read path)."""
    sig, lengths, _qlo, _qhi = _unpack_i16(buf)
    return _device_basecall(params, sig, lengths, cfg, temperature, viterbi_only, compute_trace,
                            rnn_impl, stream, packed=True)


def _device_basecall_chunk_packed_i16(params, buf, cfg, temperature, viterbi_only,
                                      compute_trace, rnn_impl="auto", stream=torch.float32):
    """int16-wire chunk program (the production long-read path)."""
    sig, lengths, qlo, qhi = _unpack_i16(buf)
    return _device_basecall_chunk(params, sig, lengths, qlo, qhi, cfg, temperature,
                                  viterbi_only, compute_trace, rnn_impl, stream, packed=True)


# -- the d8 wire: int8 deltas + width-scaled exception slots -----------------
#
# Counterpart of flappie_tpu/basecall.py:466-563.  ADC steps are mostly
# small but not bounded, so the wire holds each row's int8 deltas clipped
# to [-128, 127] plus (index, correction) pairs that restore the clipped
# part; the device inverts it to the exact [B, W+16] int16 buffer of the
# i16 wire and runs the i16 program, so d8 and i16 outputs are equal by
# construction.  A row has ceil(W/64) exception slots; a batch with a row
# beyond them (or a correction beyond int16) encodes to None and takes
# the i16 wire.  Payload: W + 6*ceil(W/64) + 32 bytes against 2*W + 32.


def d8_exc_slots(W: int) -> int:
    """Exception slots of a row of payload width W."""
    return (W + 63) // 64


def _d8_widths(Wtot: int):
    """(W, slots) of a d8 row of Wtot bytes: the inverse of Wtot = W +
    6*d8_exc_slots(W) + 32, strictly increasing in W, so unique where it
    is defined."""
    W = max(1, (Wtot - 32) * 32 // 35 - 8)
    while W + 6 * d8_exc_slots(W) + 32 < Wtot:
        W += 1
    if W + 6 * d8_exc_slots(W) + 32 != Wtot:
        raise ValueError(f"not a d8 wire width: {Wtot}")
    return W, d8_exc_slots(W)


def encode_d8(buf_i16: np.ndarray):
    """[B, W+16] int16 buffer (pack_chunk_inputs_i16's layout) -> the
    [B, W + 6*exc + 32] int8 wire buffer, or None when a row needs more
    exception slots than it has.  The native library's encoder where it
    is available (native.py), else ``_encode_d8_np``; the two are
    bit-identical."""
    from . import native

    with timing.phase("encode_d8"):
        if native.available():
            return native.encode_d8(buf_i16)
        return _encode_d8_np(buf_i16)


def _encode_d8_np(buf_i16: np.ndarray):
    """The d8 encode in numpy.  Row layout: W int8 clipped deltas | exc
    int32 LE exception indices | exc int16 LE corrections | the 16 tail
    int16 as raw bytes; unused slots hold index W (out of range) and 0."""
    buf_i16 = np.asarray(buf_i16, np.int16)
    B, Wt = buf_i16.shape
    W = Wt - 16
    exc = d8_exc_slots(W)
    adc = buf_i16[:, :W].astype(np.int32)
    d = np.diff(adc, axis=1, prepend=0)
    stored = np.clip(d, -128, 127)
    e = d - stored
    ii, jj = np.nonzero(e)
    counts = np.bincount(ii, minlength=B)
    ecorr = e[ii, jj]
    if counts.max(initial=0) > exc or (np.abs(ecorr) > 32767).any():
        return None
    idx = np.full((B, exc), W, np.int32)
    corr = np.zeros((B, exc), np.int16)
    if ii.size:
        # np.nonzero is row-major, so ii is sorted; slot = rank in row
        slot = np.arange(ii.size) - np.searchsorted(ii, ii, side="left")
        idx[ii, slot] = jj
        corr[ii, slot] = ecorr
    return np.concatenate([stored.astype(np.int8), idx.view(np.int8), corr.view(np.int8),
                           buf_i16[:, W:].view(np.int8)], axis=1)


def _decode_d8(buf):
    """Device inverse of encode_d8: [B, Wtot] int8 -> the exact [B, W+16]
    int16 buffer, integer ops only.  The corrections are added by a
    scatter into one spare column that takes the unused slots' index W
    (the JAX version drops them); torch.cumsum widens int32 to int64,
    which changes nothing: the running sums telescope to the int16 ADC
    values themselves."""
    B, Wtot = buf.shape
    W, exc = _d8_widths(Wtot)
    d = torch.zeros(B, W + 1, dtype=torch.int32, device=buf.device)
    d[:, :W] = buf[:, :W]
    idx = buf[:, W : W + 4 * exc].contiguous().view(torch.int32).to(torch.int64)
    corr = buf[:, W + 4 * exc : W + 6 * exc].contiguous().view(torch.int16).to(torch.int32)
    d.scatter_add_(1, idx, corr)
    adc = torch.cumsum(d[:, :W], dim=1).to(torch.int16)
    tail = buf[:, W + 6 * exc :].contiguous().view(torch.int16)
    return torch.cat([adc, tail], dim=1)


def _device_basecall_packed_d8(params, buf, cfg, temperature, viterbi_only, compute_trace,
                               rnn_impl="auto", stream=torch.float32):
    """d8-wire bucket program: the i16 program on the decoded buffer."""
    return _device_basecall_packed_i16(params, _decode_d8(buf), cfg, temperature, viterbi_only,
                                       compute_trace, rnn_impl, stream)


def _device_basecall_chunk_packed_d8(params, buf, cfg, temperature, viterbi_only,
                                     compute_trace, rnn_impl="auto", stream=torch.float32):
    """d8-wire chunk program: the i16 program on the decoded buffer."""
    return _device_basecall_chunk_packed_i16(params, _decode_d8(buf), cfg, temperature,
                                             viterbi_only, compute_trace, rnn_impl, stream)


def _grouped(name: str, single: str):
    """A grouped program: ``[G*rows, W]`` in, the program ``single`` (a
    name, looked up at call time) on each of its G row slices in turn,
    their byte matrices concatenated -- one upload and one output copy
    for G batches; each slice's bytes are those of its own dispatch."""

    def program(params, buf, G: int, cfg, temperature, viterbi_only, compute_trace,
                rnn_impl="auto", stream=torch.float32):
        fn = globals()[single]
        rows = buf.shape[0] // G
        return torch.cat([fn(params, buf[g * rows : (g + 1) * rows], cfg, temperature,
                             viterbi_only, compute_trace, rnn_impl, stream)
                          for g in range(G)], dim=0)

    program.__name__ = program.__qualname__ = name
    return program


_device_basecall_chunk_packed_grouped = _grouped(
    "_device_basecall_chunk_packed_grouped", "_device_basecall_chunk_packed")
_device_basecall_chunk_packed_i16_grouped = _grouped(
    "_device_basecall_chunk_packed_i16_grouped", "_device_basecall_chunk_packed_i16")
_device_basecall_chunk_packed_d8_grouped = _grouped(
    "_device_basecall_chunk_packed_d8_grouped", "_device_basecall_chunk_packed_d8")
_device_basecall_packed_i16_grouped = _grouped(
    "_device_basecall_packed_i16_grouped", "_device_basecall_packed_i16")
_device_basecall_packed_d8_grouped = _grouped(
    "_device_basecall_packed_d8_grouped", "_device_basecall_packed_d8")

# the chunk programs by wire, one batch a dispatch and grouped
CHUNK_PROGRAMS = {
    "f32": ("_device_basecall_chunk_packed", "_device_basecall_chunk_packed_grouped"),
    "i16": ("_device_basecall_chunk_packed_i16", "_device_basecall_chunk_packed_i16_grouped"),
    "d8": ("_device_basecall_chunk_packed_d8", "_device_basecall_chunk_packed_d8_grouped"),
}


def _chunk_program(kind: str, grouped: bool):
    return globals()[CHUNK_PROGRAMS[kind][int(grouped)]]


def _unpack_chunk_outputs(buf: np.ndarray, T1: int, nstate: int, compute_trace: bool):
    """Inverse of the packed layout -> (score, path, qchar, nblocks, trace)."""
    path = buf[:, :T1].astype(np.int8)
    qchar = buf[:, T1 : 2 * T1]
    ofs = 2 * T1
    trace = None
    if compute_trace:
        trace = buf[:, ofs : ofs + T1 * nstate].reshape(-1, T1, nstate)
        ofs += T1 * nstate
    score = buf[:, ofs : ofs + 4].copy().view(np.float32)[:, 0]
    nblocks = buf[:, ofs + 4 : ofs + 8].copy().view(np.int32)[:, 0]
    return score, path, qchar, nblocks, trace


def pack_chunk_inputs(signals, lengths, qlo, qhi) -> np.ndarray:
    """f32 wire: one [CB, chunk+4] array per batch, signal plus
    float-encoded int metadata (exact below 2^24)."""
    meta = np.stack(
        [
            np.asarray(lengths, np.int32),
            np.asarray(qlo, np.int32),
            np.asarray(qhi, np.int32),
            np.zeros(np.shape(signals)[0], np.int32),
        ],
        axis=1,
    ).astype(np.float32)
    return np.concatenate([np.asarray(signals, np.float32), meta], axis=1)


def pack_chunk_inputs_i16(adc, lengths, qlo, qhi, scal) -> np.ndarray:
    """int16 wire: one [CB, chunk+16] int16 array per batch.  ``scal``:
    [CB, 4] f32 (offset, raw_unit, med, mad); the 16 tail int16 are 8 f32
    (length, qlo, qhi, offset, raw_unit, med, mad, 0) bit-cast to int16
    pairs (little-endian both sides); the device inverse is _unpack_i16."""
    B = np.shape(adc)[0]
    tail = np.zeros((B, 8), np.float32)
    tail[:, 0] = lengths
    tail[:, 1] = qlo
    tail[:, 2] = qhi
    tail[:, 3:7] = scal
    return np.concatenate([np.asarray(adc, np.int16), tail.view(np.int16)], axis=1)


def pack_bucket(items, bucket: int):
    """One bucket batch of preprocessed reads ``items`` [(tag, RawTable)],
    each padded to ``bucket`` samples -> (is_i16, packed buffer): the
    int16 ADC wire when every read keeps its ADC counts and
    FLAPPIE_TPU_UPLOAD is not f32, else the f32 wire of host-normalised
    signal."""
    B = len(items)
    lengths = np.zeros(B, np.int32)
    zeros = np.zeros(B, np.int32)
    if _upload_mode() != "f32" and all(_i16_capable(rt) for _, rt in items):
        adc = np.zeros((B, bucket), np.int16)
        scal = np.zeros((B, 4), F32)
        scal[:, 3] = 1.0  # pad rows: mad=1 -> exact zero signal
        for j, (_, rt) in enumerate(items):
            L = rt.end - rt.start
            adc[j, :L] = rt.adc[rt.start : rt.end]
            lengths[j] = L
            scal[j] = (rt.cal[0], rt.cal[1], rt.norm[0], rt.norm[1])
        return True, pack_chunk_inputs_i16(adc, lengths, zeros, zeros, scal)
    sig = np.zeros((B, bucket), F32)
    for j, (_, rt) in enumerate(items):
        seg = rt.active()
        sig[j, : seg.size] = seg
        lengths[j] = seg.size
    return False, pack_chunk_inputs(sig, lengths, zeros, zeros)


def _on_device(device: torch.device):
    """The context that makes ``device`` current on the calling thread
    (the C entries size their grids on the current device)."""
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


class _InFlight:
    """One dispatched batch: its output bytes land in ``host`` (pinned
    memory on the GPU) once ``event`` has completed.  ``keep`` holds the
    pinned input buffer until then.  On the GPU ``start`` (a timing event
    recorded before the upload) and ``event`` give the batch's time in
    flight, kept at its first collection as an ``on_device`` span under
    ``ids`` on ``queue``'s clock."""

    def __init__(self, host, event=None, keep=None, start=None, queue=None, ids=None):
        self.host, self.event, self.keep = host, event, keep
        self.start, self.queue, self.ids = start, queue, ids

    def result(self) -> np.ndarray:
        with timing.phase("collect_wait"):  # device wait (the D2H copy ends with it)
            if self.event is not None:
                self.event.synchronize()
                if self.start is not None:
                    start, self.start = self.start, None
                    t0 = self.queue.host_time(start)
                    timing.on_device(t0, t0 + start.elapsed_time(self.event) * 1e-3,
                                     str(self.queue.device), **self.ids)
            return self.host.numpy()

    def __array__(self, dtype=None, copy=None):
        """``np.asarray(handle)``: the output bytes, waited for, as the
        JAX package's device arrays read."""
        return _as_array(self.result(), dtype, copy)


def _as_array(out: np.ndarray, dtype=None, copy=None) -> np.ndarray:
    """``__array__``'s result (numpy 2's signature) from ``out``."""
    out = np.asarray(out, dtype=dtype)
    return out.copy() if copy else out


class _DeviceQueue:
    """Runs packed-batch programs on one device.  On the GPU each batch is
    uploaded from pinned host memory on the next of STREAMS CUDA streams,
    and its output bytes are copied back into pinned memory on the same
    stream, so ``run`` returns at once; on the CPU it runs in place.  Any
    thread may call ``run`` (the upload pool's, the prewarm's): the stream
    rotation takes a lock, and the caller makes the device current.

    The card's clock is tied to the host's once: an anchor event recorded
    on an idle device and waited for, read against perf_counter around
    it; a batch's events are then placed by their elapsed time from it
    (``host_time``)."""

    def __init__(self, device: torch.device):
        self.device = device
        self._streams = []
        self._next = 0
        self._lock = threading.Lock()
        if device.type == "cuda":
            self._streams = [torch.cuda.Stream(device) for _ in range(STREAMS)]
            # the caller uploaded the weights on the current stream; the
            # batch streams read them, so the upload must be complete first
            torch.cuda.synchronize(device)
            self._anchor = torch.cuda.Event(enable_timing=True)
            t0 = time.perf_counter()
            self._anchor.record(self._streams[0])
            self._anchor.synchronize()
            self._anchor_t = 0.5 * (t0 + time.perf_counter())

    def host_time(self, event) -> float:
        """perf_counter's reading when ``event`` (recorded on this
        device, completed) ran on the device."""
        return self._anchor_t + self._anchor.elapsed_time(event) * 1e-3

    def run(self, program, buf: np.ndarray) -> _InFlight:
        """Enqueue ``program(device_buffer) -> output tensor`` on ``buf``."""
        with timing.phase("dispatch"):
            if self.device.type != "cuda":
                with timing.phase("dispatch_upload"):
                    host = torch.from_numpy(np.ascontiguousarray(buf))
                with timing.phase("dispatch_launch"), torch.inference_mode():
                    return _InFlight(program(host))
            with self._lock:
                stream = self._streams[self._next % len(self._streams)]
                self._next += 1
            with torch.cuda.stream(stream), torch.inference_mode():
                with timing.phase("dispatch_upload"):  # a host copy into pinned memory
                    host = torch.from_numpy(np.ascontiguousarray(buf)).pin_memory()
                    start = torch.cuda.Event(enable_timing=True)
                    start.record(stream)
                    dev = host.to(self.device, non_blocking=True)
                with timing.phase("dispatch_launch"):  # Python issuing the kernels
                    out = program(dev)
                    with timing.phase("launch_copyback"):
                        pinned = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
                        pinned.copy_(out, non_blocking=True)
                        event = torch.cuda.Event(enable_timing=True)
                        event.record(stream)
            return _InFlight(pinned, event, keep=host, start=start, queue=self,
                             ids=timing.current_ids())


class _Pipeline:
    """Dispatch-ahead queue: push (tag, in-flight batch) pairs; the oldest
    is collected once more than ``depth`` are queued.  An in-flight batch
    may be a Future of one (a dispatch on the upload pool), resolved under
    ``upload_wait``.  Under FLAPPIE_TPU_COLLECT_THREAD collection runs on
    one FIFO background thread, so batches are collected in push order
    as on the caller's thread; the caller waits for the oldest collect
    (``collect_bound_wait``) once more than ``depth`` are pending, and a
    collect failure without ``on_error`` re-raises at the next push or
    drain.  ``on_error(tag, exc)``, when given, absorbs a failure so one
    bad batch degrades to its own reads (reference NULL-propagation,
    src/flappie_stdlib.h:37-45).  A batch is collected under the timing
    ids in force when it was pushed."""

    def __init__(self, collect, depth: int = PIPELINE_DEPTH, on_error=None):
        self._collect = collect
        self._depth = depth
        self._on_error = on_error
        self._q: list = []
        self._pool = (ThreadPoolExecutor(1, thread_name_prefix="flappie-collect")
                      if _collect_threaded() else None)

    def _run(self, tag, pending) -> None:
        try:
            if isinstance(pending, Future):  # a dispatch on the upload pool
                with timing.phase("upload_wait"):
                    pending = pending.result()
            out = pending.result()
            with timing.phase("collect_host"):  # unpack + assemble
                self._collect(tag, out)
        except Exception as exc:  # noqa: BLE001 - per-batch isolation
            if self._on_error is None:
                raise
            self._on_error(tag, exc)

    def push(self, tag, pending) -> None:
        run = timing.carry(self._run)
        if self._pool is not None:
            self._q.append(self._pool.submit(run, tag, pending))
            if len(self._q) > self._depth:
                with timing.phase("collect_bound_wait"):
                    self._q.pop(0).result()
            return
        self._q.append((run, tag, pending))
        if len(self._q) > self._depth:
            run, tag, pending = self._q.pop(0)
            run(tag, pending)

    def drain(self) -> None:
        if self._pool is not None:
            try:
                for fut in self._q:
                    fut.result()
            finally:
                self._q.clear()
                self._pool.shutdown(wait=True)
                self._pool = None
            return
        for run, tag, pending in self._q:
            run(tag, pending)
        self._q.clear()


class Basecaller:
    """Batched basecaller for one model on one device (``cuda`` unless
    ``device`` says otherwise).  ``stream``: the recurrent stack's stream
    dtype, torch.float32 or torch.bfloat16 (``--fast``); None reads
    FLAPPIE_TPU_RNN_STREAM once, here (ops/precision.py).  A stack that
    is not fused runs f32 under either."""

    def __init__(
        self,
        model="r941_native",
        params=None,
        checkpoint: Optional[str] = None,
        temperature: float = 1.0,
        viterbi_only: bool = False,
        compute_trace: bool = True,
        seed: int = 0,
        rnn_impl: str = "auto",
        chunk: Optional[int] = None,
        overlap: int = 1600,
        chunk_batch: int = 256,
        device=None,
        stream=None,
    ):
        self.device = resolve_device(device)
        self.stream = precision.check_stream(stream)
        self.cfg = get_model_config(model) if isinstance(model, str) else model
        check_supported(self.cfg, rnn_impl)
        if self.cfg.head != "flipflop":
            raise NotImplementedError(
                f"model {self.cfg.name!r}: the basecaller decodes flip-flop heads, as the "
                "JAX package's does; the run-length V2 model runs through "
                "flappie_tpu_torch.cli.runnie, a V1 run-length model through "
                "models.network.transitions and decode.runlength's rle_v1_viterbi and "
                "rle_v1_posterior")
        if params is None:
            params = load_npz(checkpoint) if checkpoint is not None else init_synthetic(
                self.cfg, seed=seed)
        validate(params, self.cfg)
        # under the bf16 stream each fused layer's iW is rounded once, here
        self.params = stream_params(params_to_torch(params, self.device), self.cfg,
                                    self.stream, rnn_impl)
        self.temperature = float(temperature)
        self.viterbi_only = bool(viterbi_only)
        self.compute_trace = bool(compute_trace)
        self.rnn_impl = rnn_impl
        # Chunked fast path (0 disables): reads longer than `chunk`
        # samples are split into overlapping chunks batched through ONE
        # fixed-shape program and stitched at overlap midpoints
        # (parallel/chunking.py); the default gives every model 2,560
        # serial blocks per chunk.
        stride = self.cfg.total_stride
        if chunk is None:
            chunk = 2560 * stride
        self.chunk = int(chunk) - int(chunk) % stride if chunk else 0
        self.overlap = int(overlap)
        self.chunk_batch = int(chunk_batch)
        self._chaos_counter = [0]
        self._queue = _DeviceQueue(self.device)
        # dispatches by program name, so that a run shows which wire ran;
        # dispatches come from the caller's thread, the upload pool and
        # the prewarm thread, so the count takes a lock
        self.dispatch_stats: dict = {}
        self._stats_lock = threading.Lock()
        self._upload_pool = None  # FLAPPIE_TPU_UPLOAD_THREADS, made at first use

    # -- device side ------------------------------------------------------

    def _count_dispatch(self, program) -> None:
        name = getattr(program, "__name__", str(program))
        with self._stats_lock:
            self.dispatch_stats[name] = self.dispatch_stats.get(name, 0) + 1

    def _dispatch(self, program, buf: np.ndarray, G: Optional[int] = None,
                  chaos: bool = True) -> _InFlight:
        """Upload one packed batch (G batches for a grouped program) and
        enqueue its program; returns at once on the GPU (the output bytes
        are collected later).  The one dispatch point of every wire and
        program, which DistributedBasecaller overrides.  ``chaos``:
        subject to FLAPPIE_TPU_CHAOS_DISPATCH (not the prewarm's)."""
        if chaos:
            _chaos_maybe_fail_dispatch()
        self._count_dispatch(program)
        extra = () if G is None else (G,)
        return self._queue.run(
            lambda dev: program(self.params, dev, *extra, self.cfg, self.temperature,
                                self.viterbi_only, self.compute_trace, self.rnn_impl,
                                self.stream), buf)

    def _submit_dispatch(self, program, buf: np.ndarray, G: Optional[int] = None):
        """``_dispatch`` on the upload pool under FLAPPIE_TPU_UPLOAD_THREADS
        > 0 (a Future the pipeline resolves; the pool's thread makes this
        Basecaller's device current), else at once on this thread."""
        n = _upload_threads()
        if n <= 0:
            return self._dispatch(program, buf, G)
        with self._stats_lock:
            if self._upload_pool is None:
                self._upload_pool = ThreadPoolExecutor(n, thread_name_prefix="flappie-upload")
        return self._upload_pool.submit(timing.carry(self._dispatch_on_device), program, buf, G)

    def _dispatch_on_device(self, program, buf, G=None):
        with _on_device(self.device):
            return self._dispatch(program, buf, G)

    # -- the packed-dispatch entries (the JAX Basecaller's public API) -------
    #
    # Each uploads one packed buffer (G batches of equal rows for a grouped
    # entry) through ``_dispatch``, with this Basecaller's device current,
    # and returns a handle without collecting the output: its ``result()``
    # or ``np.asarray`` waits for the byte matrix (unpack_chunk_outputs's
    # layout).
    # Going through ``_dispatch`` lets DistributedBasecaller shard every
    # entry.  The programs take their widths from the buffer, not from
    # ``self.chunk``.

    @staticmethod
    def pack_chunk_inputs(signals, lengths, qlo, qhi) -> np.ndarray:
        """The f32 wire's [CB, chunk+4] buffer (module ``pack_chunk_inputs``)."""
        return pack_chunk_inputs(signals, lengths, qlo, qhi)

    @staticmethod
    def pack_chunk_inputs_i16(adc, lengths, qlo, qhi, scal) -> np.ndarray:
        """The int16 wire's [CB, chunk+16] buffer (module
        ``pack_chunk_inputs_i16``); ``encode_d8`` of it is the d8 wire's."""
        return pack_chunk_inputs_i16(adc, lengths, qlo, qhi, scal)

    def call_chunk_batch_device(self, signals, lengths, qlo, qhi):
        """One [CB, chunk] batch of normalised signal through the chunk
        program (per-chunk owned-range score sums in [qlo, qhi)); returns
        the dispatch's handle without waiting."""
        return self.dispatch_packed_chunk(pack_chunk_inputs(signals, lengths, qlo, qhi))

    def dispatch_packed_batch(self, buf):
        """One full-read (bucket) batch on the f32 wire."""
        return self._dispatch_on_device(_device_basecall_packed, buf)

    def dispatch_packed_batch_i16(self, buf):
        return self._dispatch_on_device(_device_basecall_packed_i16, buf)

    def dispatch_packed_batch_d8(self, buf):
        return self._dispatch_on_device(_device_basecall_packed_d8, buf)

    def dispatch_packed_chunk(self, buf):
        """One chunk batch on the f32 wire."""
        return self._dispatch_on_device(_device_basecall_chunk_packed, buf)

    def dispatch_packed_chunk_i16(self, buf):
        return self._dispatch_on_device(_device_basecall_chunk_packed_i16, buf)

    def dispatch_packed_chunk_d8(self, buf):
        return self._dispatch_on_device(_device_basecall_chunk_packed_d8, buf)

    def dispatch_packed_chunk_grouped(self, buf, G: int):
        """G chunk batches as one upload; their output rows in order."""
        return self._dispatch_on_device(_device_basecall_chunk_packed_grouped, buf, G)

    def dispatch_packed_chunk_i16_grouped(self, buf, G: int):
        return self._dispatch_on_device(_device_basecall_chunk_packed_i16_grouped, buf, G)

    def dispatch_packed_chunk_d8_grouped(self, buf, G: int):
        return self._dispatch_on_device(_device_basecall_chunk_packed_d8_grouped, buf, G)

    def dispatch_packed_batch_i16_grouped(self, buf, G: int):
        """G full-read batches of one bucket as one upload."""
        return self._dispatch_on_device(_device_basecall_packed_i16_grouped, buf, G)

    def dispatch_packed_batch_d8_grouped(self, buf, G: int):
        return self._dispatch_on_device(_device_basecall_packed_d8_grouped, buf, G)

    def unpack_chunk_outputs(self, buf):
        """A chunk batch's output bytes (or its handle) -> (score, path,
        qchar, nblocks, trace) at this Basecaller's chunk width."""
        T1 = self.chunk // self.cfg.total_stride + 1
        return _unpack_chunk_outputs(np.asarray(buf), T1, self.cfg.nstate, self.compute_trace)

    def call_batch_device(self, signals, lengths):
        """Run the full-read program on one batch on this Basecaller's
        device: ``signals`` [B, T] float32 normalised signal
        (zero-padded), ``lengths`` [B] (numpy or tensors).  Returns the
        device tensors (score, path, qchar, nblocks, trace) without
        waiting for them, so callers can overlap host work with the
        device's."""
        with _on_device(self.device), torch.inference_mode():
            sig = torch.as_tensor(signals, dtype=torch.float32).to(self.device)
            lens = torch.as_tensor(lengths, dtype=torch.int32).to(self.device)
            return _device_basecall(self.params, sig, lens, self.cfg, self.temperature,
                                    self.viterbi_only, self.compute_trace, self.rnn_impl,
                                    self.stream)

    def call_batch(self, signals, lengths):
        """``call_batch_device`` collected: numpy (score, path, qpath,
        nblocks, trace), qpath the phred bytes."""
        return tuple(x.cpu().numpy() for x in self.call_batch_device(signals, lengths))

    def close(self) -> None:
        """Stop the upload pool, if any (after the dispatches it holds)."""
        if self._upload_pool is not None:
            self._upload_pool.shutdown(wait=True)
            self._upload_pool = None

    def _dummy_chunk_buf(self, kind: str, rows: int) -> np.ndarray:
        """The prewarm's chunk batch: ``rows`` dummy rows on wire ``kind``
        (f32, i16 or d8), a few valid samples of zero signal and an empty
        score range each."""
        lengths = np.full(rows, self.cfg.total_stride, np.int32)
        z = np.zeros(rows, np.int32)
        if kind == "f32":
            buf = pack_chunk_inputs(np.zeros((rows, self.chunk), F32), lengths, z, z)
        else:
            scal = np.zeros((rows, 4), F32)
            scal[:, 3] = 1.0  # mad=1 -> exact zero signal
            buf = pack_chunk_inputs_i16(np.zeros((rows, self.chunk), np.int16), lengths, z, z,
                                        scal)
            if kind == "d8":
                buf = encode_d8(buf)  # zero deltas never need an exception slot
        return buf

    def prewarm_chunked(self) -> None:
        """Run one dummy chunk batch (a group of them under
        FLAPPIE_TPU_DISPATCH_GROUP) on the wire the run will use, and wait
        for it: the first call of the chunk program builds any kernel not
        built yet and warms cuDNN and the allocator.  The CLI calls it on a
        background thread under FLAPPIE_TPU_PREWARM=1.  Unlike the JAX
        package's, a failure is not swallowed: it raises."""
        if not self.chunk:
            return
        mode = _upload_mode()
        kind = "d8" if mode == "d8" else "f32" if mode == "f32" else "i16"
        G = _dispatch_group()
        buf = self._dummy_chunk_buf(kind, self.chunk_batch)
        with _on_device(self.device):
            if G > 1:
                pending = self._dispatch(_chunk_program(kind, True), np.concatenate([buf] * G),
                                         G, chaos=False)
            else:
                pending = self._dispatch(_chunk_program(kind, False), buf, chaos=False)
            pending.result()

    # -- full pipeline ----------------------------------------------------

    @timing.job()  # each call one job (a fresh id a call)
    def basecall_raw_tables(
        self,
        reads: Sequence[RawTable],
        trim_start: int = 200,
        trim_end: int = 10,
        varseg_chunk: int = 100,
        varseg_thresh: float = 0.0,
        delta: float = 0.0,
        reverse: bool = False,
        max_batch: int = 32,
    ) -> List[Optional[BasecallResult]]:
        """Preprocess, chunk or bucket, batch and decode a set of reads.

        Entries of ``reads`` may be RawTables or zero-arg callables
        returning one (lazy reads, materialised on the preprocessing
        thread).  Returns one BasecallResult per input (None where the
        read failed), in input order.
        """

        def _pre(batch):
            loaded = []
            for r in batch:
                if callable(r):
                    with timing.phase("fast5_read"):
                        r = r()
                loaded.append(r)
            with timing.phase("preprocess"):
                return preprocess_batch(loaded, trim_start, trim_end, varseg_chunk,
                                        varseg_thresh, delta)

        results: List[Optional[BasecallResult]] = [None] * len(reads)
        chunked = self._chunked_run(results, reverse) if self.chunk else None
        prepped: list = []  # short reads -> the bucketed path below

        def _absorb(processed, base):
            # reads longer than one chunk go through the chunked program,
            # dispatched incrementally so later waves' preprocessing
            # overlaps earlier waves' device work
            _chaos_corrupt_reads(processed, self._chaos_counter)
            batch = [(base + k, rt) for k, rt in enumerate(processed) if rt is not None]
            if chunked is not None:
                long_items = [(i, rt) for i, rt in batch if rt.end - rt.start > self.chunk]
                batch = [(i, rt) for i, rt in batch if rt.end - rt.start <= self.chunk]
                if long_items:
                    chunked.add(long_items)
            prepped.extend(batch)

        wave = _preprocess_wave()
        if wave and len(reads) > wave:
            from concurrent.futures import ThreadPoolExecutor

            offsets = list(range(0, len(reads), wave))
            pre = timing.carry(_pre)  # the waves' spans under this job's id
            with ThreadPoolExecutor(1, thread_name_prefix="flappie-pre") as ex:
                fut = ex.submit(pre, reads[:wave])
                for w, ofs in enumerate(offsets):
                    with timing.phase("wave_wait"):
                        processed = fut.result()
                    if w + 1 < len(offsets):
                        nxt = offsets[w + 1]
                        fut = ex.submit(pre, reads[nxt : nxt + wave])
                    _absorb(processed, ofs)
        else:
            _absorb(_pre(reads), 0)
        if chunked is not None:
            chunked.flush()

        # group by bucket to keep shapes static; batch within bucket
        by_bucket: dict = {}
        for i, rt in prepped:
            by_bucket.setdefault(bucket_length(rt.end - rt.start), []).append((i, rt))

        def _dispatch(part, bucket):
            with timing.phase("pack"):
                i16, buf = pack_bucket(part, bucket)
                b8 = encode_d8(buf) if i16 and _prefer_d8() else None
                timing.count(rows=len(part), rows_valid=len(part), slots=len(part) * bucket,
                             owned=sum(rt.end - rt.start for _, rt in part))
            if b8 is not None:
                return self._submit_dispatch(_device_basecall_packed_d8, b8)
            return self._submit_dispatch(
                _device_basecall_packed_i16 if i16 else _device_basecall_packed, buf)

        def _collect(tag, out):
            part, bucket = tag
            T1 = -(-bucket // self.cfg.total_stride) + 1
            score, path, qchar, nblocks, trace = _unpack_chunk_outputs(
                out, T1, self.cfg.nstate, self.compute_trace)
            for j, (i, rt) in enumerate(part):
                results[i] = self._assemble(
                    rt, score[j], path[j], qchar[j], int(nblocks[j]),
                    None if trace is None else trace[j], reverse)

        def _on_error(tag, exc):
            part, _bucket = tag
            print(f"basecall batch failed ({exc}); dropping {len(part)} read(s)",
                  file=sys.stderr)

        pipe = _Pipeline(_collect, on_error=_on_error)
        for bucket, items in sorted(by_bucket.items()):
            for ofs in range(0, len(items), max_batch):
                part = items[ofs : ofs + max_batch]
                with timing.batch():
                    try:
                        pipe.push((part, bucket), _dispatch(part, bucket))
                    except Exception as exc:  # noqa: BLE001 - batch isolation
                        _on_error((part, bucket), exc)
        if chunked is not None:
            chunked.drain()
        pipe.drain()
        return results

    def basecall_read(self, rt: RawTable, **kw) -> Optional[BasecallResult]:
        """One read through ``basecall_raw_tables``."""
        return self.basecall_raw_tables([rt], **kw)[0]

    def basecall_read_chunked(self, rt: RawTable, chunk: int = 16000, overlap: int = 2000,
                              delta: float = 0.0, reverse: bool = False,
                              **trim_kw) -> Optional[BasecallResult]:
        """One long read decoded as one row: trim and normalise, cut the
        signal into overlapping chunks (``plan_chunks``), run the network
        on the chunks as one batch, stitch their transition weights at
        the overlap midpoints (``stitch_trans``) and decode the stitched
        matrix, padded to a multiple of 256 blocks, in one call.
        ``trim_kw``: trim_and_segment's arguments."""
        if rt.raw is None:
            return None
        rt = replace(rt, raw=rt.raw.copy())  # callers keep their data
        rt = trim_and_segment(rt, **trim_kw)
        if not rt.valid:
            return None
        normalise_signal(rt, delta)
        seg = rt.active()
        plan = plan_chunks(seg.size, self.cfg.total_stride, chunk, overlap)
        chunks, lengths = extract_chunks(seg, plan)
        dev = self.device
        with _on_device(dev), torch.inference_mode():
            trans, _ = _device_basecall_fwd(self.params, torch.from_numpy(chunks).to(dev),
                                            torch.from_numpy(lengths).to(dev), self.cfg,
                                            self.temperature, self.rnn_impl, self.stream)
            stitched = stitch_trans(trans.cpu().numpy(), plan)
            T = stitched.shape[0]
            buf = np.zeros((1, -(-T // 256) * 256, stitched.shape[1]), F32)
            buf[0, :T] = stitched
            out = _device_decode(torch.from_numpy(buf).to(dev),
                                 torch.tensor([T], dtype=torch.int32, device=dev),
                                 self.cfg.nbase, self.cfg.nstate, self.viterbi_only,
                                 self.compute_trace)
            score, path, qchar, trace = (x[0].cpu().numpy() for x in out)
        return self._assemble(rt, float(score), path, qchar, T, trace, reverse)

    # -- chunked production path -------------------------------------------

    def _chunked_run(self, results, reverse: bool):
        """Returns an object whose ``add(items)`` registers long reads and
        dispatches every FULL chunk batch at once, whose ``flush()``
        dispatches the remainder, and whose ``drain()`` collects every
        batch in flight: full batches at self.chunk_batch, then one final
        (possibly bucketed) tail.

        Under FLAPPIE_TPU_DISPATCH_GROUP=G > 1, G consecutive batches of
        one wire go as one grouped dispatch (flappie_tpu/basecall.py:
        1316-1400), and a failed group drops only its batches' reads.  A
        partial group (the tail, or a change of wire) runs at its own
        length: the JAX package pads it with dummy batches to reuse one
        compiled program, and torch compiles nothing per shape."""
        stride = self.cfg.total_stride
        chunk_T = self.chunk
        nstate = self.cfg.nstate
        jobs = []  # (read index, ChunkRecord) not yet packed
        state: dict = {}
        dispatched = [False]  # has any full batch been packed yet?
        i16_ok = _upload_mode() != "f32"
        # the collector thread and this one both finish reads
        lock = threading.Lock()

        def _register(items):
            for i, rt in items:
                seg = rt.active()
                plan = plan_chunks(seg.size, stride, chunk_T, self.overlap)
                recs = chunk_records(plan)
                nb = plan.nblocks
                i16 = i16_ok and _i16_capable(rt)
                with lock:
                    state[i] = {
                        "rt": rt,
                        "seg": seg,
                        "adc_seg": rt.adc[rt.start : rt.end] if i16 else None,
                        "scal": (rt.cal[0], rt.cal[1], rt.norm[0], rt.norm[1]) if i16 else None,
                        "nb": nb,
                        "remaining": len(recs),
                        "score": 0.0,
                        "path": np.zeros(nb + 1, np.int8),
                        "qchar": np.zeros(nb + 1, np.uint8),
                        "trace": (np.zeros((nb + 1, nstate), np.uint8)
                                  if self.compute_trace else None),
                    }
                jobs.extend((i, r) for r in recs)

        def _pack(job_slice, CB):
            """-> (wire, packed buffer) of one chunk batch."""
            # dummy rows: a few valid samples, empty score range
            lengths = np.full(CB, stride, np.int32)
            qlo = np.zeros(CB, np.int32)
            qhi = np.zeros(CB, np.int32)
            if all(state[i]["adc_seg"] is not None for i, _ in job_slice):
                adc = np.zeros((CB, chunk_T), np.int16)
                scal = np.zeros((CB, 4), F32)
                scal[:, 3] = 1.0  # dummy rows: mad=1 -> exact zero signal
                for j, (i, r) in enumerate(job_slice):
                    adc[j, : r.length] = state[i]["adc_seg"][r.start : r.start + r.length]
                    lengths[j] = r.length
                    qlo[j] = r.qlo
                    qhi[j] = r.qhi
                    scal[j] = state[i]["scal"]
                buf16 = pack_chunk_inputs_i16(adc, lengths, qlo, qhi, scal)
                b8 = encode_d8(buf16) if _prefer_d8() else None
                return ("d8", b8) if b8 is not None else ("i16", buf16)
            sig = np.zeros((CB, chunk_T), F32)
            for j, (i, r) in enumerate(job_slice):
                sig[j, : r.length] = state[i]["seg"][r.start : r.start + r.length]
                lengths[j] = r.length
                qlo[j] = r.qlo
                qhi[j] = r.qhi
            return "f32", pack_chunk_inputs(sig, lengths, qlo, qhi)

        def _finish(i):
            st = state[i]
            if st["remaining"] > 0:
                return
            results[i] = None if st.get("failed") else self._assemble(
                st["rt"], st["score"], st["path"], st["qchar"], st["nb"],
                st["trace"], reverse)
            state[i] = {"remaining": 0}  # free the buffers

        def _collect(job_slice, out):
            score, path, qchar, _, trace = _unpack_chunk_outputs(
                out, chunk_T // stride + 1, nstate, self.compute_trace)
            with lock:
                for j, (i, r) in enumerate(job_slice):
                    st = state[i]
                    if st["remaining"] <= 0:
                        continue
                    end = r.keep_hi + (1 if r.last else 0)  # fencepost entry
                    lo, g0 = r.keep_lo, r.g0
                    st["path"][lo:end] = path[j, lo - g0 : end - g0]
                    st["qchar"][lo:end] = qchar[j, lo - g0 : end - g0]
                    if st["trace"] is not None:
                        st["trace"][lo:end] = trace[j, lo - g0 : end - g0]
                    st["score"] += float(score[j])
                    st["remaining"] -= 1
                    _finish(i)

        def _on_error(job_slice, exc):
            # a failed chunk batch fails only the reads it carries
            fails = sorted({i for i, _ in job_slice})
            print(f"chunk batch failed ({exc}); dropping read(s) {fails}",
                  file=sys.stderr)
            with lock:
                for i, _r in job_slice:
                    st = state[i]
                    if st["remaining"] <= 0:
                        continue
                    st["failed"] = True
                    st["remaining"] -= 1
                    _finish(i)

        G = _dispatch_group()
        pipe = _Pipeline(_collect, on_error=_on_error)
        # a group is dispatched and collected under its first batch's ids
        pend = SimpleNamespace(kind=None, parts=[], bufs=[], ids=None)

        def _push(part, kind, bufs):
            try:
                if len(bufs) == 1 and G <= 1:
                    pending = self._submit_dispatch(_chunk_program(kind, False), bufs[0])
                else:
                    pending = self._submit_dispatch(_chunk_program(kind, True),
                                                    np.concatenate(bufs), len(bufs))
                pipe.push(part, pending)
            except Exception as exc:  # noqa: BLE001 - batch isolation
                _on_error(part, exc)

        def _flush_group():
            """The pending batches (G, or fewer at a partial group) as one
            grouped dispatch."""
            if not pend.bufs:
                return
            with timing.ids(**pend.ids):
                _push([j for p in pend.parts for j in p], pend.kind, list(pend.bufs))
            pend.parts.clear()
            pend.bufs.clear()

        @timing.batch()  # a fresh batch id a call
        def _route(part, CB):
            try:
                with timing.phase("pack"):
                    kind, buf = _pack(part, CB)
                    timing.count(rows=CB, rows_valid=len(part), slots=CB * chunk_T,
                                 owned=stride * sum(r.keep_hi - r.keep_lo for _, r in part))
            except Exception as exc:  # noqa: BLE001 - batch isolation
                _on_error(part, exc)
                return
            if G <= 1:
                _push(part, kind, [buf])
                return
            if pend.bufs and kind != pend.kind:
                _flush_group()
            if not pend.bufs:
                pend.ids = timing.current_ids()
            pend.kind = kind
            pend.parts.append(part)
            pend.bufs.append(buf)
            if len(pend.bufs) == G:
                _flush_group()

        def add(items):
            _register(items)
            while len(jobs) >= self.chunk_batch:
                part = jobs[: self.chunk_batch]
                del jobs[: self.chunk_batch]
                dispatched[0] = True
                _route(part, self.chunk_batch)

        def flush():
            # Tail batch size: when no full batch was ever reached, a
            # handful of chunks should not pay a full batch of padding;
            # after any full batch keep the production size.
            if jobs:
                CB = (self.chunk_batch if dispatched[0]
                      else min(self.chunk_batch, bucket_length(len(jobs), 8)))
                while jobs:
                    part = jobs[:CB]
                    del jobs[:CB]
                    _route(part, CB)
            _flush_group()

        return SimpleNamespace(add=add, flush=flush, drain=pipe.drain)

    def _assemble(self, rt, score, path, qpath, nblock, trace, reverse) -> Optional[BasecallResult]:
        # Per-read validity net: a poisoned read inside a batch (NaN
        # signal, zero-length row) surfaces as a non-finite score or an
        # empty block range; it degrades to None without touching its
        # batchmates.
        score = float(score)
        if not np.isfinite(score) or nblock < 1:
            return None
        basecall, quality = path_to_basecall(path, qpath, nblock, self.cfg.nbase)
        if reverse:
            basecall = basecall[::-1]
            quality = quality[::-1]
        return BasecallResult(
            uuid=rt.uuid,
            score=float(score),
            basecall=basecall,
            quality=quality,
            nblock=nblock,
            nsample=rt.n,
            trim_start=rt.start,
            trim_end=rt.end,
            trace=trace[: nblock + 1] if self.compute_trace else None,
            signal=rt.active().copy(),
        )
