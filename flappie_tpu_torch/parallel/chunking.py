"""Chunked long-read processing (overlap + stitch).

The reference runs each recurrence over the entire read in one
sequential pass - its scalability wall (no chunking, no
overlap-stitching).  The answer to very long reads is the
sequence-parallel analogue used by modern basecallers: split the signal
into fixed-size overlapping chunks, run the network over all chunks as
one batch (turning read length into batch parallelism), then stitch the
per-chunk CRF transition weights back into one full-length matrix at
overlap midpoints and decode globally.

The recurrent layers' state decays over a few hundred samples, so with
an overlap comfortably above the effective context the stitched
transition weights match the full-read forward pass away from chunk
borders; decode (Viterbi / forward-backward) then runs on the stitched
matrix exactly as for a short read.  The full-read path remains the
parity path; chunking is the fast/scalable path.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Tuple

import numpy as np

F32 = np.float32

@dataclass(frozen=True)
class ChunkPlan:
    nsample: int
    stride: int
    chunk: int  # samples per chunk
    step: int  # samples between chunk starts (chunk - overlap)
    starts: Tuple[int, ...]  # chunk start samples
    cuts: Tuple[int, ...]  # global block boundaries per chunk (len = nchunk+1)

    @property
    def nchunk(self) -> int:
        return len(self.starts)

    @property
    def nblocks(self) -> int:
        return self.cuts[-1]


def plan_chunks(nsample: int, stride: int, chunk: int = 16000, overlap: int = 2000) -> ChunkPlan:
    """Chunk layout for one read.

    chunk and (chunk - overlap) must be multiples of the model stride so
    chunk-local blocks align with global blocks.
    """
    chunk -= chunk % stride
    step = chunk - overlap
    step -= step % stride
    if step <= 0:
        raise ValueError(f"overlap {overlap} must be smaller than chunk {chunk}")
    if nsample <= chunk:
        starts: Tuple[int, ...] = (0,)
    else:
        starts = tuple(range(0, nsample - overlap, step))
        # drop a trailing start that would yield an all-overlap chunk
        if len(starts) > 1 and starts[-1] + overlap >= nsample:
            starts = starts[:-1]

    total_blocks = -(-nsample // stride)
    cuts = [0]
    for i in range(1, len(starts)):
        # boundary at the midpoint of the overlap between chunks i-1, i
        mid = starts[i] + (starts[i - 1] + chunk - starts[i]) // 2
        cuts.append(min(mid // stride, total_blocks))
    cuts.append(total_blocks)
    return ChunkPlan(nsample, stride, chunk, step, starts, tuple(cuts))


def extract_chunks(seg: np.ndarray, plan: ChunkPlan) -> Tuple[np.ndarray, np.ndarray]:
    """[nsample] -> (chunks [N, chunk] zero-padded, lengths [N])."""
    N = plan.nchunk
    out = np.zeros((N, plan.chunk), F32)
    lengths = np.zeros(N, np.int32)
    for i, s in enumerate(plan.starts):
        piece = seg[s : s + plan.chunk]
        out[i, : piece.size] = piece
        lengths[i] = piece.size
    return out, lengths


@dataclass(frozen=True)
class ChunkRecord:
    """One chunk's slice and ownership ranges (all block units global
    unless noted).

    The production chunked path decodes each chunk independently and
    stitches the decoded *paths* at the overlap-midpoint cuts (the
    standard long-read strategy modern basecallers use; the reference
    instead scans whole reads serially, src/networks.c:557-580, which
    is its scalability wall).  Each chunk owns global blocks
    [keep_lo, keep_hi); the last chunk also provides the final
    fencepost path entry.  [qlo, qhi) is the chunk-LOCAL qpath index
    range whose sum is the chunk's contribution to the read score
    (transitions into the owned blocks; global q index g maps to local
    g - g0, and index 0 -- the reference's qpath[0]=NaN quirk -- is
    never summed).
    """

    start: int  # first sample
    length: int  # valid samples in this chunk
    g0: int  # global block index of local block 0
    keep_lo: int
    keep_hi: int
    qlo: int  # local
    qhi: int  # local
    last: bool


def chunk_records(plan: ChunkPlan) -> List[ChunkRecord]:
    recs = []
    n = plan.nchunk
    for i, s in enumerate(plan.starts):
        g0 = s // plan.stride
        last = i == n - 1
        lo, hi = plan.cuts[i], plan.cuts[i + 1]
        recs.append(
            ChunkRecord(
                start=s,
                length=min(plan.chunk, plan.nsample - s),
                g0=g0,
                keep_lo=lo,
                keep_hi=hi,
                qlo=max(1, lo - g0),
                qhi=hi - g0 + (1 if last else 0),
                last=last,
            )
        )
    return recs



def stitch_trans(trans_chunks: np.ndarray, plan: ChunkPlan) -> np.ndarray:
    """Per-chunk transition weights [N, TB, P] -> full read [nblocks, P].

    Chunk i contributes global blocks [cuts[i], cuts[i+1]); its local
    block b maps to global block starts[i]//stride + b.
    """
    P = trans_chunks.shape[-1]
    out = np.zeros((plan.nblocks, P), trans_chunks.dtype)
    for i in range(plan.nchunk):
        g0 = plan.starts[i] // plan.stride
        lo, hi = plan.cuts[i], plan.cuts[i + 1]
        out[lo:hi] = trans_chunks[i, lo - g0 : hi - g0]
    return out
