"""Chunked training data pipeline (counterpart of
flappie_tpu/train/data.py).

Long (signal, block-path) pairs are cut into fixed-size signal chunks
with their aligned target base sub-sequences, then shuffled into
static-shape batches for the CTC step (train/ctc.py).  Chunk boundaries
reset the flip/flop parity: each chunk's targets are re-encoded on their
own with flipflop_encode.  Everything here is numpy except the teacher's
labelling, which runs the port's network and Viterbi decode.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator, List, Sequence, Tuple

import numpy as np
import torch

from ..models.network import transitions
from ..ops.crf_bm import decode_bm
from .ctc import flipflop_encode
from .trainer import to_device

F32 = np.float32


def path_to_bases(path: np.ndarray, nblocks: int, nbase: int) -> np.ndarray:
    """Collapse a block state path into the base sequence it calls: a
    base at every position in [1, nblocks) where the state changes, read
    as state % nbase (src/decode.c:66-79, src/flappie.c:284-297)."""
    p = np.asarray(path)[:nblocks]
    change = np.nonzero(p[1:] != p[:-1])[0] + 1
    return (p[change] % nbase).astype(np.int32)


@dataclass(frozen=True)
class ChunkExample:
    signal: np.ndarray  # [<=chunk] float32
    bases: np.ndarray  # [<=Lmax] int32 target bases


def chunk_examples(
    signal: np.ndarray,
    block_path: np.ndarray,
    stride: int,
    chunk: int,
    nbase: int = 4,
    min_bases: int = 2,
) -> List[ChunkExample]:
    """Cut one mapped read into non-overlapping training chunks."""
    chunk -= chunk % stride
    out = []
    n = signal.shape[0]
    for s in range(0, n, chunk):
        sig = np.asarray(signal[s : s + chunk], F32)
        nblk = -(-sig.shape[0] // stride)
        g0 = s // stride
        bases = path_to_bases(block_path[g0 : g0 + nblk + 1], nblk + 1, nbase)
        if bases.size >= min_bases and sig.size >= stride * min_bases:
            out.append(ChunkExample(sig, bases))
    return out


def batches(
    examples: Sequence[ChunkExample],
    chunk: int,
    batch: int,
    nbase: int = 4,
    seed: int = 0,
    epochs: int = 1,
    drop_last: bool = False,
) -> Iterator[Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]]:
    """Shuffled static-shape batches: (signal [B, chunk], lengths [B],
    states [B, L] flip-flop codes, target_lengths [B]); L is the
    dataset-wide maximum."""
    if not examples:
        return
    L = max(e.bases.size for e in examples)
    rng = np.random.default_rng(seed)
    for _ in range(epochs):
        order = rng.permutation(len(examples))
        for ofs in range(0, len(order), batch):
            sel = order[ofs : ofs + batch]
            if drop_last and sel.size < batch:
                continue
            B = batch
            sig = np.zeros((B, chunk), F32)
            lengths = np.zeros(B, np.int32)
            targets = np.zeros((B, L), np.int32)
            tlen = np.ones(B, np.int32)  # padded rows: 1 dummy base
            for j, i in enumerate(sel):
                e = examples[i]
                sig[j, : e.signal.size] = e.signal
                lengths[j] = e.signal.size
                targets[j, : e.bases.size] = e.bases
                tlen[j] = e.bases.size
            states = flipflop_encode(targets, tlen, nbase)
            yield sig, lengths, states.astype(np.int32), tlen


def viterbi_paths(cfg, params, signals: Sequence[np.ndarray], device=None,
                  batch: int = 16) -> List[np.ndarray]:
    """Teacher labels: each signal's Viterbi block path [nblocks + 1]
    int32 under ``params`` (a tree of tensors, or of numpy arrays that
    go to ``device``: trainer.to_device), through ``transitions`` and
    ``decode_bm(viterbi_only=True)``, in zero-padded batches of
    ``batch`` signals."""
    params = to_device(params, device)
    dev = next(iter(params["ff"].values())).device
    out = []
    with torch.no_grad():
        for ofs in range(0, len(signals), batch):
            part = signals[ofs : ofs + batch]
            T = max(s.size for s in part)
            sig = np.zeros((len(part), T), F32)
            for j, s in enumerate(part):
                sig[j, : s.size] = s
            lengths = torch.as_tensor([s.size for s in part], dtype=torch.int32, device=dev)
            trans, nblocks = transitions(params, cfg, torch.from_numpy(sig).to(dev), lengths)
            _, path, _, _ = decode_bm(trans, nblocks, cfg.nbase, viterbi_only=True,
                                      compute_trace=False)
            path, nblocks = path.cpu().numpy(), nblocks.cpu().numpy()
            out += [path[j, : nblocks[j] + 1] for j in range(len(part))]
    return out


def teacher_dataset(cfg, teacher_params, n_reads: int, read_len: int, chunk: int,
                    seed: int = 0, device=None) -> List[ChunkExample]:
    """Synthetic-teacher mapped reads: random signals labelled by the
    teacher's own Viterbi paths (self-consistent targets a student can
    converge to).  Returns chunk examples."""
    rng = np.random.default_rng(seed)
    signals = rng.normal(size=(n_reads, read_len)).astype(F32)
    paths = viterbi_paths(cfg, teacher_params, list(signals), device, batch=n_reads)
    out = []
    for i in range(n_reads):
        out.extend(chunk_examples(signals[i], paths[i], cfg.total_stride, chunk, cfg.nbase))
    return out
