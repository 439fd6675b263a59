"""The runnie ``.run`` text format and its post-processing to FASTA.

A host copy of flappie_tpu/io/run_format.py (the port imports nothing of
that package).

Writer (src/runnie.c:277-311): per read a ``# uuid`` line followed by
one ``base\\tshape\\tscale\\tdwell`` line per called base (C %f / %d
formatting).

Post-processor (misc/decode_runnie.py): expands run-length-compressed
calls into FASTA using the mode of the continuous Weibull
(``max(1, floor(scale * scale_factor[base]))``) with per-base fudge
factors, or emits the compressed sequence directly (--rlc).
"""

from __future__ import annotations

from typing import Iterable, Iterator, List, Optional, Sequence, TextIO, Tuple

import numpy as np

from ..decode.runlength import BASES, RunRecord

DEFAULT_SCALE = (1.02, 1.04, 1.04, 1.02)
DEFAULT_SHAPE = (1.00, 1.00, 1.00, 1.00)


def write_run_record(fh: TextIO, uuid: str, runs: Sequence[RunRecord]) -> None:
    fh.write(f"# {uuid}\n")
    for r in runs:
        fh.write(f"{r.base}\t{r.shape:f}\t{r.scale:f}\t{r.dwell:d}\n")


def read_run_records(fh: Iterable[str]) -> Iterator[Tuple[str, List[List[str]]]]:
    """Parse a .run stream into (read_name, rows) pairs
    (misc/decode_runnie.py:95-106)."""
    name: Optional[str] = None
    data: List[List[str]] = []
    first = True
    for line in fh:
        if line.startswith("#"):
            if not first:
                yield name, data
            first = False
            name = line[2:-1]
            data = []
        else:
            data.append(line.split("\t"))
    if not first:
        yield name, data


def run_estimate_modes(shape: np.ndarray, scale: np.ndarray) -> np.ndarray:
    """Run length via the mode of the continuous Weibull
    (misc/decode_runnie.py:69-73): max(1, floor(scale))."""
    return np.maximum(1, np.floor(scale)).astype(int)


def runlength_basecall(
    rows: List[List[str]],
    shapef: Sequence[float] = DEFAULT_SHAPE,
    scalef: Sequence[float] = DEFAULT_SCALE,
) -> Optional[str]:
    """misc/decode_runnie.py:77-92."""
    if len(rows) == 0:
        return None
    base_idx = np.array([BASES.index(r[0]) for r in rows], dtype=np.int32)
    shape = np.array([float(r[1]) for r in rows])
    scale = np.array([float(r[2]) for r in rows])
    shapef = np.asarray(shapef, dtype=np.float64)
    scalef = np.asarray(scalef, dtype=np.float64)
    runlen = run_estimate_modes(shape * shapef[base_idx], scale * scalef[base_idx])
    return "".join(BASES[b] * r for b, r in zip(base_idx, runlen))


def rlc_basecall(rows: List[List[str]]) -> Optional[str]:
    """--rlc mode: the run-length-compressed sequence itself."""
    if len(rows) == 0:
        return None
    return "".join(r[0] for r in rows)


def wrap_fasta(name: str, seq: str, width: int = 60) -> str:
    body = "\n".join(seq[i : i + width] for i in range(0, len(seq), width))
    return f">{name}\n{body}\n"
