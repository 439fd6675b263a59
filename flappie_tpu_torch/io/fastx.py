"""FASTA/FASTQ/SAM output, byte-compatible with the reference.

Format strings are transcribed from src/flappie_output.c:92-133
including the quirks:

- the header metadata is JSON-ish with the reference's exact spacing
  (two spaces after the read name, double spaces before "nblock" and
  "sequence_length");
- floats are printed as C "%f" (6 decimal places) of values computed in
  float32 exactly as the C expression does;
- SAM records print sequence and quality TWICE: once inside the format
  string and once again via fprint_string (flappie_output.c:124-133) -
  reproduced for byte parity.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np

F32 = np.float32


@dataclass
class BasecallResult:
    """Mirror of _raw_basecall_info (src/flappie_structures.h:24-35)."""

    uuid: Optional[str]
    score: float
    basecall: str
    quality: Optional[str]
    nblock: int
    nsample: int
    trim_start: int
    trim_end: int
    trace: Optional[np.ndarray] = None  # [nblock+1, nstate] uint8
    signal: Optional[np.ndarray] = None  # trimmed, normalised signal

    @property
    def basecall_length(self) -> int:
        return len(self.basecall)


OUTFORMATS = ("fasta", "fastq", "sam")


def _cfloat(x) -> str:
    """C printf %f of a float32 value (promoted to double)."""
    v = float(F32(x))
    if np.isnan(v):
        return "nan" if not np.signbit(v) else "-nan"
    if np.isinf(v):
        return "inf" if v > 0 else "-inf"
    return f"{v:f}"


def _header_json(readname: str, res: BasecallResult) -> str:
    nblock = res.nblock
    norm_score = _cfloat(F32(-res.score) / F32(nblock)) if nblock else "nan"
    bpb = _cfloat(
        np.divide(F32(nblock), F32(res.basecall_length))
        if res.basecall_length
        else np.float64("inf")
    )
    return (
        f'{{ "filename" : "{readname}", "uuid" : "{res.uuid}", '
        f'"normalised_score" : {norm_score},  "nblock" : {nblock},  '
        f'"sequence_length" : {res.basecall_length},  '
        f'"blocks_per_base" : {bpb}, "nsample" : {res.nsample}, '
        f'"trim" : [ {res.trim_start}, {res.trim_end} ] }}'
    )


def format_fasta(uuid: str, readname: str, uuid_primary: bool, prefix: str, res: BasecallResult) -> str:
    name = uuid if uuid_primary else readname
    return f">{prefix}{name}  {_header_json(readname, res)}\n{res.basecall}\n"


def format_fastq(uuid: str, readname: str, uuid_primary: bool, prefix: str, res: BasecallResult) -> str:
    if res.quality is None:
        raise ValueError("Can't output fastq for reads without quality values")
    name = uuid if uuid_primary else readname
    return (
        f"@{prefix}{name}  {_header_json(readname, res)}\n"
        f"{res.basecall}\n+\n{res.quality}\n"
    )


def format_sam(uuid: str, readname: str, uuid_primary: bool, prefix: str, res: BasecallResult) -> str:
    name = uuid if uuid_primary else readname
    qual = res.quality if res.quality is not None else ""
    # Reference quirk: fprintf_sam prints seq+qual in the record AND
    # repeats them on a second line (flappie_output.c:127-132).
    return (
        f"{prefix}{name}\t4\t*\t0\t0\t*\t*\t0\t0\t{res.basecall}\t{qual}\n"
        f"{res.basecall}\t{qual}\n"
    )


FORMATTERS = {"fasta": format_fasta, "fastq": format_fastq, "sam": format_sam}


def format_read(outformat: str, uuid: str, readname: str, uuid_primary: bool, prefix: str, res: BasecallResult) -> str:
    try:
        fmt = FORMATTERS[outformat]
    except KeyError:
        raise ValueError(f"Invalid output format {outformat!r}")
    return fmt(uuid, readname, uuid_primary, prefix, res)
