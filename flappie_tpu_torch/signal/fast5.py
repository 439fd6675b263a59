"""fast5 (HDF5) raw-signal reading.

Mirrors the reference reader semantics (src/fast5_interface.c:231-318):
the first read group under ``/Raw/Reads/`` is taken, its ``read_id``
attribute is the uuid, and the int16 ``Signal`` dataset is converted to
float32 and scaled to pA as ``(raw + offset) * range / digitisation``
using the ``/UniqueGlobalKey/channel_id`` attributes.

Additionally supports multi-read fast5 files (top-level ``read_*``
groups), which the reference does not handle (RUNNIE.md:109) - each read
carries its own ``channel_id`` group (``iter_reads``, CLI ``--multi``).

A copy of the JAX package's fast5 module.  Where h5py is not installed,
files are written and read through the minimal HDF5 codec in
hdf5_min.py, which reads contiguous datasets and chunked ones under the
shuffle and deflate filters only: a dataset under any other filter (lzf,
VBZ) anywhere in a file makes the whole file unreadable (read_raw
returns an invalid read, iter_reads raises, and the CLIs report the file
as "No basecall returned").
"""

from __future__ import annotations

from typing import Iterator, List

import numpy as np

try:
    import h5py
except ImportError:  # hdf5_min.py takes its place
    h5py = None

from .preprocess import F32, RawTable


def _decode_attr(val) -> str:
    if isinstance(val, bytes):
        return val.decode("utf-8")
    return str(val)


def _scale_signal(sig: np.ndarray, channel_attrs, scale_to_pA: bool):
    """Returns (pA float32 signal, int16 ADC or None, (offset, raw_unit)).

    The ADC counts + calibration ride along on the RawTable so the
    device can rebuild the normalised signal from half the upload bytes
    (basecall._unpack_i16); kept only when the source samples are
    integral int16, as real fast5 Signal datasets are."""
    raw = sig.astype(F32)
    adc = None
    cal = None
    if scale_to_pA:
        digitisation = F32(channel_attrs["digitisation"])
        offset = F32(channel_attrs["offset"])
        rng = F32(channel_attrs["range"])
        raw_unit = rng / digitisation  # float32 divide, as reference
        raw = (raw + offset) * raw_unit
        if np.issubdtype(sig.dtype, np.integer) and sig.dtype.itemsize <= 2:
            adc = np.ascontiguousarray(sig, dtype=np.int16)
            cal = (offset, raw_unit)
    return raw, adc, cal


def _chaos() -> bool:
    """Fault injection (reference CHAOSMONKEY, src/flappie_stdlib.h:18-35):
    with FLAPPIE_TPU_CHAOS=p set, each read_raw fails with probability p,
    exercising the per-read fault isolation (flappie_tpu/signal/fast5.py:
    56-64)."""
    import os
    import random

    p = os.environ.get("FLAPPIE_TPU_CHAOS")
    return p is not None and random.random() < float(p)


def read_raw(filename: str, scale_to_pA: bool = True) -> RawTable:
    """Read the first read of a single-read fast5 file.

    Returns an invalid RawTable (raw=None) on any failure, matching the
    reference's NULL-propagation fault isolation (and at random under
    FLAPPIE_TPU_CHAOS).
    """
    if _chaos():
        return RawTable(None, 0, 0, 0, None)
    if h5py is None:
        return _read_raw_min(filename, scale_to_pA)
    try:
        with h5py.File(filename, "r") as f:
            reads = f.get("/Raw/Reads")
            if reads is None or len(reads) == 0:
                return RawTable(None, 0, 0, 0, None)
            name = sorted(reads.keys())[0]
            grp = reads[name]
            uuid = _decode_attr(grp.attrs["read_id"])
            sig = grp["Signal"][()]
            raw, adc, cal = _scale_signal(
                sig, f["/UniqueGlobalKey/channel_id"].attrs, scale_to_pA
            )
            return RawTable(uuid, raw.size, 0, raw.size, raw, adc=adc, cal=cal)
    except Exception:
        return RawTable(None, 0, 0, 0, None)


def _read_raw_min(filename: str, scale_to_pA: bool) -> RawTable:
    """read_raw through the minimal HDF5 codec (no h5py)."""
    from . import hdf5_min

    try:
        root = hdf5_min.read(filename)
        reads = root.get("/Raw/Reads")
        if reads is None or not reads.children:
            return RawTable(None, 0, 0, 0, None)
        grp = reads.children[sorted(reads.children)[0]]
        uuid = _decode_attr(grp.attrs["read_id"])
        raw, adc, cal = _scale_signal(
            grp.children["Signal"].data,
            root.get("/UniqueGlobalKey/channel_id").attrs, scale_to_pA,
        )
        return RawTable(uuid, raw.size, 0, raw.size, raw, adc=adc, cal=cal)
    except Exception:
        return RawTable(None, 0, 0, 0, None)


def iter_reads(filename: str, scale_to_pA: bool = True) -> Iterator[RawTable]:
    """Iterate all reads in a fast5 file (single- or multi-read layout).

    A single-read file yields read_raw's read when it is valid; a
    multi-read file yields each ``read_*`` group in sorted order, and a
    group that fails to read is skipped.  A file that is not HDF5 raises."""
    if h5py is None:
        yield from _iter_reads_min(filename, scale_to_pA)
        return
    with h5py.File(filename, "r") as f:
        if "Raw" in f:  # single-read layout
            rt = read_raw(filename, scale_to_pA)
            if rt.valid:
                yield rt
            return
        for name in sorted(f.keys()):
            if not name.startswith("read_"):
                continue
            grp = f[name]
            try:
                raw_grp = grp["Raw"]
                uuid = _decode_attr(raw_grp.attrs.get("read_id", name[len("read_") :]))
                sig = raw_grp["Signal"][()]
                raw, adc, cal = _scale_signal(sig, grp["channel_id"].attrs, scale_to_pA)
            except Exception:
                continue
            yield RawTable(uuid, raw.size, 0, raw.size, raw, adc=adc, cal=cal)


def _iter_reads_min(filename: str, scale_to_pA: bool) -> Iterator[RawTable]:
    """iter_reads through the minimal HDF5 codec (no h5py)."""
    from . import hdf5_min

    root = hdf5_min.read(filename)
    if "Raw" in root.children:  # single-read layout
        rt = _read_raw_min(filename, scale_to_pA)
        if rt.valid:
            yield rt
        return
    for name in sorted(root.children):
        if not name.startswith("read_"):
            continue
        grp = root.children[name]
        try:
            raw_grp = grp.children["Raw"]
            uuid = _decode_attr(raw_grp.attrs.get("read_id", name[len("read_") :]))
            raw, adc, cal = _scale_signal(raw_grp.children["Signal"].data,
                                          grp.children["channel_id"].attrs, scale_to_pA)
        except Exception:
            continue
        yield RawTable(uuid, raw.size, 0, raw.size, raw, adc=adc, cal=cal)


def list_read_ids(filename: str) -> List[str]:
    return [rt.uuid for rt in iter_reads(filename, scale_to_pA=False)]


def write_single_read_fast5(
    filename: str,
    signal: np.ndarray,
    read_id: str,
    digitisation: float = 8192.0,
    offset: float = 16.0,
    range_: float = 1373.41,
    sampling_rate: float = 4000.0,
    read_number: int = 1,
) -> None:
    """Write a single-read fast5 with the layout the reference reads.

    Used by tests and benchmarks: the bundled reads/ fast5 files are
    git-LFS pointers in this checkout, so real fast5 inputs are
    synthesised from the bundled .crp signal fixtures.  ``signal`` is in
    ADC units (typically int16 range).
    """
    sig = np.asarray(signal)
    if sig.dtype.kind == "f":
        sig = np.round(sig).astype(np.int16)
    if h5py is None:
        from . import hdf5_min

        read = hdf5_min.Node(
            attrs={"read_id": np.bytes_(read_id), "read_number": np.int32(read_number)},
            children={"Signal": hdf5_min.Node(data=np.asarray(sig, np.int16))},
        )
        channel = hdf5_min.Node(attrs={
            "digitisation": np.float64(digitisation), "offset": np.float64(offset),
            "range": np.float64(range_), "sampling_rate": np.float64(sampling_rate),
            "channel_number": np.bytes_("1"),
        })
        hdf5_min.write(filename, hdf5_min.Node(children={
            "Raw": hdf5_min.Node(children={"Reads": hdf5_min.Node(
                children={f"Read_{read_number}": read})}),
            "UniqueGlobalKey": hdf5_min.Node(children={"channel_id": channel}),
        }))
        return
    with h5py.File(filename, "w") as f:
        grp = f.create_group(f"/Raw/Reads/Read_{read_number}")
        grp.attrs["read_id"] = np.bytes_(read_id)
        grp.attrs["read_number"] = np.int32(read_number)
        grp.create_dataset("Signal", data=sig, dtype=np.int16)
        ch = f.create_group("/UniqueGlobalKey/channel_id")
        ch.attrs["digitisation"] = np.float64(digitisation)
        ch.attrs["offset"] = np.float64(offset)
        ch.attrs["range"] = np.float64(range_)
        ch.attrs["sampling_rate"] = np.float64(sampling_rate)
        ch.attrs["channel_number"] = np.bytes_("1")
