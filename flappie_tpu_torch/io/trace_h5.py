"""Trace/summary HDF5 output, format-compatible with the reference.

A copy of the JAX package's trace writer (reference
src/fast5_interface.c:59-197,320-349).  Per-read group (named by uuid or
read filename) containing:
- ``signal``: float32 [nsample] - the trimmed (normalised) signal
- ``trace``: uint8 [nblk+1, nstate] - state occupancy probabilities x255

Both datasets use gzip+shuffle chunked compression when
compression_level > 0 (chunk = (chunk_size,) / (chunk_size, nstate)).

Through h5py where it is installed, with the JAX package's own calls;
otherwise through signal/hdf5_min.py, which writes the same layout:
the groups are collected and the file is written at ``close()``, after
the groups of an existing file (read with hdf5_min) that this run does
not replace.  A file hdf5_min cannot read raises and is left as it is.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

try:
    import h5py
except ImportError:  # hdf5_min.py takes its place
    h5py = None

from ..signal import hdf5_min
from .fastx import BasecallResult


class TraceWriter:
    """Equivalent of open_or_create_hdf5 + write_summary."""

    def __init__(self, filename: Optional[str], chunk_size: int = 200, compression_level: int = 1):
        self.filename = filename
        self.chunk_size = chunk_size
        self.compression_level = compression_level
        self._fh = self._root = None
        if filename and h5py is not None:
            self._fh = h5py.File(filename, "a")
        elif filename:
            self._root = hdf5_min.read(filename) if os.path.exists(filename) else hdf5_min.Node()

    def write(self, readname: str, res: BasecallResult) -> None:
        if res.trace is None or (self._fh is None and self._root is None):
            return
        sig = np.asarray(res.signal, np.float32)
        trace = np.asarray(res.trace, np.uint8)
        if self._root is not None:
            self._write_min(readname, sig, trace)
            return
        if readname in self._fh:  # re-run into an existing file, or a
            del self._fh[readname]  # duplicated read id: last write wins
        grp = self._fh.create_group(readname)
        kw = {}
        if self.compression_level > 0:
            kw = dict(compression="gzip", compression_opts=self.compression_level, shuffle=True)
        grp.create_dataset(
            "signal",
            data=sig,
            dtype="<f4",
            chunks=(min(self.chunk_size, max(sig.size, 1)),) if kw else None,
            **kw,
        )
        grp.create_dataset(
            "trace",
            data=trace,
            dtype="<u1",
            chunks=(min(self.chunk_size, trace.shape[0]), trace.shape[1]) if kw else None,
            **kw,
        )

    def _write_min(self, readname: str, sig: np.ndarray, trace: np.ndarray) -> None:
        kw = {}
        if self.compression_level > 0:
            kw = dict(compression=self.compression_level, shuffle=True)
        self._root.children[readname] = hdf5_min.Node(children={  # last write wins
            "signal": hdf5_min.Node(
                data=sig, chunks=(min(self.chunk_size, max(sig.size, 1)),) if kw else None, **kw),
            "trace": hdf5_min.Node(
                data=trace,
                chunks=(min(self.chunk_size, trace.shape[0]), trace.shape[1]) if kw else None,
                **kw),
        })

    def close(self):
        if self._fh is not None:
            self._fh.close()
            self._fh = None
        if self._root is not None:
            # a whole new file beside the old one, then swapped in
            tmp = f"{self.filename}.tmp{os.getpid()}"
            try:
                hdf5_min.write(tmp, self._root)
                os.replace(tmp, self.filename)
            finally:
                if os.path.exists(tmp):
                    os.remove(tmp)
            self._root = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
