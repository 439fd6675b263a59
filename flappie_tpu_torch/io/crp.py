"""Reader/writer for the reference ``.crp`` hex-float matrix text format.

A copy of the JAX package's crp module (reference
src/test/flappie_util.c:30-142): a header line ``nr\tnc`` followed by one
line per *column*, each containing ``nr`` C99 hex-floats (``%a``)
separated by tabs.  Hex-float serialisation is bit-stable, which is what
makes the bundled signal fixtures usable as bit-exact goldens.

Matrices are returned as numpy float32 arrays of shape ``(nc, nr)``
(row-per-column, i.e. time-major), the [T, C] layout of the pipeline.
"""

from __future__ import annotations

import numpy as np


def read_crp(path: str) -> np.ndarray:
    """Read a .crp file -> float32 array of shape (nc, nr)."""
    with open(path, "r") as fh:
        header = fh.readline().split()
        nr, nc = int(header[0]), int(header[1])
        out = np.empty((nc, nr), dtype=np.float32)
        for c in range(nc):
            vals = fh.readline().split()
            if len(vals) != nr:
                raise ValueError(f"{path}: column {c} has {len(vals)} values, expected {nr}")
            out[c] = [np.float32(float.fromhex(v)) for v in vals]
    return out


def write_crp(path: str, mat: np.ndarray) -> int:
    """Write a (nc, nr) float32 array as .crp (a 1-D array is nc columns
    of one value).  Returns the elements written."""
    mat = np.asarray(mat, dtype=np.float32)
    if mat.ndim == 1:
        mat = mat[:, None]
    nc, nr = mat.shape
    with open(path, "w") as fh:
        fh.write(f"{nr}\t{nc}\n")
        for c in range(nc):
            fh.write("\t".join(float(v).hex() for v in mat[c]))
            fh.write("\n")
    return nr * nc
