"""PyTorch port on the CPU: ``io/crp.py`` against the JAX package's.

``write_crp`` gives the JAX writer's bytes on seeded float32 matrices
(normal values, -0.0, subnormals, the extremes, +-inf and NaN) and on a
1-D input; each package's ``read_crp`` reads either file back to the same
bits; a column of the wrong length raises in both.
"""

from __future__ import annotations

import numpy as np
import pytest

from flappie_tpu.io import crp as j_crp

from flappie_tpu_torch.io import crp as p_crp


def _matrix(case: str) -> np.ndarray:
    rng = np.random.default_rng(41)
    if case == "normal":
        return rng.standard_normal((7, 13)).astype(np.float32)
    if case == "special":
        fi = np.finfo(np.float32)
        vals = np.array([0.0, -0.0, fi.tiny, -fi.tiny, fi.smallest_subnormal,
                         -3 * fi.smallest_subnormal, fi.max, -fi.max, np.inf, -np.inf,
                         np.nan, 1.0, -1.5, 2.0 ** -140], np.float32)
        return np.stack([vals, rng.permutation(vals)])
    if case == "1d":
        return (rng.standard_normal(9) * 1e-3).astype(np.float32)
    return rng.standard_normal((1, 1)).astype(np.float32)  # "one"


@pytest.mark.parametrize("case", ["normal", "special", "1d", "one"])
def test_write_crp_matches_jax_bytes_and_reads_back(tmp_path, case):
    mat = _matrix(case)
    ours, theirs = tmp_path / "port.crp", tmp_path / "jax.crp"
    assert p_crp.write_crp(str(ours), mat) == j_crp.write_crp(str(theirs), mat) == mat.size
    assert ours.read_bytes() == theirs.read_bytes()
    want = mat.reshape(mat.shape[0], -1).view(np.uint32)
    for reader in (p_crp.read_crp, j_crp.read_crp):
        for path in (ours, theirs):
            got = reader(str(path))
            assert got.dtype == np.float32
            np.testing.assert_array_equal(got.view(np.uint32), want)


def test_read_crp_rejects_a_short_column(tmp_path):
    bad = tmp_path / "bad.crp"
    bad.write_text("3\t2\n0x1p+0\t0x1p+1\t0x1p+2\n0x1p+0\t0x1p+1\n")
    for reader in (p_crp.read_crp, j_crp.read_crp):
        with pytest.raises(ValueError, match="column 1 has 2 values, expected 3"):
            reader(str(bad))
