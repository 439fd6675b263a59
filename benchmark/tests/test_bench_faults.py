"""The comparison that decides ``correct`` fails what it must: the
control (the reference in TF32, one precision below the configuration's,
in the program's place), and a run whose timed path is broken
underneath (an answer altered where it is produced; half of a batch's
rows left out).  The cells run one chip and no training step, so the
faults of a state left unchanged and of the exchange between chips do
not arise."""

import io
import json
import shutil
import tempfile

import numpy as np
import pytest

from benchmark.harness import cell as cell_mod
from benchmark.harness import check, spec
from benchmark.tests.conftest import shrink

CELLS = ["r941_native.offline", "r941_5mC.offline"]


def _run(workload, seed=2 ** 31 + 5):
    out = io.StringIO()
    assert cell_mod.run(workload, seed, 1.0, False, device="cpu", adjust=shrink, out=out) == 0
    return json.loads(out.getvalue().strip().splitlines()[-1])


@pytest.mark.parametrize("workload", CELLS)
def test_control_fails(workload):
    """The reference in TF32 against the float32 reference, on the reads
    a run samples, at a size this test holds: outside the cell's limits."""
    cell = spec.load(workload)
    shrink(cell, reads=12)
    tmp = tempfile.mkdtemp()
    try:
        inputs, params, loop = cell_mod.prepare(cell, 9, "cpu", tmp, 0)
        win = loop.window(0.0)
        idx = loop.sample(win, 9)
        loop.close()
        want = cell_mod.reference_records(cell, inputs, params, idx, "cpu")
        low = cell_mod.reference_records(cell, inputs, params, idx, "cpu", "tf32")
        numbers = check.compare(low, want)
        assert not check.verdict(numbers, cell.limits), numbers
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


@pytest.mark.parametrize("workload", CELLS)
def test_altered_answer_fails(workload, monkeypatch):
    """One base of every read changed where the program produces it."""
    from flappie_tpu_torch import basecall

    plain = basecall.path_to_basecall

    def altered(*a, **k):
        seq, qual = plain(*a, **k)
        return ("T" if seq[:1] != "T" else "A") + seq[1:], qual

    monkeypatch.setattr(basecall, "path_to_basecall", altered)
    assert _run(workload)["correct"] is False


@pytest.mark.parametrize("workload", CELLS)
def test_half_the_batch_left_out_fails(workload, monkeypatch):
    """The second half of every batch's rows dropped: their paths and
    scores zeroed where the batch's outputs are unpacked."""
    from flappie_tpu_torch import basecall

    plain = basecall._unpack_chunk_outputs

    def half(*a, **k):
        score, path, qchar, nblocks, trace = plain(*a, **k)
        score, path = np.array(score), np.array(path)
        h = (len(path) + 1) // 2
        path[h:] = 0
        score[h:] = 0.0
        return score, path, qchar, nblocks, trace

    monkeypatch.setattr(basecall, "_unpack_chunk_outputs", half)
    assert _run(workload)["correct"] is False


def test_sound_run_passes():
    assert _run("r941_native.offline")["correct"] is True
