"""On the card (skips without one): a short run of each cell (the result
line's shape, ``correct``, the trace's device numbers), and the
reference's float32 whatever TF32 setting the process left."""

import io
import json
import os

import numpy as np
import pytest
import torch

from benchmark.harness import cell as cell_mod
from benchmark.harness import fast5, spec
from benchmark.reference import flipflop, flipflop_weights

CELLS = ["r941_native.offline", "r941_5mC.offline"]


@pytest.mark.cuda
@pytest.mark.parametrize("workload", CELLS)
@pytest.mark.parametrize("trace", [False, True])
def test_cell_on_the_card(card, workload, trace):
    out = io.StringIO()
    assert cell_mod.run(workload, 2 ** 31 + 99, 5.0, trace, out=out) == 0
    res = json.loads(out.getvalue().strip().splitlines()[-1])
    assert res["correct"] is True and res["failed"] == 0
    assert res["device"]["platform"] == "gpu" and res["device"]["kind"] == card
    assert list(res)[-1] == "check"
    if trace:
        assert 0 < res["device"]["busy_s"] <= res["device"]["window_s"]
        assert len(res["breakdown"]["device_ops"]) <= 10
        for name, m in res["metrics"].items():
            if "roofline" in name or "mfu" in name:
                assert 0 < m["value"] <= 100
    else:
        assert "setup_s" in res["metrics"]


@pytest.mark.cuda
def test_reference_float32_whatever_tf32_was(card, monkeypatch):
    """TF32 switched on before the reference runs leaves its records as
    they are with TF32 off, and is on again after."""
    cfg = json.load(open(os.path.join(spec.BENCH_DIR, "configs", "r941_native.json")))
    params = flipflop_weights.make(cfg["widths"], 2 ** 31 + 3, "cuda")
    rng = np.random.default_rng(4)
    reads = [(f"{i:08x}-0000-4000-8000-000000000000", fast5.synthetic_adc(n, rng))
             for i, n in enumerate([40000, 9000])]
    for flag in (torch.backends.cuda.matmul, torch.backends.cudnn):
        monkeypatch.setattr(flag, "allow_tf32", False)
    off = flipflop.records(cfg, reads, fast5.CHANNEL, params, "cuda")
    for flag in (torch.backends.cuda.matmul, torch.backends.cudnn):
        monkeypatch.setattr(flag, "allow_tf32", True)
    on = flipflop.records(cfg, reads, fast5.CHANNEL, params, "cuda")
    assert on == off
    assert torch.backends.cuda.matmul.allow_tf32 and torch.backends.cudnn.allow_tf32
