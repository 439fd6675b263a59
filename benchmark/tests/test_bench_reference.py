"""The plain reference against the C code's semantics and against the
program's CPU path at a tiny size (this test imports both)."""

import importlib.util
import io
import json
import os

import numpy as np
import pytest
import torch

from benchmark.harness import cell as cell_mod
from benchmark.harness import fast5, spec
from benchmark.reference import flipflop, signal
from benchmark.reference import flipflop_weights as weights
from benchmark.tests.conftest import shrink

ORACLE = os.path.join(spec.ROOT, "tests", "oracle.py")


def _oracle():
    s = importlib.util.spec_from_file_location("bench_test_oracle", ORACLE)
    m = importlib.util.module_from_spec(s)
    s.loader.exec_module(m)
    return m


@pytest.mark.parametrize("w,s", [(5, 1), (19, 5), (19, 2), (7, 3)])
def test_edge_columns_are_the_c_tapmap(w, s):
    """Every column the reference fixes is the C loops' (tests/oracle.py
    conv_tapmap), and every other column is the mathematical window."""
    oracle = _oracle()
    padL = (w - 1) // 2
    for n in range(w, 400):
        ncol, contribs = oracle.conv_tapmap(n, w, s)
        fixes = flipflop._edge_columns(n, w, s)
        for c in range(ncol):
            want = sorted(contribs.get(c, []))
            if c in fixes:
                assert sorted(fixes[c]) == want, (n, c)
            else:  # the mathematical window: tap j on sample c*s - padL + j
                taps = {(st + j, j) for st, lo, hi in want for j in range(lo, hi)
                        if 0 <= st + j < n}
                assert taps == {(c * s - padL + j, j) for j in range(w)
                                if 0 <= c * s - padL + j < n}, (n, c)


def test_conv_matches_the_oracle():
    oracle = _oracle()
    rng = np.random.default_rng(3)
    W = rng.standard_normal((19, 16, 8)).astype(np.float32)
    b = rng.standard_normal(8).astype(np.float32)
    lengths = [19, 40, 57, 63, 100]
    x = np.zeros((len(lengths), 16, 100), np.float32)
    for r, n in enumerate(lengths):
        x[r, :, :n] = rng.standard_normal((16, n))
    model = flipflop.Model([{"winlen": 19, "in_ch": 16, "out_ch": 8, "stride": 5,
                             "activation": "swish"}], [], 4)
    net = flipflop.Network(model, {"conv0/W": torch.from_numpy(W), "conv0/b": torch.from_numpy(b)})
    got = net._conv(torch.from_numpy(x), 0, lengths).numpy()
    for r, n in enumerate(lengths):
        want = oracle.conv_same(x[r, :, :n].T.astype(np.float64), W, b, 5)
        assert np.allclose(got[r, :, :want.shape[0]].T, want, atol=1e-4), n


def test_tf32_rounds_to_ten_mantissa_bits():
    x = torch.tensor([1.0, 1.0 + 2 ** -11, 1.0 + 3 * 2 ** -11, 1.0 + 2 ** -12, -3.14159265])
    got = flipflop._tf32(x)
    assert got[0] == 1.0
    assert got[1] == 1.0  # a tie rounds to the even mantissa
    assert got[2] == 1.0 + 2 ** -9  # a tie rounds up to the even one
    assert got[3] == 1.0
    assert (got.view(torch.int32) & 0x1FFF == 0).all()
    assert abs(got[4] + 3.14159265) < 2 ** -9


@pytest.mark.parametrize("name", ["r941_native", "r941_5mC"])
def test_network_matches_the_programs_cpu_path(name):
    from flappie_tpu_torch.models.config import get_model_config
    from flappie_tpu_torch.models.network import transitions
    from flappie_tpu_torch.models.params import params_to_torch, unflatten

    cfg = json.load(open(os.path.join(spec.BENCH_DIR, "configs", f"{name}.json")))
    p = weights.make(cfg["widths"], 11, "cpu")
    lengths = [900, 1000, 333, 1]
    rng = np.random.default_rng(5)
    sig = np.zeros((4, 1000), np.float32)
    for r, n in enumerate(lengths):
        sig[r, :n] = rng.standard_normal(n)
    want, nb = flipflop.Network(flipflop.Model.from_config(cfg), p).transitions(
        torch.from_numpy(sig), lengths)
    tree = params_to_torch(unflatten({k: v.numpy() for k, v in p.items()}), "cpu")
    with torch.no_grad():
        got, nb2 = transitions(tree, get_model_config(cfg["model"]), torch.from_numpy(sig),
                               torch.tensor(lengths, dtype=torch.int32))
    assert nb.tolist() == nb2.tolist()
    for r in range(4):
        n = int(nb[r])
        assert torch.allclose(got[r, :n], want[r, :n], atol=2e-5), r


def _tf32_on():
    """(cuBLAS, cuDNN convolutions) may use TF32, through whichever
    interface torch lets read."""
    m, c = torch.backends.cuda.matmul, torch.backends.cudnn
    try:
        return m.allow_tf32, c.allow_tf32
    except RuntimeError:
        return m.fp32_precision == "tf32", c.conv.fp32_precision == "tf32"


@pytest.mark.parametrize("switch_on", [
    "torch.backends.cuda.matmul.allow_tf32 = True; torch.backends.cudnn.allow_tf32 = True",
    "torch.set_float32_matmul_precision('high')",
    "torch.backends.cuda.matmul.fp32_precision = 'tf32'; "
    "torch.backends.cudnn.conv.fp32_precision = 'tf32'",
])
def test_reference_sets_its_own_float32(switch_on):
    """With TF32 switched on beforehand (by either of torch's interfaces),
    the reference computes with it off and switches it back on after,
    and its records are those of a run with TF32 off.  In a fresh
    process: torch's TF32 state is the process's."""
    code = f"""
import sys, warnings
warnings.simplefilter("ignore")
sys.path.insert(0, {spec.ROOT!r})
import numpy as np, torch
torch.set_num_threads(1)
from benchmark.harness import fast5
from benchmark.reference import flipflop, flipflop_weights
from benchmark.tests.test_bench_reference import _tf32_on
import json
cfg = json.load(open({os.path.join(spec.BENCH_DIR, "configs", "r941_5mC.json")!r}))
cfg["decode"].update(chunk_samples=800, overlap=200)
params = flipflop_weights.make(cfg["widths"], 3, "cpu")
rng = np.random.default_rng(4)
reads = [("00000000-0000-4000-8000-000000000000", fast5.synthetic_adc(3000, rng))]
off = flipflop.records(cfg, reads, fast5.CHANNEL, params, "cpu")
{switch_on}
before = _tf32_on()
seen = []
plain = flipflop.Network.transitions
def watched(self, *a, **k):
    seen.append(_tf32_on())
    return plain(self, *a, **k)
flipflop.Network.transitions = watched
on = flipflop.records(cfg, reads, fast5.CHANNEL, params, "cpu")
print(before, seen, _tf32_on(), on == off)
"""
    import subprocess
    import sys

    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, check=True)
    assert out.stdout.split("\n")[-2] == "(True, True) [(False, False)] (True, True) True", out


def test_phred_and_basecall():
    q = np.array([np.nan, np.log(0.5), np.log(0.99), 0.0, np.log(0.9)], np.float32)
    ph = signal.phred_chars(np.nan_to_num(q))
    assert ph[1] == 33 + 3 and ph[2] == 33 + 20 and ph[3] == 33 + 50 and ph[4] == 33 + 10
    # changes within the first 5 blocks at 2 (state 1) and 3 (state 5,
    # base 5 % 4); the change at block 5 lies past nblock
    seq, qual = signal.basecall(np.array([0, 0, 1, 5, 5, 2]), ph, 5, 4)
    assert seq == "CC"
    assert qual == chr(ph[2]) + chr(ph[3])


@pytest.mark.parametrize("workload", ["r941_native.offline", "r941_5mC.offline"])
def test_reference_agrees_with_the_programs_cpu_path(workload, monkeypatch):
    """A whole run on the CPU at a tiny size: every compared record of
    the program's CPU path equals the reference's."""
    out = io.StringIO()
    rc = cell_mod.run(workload, 2 ** 31 + 17, 1.0, False, device="cpu", adjust=shrink, out=out)
    assert rc == 0
    res = json.loads(out.getvalue().strip().splitlines()[-1])
    assert res["correct"] is True
    assert res["failed"] == 0
    assert res["check"]["meta_mismatch"][0] == 0
    assert res["check"]["seq_err"][0] == 0.0
    assert res["check"]["score_gap_max"][0] < 1.5e-6  # the printed score's last digit
