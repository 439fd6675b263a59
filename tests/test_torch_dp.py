"""PyTorch port on the CPU: data-parallel training across processes
(``make_train_step(..., group=...)`` and
``python -m flappie_tpu_torch.train.distributed``).

Two ranks over gloo, each with its own rows of a five-row batch (three
and two: unequal shards), take two steps of r941_native at full width
(100 blocks a row).  Against one process taking the same steps on the
whole batch: every step's loss within 1e-5 relative, and the first
step's summed gradients within 1e-3 of each leaf's largest |gradient|
(the band of tests/test_torch_train.py's card checks); the two ranks'
parameters are identical after every step; and the first loss within
1e-5 relative of the JAX package's ``nll_loss`` on the whole batch.
Every process runs torch on one intra-op thread.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from flappie_tpu.models import config as j_config
from flappie_tpu.models.params import init_synthetic as j_init
from flappie_tpu.train import trainer as j_trainer

from flappie_tpu_torch.models.config import get_model_config
from flappie_tpu_torch.models.params import init_synthetic
from flappie_tpu_torch.train import distributed
from flappie_tpu_torch.train.trainer import make_train_step, synthetic_batch, tree_leaves

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARGS = ["--nproc", "2", "--steps", "2", "--batch", "5", "--blocks", "100", "--seed", "3",
        "--lr", "2e-4", "--device", "cpu", "--backend", "gloo"]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    out = tmp_path_factory.mktemp("dp")
    env = {**os.environ, "OMP_NUM_THREADS": "1", "PYTHONPATH": REPO}
    proc = subprocess.run([sys.executable, "-m", "flappie_tpu_torch.train.distributed"]
                          + ARGS + ["--out", str(out)],
                          cwd=out, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    summary = json.loads(proc.stdout.strip().splitlines()[-1])
    return summary, [np.load(out / f"rank{r}.npz") for r in range(2)]


def _one_process(steps: int):
    cfg = get_model_config("r941_native")
    signal, lengths, path = (torch.from_numpy(a) for a in
                             synthetic_batch(cfg, 5, 100 * cfg.total_stride, seed=3))
    step, init = make_train_step(cfg, lr=2e-4)
    params, opt = init(init_synthetic(cfg, seed=3), device="cpu")
    losses, grads = [], None
    for k in range(steps):
        losses.append(float(step(params, opt, signal, lengths, path)))
        if k == 0:
            grads = {key: t.grad.numpy().copy() for key, t in tree_leaves(params)}
    return losses, grads


def test_two_ranks_match_one_process_and_jax(ranks):
    summary, (r0, r1) = ranks
    assert summary["ranks_equal"] and summary["rows"] == [3, 2]
    assert list(r0["digests"]) == list(r1["digests"]) and len(r0["digests"]) == 2
    np.testing.assert_array_equal(r0["losses"], r1["losses"])
    want, grads = _one_process(2)
    np.testing.assert_allclose(r0["losses"], want, rtol=1e-5, atol=0)
    for key, g in grads.items():
        got = r0[f"g/{key}"]
        np.testing.assert_array_equal(got, r1[f"g/{key}"])
        assert np.abs(got - g).max() <= 1e-3 * np.abs(g).max(), key

    jcfg = j_config.MODELS["r941_native"]
    signal, lengths, path = j_trainer.synthetic_batch(jcfg, 5, 100 * jcfg.total_stride, seed=3)
    j_loss = float(j_trainer.nll_loss(j_init(jcfg, seed=3), jcfg, jnp.asarray(signal),
                                      jnp.asarray(lengths), jnp.asarray(path),
                                      rnn_impl="scan"))
    assert abs(r0["losses"][0] - j_loss) <= 1e-5 * abs(j_loss)


def test_rank_mode_needs_its_rendezvous(tmp_path, capsys):
    assert distributed.main(["--nproc", "2", "--rank", "0", "--out", str(tmp_path)]) == 2
    assert distributed.main(["--nproc", "0"]) == 2
    assert "--coordinator" in capsys.readouterr().err
