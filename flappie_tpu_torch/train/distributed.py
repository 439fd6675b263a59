"""Data-parallel training across processes, on a seeded synthetic batch.

    # spawn N local ranks over gloo or nccl, then check them:
    python -m flappie_tpu_torch.train.distributed --nproc 2 --steps 3 \\
        --batch 32 --blocks 512 [--device cpu] [--backend gloo] [--out DIR]

    # or run each rank yourself, on every host:
    python -m flappie_tpu_torch.train.distributed --nproc N --rank R \\
        --coordinator HOST:PORT ...

Every rank builds the same synthetic weights (``--seed``) and the same
global batch (``synthetic_batch``: ``--batch`` rows of ``--blocks`` blocks
of the model's stride), keeps its own contiguous rows
(``torch.tensor_split``: unequal when the batch does not divide), and
takes ``--steps`` steps of ``make_train_step(..., group=...)``
(train/trainer.py: loss scaled by local_B / global_B, gradients summed by
one all_reduce before Adam).  Each rank writes ``DIR/rank<R>.npz``: the
global loss of every step, a SHA-256 of its parameters' bytes after every
step, the summed gradients of the first step, each step's wall seconds
and its kernel launch counts (K8, K8-bf16, K7 and K3/K4: zero on the
CPU).  The ranks inherit the environment, FLAPPIE_TPU_RNN_STREAM (the
stream of ``nll_loss``) and the precision knobs included.  Spawn
mode then checks that every rank's digests are equal and prints one JSON
line with the losses, rows, step times, launch counts and digests; it
exits 1 if the digests differ.

``--device cuda`` puts rank R on card R % (visible cards); ``cuda:0``
puts every rank on card 0, where NCCL refuses two ranks, so pass
``--backend gloo`` (which all-reduces CUDA tensors through the host).
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import socket
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from ..parallel.launch import package_env, rank_device


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m flappie_tpu_torch.train.distributed",
        description="Data-parallel training steps across processes on a seeded synthetic "
                    "batch; checks that every rank keeps the same parameters.")
    p.add_argument("--nproc", type=int, required=True, help="Number of ranks")
    p.add_argument("--rank", type=int, default=None,
                   help="Run as this rank only (with --coordinator)")
    p.add_argument("--coordinator", default=None, metavar="host:port",
                   help="Rendezvous of the ranks (spawn mode: a free localhost port)")
    p.add_argument("--model", default="r941_native", help="Registry model")
    p.add_argument("--batch", type=int, default=32, help="Global batch rows")
    p.add_argument("--blocks", type=int, default=512, help="Blocks a row")
    p.add_argument("--steps", type=int, default=3)
    p.add_argument("--lr", type=float, default=2e-4)
    p.add_argument("--seed", type=int, default=0, help="Weights and batch")
    p.add_argument("--device", default="cuda",
                   help="cuda (rank R on card R %% cards), cuda:K (every rank on card K) "
                        "or cpu")
    p.add_argument("--backend", default=None,
                   help="torch.distributed backend (default nccl on CUDA, gloo on the CPU)")
    p.add_argument("--out", default=None, metavar="dir",
                   help="Directory of the ranks' npz files (default: a temporary one)")
    return p


def digest(params) -> str:
    """SHA-256 of a parameter tree's bytes, leaf by leaf in tree order."""
    from .trainer import tree_leaves

    h = hashlib.sha256()
    for _, t in tree_leaves(params):
        h.update(t.detach().cpu().numpy().tobytes())
    return h.hexdigest()


def run_rank(args) -> int:
    from ..models.config import get_model_config
    from ..ops import crf_bm_cuda, rnn_cuda
    from ..models.params import init_synthetic
    from ..parallel.pipeline import init_distributed
    from .trainer import make_train_step, synthetic_batch, tree_leaves

    import torch.distributed as dist

    device = torch.device(rank_device(args.device, args.rank))
    if device.type == "cuda":
        torch.cuda.set_device(device)
    group = init_distributed(args.coordinator, args.nproc, args.rank, args.backend)
    try:
        cfg = get_model_config(args.model)
        batch = synthetic_batch(cfg, args.batch, args.blocks * cfg.total_stride, args.seed)
        mine = [torch.tensor_split(torch.from_numpy(a), args.nproc)[args.rank].to(device)
                for a in batch]
        step, init = make_train_step(cfg, lr=args.lr, group=group)
        params, opt = init(init_synthetic(cfg, seed=args.seed), device=device)
        losses, seconds, digests, grads = [], [], [], {}
        for k in range(args.steps):
            t0 = time.perf_counter()
            losses.append(float(step(params, opt, *mine)))  # float() waits for the device
            seconds.append(time.perf_counter() - t0)
            digests.append(digest(params))
            if k == 0:
                grads = {f"g/{key}": t.grad.detach().cpu().numpy()
                         for key, t in tree_leaves(params)}
        launches = {f"launches/{name}": c.launches for name, c in (
            ("lstm_layer_train", rnn_cuda.lstm_layer_tm_train),
            ("lstm_layer_train_bf16", rnn_cuda.lstm_layer_tm_train_bf16),
            ("grumod_layer", rnn_cuda.grumod_layer_tm), ("crf_sum_scan", crf_bm_cuda.sum_states))}
        np.savez(os.path.join(args.out, f"rank{args.rank}.npz"), losses=np.asarray(losses),
                 seconds=np.asarray(seconds), digests=np.asarray(digests),
                 rows=mine[0].shape[0], **grads, **launches)
    finally:
        if group is not None:
            dist.destroy_process_group()
    return 0


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def spawn(args, argv) -> int:
    """Run ``args.nproc`` ranks as subprocesses, wait for them and check
    that their parameters stayed equal."""
    out = args.out or tempfile.mkdtemp(prefix="flappie-dp-")
    os.makedirs(out, exist_ok=True)
    coordinator = args.coordinator or f"localhost:{_free_port()}"
    procs = [subprocess.Popen([sys.executable, "-m", "flappie_tpu_torch.train.distributed",
                               *argv, "--rank", str(r), "--coordinator", coordinator,
                               "--out", out], env=package_env()) for r in range(args.nproc)]
    rc = 0
    for p in procs:
        rc |= p.wait()
    if rc:
        return rc
    ranks = [np.load(os.path.join(out, f"rank{r}.npz")) for r in range(args.nproc)]
    digests = [list(z["digests"]) for z in ranks]
    same = all(d == digests[0] for d in digests)
    print(json.dumps({
        "losses": [float(x) for x in ranks[0]["losses"]],
        "rows": [int(z["rows"]) for z in ranks], "ranks_equal": same,
        "step_s": [[float(x) for x in z["seconds"]] for z in ranks],
        "launches": [{k.split("/", 1)[1]: int(z[k]) for k in z.files if k.startswith("launches/")}
                     for z in ranks],
        "digests": digests[0], "out": out}))
    return 0 if same else 1


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    args = build_parser().parse_args(argv)
    if args.nproc < 1:
        print("--nproc must be at least 1", file=sys.stderr)
        return 2
    if args.rank is None:
        return spawn(args, argv)
    if args.out is None or (args.nproc > 1 and args.coordinator is None):
        print("--rank needs --out and, for more than one rank, --coordinator", file=sys.stderr)
        return 2
    return run_rank(args)


if __name__ == "__main__":
    sys.exit(main())
