"""CRF training: supervised block-path negative log-likelihood.

Counterpart of flappie_tpu/train/trainer.py.  The loss is the flip-flop
CRF NLL of a supervised block path,

    loss = -mean_b( path_score_b / nblocks_b )

over the globally-normalised transition weights of the training path
(``transitions(..., train=True)``: K8 or K7 forward with the
recompute-gates adjoint, the head's logZ through K3 forward and K4
backward).

The optimiser is ``torch.optim.Adam`` with optax.adam's defaults (b1
0.9, b2 0.999, eps 1e-8, lr 1e-4 unless given); the JAX package's
``optax.adam`` computes the same update.  Training updates the
parameter tensors in place (the JAX step returns new trees): one copy of
the weights and moments lives on the device.

Data parallelism across processes (the JAX package shards the step over
a mesh and XLA inserts the gradient all-reduce): ``make_train_step(...,
group=...)`` with a ``torch.distributed`` group of ranks, each holding
its own rows of the global batch.  Each rank scales its loss by
local_B / global_B and, after backward, sums the gradients across the
ranks with one ``all_reduce`` over a flat buffer before Adam, so every
rank takes the global batch mean's step, also with unequal shards, and
keeps the same parameters.  The parameters are a tree of tensors, not an
``nn.Module``, so ``DistributedDataParallel`` does not apply.

Data and model parallelism in one process (the JAX package shards the
step over a ``(data, model)`` Mesh): ``make_train_step(..., mesh=...)``.
``init`` places the parameters with parallel/mesh.py ``shard_params`` (a
tree a data replica, the ``rnn*`` / ``ff`` leaves in column shards over
the replica's devices) and builds one Adam over every replica's tensors,
so each moment lives beside its shard, where ``shard_opt_state`` places
it.  A step splits the batch rows over the data replicas, scales each
replica's loss by local_B / global_B, sums the replicas' gradients in
replica order and hands every replica the sum, so every replica takes
the same Adam step on its own shards.  The layers gather their shards
(network.py), so a ``(1, n_model)`` mesh computes one device's
arithmetic: the same losses, parameters and moments, bit for bit on the
CPU.

The train-state npz uses the JAX package's key layout, so a checkpoint
written by either package resumes in the other: ``p/['rnn0']['iW']``
for a parameter, ``o/[0].count``, ``o/[0].mu[...]``, ``o/[0].nu[...]``
for Adam's step and moments, and ``step``.  Leaves are written whole (a
sharded run's first replica, gathered), so a state saved on one mesh
loads on another or on one device.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .. import resolve_device
from ..models.config import ModelConfig
from ..models.network import transitions
from ..models.params import params_to_torch
from ..ops.crf import path_score
from ..parallel.mesh import Replicas, batch_sharding, leaf_tensors, shard_opt_state, shard_params


def tree_leaves(params):
    """(key, tensor) pairs of a parameter tree in the JAX package's leaf
    order (sorted dict keys), keyed as jax.tree_util.keystr writes them."""
    return [(f"['{layer}']['{k}']", params[layer][k])
            for layer in sorted(params) for k in sorted(params[layer])]


def nll_loss(params, cfg: ModelConfig, signal, lengths, target_path, stream=None):
    """signal [B, T], lengths [B], target_path [B, ceil(T/stride) + 1]
    int32 -> scalar loss, differentiable in ``params``.  ``stream``: the
    recurrent stack's stream dtype (None: FLAPPIE_TPU_RNN_STREAM at call
    time, as ``transitions`` reads it; the JAX package's
    ``rnn_impl="train"`` reads the same variable inside its kernels)."""
    trans, nblocks = transitions(params, cfg, signal, lengths, train=True, stream=stream)
    score = path_score(trans, target_path, nblocks, cfg.nbase)
    return -torch.mean(score / nblocks.to(trans.dtype))


def _trees(params) -> list:
    """The trees of a run: a mesh's replicas, or the one tree."""
    return list(params) if isinstance(params, Replicas) else [params]


def _tensors(params) -> list:
    """(key, tensor) for every tensor that stores a leaf of every tree of
    the run (a sharded leaf's shards in order), replica by replica."""
    return [(key, t) for tree in _trees(params) for key, leaf in tree_leaves(tree)
            for t in leaf_tensors(leaf)]


def adam(params, lr: float = 1e-4) -> torch.optim.Adam:
    """Adam with optax.adam's defaults over the tensors of the tree (of
    every replica's tree, shards included), which it marks as requiring
    gradients."""
    leaves = [t.requires_grad_() for _, t in _tensors(params)]
    return torch.optim.Adam(leaves, lr=lr, betas=(0.9, 0.999), eps=1e-8)


def to_device(params, device=None):
    """A tree of numpy arrays (``init_synthetic``, ``load_npz``) becomes
    float32 tensors on ``device`` (``cuda`` unless the caller asks for
    the CPU; raises without a GPU); a tree of tensors is returned as it
    is."""
    leaf = next(iter(next(iter(params.values())).values()))
    if isinstance(leaf, torch.Tensor):
        return params
    return params_to_torch(params, resolve_device(device))


def all_reduce_grads(params, group) -> None:
    """Sum every leaf's gradient across ``group``'s ranks in place: one
    all_reduce over the leaves flattened into one buffer (a leaf without
    a gradient counts as zeros)."""
    import torch.distributed as dist

    leaves = [t for _, t in tree_leaves(params)]
    grads = [t.grad if t.grad is not None else torch.zeros_like(t) for t in leaves]
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat, group=group)
    ofs = 0
    for t, g in zip(leaves, grads):
        t.grad = flat[ofs : ofs + g.numel()].view_as(g)
        ofs += g.numel()


def _sum_replica_grads(params) -> None:
    """Every replica's gradient of each stored tensor becomes the sum over
    the replicas, added in replica order on the first replica's tensor's
    device (a replica without rows counts as zeros)."""
    per_tree = [[t for _, t in _tensors(tree)] for tree in params]
    for ts in zip(*per_tree):
        grads = [t.grad if t.grad is not None else torch.zeros_like(t) for t in ts]
        total = grads[0]
        for g in grads[1:]:
            total = total + g.to(total.device)
        for t in ts:
            t.grad = total.to(t.device, copy=True)


def make_train_step(cfg: ModelConfig, lr: float = 1e-4, loss_fn=nll_loss, group=None,
                    stream=None, mesh=None):
    """(train_step, init).  ``init(params, device=None)`` -> (params as
    tensors on the device, their optimiser); ``train_step(params,
    optimizer, *batch)`` runs one loss, gradient and Adam update in place
    and returns the loss (a detached scalar).  ``stream`` (a dtype) is
    passed to ``loss_fn``; None leaves it to the loss (``nll_loss``:
    FLAPPIE_TPU_RNN_STREAM at each step).

    ``group``: a torch.distributed process group of data-parallel ranks,
    each passing its own rows of the batch (module docstring).  Every rank
    must start from the same parameters; the loss returned is the global
    batch's.

    ``mesh``: a parallel/mesh.py Mesh (module docstring).  ``init``
    returns the replicas' trees (``shard_params``; its ``device`` must be
    None) and one Adam over all of them; ``train_step`` takes the whole
    batch on any device and returns the global batch's loss on the first
    replica's device."""
    import torch.distributed as dist

    ranks = 1 if group is None else dist.get_world_size(group)
    if mesh is not None and group is not None:
        raise ValueError("make_train_step: a mesh or a process group, not both")
    if stream is not None:
        loss_fn = functools.partial(loss_fn, stream=stream)

    def init(params, device=None):
        if mesh is not None:
            if device is not None:
                raise ValueError("make_train_step: the devices come from the mesh")
            params = shard_params(to_device(params, mesh.devices[0]), mesh)
        else:
            params = to_device(params, device)
        return params, adam(params, lr)

    def mesh_step(params, optimizer, *batch):
        optimizer.zero_grad(set_to_none=True)
        B = batch[0].shape[0]
        total = None
        for i, (lo, hi) in enumerate(batch_sharding(mesh, B)):
            dev = mesh.devices[i]
            loss = loss_fn(params[i], cfg, *(a[lo:hi].to(dev) for a in batch))
            if len(mesh) > 1:
                loss = loss * ((hi - lo) / B)
            loss.backward()
            loss = loss.detach().to(mesh.devices[0])
            total = loss if total is None else total + loss
        if len(mesh) > 1:
            _sum_replica_grads(params)
        optimizer.step()
        return total

    def train_step(params, optimizer, *batch):
        if mesh is not None:
            return mesh_step(params, optimizer, *batch)
        optimizer.zero_grad(set_to_none=True)
        loss = loss_fn(params, cfg, *batch)
        if ranks > 1:
            rows = torch.tensor([float(batch[0].shape[0])], device=loss.device)
            dist.all_reduce(rows, group=group)
            loss = loss * (batch[0].shape[0] / rows.item())
        loss.backward()
        if ranks > 1:
            all_reduce_grads(params, group)
            total = loss.detach().reshape(1).clone()
            dist.all_reduce(total, group=group)
            loss = total[0]
        optimizer.step()
        return loss.detach()

    return train_step, init


def _adam_count(params, optimizer) -> int:
    steps = {int(optimizer.state[t]["step"]) if optimizer.state.get(t) else 0
             for _, t in _tensors(params)}
    if len(steps) != 1:
        raise ValueError(f"optimiser leaves are at different steps {sorted(steps)}")
    return steps.pop()


def _whole_cpu(tensors) -> np.ndarray:
    return torch.cat([t.detach().cpu() for t in tensors], dim=-1).numpy()


def save_train_state(path: str, params, optimizer, step: int) -> None:
    """Checkpoint params, Adam's step and moments, and ``step`` to one npz
    in the JAX package's key layout (module docstring); a mesh run's
    first replica, each leaf and moment whole."""
    flat = {}
    count = _adam_count(params, optimizer)
    flat["o/[0].count"] = np.asarray(count, np.int32)
    for key, leaf in tree_leaves(_trees(params)[0]):
        ts = leaf_tensors(leaf)
        flat["p/" + key] = _whole_cpu(ts)
        for name, moment in (("mu", "exp_avg"), ("nu", "exp_avg_sq")):
            ms = [(optimizer.state.get(t) or {}).get(moment) for t in ts]
            flat[f"o/[0].{name}{key}"] = (
                _whole_cpu(ms) if all(m is not None for m in ms)
                else np.zeros(tuple(leaf.shape), np.float32))
    flat["step"] = np.asarray(step, np.int64)
    np.savez(path, **flat)


def load_train_state(path: str, params, optimizer):
    """Restore a state saved by either package's ``save_train_state`` into
    ``params`` (copied in place; a mesh run's every replica, the moments
    placed by ``shard_opt_state``) and ``optimizer`` (built over those
    params); returns (params, optimizer, step).  Every leaf must be in the
    file at the template's shape, or nothing is changed and this raises."""
    with np.load(path) as z:
        files = dict(z)
    leaves = tree_leaves(_trees(params)[0])
    for key, leaf in leaves:
        for k in ("p/" + key, "o/[0].mu" + key, "o/[0].nu" + key):
            if k not in files:
                raise KeyError(f"checkpoint missing {k}")
            if files[k].shape != tuple(leaf.shape):
                raise ValueError(f"checkpoint leaf {k} has shape {files[k].shape}, "
                                 f"expected {tuple(leaf.shape)}")
    for k in ("o/[0].count", "step"):
        if k not in files:
            raise KeyError(f"checkpoint missing {k}")
    count = int(files["o/[0].count"])

    def tree(prefix):
        out: dict = {}
        for key, _ in leaves:
            layer, name = key[2:-2].split("']['")
            out.setdefault(layer, {})[name] = torch.from_numpy(files[prefix + key])
        return out

    state = {"count": count, "mu": tree("o/[0].mu"), "nu": tree("o/[0].nu")}
    if isinstance(params, Replicas):
        placed = shard_params(tree("p/"), params.mesh)
        states = shard_opt_state(state, params.mesh)
    else:
        placed, states = [tree("p/")], [state]
    with torch.no_grad():
        for dst, src, st in zip(_trees(params), placed, states):
            for (key, leaf), (_, new), (_, mu), (_, nu) in zip(
                    tree_leaves(dst), tree_leaves(src), tree_leaves(st["mu"]),
                    tree_leaves(st["nu"])):
                for t, p, m, v in zip(leaf_tensors(leaf), leaf_tensors(new), leaf_tensors(mu),
                                      leaf_tensors(nu)):
                    t.copy_(p)
                    optimizer.state.pop(t, None)
                    if count:
                        optimizer.state[t] = {
                            "step": torch.tensor(float(count), dtype=torch.float32),
                            "exp_avg": m.to(t.device, copy=True),
                            "exp_avg_sq": v.to(t.device, copy=True),
                        }
    return params, optimizer, int(files["step"])


def synthetic_batch(cfg: ModelConfig, B: int, T: int, seed: int = 0):
    """A tiny synthetic supervised batch (for tests and dry runs), numpy."""
    rng = np.random.default_rng(seed)
    signal = rng.normal(size=(B, T)).astype(np.float32)
    lengths = np.full(B, T, np.int32)
    nblk = cfg.nblocks(T)
    # random flip states: transitions into flip states are always allowed
    path = rng.integers(0, cfg.nbase, size=(B, nblk + 1)).astype(np.int32)
    return signal, lengths, path
