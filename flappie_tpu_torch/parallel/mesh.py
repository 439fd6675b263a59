"""Device mesh and placement: data replicas and model shards.

Counterpart of flappie_tpu/parallel/mesh.py.  The reference scales by one
process per read stitched together with GNU parallel (its README.md:81-83);
here a Mesh arranges devices as ``[n_data, n_model]``, row-major, as the
JAX package's ``make_mesh`` reshapes its device list:

- **data parallelism** over reads and chunks (the ``data`` axis, the
  rows): a batch's rows split into contiguous shards in input order, one
  a data replica (``shard_batch``, as ``torch.tensor_split`` splits
  them); each replica runs its rows on its row's first device.
- **the model axis** (the columns) shards parameter storage: the last
  axis of every ``rnn*`` / ``ff*`` leaf that ``n_model`` divides is held
  as ``n_model`` contiguous column shards, one on each of the row's
  devices (``param_pspec``, JAX's rule), and Adam's moments alike
  (``shard_opt_state``).  A layer reads its leaves whole: the network
  gathers them on the replica's first device (``whole``) before the
  fused layer runs, and drops them after it, so the kernels, their
  summation order and their bytes are those of one device, as XLA
  replicates the sharded operands of a ``pallas_call``.  Under autograd
  the gather's backward hands each shard its own columns of the gradient
  on its own device.  The fused recurrence is not split across devices
  (no exchange of h every step).

A device may appear more than once: ``["cpu"] * 8`` or ``["cuda:0"] * 4``
is a mesh of replicas or shards on one device, the counterpart of XLA's
virtual host devices, which exercises the placement without more cards.
Each shard is a copy of its own, also where a device repeats.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch


class Mesh:
    """Devices on a ``[n_data, n_model]`` grid (``grid``: one tuple of
    ``n_model`` devices a data replica, row-major from ``devices``).
    ``devices`` is each replica's first device, where its layers run, and
    ``len`` the number of replicas."""

    def __init__(self, devices: Sequence, n_model: int = 1):
        flat = tuple(torch.device(d) for d in devices)
        if not flat:
            raise ValueError("a mesh needs at least one device")
        if n_model < 1 or len(flat) % n_model:
            raise ValueError(f"{len(flat)} devices do not make rows of {n_model}")
        self.grid = tuple(flat[i : i + n_model] for i in range(0, len(flat), n_model))
        self.devices = tuple(row[0] for row in self.grid)

    @property
    def shape(self) -> dict:
        return {"data": len(self.grid), "model": len(self.grid[0])}

    def __len__(self) -> int:
        return len(self.grid)


def make_mesh(n_data: Optional[int] = None, n_model: int = 1, devices=None) -> Mesh:
    """A mesh of the first ``n_data * n_model`` of ``devices`` as
    ``[n_data, n_model]``, row-major; ``devices`` defaults to the visible
    cards and ``n_data`` to ``len(devices) // n_model``.  Raises when the
    default list is asked for more cards than are visible."""
    if n_model < 1:
        raise ValueError(f"n_model must be at least 1, got {n_model}")
    if devices is None:
        visible = torch.cuda.device_count()
        n = visible // n_model if n_data is None else n_data
        if n * n_model > visible or n < 1:
            raise ValueError(f"a mesh of {max(n, 1) * n_model} CUDA devices: {visible} are "
                             "visible")
        devices = [torch.device("cuda", i) for i in range(n * n_model)]
    devices = list(devices)
    n = len(devices) // n_model if n_data is None else n_data
    if n < 1 or n * n_model > len(devices):
        raise ValueError(f"a mesh of {n} x {n_model} devices from a list of {len(devices)}")
    return Mesh(devices[: n * n_model], n_model)


def param_pspec(key: str, shape: tuple, n_model: int) -> tuple:
    """The placement of one parameter (flat key ``layer/name``) as JAX's
    PartitionSpec reads as a tuple: ``(..., None, "model")`` shards the
    last axis over the model axis (``rnn*`` and ``ff*`` leaves whose last
    axis ``n_model`` divides), ``()`` replicates."""
    if n_model <= 1:
        return ()
    if shape[-1] % n_model == 0 and (key.startswith("rnn") or key.startswith("ff")):
        return (None,) * (len(shape) - 1) + ("model",)
    return ()


class Sharded:
    """One parameter held as contiguous column shards (its last axis),
    one on each model device of a data replica.  ``to`` maps over the
    shards (a dtype cast of a shard is the shard of the cast)."""

    def __init__(self, shards):
        self.shards = list(shards)

    @property
    def shape(self) -> tuple:
        s = tuple(self.shards[0].shape)
        return s[:-1] + (sum(t.shape[-1] for t in self.shards),)

    def gather(self, device) -> torch.Tensor:
        """The whole tensor on ``device`` (a cat of the shards moved
        there; differentiable)."""
        return torch.cat([t.to(device) for t in self.shards], dim=-1)

    def to(self, *args, **kw) -> "Sharded":
        return Sharded(t.to(*args, **kw) for t in self.shards)


def leaf_tensors(leaf) -> list:
    """The tensors that store one leaf: its shards, or the leaf itself."""
    return list(leaf.shards) if isinstance(leaf, Sharded) else [leaf]


def whole(layer: dict, device) -> dict:
    """One layer's leaves whole on ``device``: each Sharded leaf gathered
    there, a plain leaf as it is (the layer itself when none is
    sharded)."""
    if not any(isinstance(v, Sharded) for v in layer.values()):
        return layer
    return {k: v.gather(device) if isinstance(v, Sharded) else v for k, v in layer.items()}


class Replicas(list):
    """The trees of a mesh's data replicas, in row order (a list), with
    the mesh they are placed on."""

    def __init__(self, trees, mesh: Mesh):
        super().__init__(trees)
        self.mesh = mesh


def _place(key: str, x, row: tuple):
    t = torch.as_tensor(x)
    if "model" not in param_pspec(key, tuple(t.shape), len(row)):
        return t.to(row[0], copy=True)
    return Sharded(part.to(d, copy=True).contiguous()
                   for part, d in zip(torch.chunk(t, len(row), dim=-1), row))


def shard_params(params, mesh: Mesh) -> Replicas:
    """One tree (``{layer: {name: tensor or array}}``) a data replica, in
    mesh order: a leaf that ``param_pspec`` shards becomes ``n_model``
    contiguous column shards (a Sharded), shard j on the row's device j,
    as JAX places them; any other leaf lives on the row's first device.
    Every tensor is a copy of its own, also where a device repeats."""
    return Replicas([{layer: {k: _place(f"{layer}/{k}", t, row) for k, t in p.items()}
                      for layer, p in params.items()} for row in mesh.grid], mesh)


def shard_opt_state(opt_state: dict, mesh: Mesh) -> list:
    """Adam's state ``{"count": step, "mu": tree, "nu": tree}`` (optax's
    ScaleByAdamState fields; the moments are parameter-shaped trees) a
    data replica: the moments placed exactly like their parameters
    (``shard_params``), the step count replicated."""
    mus = shard_params(opt_state["mu"], mesh)
    nus = shard_params(opt_state["nu"], mesh)
    return [{"count": opt_state["count"], "mu": mu, "nu": nu} for mu, nu in zip(mus, nus)]


def batch_sharding(mesh: Mesh, rows: int) -> list:
    """The (start, stop) row range of each shard of a batch of ``rows``
    rows over the data axis, in input order: contiguous, the first
    ``rows % n`` one row longer, as ``torch.tensor_split`` splits into n
    over the mesh's n replicas; with fewer rows than replicas, only the
    first ``rows`` replicas get one (no empty shard)."""
    k = max(1, min(len(mesh), rows))
    base, extra = divmod(rows, k)
    bounds, start = [], 0
    for i in range(k):
        stop = start + base + (i < extra)
        bounds.append((start, stop))
        start = stop
    return bounds


def shard_batch(mesh: Mesh, *arrays):
    """Each array's row shards (``batch_sharding``) placed on their data
    replicas' first devices: a list (one entry a shard) per array; a
    single array gives its list alone."""
    out = []
    for a in arrays:
        a = torch.as_tensor(a)
        out.append([a[lo:hi].to(d) for (lo, hi), d in
                    zip(batch_sharding(mesh, a.shape[0]), mesh.devices)])
    return tuple(out) if len(out) > 1 else out[0]
