"""Device mesh and data-parallel placement.

Counterpart of flappie_tpu/parallel/mesh.py.  The reference scales by one
process per read stitched together with GNU parallel (its README.md:81-83);
here reads shard over the ``data`` axis of a Mesh, a list of devices that
each hold a replica of the weights and run their rows of a batch.

- **data parallelism** over reads and chunks: a batch's rows split into
  contiguous shards in input order, one a device (``shard_batch``, as
  ``torch.tensor_split`` splits them); the weights are replicated
  (``shard_params``).
- **tensor parallelism** (the JAX mesh's ``model`` axis, which shards the
  recurrent gate dimension) is not ported: ``make_mesh(n_model > 1)``
  raises (ROADMAP item 19).

A device may appear more than once: ``["cpu", "cpu"]`` or ``["cuda:0",
"cuda:0"]`` gives two replicas on one device, the counterpart of XLA's
virtual host devices, which exercises the sharding path without a second
card.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

_NO_TP = ("tensor parallelism (n_model > 1) is not ported to flappie_tpu_torch "
          "(ROADMAP item 19: the gate-dimension split of the fused recurrence)")


class Mesh:
    """An ordered tuple of devices on one ``data`` axis."""

    def __init__(self, devices: Sequence):
        self.devices = tuple(torch.device(d) for d in devices)
        if not self.devices:
            raise ValueError("a mesh needs at least one device")

    @property
    def shape(self) -> dict:
        return {"data": len(self.devices), "model": 1}

    def __len__(self) -> int:
        return len(self.devices)


def make_mesh(n_data: Optional[int] = None, n_model: int = 1, devices=None) -> Mesh:
    """A mesh of ``n_data`` devices: the first of ``devices``, which
    defaults to ``cuda:0 ... cuda:{n-1}`` (every visible card when
    ``n_data`` is None).  Raises when the default list is asked for more
    cards than are visible, and for ``n_model > 1``."""
    if n_model != 1:
        raise NotImplementedError(_NO_TP)
    if devices is None:
        visible = torch.cuda.device_count()
        n = visible if n_data is None else n_data
        if n > visible or n < 1:
            raise ValueError(f"a mesh of {n} CUDA devices: {visible} are visible")
        devices = [torch.device("cuda", i) for i in range(n)]
    devices = list(devices)
    n = len(devices) if n_data is None else n_data
    if not 1 <= n <= len(devices):
        raise ValueError(f"a mesh of {n} devices from a list of {len(devices)}")
    return Mesh(devices[:n])


def shard_params(params, mesh: Mesh) -> list:
    """One replica of a parameter tree (``{layer: {name: tensor}}``) on
    each mesh device, in mesh order; each is a copy of its own, also where
    a device repeats."""
    return [{layer: {k: t.to(d, copy=True) for k, t in p.items()}
             for layer, p in params.items()} for d in mesh.devices]


def batch_sharding(mesh: Mesh, rows: int) -> list:
    """The (start, stop) row range of each shard of a batch of ``rows``
    rows, in input order: contiguous, the first ``rows % n`` one row
    longer, as ``torch.tensor_split`` splits into n, over the mesh's n
    devices; with fewer rows than devices, only the first ``rows``
    devices get one (no empty shard)."""
    k = max(1, min(len(mesh), rows))
    base, extra = divmod(rows, k)
    bounds, start = [], 0
    for i in range(k):
        stop = start + base + (i < extra)
        bounds.append((start, stop))
        start = stop
    return bounds


def shard_batch(mesh: Mesh, *arrays):
    """Each array's row shards (``batch_sharding``) placed on their mesh
    devices: a list (one entry a shard) per array; a single array gives
    its list alone."""
    out = []
    for a in arrays:
        a = torch.as_tensor(a)
        out.append([a[lo:hi].to(d) for (lo, hi), d in
                    zip(batch_sharding(mesh, a.shape[0]), mesh.devices)])
    return tuple(out) if len(out) > 1 else out[0]
