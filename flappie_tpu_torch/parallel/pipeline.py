"""Data-parallel basecalling over a device mesh.

Counterpart of flappie_tpu/parallel/pipeline.py, the replacement for the
reference's process-level fan-out (``find ... | parallel -P $(nproc) -X
flappie``, its README.md:81-83): each packed batch's rows shard over the
mesh's data replicas, each holding its tree of the weights (model-sharded
over its row's devices where the mesh has a model axis, parallel/mesh.py),
and the shards' output bytes are concatenated back in input order.

The JAX version pads every batch to a multiple of the data axis with
filler rows (its ``_filler_rows``), because an SPMD program needs equal
shards.  Here each shard is a program call of its own on its own device,
and the programs take any batch size, so shards may be unequal (the
first ``rows % n`` one row longer, ``mesh.batch_sharding``) and need no
fillers; a batch of fewer rows than devices runs on fewer devices.  Rows
are independent reads or chunks, and a row's bytes do not depend on the
batch it shares (ops/rnn.py ``rows_matmul``, ops/conv.py ``_conv_math``
and ops/crf.py ``lse`` keep the CPU path's sums in one order at every
batch size), so the output bytes equal the one-device run's, on the CPU
exactly (on the card see ROADMAP.md section 3).

Every wire shards so (f32, i16, d8), a batch whose d8 encode overflowed
to i16 too, and a grouped dispatch of G batches shards each batch's rows
in the same bounds: a device's shard is its rows of every batch, G
slices that its own grouped program runs in turn, and the output rows
are put back in group order.

Each data replica has one persistent dispatch thread, which makes its
first device current (``torch.cuda.device``) around every shard: the C entries
size their grids and set kernel attributes on the current device, and a
shard's streams and tensors belong to its device.  A launch returns only
when the host has issued it, so one thread dispatching N shards in turn
would serialise the devices; ctypes releases the interpreter lock in the
C calls, so the threads overlap.

Multi-process runs (one process per host, or per device group) call
``init_distributed`` first; inference needs no collective, so the
launcher (parallel/launch.py) shards reads by file instead, and the
process group serves data-parallel training (train/trainer.py).
"""

from __future__ import annotations

from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Optional

import numpy as np
import torch

from .. import timing
from ..basecall import (Basecaller, _as_array, _chaos_maybe_fail_dispatch, _device_basecall,
                        _DeviceQueue, _on_device)
from .mesh import Mesh, batch_sharding, make_mesh, shard_params


def init_distributed(coordinator: Optional[str] = None, num_processes: Optional[int] = None,
                     process_id: Optional[int] = None, backend: Optional[str] = None):
    """Join a process group of ``num_processes`` ranks (``process_id`` is
    this one's) that meet at ``coordinator`` (host:port); returns the
    default group, or None for one process (a no-op).  ``backend``:
    ``nccl`` where CUDA is available, else ``gloo``, unless given (two
    ranks on one card need ``gloo``: NCCL refuses them)."""
    if num_processes is None or num_processes <= 1:
        return None
    if coordinator is None or process_id is None:
        raise ValueError("init_distributed: a multi-process run needs the coordinator's "
                         "host:port and this process's id")
    import torch.distributed as dist

    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    dist.init_process_group(backend, init_method=f"tcp://{coordinator}",
                            world_size=num_processes, rank=process_id)
    return dist.group.WORLD


class _Sharded:
    """One dispatched batch: a future a shard, in row order; each gives
    that shard's in-flight batch (basecall._InFlight).  A grouped batch's
    shards hold G slices each, put back in group order."""

    def __init__(self, futures, G: Optional[int] = None):
        self._futures = futures
        self._G = G

    def result(self) -> np.ndarray:
        with timing.phase("shard_wait"):  # the dispatch threads issuing the shards
            pending = [f.result() for f in self._futures]
        parts = [p.result() for p in pending]
        if len(parts) == 1:
            return parts[0]
        if self._G is None:
            return np.concatenate(parts, axis=0)
        G = self._G
        groups = [p.reshape(G, p.shape[0] // G, p.shape[1]) for p in parts]
        return np.concatenate(groups, axis=1).reshape(-1, parts[0].shape[1])

    def __array__(self, dtype=None, copy=None):
        """``np.asarray(handle)``: the output bytes, as ``result()``."""
        return _as_array(self.result(), dtype, copy)


class DistributedBasecaller(Basecaller):
    """A Basecaller whose batches shard over a Mesh's data replicas.

    ``mesh`` defaults to ``make_mesh(n_model=n_model)`` over every
    visible card (``n_model`` is read only then, as in the JAX package);
    the devices come from it, so ``device`` is not an argument here.
    Every other argument is Basecaller's.  The weights (after
    ``stream_params``, so ``stream=torch.bfloat16`` holds under the mesh
    too) are placed by ``shard_params``: a tree a data replica, its
    ``rnn*`` / ``ff`` leaves in column shards over the row's devices when
    the mesh has a model axis.  Each replica gets a dispatch queue and a
    thread of its own on its first device, where its layers run.
    ``self.params`` stays whole on the first replica's first device
    (``basecall_read_chunked`` runs there).
    """

    def __init__(self, *args, mesh: Optional[Mesh] = None, n_model: int = 1, **kw):
        if "device" in kw:
            raise TypeError("DistributedBasecaller: the devices come from the mesh")
        self.mesh = mesh if mesh is not None else make_mesh(n_model=n_model)
        super().__init__(*args, device=self.mesh.devices[0], **kw)
        self.replicas = shard_params(self.params, self.mesh)
        # the shards were copied on each device's current stream; the
        # batch streams read them
        for d in {d for row in self.mesh.grid for d in row if d.type == "cuda"}:
            torch.cuda.synchronize(d)
        self._queues = [_DeviceQueue(d) for d in self.mesh.devices]
        self._threads = [ThreadPoolExecutor(1, thread_name_prefix=f"flappie-shard{i}")
                         for i in range(len(self.mesh))]
        # one record a dispatch, bounded: a long-lived server must not grow
        # without bound, and the summary covers the recent past
        self.wire_log: deque = deque(maxlen=4096)

    def _run_shard(self, i: int, program, shard: np.ndarray, G: Optional[int]):
        extra = () if G is None else (G,)
        with _on_device(self.mesh.devices[i]):
            return self._queues[i].run(
                lambda dev: program(self.replicas[i], dev, *extra, self.cfg, self.temperature,
                                    self.viterbi_only, self.compute_trace, self.rnn_impl,
                                    self.stream), shard)

    def _dispatch(self, program, buf: np.ndarray, G: Optional[int] = None,
                  chaos: bool = True) -> _Sharded:
        """Split one packed batch's rows (each of a grouped dispatch's G
        batches in the same bounds) over the mesh and hand each shard to
        its device's thread; returns at once."""
        if chaos:
            _chaos_maybe_fail_dispatch()
        self._count_dispatch(program)
        buf = np.ascontiguousarray(buf)
        rows = buf.shape[0] if G is None else buf.shape[0] // G
        bounds = batch_sharding(self.mesh, rows)
        if G is None:
            shards = [buf[lo:hi] for lo, hi in bounds]
        else:
            groups = buf.reshape(G, rows, buf.shape[1])
            shards = [np.ascontiguousarray(groups[:, lo:hi]).reshape(-1, buf.shape[1])
                      for lo, hi in bounds]
        run = timing.carry(self._run_shard)  # each shard under the batch's ids
        futures = [self._threads[i].submit(run, i, program, shard, G)
                   for i, shard in enumerate(shards)]
        self.wire_log.append({
            "program": getattr(program, "__name__", str(program)),
            "dtype": str(buf.dtype),
            "rows": int(buf.shape[0]),
            # every mesh device the dispatch used: data shards x model devices
            "devices": len(futures) * self.mesh.shape["model"],
            "shard_rows": [len(shard) for shard in shards],
        })
        return _Sharded(futures, G)

    def call_batch_device(self, signals, lengths):
        """Basecaller's ``call_batch_device`` with the rows sharded over
        the data replicas (``batch_sharding``; unequal shards, no filler
        rows), each replica's program issued on its first device in turn;
        the outputs are concatenated on the first replica's device, in
        input order, without waiting for them."""
        signals = torch.as_tensor(signals, dtype=torch.float32)
        lengths = torch.as_tensor(lengths, dtype=torch.int32)
        outs = []
        for i, (lo, hi) in enumerate(batch_sharding(self.mesh, signals.shape[0])):
            dev = self.mesh.devices[i]
            with _on_device(dev), torch.inference_mode():
                outs.append(_device_basecall(
                    self.replicas[i], signals[lo:hi].to(dev), lengths[lo:hi].to(dev), self.cfg,
                    self.temperature, self.viterbi_only, self.compute_trace, self.rnn_impl,
                    self.stream))
        first = self.mesh.devices[0]
        with _on_device(first), torch.inference_mode():
            return tuple(torch.cat([o[k].to(first) for o in outs]) for k in range(len(outs[0])))

    def wire_summary(self) -> dict:
        """Per program and wire dtype (float32: f32, int16: i16, int8: d8):
        the dispatches, the shard counts they spanned and their rows (the
        JAX summary's keys)."""
        summary: dict = {}
        for rec in self.wire_log:
            ent = summary.setdefault(f"{rec['program']}[{rec['dtype']}]",
                                     {"dispatches": 0, "devices": set(), "rows": 0})
            ent["dispatches"] += 1
            ent["devices"].add(rec["devices"])
            ent["rows"] += rec["rows"]
        return {k: {**v, "devices": sorted(v["devices"])} for k, v in summary.items()}

    def close(self) -> None:
        """Stop the dispatch threads (after the shards in flight) and the
        upload pool."""
        super().close()
        for t in self._threads:
            t.shutdown(wait=True)
