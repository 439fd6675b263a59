"""Multi-process / multi-host basecalling launcher.

Counterpart of flappie_tpu/parallel/launch.py.  The reference scales by
``find reads/ | parallel -P $(nproc) -X flappie`` (its README.md:81-83):
independent processes, outputs concatenated in whatever order they
finish.  Here:

- one worker process per host, card or device group, each basecalling
  through the port's flappie CLI helpers (``expand_files``,
  ``expand_reads``, ``make_caller``: ``--device``, ``--mesh``, ``--fast``;
  ``--qcal`` applied as the CLI applies it); reads are independent, so
  inference needs no collective;
- deterministic STRIDED read assignment: worker r handles input files
  [r::nproc] of the expanded file list (every worker expands the same
  list, so the assignment needs no coordination);
- input-order output merge: workers write indexed part files and the
  merge puts the records back into the order one process gives,
  ``--limit`` under ``--multi`` included, so the merged output has the
  bytes of a single process (unlike the reference's arbitrary
  concatenation).

Usage:

    # spawn N local workers and merge:
    python -m flappie_tpu_torch.parallel.launch --nproc N -- \\
        --model r941_native --output out.fastq reads/

    # or run one worker per host yourself (e.g. under slurm/k8s):
    python -m flappie_tpu_torch.parallel.launch --nproc N --rank R -- ...
    python -m flappie_tpu_torch.parallel.launch --nproc N --merge -- ...  # afterwards

Under ``--device cuda`` (the default) worker r runs on card r % (visible
cards); ``--device cuda:K`` puts every worker on card K.  Per-worker trace
HDF5 files are written as <trace>.partR (the reference does the same with
--trace trace_{%}, its RUNNIE.md:47-49) and merged into <trace>, through
h5py where it is installed, else signal/hdf5_min.py.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from typing import List

import torch

PACKAGE_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def package_env() -> dict:
    """This environment with this package's checkout first on PYTHONPATH,
    so that a subprocess started from any directory imports it."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(p for p in (PACKAGE_ROOT, env.get("PYTHONPATH")) if p)
    return env


def rank_device(device: str, rank: int) -> str:
    """``cuda`` -> card ``rank`` % (visible cards); any other device as
    it is given."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None and torch.cuda.device_count() > 0:
        return f"cuda:{rank % torch.cuda.device_count()}"
    return device


def _split_argv(argv):
    if "--" in argv:
        k = argv.index("--")
        return argv[:k], argv[k + 1:]
    return argv, []


def build_parser():
    p = argparse.ArgumentParser(
        prog="flappie-torch-launch",
        description="Run flappie workers across processes/hosts and merge their outputs "
                    "in input order.  Arguments after `--` go to the flappie CLI unchanged.",
    )
    p.add_argument("--nproc", type=int, default=None, help="Total number of workers")
    p.add_argument("--rank", type=int, default=None,
                   help="Run as worker RANK only (multi-host mode; merge separately with "
                        "--merge)")
    p.add_argument("--merge", action="store_true", default=False,
                   help="Merge existing part files (after all workers exit)")
    p.add_argument("--partdir", default=None,
                   help="Directory for part files (default: the current directory)")
    return p


def _part_path(partdir: str, rank: int) -> str:
    return os.path.join(partdir, f"flappie_part{rank}.jsonl")


def worker(rank: int, nproc: int, flappie_argv: List[str], partdir: str) -> int:
    """Basecall this worker's strided file shard; write an indexed part
    file (and a trace shard) so that the merge can restore input order."""
    from ..cli import flappie as cli
    from ..io.fastx import OUTFORMATS, format_read
    from ..io.trace_h5 import TraceWriter
    from ..models.config import MODELS
    from ..qcal import apply_qcal, parse_qcal

    args = cli.build_parser().parse_args(flappie_argv)
    if args.model not in MODELS or args.format not in OUTFORMATS:
        print("bad --model/--format", file=sys.stderr)
        return 1
    try:
        qcal = parse_qcal(args.qcal, model=args.model) if args.qcal else None
    except ValueError as exc:
        print(f"flappie-torch-launch: {exc}", file=sys.stderr)
        return 2
    if args.mesh <= 1:
        args.device = rank_device(args.device, rank)

    files = cli.expand_files(args.files)
    if args.limit > 0:
        files = files[: args.limit]
    caller = cli.make_caller(args)
    if caller is None:
        return 1
    reads, index = [], []  # index: (file index, read index in the file, path, name)
    for gi, fn in enumerate(files):
        if gi % nproc != rank:
            continue
        rts, names, _ = cli.expand_reads([fn], args.multi)
        reads.extend(rts)
        index.extend((gi, ri, fn, name) for ri, name in enumerate(names))
    results = cli.basecall(caller, args, reads)

    trace_path = f"{args.trace}.part{rank}" if args.trace else None
    if trace_path and os.path.exists(trace_path):
        os.remove(trace_path)  # a shard holds this run's groups only
    os.makedirs(partdir, exist_ok=True)
    with open(_part_path(partdir, rank), "w") as part, TraceWriter(
            trace_path, args.hdf5_chunk, args.hdf5_compression) as tracer:
        for (gi, ri, fn, name), res in zip(index, results):
            rec = group = None
            if res is None:
                print(f"No basecall returned for {fn}", file=sys.stderr)
            else:
                res = apply_qcal(res, qcal)
                rec = format_read(args.format, res.uuid, name, args.uuid, args.prefix, res)
                group = res.uuid if args.uuid else name
                tracer.write(group, res)
            part.write(json.dumps({"i": [gi, ri], "rec": rec, "trace": group}) + "\n")
    if args.mesh > 1:
        caller.close()
    return 0


def merge_traces(path: str, picks: dict, nproc: int) -> None:
    """Write the trace file ``path`` from the workers' shards
    ``path.partR``: group name -> rank of the shard whose group is kept
    (``picks``).  The shards are removed."""
    from ..io import trace_h5
    from ..signal import hdf5_min

    shards = {r: f"{path}.part{r}" for r in range(nproc)}
    if trace_h5.h5py is not None:
        h5py = trace_h5.h5py
        with h5py.File(path, "w") as dst:
            srcs = {r: h5py.File(shards[r], "r") for r in set(picks.values())}
            try:
                for name, r in picks.items():
                    srcs[r].copy(srcs[r][name], dst, name)
            finally:
                for f in srcs.values():
                    f.close()
    else:
        trees = {r: hdf5_min.read(shards[r]) for r in set(picks.values())}
        root = hdf5_min.Node(children={name: trees[r].children[name]
                                       for name, r in picks.items()})
        tmp = f"{path}.tmp{os.getpid()}"
        try:
            hdf5_min.write(tmp, root)
            os.replace(tmp, path)
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)
    for shard in shards.values():
        if os.path.exists(shard):
            os.remove(shard)


def merge(nproc: int, flappie_argv: List[str], partdir: str) -> int:
    """Write the part files' records in global (file, read) input order,
    as one process would (the first ``--limit`` reads under ``--multi``),
    and merge the workers' trace shards into the one requested file (an
    improvement over the reference, which leaves traces sharded one file
    per process, its RUNNIE.md:47-49)."""
    from ..cli import flappie as cli

    args = cli.build_parser().parse_args(flappie_argv)
    entries = []
    for r in range(nproc):
        path = _part_path(partdir, r)
        if not os.path.exists(path):
            print(f"missing part file {path}", file=sys.stderr)
            return 1
        with open(path) as fh:
            entries.extend((tuple(d["i"]), r, d["rec"], d["trace"]) for d in map(json.loads, fh))
    entries.sort(key=lambda e: e[0])
    if args.multi and args.limit > 0:
        entries = entries[: args.limit]
    out = open(args.output, "w") if args.output else sys.stdout
    try:
        for _, _, rec, _ in entries:
            if rec is not None:
                out.write(rec)
    finally:
        if out is not sys.stdout:
            out.close()
    for r in range(nproc):
        os.remove(_part_path(partdir, r))
    if args.trace:
        # the last write of a group name wins, as in one process's file
        merge_traces(args.trace, {g: r for _, r, _, g in entries if g is not None}, nproc)
    return 0


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    own, flappie_argv = _split_argv(argv)
    args = build_parser().parse_args(own)
    if args.nproc is None or args.nproc < 1:
        print("--nproc is required", file=sys.stderr)
        return 2
    partdir = args.partdir or os.getcwd()

    if args.merge:
        return merge(args.nproc, flappie_argv, partdir)
    if args.rank is not None:
        return worker(args.rank, args.nproc, flappie_argv, partdir)

    # spawn-local mode: one subprocess per worker, then merge
    procs = []
    for r in range(args.nproc):
        cmd = [sys.executable, "-m", "flappie_tpu_torch.parallel.launch",
               "--nproc", str(args.nproc), "--rank", str(r), "--partdir", partdir,
               "--"] + flappie_argv
        procs.append(subprocess.Popen(cmd, env=package_env()))
    rc = 0
    for p in procs:
        rc |= p.wait()
    if rc:
        return rc
    return merge(args.nproc, flappie_argv, partdir)


if __name__ == "__main__":
    sys.exit(main())
