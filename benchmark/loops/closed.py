"""The closed loop: jobs back to back, as ``flappie-torch reads/ >
calls.fastq`` runs one.  The CLI's parser and ``make_caller`` build the
caller once; a job is one directory through ``expand_files``,
``expand_reads``, ``basecall`` (``Basecaller.basecall_raw_tables``) and
``format_read`` of each result into a file.

The mix's ``check``: ``reads`` compared with the reference, ``short_reads``
of them at or under one chunk, the longest read of the window always
among them.
"""

from __future__ import annotations

import os
import time
from typing import List

import numpy as np

from benchmark.harness import check


class Loop:
    def __init__(self, cell, inputs, ckpt: str, device: str, tmp: str):
        from flappie_tpu_torch.cli import flappie

        self.cell = cell
        self.flappie = flappie
        self.inputs = inputs
        flags = list(cell.config["flags"]) + list(cell.traffic.get("flags", []))
        self.args = flappie.build_parser().parse_args(
            flags + ["--checkpoint", ckpt, "--device", device, inputs.dirs[0]])
        self.caller = flappie.make_caller(self.args)
        self.out_dir = os.path.join(tmp, "out")
        os.makedirs(self.out_dir)
        self.njob = 0
        self.last_out = {}  # directory index -> its latest output file
        self.jobs = []  # (directory index, reads, called, start, end) in the window

    def job(self, d: int):
        """One directory through the CLI's path; (reads, called)."""
        from flappie_tpu_torch import timing
        from flappie_tpu_torch.io.fastx import format_read

        a = self.args
        path = os.path.join(self.out_dir, f"job{self.njob:04d}.fastq")
        self.njob += 1
        files = self.flappie.expand_files([self.inputs.dirs[d]])
        reads, names, fnames = self.flappie.expand_reads(files, a.multi)
        results = self.flappie.basecall(self.caller, a, reads)
        called = 0
        with timing.phase("format_write"), open(path, "w") as out:
            for name, res in zip(names, results):
                if res is None:
                    continue
                out.write(format_read(a.format, res.uuid, name, a.uuid, a.prefix, res))
                called += 1
        self.last_out[d] = path
        return len(reads), called

    def warm(self, n: int) -> None:
        for k in range(n):
            self.job(k % len(self.inputs.dirs))

    def window(self, seconds: float) -> dict:
        """Jobs cycling over the directories until the first that ends
        past ``seconds``."""
        from flappie_tpu_torch import timing

        timing.reset()
        t0 = time.perf_counter()
        k = 0
        while True:
            d = k % len(self.inputs.dirs)
            s = time.perf_counter()
            n, called = self.job(d)
            e = time.perf_counter()
            self.jobs.append((d, n, called, s, e))
            k += 1
            if e - t0 >= seconds:
                break
        phases = timing.report()["phases"]
        samples = sum(self.dir_samples(d) for d, *_ in self.jobs)
        span = self.jobs[-1][4] - self.jobs[0][3]
        return {
            "window_s": span,
            "phase_s": {k: v["wall_s"] for k, v in phases.items()},
            "attempted": sum(j[1] for j in self.jobs),
            "failed": sum(j[1] - j[2] for j in self.jobs),
            "e2e": {"msamples_per_s": samples / span / 1e6},
            "reads": sorted({i for d, *_ in self.jobs for i in self.dir_reads(d)}),
            "job_reads": [self.dir_reads(d) for d, *_ in self.jobs],
        }

    def dir_reads(self, d: int) -> List[int]:
        return [i for f in self.inputs.dir_files[d] for i in self.inputs.files[f].reads]

    def dir_samples(self, d: int) -> int:
        return sum(self.inputs.reads[i].adc.size for i in self.dir_reads(d))

    def traced_stretch(self, n: int) -> List[int]:
        """``n`` more whole jobs (the profiler covers them); their reads."""
        reads = []
        for k in range(n):
            d = (len(self.jobs) + k) % len(self.inputs.dirs)
            self.job(d)
            reads.append(self.dir_reads(d))
        return reads

    def outputs(self) -> dict:
        """read index -> the output file holding its latest record."""
        return {i: self.last_out[d] for d in self.last_out for i in self.dir_reads(d)}

    def sample(self, win: dict, seed: int) -> List[int]:
        """Read indices whose records are compared, drawn from the seed:
        short reads, the longest, the rest at random."""
        rng = np.random.default_rng([seed, 7])
        c = self.cell.traffic["check"]
        outs = self.outputs()
        pool = [i for i in win["reads"] if i in outs]
        chunk = self.cell.config["decode"]["chunk_samples"]
        size = {i: self.inputs.reads[i].adc.size for i in pool}
        short = [i for i in pool if size[i] <= chunk]
        long_ = [i for i in pool if size[i] > chunk]
        pick = list(rng.choice(short, min(len(short), c["short_reads"]), replace=False)) if short else []
        rest = [i for i in long_ if i != max(pool, key=size.get)]
        pick += list(rng.choice(rest, min(len(rest), c["reads"] - len(pick) - 1), replace=False))
        pick.append(max(pool, key=size.get))
        return sorted({int(i) for i in pick})

    def records(self, idx) -> dict:
        """The program's records of reads ``idx``, as it wrote them (every
        record of the files that hold them)."""
        outs = self.outputs()
        got = {}
        for path in sorted({outs[i] for i in idx}):
            with open(path) as fh:
                got.update(check.parse_fastq(fh.read()))
        return got

    def close(self) -> None:
        self.caller.close()
        self.caller = None
