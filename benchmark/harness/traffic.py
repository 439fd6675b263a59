"""The one traffic generator: every mix is a data file of parameters
(``traffic/<mix>.json``) that this module reads.

A mix fixes the shape of its work from its own ``shape_seed``: the read
lengths, how they fall into files and directories, the order of the
reads in each file and directory.  The run's ``--seed`` draws the signal
of every read (and the program's weights).  So every seed brings the
same sizes in the same order, and the seed moves the content of the
work, not its amount: how soon a job's first batch fills depends on the
order of what came before, so the order is fixed too.

Keys of a mix:

- ``loop``: the module ``loops/<loop>.py`` that drives the program;
- ``reads``: ``law`` (the module ``laws/<law>.py`` that draws the
  lengths) and that law's parameters, ``mean_dwell`` (samples a base);
- ``files``: ``reads_per_file``, ``dirs`` (reads are dealt over the
  directories by length, so each directory holds a like mix);
- ``flags``: command-line flags the mix adds;
- ``warm``: jobs run in set-up; ``trace``: the jobs the profiler covers
  in a ``--trace 1`` run;
- ``check``: what the comparison with the reference samples (the loop
  reads it).
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import List

import numpy as np

from . import fast5, spec


@dataclass
class Read:
    index: int
    uuid: str
    adc: np.ndarray


@dataclass
class File:
    path: str
    reads: List[int]  # indices into Inputs.reads


@dataclass
class Inputs:
    reads: List[Read]
    files: List[File]
    dirs: List[str]
    dir_files: List[List[int]]  # the files of each directory


def lengths(mix: dict) -> np.ndarray:
    """The mix's read lengths, fixed by its shape seed."""
    p = mix["reads"]
    return spec.module("laws", p["law"]).draw(p, np.random.default_rng(mix["shape_seed"]))


def _groups(mix: dict) -> List[List[int]]:
    """Read indices of each file (by length, dealt so that groups are
    alike), fixed by the shape seed."""
    n = lengths(mix)
    per = mix["files"]["reads_per_file"]
    nfile = len(n) // per
    order = np.argsort(n, kind="stable")
    return [sorted(int(i) for i in order[f::nfile]) for f in range(nfile)]


def make(mix: dict, seed: int, root: str) -> Inputs:
    """Write the mix's fast5 files under ``root``, their signal drawn
    from ``seed``."""
    sig_rng = np.random.default_rng(seed)
    order_rng = np.random.default_rng([mix["shape_seed"], 2])
    n = lengths(mix)
    tag = f"{seed % (1 << 48):012x}"
    reads = [Read(i, f"{i:08x}-0000-4000-8000-{tag}",
                  fast5.synthetic_adc(int(n[i]), sig_rng, mix["reads"]["mean_dwell"]))
             for i in range(len(n))]
    groups = [list(order_rng.permutation(g)) for g in _groups(mix)]
    files, dirs, dir_files = [], [], []
    ndir = mix["files"]["dirs"]
    deal = np.argsort([n[g].sum() for g in groups], kind="stable")
    for d in range(ndir):
        path = os.path.join(root, f"dir{d}")
        os.makedirs(path)
        dirs.append(path)
        members = list(order_rng.permutation(deal[d::ndir]))
        dir_files.append([])
        for j, f in enumerate(members):
            dir_files[d].append(len(files))
            files.append(File(os.path.join(path, f"read{j:04d}.fast5"), groups[f]))
    for f in files:
        if len(f.reads) == 1 and mix["files"]["reads_per_file"] == 1:
            r = reads[f.reads[0]]
            fast5.write_single_read(f.path, r.adc, r.uuid)
        else:
            fast5.write_multi_read(f.path, [(reads[i].uuid, reads[i].adc) for i in f.reads])
    return Inputs(reads, files, dirs, dir_files)

