"""One cell's specification, found by the names in BENCHMARK.json.

Everything that belongs to one configuration, traffic mix or per-layer
metric is a file of its own beside this package:

- ``configs/<config>.json`` (the path is the configuration's ``file``):
  the program's model key, the published widths and their source, the
  precision, the command-line flags, the ``FLAPPIE_TPU_*`` knobs, and
  the decode settings the plain reference follows;
- ``traffic/<mix>.json``: the parameters the one generator reads; its
  ``loop`` names the module ``loops/<loop>.py`` that drives the program
  with them, and its ``reads.law`` the read-length law ``laws/<law>.py``;
- ``reference/<family>.py``, named by the configuration's ``reference``:
  the family's plain reference, which also makes its weights;
- ``limits/<workload>.json``: the limit of each number that decides
  ``correct`` in that cell, with the readings it was set from;
- ``metrics/<metric>.py``: a reader with ``read(ctx)`` returning the
  metric's value, or None where it finds nothing to read.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import os
from dataclasses import dataclass, field
from typing import Callable, Dict, List

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: List[dict]
    per_layer: List[dict]
    readers: Dict[str, Callable] = field(default_factory=dict)


def _load_json(path: str) -> dict:
    with open(path) as fh:
        return json.load(fh)


def reader(name: str) -> Callable:
    """``metrics/<name>.py``'s ``read``."""
    path = os.path.join(BENCH_DIR, "metrics", f"{name}.py")
    mod_spec = importlib.util.spec_from_file_location(f"bench_metric_{name}", path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod.read


def module(kind: str, name: str):
    """The module ``<kind>/<name>.py`` of the benchmark (``loops``,
    ``laws``, ``reference``)."""
    if not name.isidentifier():
        raise KeyError(f"{kind} {name!r} is not a module name")
    return importlib.import_module(f"benchmark.{kind}.{name}")


def load(workload: str, root: str = ROOT) -> Cell:
    """The cell of BENCHMARK.json named ``workload``."""
    bench = _load_json(os.path.join(root, "BENCHMARK.json"))
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json; known: {', '.join(cells)}")
    w = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    config = _load_json(os.path.join(root, configs[w["config"]]["file"]))
    traffic = _load_json(os.path.join(BENCH_DIR, "traffic", f"{w['traffic']}.json"))
    limits = _load_json(os.path.join(BENCH_DIR, "limits", f"{workload}.json"))
    e2e = [m for m in bench["end_to_end"] if workload in m.get("workloads", [workload])]
    reported = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if (workload in m["workloads"] if "workloads" in m else m["moves"] in reported)]
    cell = Cell(workload, int(w["chips"]), config, traffic, limits, e2e, per_layer)
    cell.readers = {m["name"]: reader(m["name"]) for m in per_layer}
    return cell
