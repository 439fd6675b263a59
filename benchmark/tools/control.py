"""Readings that the limits of ``correct`` are set from, for one cell,
in one process: for each seed, the program's numbers (its timed entry on
a short stretch at the cell's own sizes: one job of the loop) and the
control's (the reference computed
in TF32, put in the program's place), both against the float32
reference on the same sampled reads.

    python3 benchmark/tools/control.py --workload r941_native.offline --seeds 1,2,3 \\
        --out control.jsonl [--device cuda]

One JSON line a seed goes to ``--out`` and to standard output.
"""

import argparse
import json
import os
import shutil
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, ROOT)


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--device", default="cuda")
    p.add_argument("--no-control", action="store_true")
    a = p.parse_args(argv)
    import gc

    import torch

    from benchmark.harness import cell as cell_mod
    from benchmark.harness import check, env, spec

    cell = spec.load(a.workload)
    env.apply(cell.config)
    import flappie_tpu_torch  # noqa: F401

    os.makedirs(os.path.dirname(os.path.abspath(a.out)), exist_ok=True)
    for seed in (int(s) for s in a.seeds.split(",")):
        tmp = tempfile.mkdtemp(prefix="flappie-control-")
        try:
            t0 = time.perf_counter()
            inputs, params, loop = cell_mod.prepare(cell, seed, a.device, tmp, 0)
            win = loop.window(0.0)  # one job
            idx = loop.sample(win, seed)
            got = loop.records(idx)
            loop.close()
            del loop
            gc.collect()
            if a.device == "cuda":
                torch.cuda.empty_cache()
            t1 = time.perf_counter()
            want = cell_mod.reference_records(cell, inputs, params, idx, a.device)
            per = {"program": [], "control": []}
            row = {"workload": a.workload, "seed": seed, "reads": len(idx),
                   "program": check.compare(got, want, per["program"])}
            t2 = time.perf_counter()
            if not a.no_control:
                low = cell_mod.reference_records(cell, inputs, params, idx, a.device, "tf32")
                row["control"] = check.compare(low, want, per["control"])
            row["per_read"] = per
            row["seconds"] = {"program": t1 - t0, "reference": t2 - t1,
                              "control": time.perf_counter() - t2}
            line = json.dumps(row)
            print(line, flush=True)
            with open(a.out, "a") as fh:
                fh.write(line + "\n")
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
