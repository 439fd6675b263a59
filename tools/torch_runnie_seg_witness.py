"""Runnie's records under the ``seg`` CRF impl against the other impls, on
the CPU, in the PyTorch port and in the JAX package.

chip_smoke.py's runnie phase holds runnie under FLAPPIE_TPU_CRF_IMPL=seg
on the card to the default impl, and counts the records that meet
compare_runs' strict rule (base and dwell equal, shape and scale within
2e-5).  This script gives the same count off the card: the same reads
(chip_smoke's runnie reads, seed 20261017, the first ``--reads`` of
them), each CLI run in its own process on the CPU (the port's with
``--device cpu``, the JAX package's with JAX_PLATFORMS=cpu), and for
each pair of runs the records that meet the strict rule.  This process
imports the port's read writer, never JAX.

    python tools/torch_runnie_seg_witness.py [--reads 8] [--threads 4]

The last line of its output is one JSON object: the records and run
counts of each run, each run's wall and the strict count of each pair.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

import chip_smoke  # noqa: E402  (read writer, .run parser and the strict rule)

RUNS = {  # name: (module, env, extra arguments)
    "port_auto": ("flappie_tpu_torch.cli.runnie", {}, ["--device", "cpu"]),
    "port_seg": ("flappie_tpu_torch.cli.runnie", {"FLAPPIE_TPU_CRF_IMPL": "seg"},
                 ["--device", "cpu"]),
    "port_scan": ("flappie_tpu_torch.cli.runnie", {"FLAPPIE_TPU_CRF_IMPL": "scan"},
                  ["--device", "cpu"]),
    "jax_seg": ("flappie_tpu.cli.runnie", {"FLAPPIE_TPU_CRF_IMPL": "seg"}, []),
    "jax_scan": ("flappie_tpu.cli.runnie", {"FLAPPIE_TPU_CRF_IMPL": "scan"}, []),
}
PAIRS = (("port_seg", "port_scan"), ("jax_seg", "jax_scan"), ("port_seg", "port_auto"),
         ("port_seg", "jax_seg"), ("port_scan", "jax_scan"), ("port_scan", "port_auto"))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reads", type=int, default=chip_smoke.RUNNIE_SEG_READS)
    ap.add_argument("--threads", type=int, default=4)
    ap.add_argument("--out", default=os.path.join(HERE, "build", "runnie_seg_witness"))
    args = ap.parse_args()

    import numpy as np

    shutil.rmtree(args.out, ignore_errors=True)
    all_reads = os.path.join(args.out, "all")
    chip_smoke.write_reads(np, np.random.default_rng(20261017), all_reads,
                           *chip_smoke.RUNNIE_READS)
    reads = os.path.join(args.out, "reads")
    os.makedirs(reads)
    for name in sorted(os.listdir(all_reads))[: args.reads]:
        shutil.copy(os.path.join(all_reads, name), reads)

    recs, walls = {}, {}
    for name, (module, env, extra) in RUNS.items():
        out = os.path.join(args.out, f"{name}.run")
        run_env = dict(os.environ, JAX_PLATFORMS="cpu", OMP_NUM_THREADS=str(args.threads),
                       **env)
        t0 = time.perf_counter()
        subprocess.run([sys.executable, "-m", module, reads, "-o", out, *extra], env=run_env,
                       cwd=HERE, check=True)
        walls[name] = time.perf_counter() - t0
        with open(out) as fh:
            recs[name] = chip_smoke.parse_run(fh.read())
        print(f"{name}: {len(recs[name])} records in {walls[name]:.1f} s", flush=True)

    strict = {}
    for a, b in PAIRS:
        uuids = sorted(recs[b])
        if sorted(recs[a]) != uuids:
            raise SystemExit(f"{a} vs {b}: records differ: {sorted(recs[a])} vs {uuids}")
        ok = [u for u in uuids if chip_smoke.strict_runs(recs[a][u], recs[b][u])]
        strict[f"{a} vs {b}"] = len(ok)
        detail = {u[-3:]: (len(recs[a][u]), len(recs[b][u]),
                           round(chip_smoke.identity("".join(x[0] for x in recs[a][u]),
                                                     "".join(x[0] for x in recs[b][u])), 6))
                  for u in uuids if u not in ok}
        print(f"{a} vs {b}: {len(ok)} of {len(uuids)} records meet the strict rule; the "
              f"others (uuid tail: runs, runs, identity) {json.dumps(detail)}", flush=True)
    print(json.dumps({"reads": args.reads,
                      "runs": {n: {u[-3:]: len(r) for u, r in sorted(v.items())}
                               for n, v in recs.items()},
                      "wall_s": walls, "strict": strict}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
