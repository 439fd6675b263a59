"""Run one cell of BENCHMARK.json once.

    python3 benchmark/run.py --workload r941_native.offline --seed 7 --seconds 51 --trace 0

from the root of a checkout.  The last line of standard output is the
result (JSON); the numbers that decided ``correct`` close standard error.
"""

import argparse
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="benchmark/run.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = p.parse_args(argv)
    from benchmark.harness import cell

    return cell.run(a.workload, a.seed, a.seconds, bool(a.trace))


if __name__ == "__main__":
    sys.exit(main())
