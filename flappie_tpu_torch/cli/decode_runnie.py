"""decode_runnie: expand runnie .run output into FASTA.

A host copy of flappie_tpu/cli/decode_runnie.py (itself a port of
misc/decode_runnie.py: same flags, same estimator, same 60-column FASTA
output).  Run as ``python -m flappie_tpu_torch.cli.decode_runnie
calls.run`` (or with the .run text on standard input).
"""

from __future__ import annotations

import argparse
import sys

from ..io.run_format import (
    DEFAULT_SCALE,
    DEFAULT_SHAPE,
    read_run_records,
    rlc_basecall,
    runlength_basecall,
    wrap_fasta,
)


def positive(mytype):
    def conv(v):
        x = mytype(v)
        if x <= 0:
            raise argparse.ArgumentTypeError("Argument must be positive")
        return x

    return conv


def _decode_one(job):
    """Pool worker: (name, rows, rlc, shape, scale) -> (name, basecall)."""
    name, rows, rlc, shape, scale = job
    if rlc:
        return name, rlc_basecall(rows)
    return name, runlength_basecall(rows, shape, scale)


def build_parser():
    p = argparse.ArgumentParser(prog="decode_runnie")
    p.add_argument("--limit", default=None, type=positive(int),
                   help="Limit number of reads processed")
    p.add_argument("--threads", "-t", default=1, type=positive(int),
                   help="Number of worker processes "
                        "(misc/decode_runnie.py:46-47)")
    p.add_argument("--rlc", default=False, action="store_true",
                   help="Call run-length compressed sequence")
    p.add_argument("--no-rlc", dest="rlc", action="store_false",
                   help="Don't call run-length compressed sequence")
    p.add_argument("--run_max", default=50, type=positive(int),
                   help="Maximum run for mean approximation")
    p.add_argument("--scale", default=DEFAULT_SCALE, nargs=4, type=positive(float),
                   metavar=("scaleA", "scaleC", "scaleG", "scaleT"),
                   help="Factors for per-base scale parameter")
    p.add_argument("--shape", default=DEFAULT_SHAPE, nargs=4, type=positive(float),
                   metavar=("shapeA", "shapeC", "shapeG", "shapeT"),
                   help="Factors for per-base shape parameter")
    p.add_argument("--width", default=60, type=positive(int),
                   help="Line width for Fasta output")
    p.add_argument("file", default="/dev/stdin", nargs="?")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    def jobs(fh):
        n = 0
        for name, rows in read_run_records(fh):
            if args.limit is not None and n >= args.limit:
                break
            n += 1
            yield name, rows, args.rlc, args.shape, args.scale

    def emit(name, basecall):
        if basecall is None:
            sys.stderr.write(f"No basecall returned for {name}\n")
            return
        sys.stdout.write(wrap_fasta(name, basecall, args.width))

    with open(args.file, "r") as fh:
        if args.threads > 1:
            # worker Pool exactly like the reference
            # (misc/decode_runnie.py:139); imap preserves input order.
            # Spawn context: a fork()ed child of a multithreaded process
            # (torch's thread pools) can deadlock.
            import multiprocessing as mp

            with mp.get_context("spawn").Pool(args.threads) as pool:
                for name, basecall in pool.imap(_decode_one, jobs(fh)):
                    emit(name, basecall)
        else:
            for job in jobs(fh):
                emit(*_decode_one(job))
    return 0


if __name__ == "__main__":
    sys.exit(main())
