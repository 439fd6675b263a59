"""flappie-serve on the PyTorch/CUDA port: a long-lived basecalling server.

Counterpart of flappie_tpu/cli/serve.py.  The reference's unit of
deployment is one short-lived process per read (``find | parallel -X
flappie``, reference README.md:81-83), and every such process pays its
start-up again.  On the card that is the CUDA context, the kernels'
first-use builds and loads (ops/cuda_build.py), the cuDNN and cuBLAS
handles, the pinned-memory pool and the weight upload.  A server keeps
the Basecaller -- weights on the device, kernels loaded, its CUDA
streams and preprocessing path -- warm across requests, so request
N >= 2 pays only for its own data.

Two intake modes:

- **stdin** (default): one request per line, each a fast5 file or a
  directory (expanded to ``dir/*.fast5`` like the flappie CLI).  Records
  stream to stdout (or to one file per request with ``--output-dir``);
  a machine-readable ack per request goes to stderr:
  ``flappie-serve: done <request> reads=N called=M wall=S.SSs``.
  EOF ends the server.
- **watch** (``--watch DIR``): poll DIR for newly arrived ``*.fast5``
  every ``--poll`` seconds and basecall them as they land (the
  sequencer-output workflow).  A file is only picked up once its
  (size, mtime) is stable across one poll interval, so files still
  being written by the sequencer are never read partially.  A file
  named ``STOP`` in DIR (or ``--stop-file``) shuts the server down
  cleanly.

Per-read fault isolation matches the flappie CLI ("No basecall
returned for X" on stderr, the batch continues); a failed request
becomes an ``error`` ack and never kills the server, nor is it re-run on
another device.  ``--warmup`` basecalls one synthetic chunk-length read
at startup, then acks ``flappie-serve: ready``.

Runs on ``cuda`` unless ``--device cpu`` is given; without a GPU the
default raises.  ``--fast`` runs the recurrent stack on the bf16 stream,
as the flappie CLI's does.  FLAPPIE_TPU_PHASES=path|stderr dumps the
per-phase wall-clock accounting of every request (timing.py) at server
exit.

Run as ``python -m flappie_tpu_torch.cli.serve < requests.txt``.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

from .. import timing
from ..io.fastx import OUTFORMATS, format_read
from ..models.config import MODELS
from ..qcal import apply_qcal, parse_qcal
from .flappie import (
    DEFAULT_MODEL,
    expand_files,
    expand_reads,
    fast_stream,
    model_help_text,
    segmentation_pair,
    trim_pair,
)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="flappie-serve",
        description="Long-lived flappie basecalling server "
                    "(warm weights + loaded kernels across requests)",
    )
    p.add_argument("--model", "-m", default=DEFAULT_MODEL, metavar="name",
                   help='Model to use ("help" to list)')
    p.add_argument("--checkpoint", default=None, metavar="npz",
                   help="Model weights (npz checkpoint); synthetic if omitted")
    p.add_argument("--format", "-f", default="fastq", metavar="format",
                   help="Output format (fasta, fastq or sam)")
    p.add_argument("--prefix", "-p", default="", metavar="string")
    p.add_argument("--uuid", dest="uuid", action="store_true", default=True)
    p.add_argument("--no-uuid", dest="uuid", action="store_false")
    p.add_argument("--delta", "-d", type=float, default=0.0, metavar="factor")
    p.add_argument("--reverse", "-r", action="store_true", default=False)
    p.add_argument("--temperature", type=float, default=1.0, metavar="factor")
    p.add_argument("--trim", "-t", type=trim_pair, default=(200, 10), metavar="start:end")
    p.add_argument("--segmentation", type=segmentation_pair, default=(100, 0.0),
                   metavar="chunk:percentile")
    p.add_argument("--viterbi", "-v", dest="viterbi", action="store_true", default=False)
    p.add_argument("--no-viterbi", "--fb", dest="viterbi", action="store_false")
    p.add_argument("--batch", type=int, default=32, metavar="B")
    p.add_argument("--chunk", type=int, default=None, metavar="samples")
    p.add_argument("--overlap", type=int, default=1600, metavar="samples")
    p.add_argument("--chunk-batch", type=int, default=256, metavar="N")
    p.add_argument("--multi", action="store_true", default=False,
                   help="Basecall every read in multi-read fast5 files")
    p.add_argument("--fast", action="store_true", default=False,
                   help="bf16 stream mode (see flappie --fast)")
    p.add_argument("--qcal", default=None, metavar="slope:offset",
                   help="Calibrate quality scores post-hoc (see flappie "
                        "--qcal; fit the pair with tools/qscore_calibrate.py)")
    # serve-specific
    p.add_argument("--output-dir", default=None, metavar="dir",
                   help="Write one <request-stem>.<format> file per request "
                        "(atomic tmp+rename) instead of streaming to stdout")
    p.add_argument("--watch", default=None, metavar="dir",
                   help="Watch a directory for newly arrived fast5 files "
                        "instead of reading requests from stdin")
    p.add_argument("--poll", type=float, default=2.0, metavar="seconds",
                   help="Watch-mode poll interval")
    p.add_argument("--stop-file", default=None, metavar="path",
                   help="Watch mode stops when this file appears "
                        "(default: <watch-dir>/STOP)")
    p.add_argument("--warmup", action="store_true", default=False,
                   help="Run the chunked program once on a synthetic read "
                        "before serving (acks 'ready' on stderr)")
    # port extension
    p.add_argument("--device", default="cuda", metavar="name",
                   help="Torch device to run on (default cuda; 'cpu' runs the "
                        "kernels' plain PyTorch versions)")
    return p


def _ack(msg: str) -> None:
    print(f"flappie-serve: {msg}", file=sys.stderr, flush=True)


class Server:
    """Holds the warm Basecaller and basecalls one request at a time."""

    def __init__(self, args):
        from ..basecall import Basecaller

        self.args = args
        self._dest_owner: dict = {}
        self.qcal = None
        if args.qcal:
            self.qcal = parse_qcal(args.qcal, model=args.model)
        self.caller = Basecaller(
            model=args.model,
            checkpoint=args.checkpoint,
            temperature=args.temperature,
            viterbi_only=args.viterbi,
            compute_trace=False,
            chunk=args.chunk,
            overlap=args.overlap,
            chunk_batch=args.chunk_batch,
            device=args.device,
            stream=fast_stream(args.fast),
        )

    def warmup(self) -> None:
        """Basecall one synthetic read one sample longer than the chunk
        size, so the chunked program and the preprocessing path have run
        once before request 1.

        Nothing is compiled for a shape here: the programs are eager
        PyTorch.  On the card this run builds (with nvcc, where the build
        directory lacks one or holds one older than its source) and loads
        every CUDA kernel that the chunk program launches (K1 or K7,
        K3/K4 or K9, K5, K6, and K10 under FLAPPIE_TPU_CONV_IMPL=pallas),
        creates the cuDNN and cuBLAS handles and the batch streams'
        first pinned buffers, and is waited for on the device.  The
        weights were uploaded when the Basecaller was made.  With
        ``--chunk 0`` the read takes a bucket program, which launches the
        same kernels."""
        import numpy as np

        from ..signal.preprocess import RawTable

        n = int(self.caller.chunk or 12800) + self.args.trim[0] + self.args.trim[1] + 1
        rng = np.random.default_rng(0)
        raw = (rng.standard_normal(n) * 20.0 + 100.0).astype(np.float32)
        rt = RawTable(uuid="warmup", n=n, start=0, end=n, raw=raw)
        self._call([rt])
        if self.caller.device.type == "cuda":
            import torch

            torch.cuda.synchronize(self.caller.device)

    def _call(self, reads):
        a = self.args
        return self.caller.basecall_raw_tables(
            reads,
            trim_start=a.trim[0], trim_end=a.trim[1],
            varseg_chunk=a.segmentation[0], varseg_thresh=a.segmentation[1],
            delta=a.delta, reverse=a.reverse, max_batch=a.batch,
        )

    def handle(self, request: str, out) -> tuple[int, int]:
        """Basecall one request (file or directory) into ``out``.

        Returns (reads_seen, reads_called).  Per-read failures are
        reported and skipped, same contract as the flappie CLI.
        """
        reads, names, fnames = expand_reads(expand_files([request]), self.args.multi)
        results = self._call(reads) if reads else []
        called = 0
        for fn, name, res in zip(fnames, names, results):
            if res is None:
                print(f"No basecall returned for {fn}", file=sys.stderr)
                continue
            res = apply_qcal(res, self.qcal)
            out.write(format_read(self.args.format, res.uuid, name,
                                  self.args.uuid, self.args.prefix, res))
            called += 1
        out.flush()
        return len(reads), called

    def handle_to_dest(self, request: str, publish_if=None) -> tuple[int, int, str]:
        """Route one request to stdout or an atomic per-request file.

        ``publish_if(n, called)``, when given, decides AFTER basecalling
        whether the result file is published at all: a watch-mode
        attempt that will be retried must never rename its tmp file to
        the final name, or a downstream consumer triggered by file
        appearance would ingest an empty result that is silently
        replaced later.  Unpublished attempts return dest=None.
        """
        a = self.args
        if not a.output_dir:
            n, called = self.handle(request, sys.stdout)
            return n, called, "-"
        os.makedirs(a.output_dir, exist_ok=True)
        stem = os.path.splitext(os.path.basename(request.rstrip("/")))[0]
        dest = os.path.join(a.output_dir, f"{stem}.{a.format}")
        # two DIFFERENT requests sharing a basename (run1/a.fast5,
        # run2/a.fast5) must not clobber each other; a repeat of the
        # SAME request keeps its name (idempotent reprocessing)
        if self._dest_owner.get(dest, request) != request:
            import hashlib

            h = hashlib.sha1(request.encode()).hexdigest()[:8]
            dest = os.path.join(a.output_dir, f"{stem}-{h}.{a.format}")
        self._dest_owner[dest] = request
        tmp = dest + ".tmp"
        try:
            with open(tmp, "w") as out:
                n, called = self.handle(request, out)
            if publish_if is not None and not publish_if(n, called):
                os.unlink(tmp)
                return n, called, None
            os.replace(tmp, dest)  # atomic: watchers never see partial files
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise
        return n, called, dest


def serve_stdin(server: Server) -> int:
    for line in sys.stdin:
        request = line.strip()
        if not request:
            continue
        t0 = time.monotonic()
        try:
            n, called, dest = server.handle_to_dest(request)
        except Exception as exc:  # noqa: BLE001 - request isolation
            _ack(f"error {request} ({exc})")
            continue
        _ack(f"done {request} reads={n} called={called} "
             f"wall={time.monotonic() - t0:.2f}s"
             + (f" output={dest}" if dest != "-" else ""))
    return 0


def watch_scan(path_stats, seen: set, pending: dict, now: float,
               min_age: float) -> list:
    """One watch poll: which candidate files are READY to basecall.

    A sequencer (or a copy) may still be writing a fast5 when it first
    appears; reading it then fails the whole request.  A file is ready
    only once its (size, mtime) signature has been UNCHANGED for at
    least ``min_age`` seconds of wall time — a wall-clock age, not a
    poll count, because polls are back-to-back whenever the previous
    poll produced work.  Atomically-renamed files are ready on the
    first poll at least ``min_age`` after they appear.

    ``path_stats``: iterable of (path, signature) for files present
    this poll; ``pending`` maps path -> (signature, first_seen_time).
    Mutates ``seen``/``pending``; returns ready paths in order.
    """
    ready = []
    for path, sig in path_stats:
        if path in seen:
            continue
        prev = pending.get(path)
        if prev is not None and prev[0] == sig:
            if now - prev[1] >= min_age:
                ready.append(path)
                seen.add(path)
                del pending[path]
        else:
            pending[path] = (sig, now)
    return ready


MAX_WATCH_RETRIES = 2


def serve_watch(server: Server) -> int:
    a = server.args
    stop_file = a.stop_file or os.path.join(a.watch, "STOP")
    seen: set[str] = set()
    pending: dict[str, tuple] = {}
    retries: dict[str, int] = {}
    while True:
        if os.path.exists(stop_file):
            _ack("stopping (stop file present)")
            return 0
        try:
            listing = sorted(
                fn for fn in os.listdir(a.watch) if fn.endswith(".fast5")
            )
        except FileNotFoundError:
            _ack(f"watch directory {a.watch} vanished; stopping")
            return 1
        current = set()
        path_stats = []
        for fn in listing:
            path = os.path.join(a.watch, fn)
            current.add(path)
            if path in seen:
                continue
            try:
                st = os.stat(path)
            except OSError:
                continue  # raced with a rename/delete; next poll decides
            path_stats.append((path, (st.st_size, st.st_mtime_ns)))
        # multi-day runs must not grow state without bound: files that
        # left the directory need no memory (a re-appearing same name is
        # a new file and is correctly re-processed)
        seen &= current
        for stale in [p for p in pending if p not in current]:
            del pending[stale]
        for stale in [p for p in retries if p not in current]:
            del retries[stale]
        # os.path.join(dir, "") normalises the trailing separator so a
        # --watch path given WITH a trailing slash still matches the
        # os.path.join-built request paths (a.watch + os.sep would not)
        watch_prefix = os.path.join(a.watch, "")
        for stale in [d for d, req in server._dest_owner.items()
                      if req.startswith(watch_prefix) and req not in current]:
            del server._dest_owner[stale]
        new = watch_scan(path_stats, seen, pending, time.monotonic(), a.poll)
        for path in new:
            t0 = time.monotonic()
            # the retry decision is made BEFORE publishing: an attempt
            # that will be retried never renames its tmp file, so
            # appearance-triggered consumers never see an empty result
            will_retry = (
                lambda n_, c_: not (
                    c_ == 0 and retries.get(path, 0) < MAX_WATCH_RETRIES
                )
            )
            try:
                n, called, dest = server.handle_to_dest(
                    path, publish_if=will_retry
                )
            except Exception as exc:  # noqa: BLE001
                _ack(f"error {path} ({exc})")
                continue
            if called == 0 and retries.get(path, 0) < MAX_WATCH_RETRIES:
                # nothing basecalled: the file may still have been
                # mid-write (stability gating is a heuristic).  Give it
                # another stability cycle; bounded so a genuinely
                # corrupt file cannot retry forever.
                retries[path] = retries.get(path, 0) + 1
                seen.discard(path)
                _ack(f"retry {path} (no reads called, attempt "
                     f"{retries[path]}/{MAX_WATCH_RETRIES})")
                continue
            _ack(f"done {path} reads={n} called={called} "
                 f"wall={time.monotonic() - t0:.2f}s"
                 + (f" output={dest}" if dest not in ("-", None) else ""))
        if not new:
            time.sleep(a.poll)


def main(argv=None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)

    if args.model.lower() == "help":
        sys.stdout.write(model_help_text())
        return 0
    if args.model not in MODELS:
        print(f'Invalid Flappie model "{args.model}".')
        sys.stdout.write(model_help_text())
        return 1
    if args.format not in OUTFORMATS:
        print(f'Unrecognised output format "{args.format}".', file=sys.stderr)
        return 1
    if not args.temperature > 0:
        print(f"Invalid temperature {args.temperature}.", file=sys.stderr)
        return 1
    if args.qcal:
        try:
            parse_qcal(args.qcal, model=args.model)
        except ValueError as exc:
            parser.error(str(exc))

    server = Server(args)
    if args.warmup:
        server.warmup()
    _ack("ready")
    try:
        if args.watch:
            return serve_watch(server)
        return serve_stdin(server)
    finally:
        # FLAPPIE_TPU_PHASES=path|stderr: cumulative per-phase wall
        # accounting across all requests, as the flappie CLI dumps it
        timing.maybe_dump()


if __name__ == "__main__":
    sys.exit(main())
