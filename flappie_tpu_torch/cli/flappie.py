"""flappie-compatible CLI on the PyTorch/CUDA port.

Counterpart of flappie_tpu/cli/flappie.py (reference src/flappie.c:42-399):
the same flags, defaults, glob/dir expansion and per-read fault
isolation, and the same output bytes.  Runs on ``cuda`` unless
``--device cpu`` is given (the counterpart of the JAX CLI's
JAX_PLATFORMS handling); without a GPU the default raises.

Run as ``python -m flappie_tpu_torch.cli.flappie reads/ > calls.fastq``.

``--trace FILE`` writes each read's trimmed signal and state-occupancy
trace to an HDF5 file (io/trace_h5.py: h5py where it is installed, else
signal/hdf5_min.py); FLAPPIE_TPU_PHASES=path|stderr dumps the per-phase
wall-clock accounting (timing.py) at exit.

``--fast`` runs the recurrent stack on the bf16 stream
(``Basecaller(stream=torch.bfloat16)``, ops/precision.py); it sets no
environment variable.

``--mesh N`` shards every device batch over N devices
(parallel/pipeline.py): the first N cards, or N replicas on the CPU under
``--device cpu``; it prints the dispatches' ``flappie-mesh: {json}``
summary on stderr at exit.  Multi-process runs go through
``python -m flappie_tpu_torch.parallel.launch``.  ``--jax-profile DIR``
(the JAX CLI's flag name, so that both parsers take the same flags)
records the basecalling loop with ``torch.profiler`` and writes a
Chrome trace under DIR.

FLAPPIE_TPU_PREWARM=1 runs ``Basecaller.prewarm_chunked`` (one dummy
chunk batch on the run's wire and group size) on a background thread
while the reads load and preprocess, when more than one file is given
and the chunked path is on; ``auto`` and ``0`` mean no prewarm (``auto``
prewarms only on a TPU in the JAX package).  A prewarm failure is raised
when the thread is joined, after the basecalling.
"""

from __future__ import annotations

import argparse
import contextlib
import glob as globmod
import json
import os
import sys
import threading

import torch

from .. import __version__, timing
from ..io.fastx import OUTFORMATS, format_read
from ..io.trace_h5 import TraceWriter
from ..models.config import FLAPPIE_MODELS, MODELS
from ..qcal import apply_qcal, parse_qcal
from ..signal.fast5 import iter_reads, read_raw

DEFAULT_MODEL = "r941_native"


def model_help_text(default_model: str = DEFAULT_MODEL, models=FLAPPIE_MODELS) -> str:
    lines = []
    for name in models:
        cfg = MODELS[name]
        tag = "(default)" if name == default_model else ""
        lines.append(f"{name:>10} : {cfg.description}  {tag}")
    return "\n".join(lines) + "\n"


def trim_pair(arg: str):
    parts = arg.split(":")
    start = int(parts[0])
    end = int(parts[1]) if len(parts) > 1 and parts[1] else start
    if start < 0 or end < 0:
        raise argparse.ArgumentTypeError("trim values must be >= 0")
    return start, end


def segmentation_pair(arg: str):
    parts = arg.split(":")
    if len(parts) != 2:
        raise argparse.ArgumentTypeError("--segmentation should be of form chunk:percentile")
    chunk = int(parts[0])
    thresh = float(parts[1]) / 100.0
    if not (0.0 < thresh < 1.0):
        raise argparse.ArgumentTypeError("percentile must be in (0, 100)")
    return chunk, thresh


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="flappie",
        description="Flappie basecaller -- basecall from raw signal",
    )
    p.add_argument("files", nargs="*", metavar="fast5", help="fast5 file or directory")
    p.add_argument("--version", action="version",
                   version=f"flappie {__version__} (flappie-tpu-torch)")
    p.add_argument("--delta", "-d", type=float, default=0.0, metavar="factor",
                   help="Use delta samples with scaling factor")
    p.add_argument("--format", "-f", default="fastq", metavar="format",
                   help="Format to output reads (fasta, fastq or sam)")
    p.add_argument("--limit", "-l", type=int, default=0, metavar="nreads",
                   help="Maximum number of reads to call (0 is unlimited)")
    p.add_argument("--model", "-m", default=DEFAULT_MODEL, metavar="name",
                   help='Model to use ("help" to list)')
    p.add_argument("--output", "-o", default=None, metavar="filename",
                   help="Write to file rather than stdout")
    p.add_argument("--prefix", "-p", default="", metavar="string",
                   help="Prefix to append to name of each read")
    p.add_argument("--reverse", "-r", dest="reverse", action="store_true", default=False,
                   help="Reverse output base calls")
    p.add_argument("--no-reverse", dest="reverse", action="store_false",
                   help="Don't reverse output base calls")
    p.add_argument("--temperature", type=float, default=1.0, metavar="factor",
                   help="Temperature for weights")
    p.add_argument("--trim", "-t", type=trim_pair, default=(200, 10), metavar="start:end",
                   help="Number of samples to trim, as start:end")
    p.add_argument("--trace", "-T", default=None, metavar="filename",
                   help="Dump trace to HDF5 file")
    p.add_argument("--licence", "--license", action="store_true", default=False,
                   help="Print licensing information")
    p.add_argument("--segmentation", type=segmentation_pair, default=(100, 0.0),
                   metavar="chunk:percentile",
                   help="Chunk size and percentile for variance based segmentation")
    p.add_argument("--viterbi", "-v", dest="viterbi", action="store_true", default=False,
                   help="Use viterbi decoding only")
    p.add_argument("--no-viterbi", "--fb", dest="viterbi", action="store_false",
                   help="Use forward-backward followed by viterbi")
    p.add_argument("--hdf5-compression", type=int, default=1, metavar="level",
                   help="Gzip compression level for HDF5 output (0:off, 1:quickest, 9:best)")
    p.add_argument("--hdf5-chunk", type=int, default=200, metavar="size",
                   help="Chunk size for HDF5 output")
    p.add_argument("--uuid", dest="uuid", action="store_true", default=True,
                   help="Output UUID")
    p.add_argument("--no-uuid", dest="uuid", action="store_false",
                   help="Output read file")
    # flappie-tpu extensions
    p.add_argument("--checkpoint", default=None, metavar="npz",
                   help="Model weights (npz checkpoint); synthetic if omitted")
    p.add_argument("--batch", type=int, default=32, metavar="B",
                   help="Maximum device batch size")
    p.add_argument("--chunk", type=int, default=None, metavar="samples",
                   help="Chunked fast path: reads longer than this are split into "
                        "overlapping chunks batched through one fixed-shape program "
                        "and stitched at overlap midpoints (default: 2560 blocks x "
                        "model stride = 12800 at stride 5, 5120 at stride 2; "
                        "0 disables)")
    p.add_argument("--overlap", type=int, default=1600, metavar="samples",
                   help="Chunk overlap; each stitched block sits at least "
                        "overlap/2 samples from its chunk's edges")
    p.add_argument("--chunk-batch", type=int, default=256, metavar="N",
                   help="Maximum chunks per device batch on the chunked path")
    p.add_argument("--mesh", type=int, default=0, metavar="N",
                   help="Shard each device batch over N devices (data "
                        "parallelism): the first N CUDA devices, or N "
                        "replicas on the CPU under --device cpu.  The "
                        "counterpart of the reference's `parallel -P N -X "
                        "flappie` fan-out; for multi-process runs use python "
                        "-m flappie_tpu_torch.parallel.launch")
    p.add_argument("--multi", action="store_true", default=False,
                   help="Basecall every read in multi-read fast5 files "
                        "(the reference only reads the first)")
    p.add_argument("--fast", action="store_true", default=False,
                   help="Speed mode: stream the recurrent layers' tensors in "
                        "bfloat16 (the bf16 stream: x, the block affine and "
                        "each layer's output in bf16; the state and the step "
                        "product stay f32).  Outputs shift within an accuracy "
                        "band instead of being byte-equal to the exact stream "
                        "(the band measured on the card: PERF.md); a model "
                        "whose recurrent stack is not fused runs f32")
    p.add_argument("--qcal", default=None, metavar="slope:offset|file",
                   help="Calibrate quality scores post-hoc: either "
                        "q' = slope*q + offset per base, or the path of "
                        "a QCAL JSON artifact with per-model isotonic "
                        "tables (the entry matching --model applies); "
                        "omit for raw model qualities (the byte-parity "
                        "default)")
    p.add_argument("--jax-profile", default=None, metavar="dir",
                   help="Profile the basecalling loop with torch.profiler "
                        "(host activity, and the card's kernels on CUDA) and "
                        "write it as the Chrome trace "
                        "dir/flappie.<pid>.pt.trace.json (chrome://tracing, "
                        "Perfetto or TensorBoard's profiler plugin); the "
                        "JAX CLI's flag name")
    # port extension
    p.add_argument("--device", default="cuda", metavar="name",
                   help="Torch device to run on (default cuda; 'cpu' runs the "
                        "kernels' plain PyTorch versions)")
    return p


def fast_stream(fast: bool):
    """``--fast``: the bf16 stream, passed explicitly; else None, which
    reads FLAPPIE_TPU_RNN_STREAM (f32 unless set)."""
    return torch.bfloat16 if fast else None


def make_caller(args):
    """The basecaller the flags ask for: a DistributedBasecaller over
    ``--mesh`` N > 1 devices, else a Basecaller on ``--device``.  Returns
    None, after saying why on stderr, when N exceeds the visible cards."""
    from ..basecall import Basecaller

    kw = dict(
        model=args.model,
        checkpoint=args.checkpoint,
        temperature=args.temperature,
        viterbi_only=args.viterbi,
        compute_trace=args.trace is not None,
        chunk=args.chunk,
        overlap=args.overlap,
        chunk_batch=args.chunk_batch,
        stream=fast_stream(args.fast),
    )
    if args.mesh <= 1:
        return Basecaller(device=args.device, **kw)
    from ..parallel.mesh import make_mesh
    from ..parallel.pipeline import DistributedBasecaller

    device = torch.device(args.device)
    devices = None  # the first N cards
    if device.type == "cuda":
        visible = torch.cuda.device_count()
        if args.mesh > visible:
            print(f"--mesh {args.mesh} exceeds the {visible} visible devices", file=sys.stderr)
            return None
    else:
        devices = [device] * args.mesh
    return DistributedBasecaller(mesh=make_mesh(args.mesh, devices=devices), **kw)


@contextlib.contextmanager
def torch_profile(logdir: str, cuda: bool):
    """``--jax-profile``: torch.profiler over the block (host activity,
    and the card's under ``cuda``), written as a Chrome trace to
    ``logdir/flappie.<pid>.pt.trace.json`` when the block ends."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    path = os.path.join(logdir, f"flappie.{os.getpid()}.pt.trace.json")
    prof.export_chrome_trace(path)
    print(f"flappie: profile written to {path}", file=sys.stderr)


def basecall(caller, args, reads):
    """``caller.basecall_raw_tables`` on ``reads`` with the flags'
    trimming, segmentation, delta, reversal and batch, under
    ``--jax-profile`` when it is given."""
    trim_start, trim_end = args.trim
    varseg_chunk, varseg_thresh = args.segmentation
    profile = (torch_profile(args.jax_profile, caller.device.type == "cuda")
               if args.jax_profile else contextlib.nullcontext())
    with profile:
        return caller.basecall_raw_tables(
            reads,
            trim_start=trim_start,
            trim_end=trim_end,
            varseg_chunk=varseg_chunk,
            varseg_thresh=varseg_thresh,
            delta=args.delta,
            reverse=args.reverse,
            max_batch=args.batch,
        )


class _Prewarm(threading.Thread):
    """``caller.prewarm_chunked()`` on a thread; its exception, if any,
    kept in ``error`` for the joiner to raise."""

    def __init__(self, caller):
        super().__init__(name="flappie-prewarm", daemon=True)
        self.caller, self.error = caller, None

    def run(self):
        try:
            self.caller.prewarm_chunked()
        except BaseException as exc:  # noqa: BLE001 - raised by the joiner
            self.error = exc


def start_prewarm(caller, nfiles: int):
    """The prewarm thread, started, under FLAPPIE_TPU_PREWARM=1 for a run
    of more than one file on the chunked path; else None."""
    if os.environ.get("FLAPPIE_TPU_PREWARM", "auto") != "1" or nfiles <= 1 or not caller.chunk:
        return None
    warm = _Prewarm(caller)
    warm.start()
    return warm


def expand_files(args_files):
    """Directory -> dir/*.fast5 glob; warn on misses (flappie.c:338-362)."""
    out = []
    for f in args_files:
        pattern = os.path.join(f, "*.fast5") if os.path.isdir(f) else f
        matches = sorted(globmod.glob(pattern))
        if not matches:
            print(
                f'File or directory "{f}" does not exist or no fast5 files found.',
                file=sys.stderr,
            )
            continue
        out.extend(matches)
    return out


def expand_reads(files, multi: bool):
    """(reads, names, fnames), one entry per read to basecall.

    With ``multi`` each file is read now and expanded to its reads
    (iter_reads; a file that yields none falls back to read_raw, whose
    invalid read reports the file).  Otherwise each file is one lazy
    read, materialised on the preprocessing thread so that fast5 IO
    overlaps dispatch (read_raw returns an invalid RawTable on failure,
    so fault isolation is unchanged)."""
    reads, names, fnames = [], [], []
    for fn in files:
        if multi:
            with timing.phase("fast5_read"):
                try:
                    rts = list(iter_reads(fn, scale_to_pA=True))
                except Exception:  # noqa: BLE001 - not a readable fast5: read_raw reports it
                    rts = []
                rts = rts or [read_raw(fn, scale_to_pA=True)]
        else:
            rts = [lambda fn=fn: read_raw(fn, scale_to_pA=True)]
        reads.extend(rts)
        names.extend([os.path.basename(fn)] * len(rts))
        fnames.extend([fn] * len(rts))
    return reads, names, fnames


def main(argv=None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)

    if args.licence:
        print("flappie-tpu-torch: a PyTorch/CUDA port of flappie-tpu, a "
              "reimplementation of the Flappie basecaller.")
        print("Original Flappie is (c) Oxford Nanopore Technologies, Ltd (ONT Public Licence).")
        return 0

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
    if not args.temperature > 0.0:
        print(f"Invalid temperature {args.temperature} -- must be > 0.", file=sys.stderr)
        return 1
    qcal = None
    if args.qcal:
        # validate up front: a malformed pair/file must fail BEFORE the
        # expensive basecalling run, not after it
        try:
            qcal = parse_qcal(args.qcal, model=args.model)
        except ValueError as exc:
            parser.error(str(exc))
    if not args.files:
        parser.error("the following arguments are required: fast5")

    files = expand_files(args.files)
    if args.limit > 0:
        files = files[: args.limit]

    caller = make_caller(args)
    if caller is None:
        return 1
    warm = start_prewarm(caller, len(files))

    reads, names, fnames = expand_reads(files, args.multi)
    if args.limit > 0:
        reads, names, fnames = reads[: args.limit], names[: args.limit], fnames[: args.limit]

    results = basecall(caller, args, reads)
    if warm is not None:
        warm.join()
        if warm.error is not None:
            raise warm.error

    out = open(args.output, "w") if args.output else sys.stdout
    try:
        with timing.phase("format_write"), TraceWriter(
                args.trace, args.hdf5_chunk, args.hdf5_compression) as tracer:
            for fn, name, res in zip(fnames, names, results):
                if res is None:
                    print(f"No basecall returned for {fn}", file=sys.stderr)
                    continue
                res = apply_qcal(res, qcal)
                out.write(format_read(args.format, res.uuid, name, args.uuid, args.prefix, res))
                out.flush()
                # under --multi --no-uuid the reads of one file share a
                # name, and the last one's group wins, as in the JAX CLI
                tracer.write(res.uuid if args.uuid else name, res)
    finally:
        if out is not sys.stdout:
            out.close()
    # FLAPPIE_TPU_PHASES=path|stderr: the per-phase wall-clock accounting
    timing.maybe_dump()
    if args.mesh > 1:
        # which programs ran and over how many devices each dispatch spanned
        print(f"flappie-mesh: {json.dumps(caller.wire_summary())}", file=sys.stderr)
    caller.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
