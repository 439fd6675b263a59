"""runnie-compatible CLI on the PyTorch/CUDA port.

Counterpart of flappie_tpu/cli/runnie.py (reference src/runnie.c): the
same flags and the same ``.run`` text, a ``# uuid`` line per read
followed by ``base\\tshape\\tscale\\tdwell`` per called base.  Runs on
``cuda`` unless ``--device cpu`` is given; without a GPU the default
raises.

    python -m flappie_tpu_torch.cli.runnie reads/ > calls.run
    python -m flappie_tpu_torch.cli.decode_runnie calls.run > calls.fasta

Reads are preprocessed on the host, bucketed by padded length and
batched, at most ``--batch`` to a program; each program runs the
network, the run-length posterior (unless ``--viterbi``) and the Viterbi
decode on the device, and returns only the path and the path-selected
shape and scale weights.  ``--fast`` runs the recurrent stack on the
bf16 stream (ops/precision.py), passed to the programs explicitly.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from .. import __version__, resolve_device
from ..basecall import _DeviceQueue, _Pipeline, _unpack_i16, bucket_length, pack_bucket
from ..decode.runlength import rle_transpost, rle_viterbi, runs_from_selected
from ..io.run_format import write_run_record
from ..models.config import get_model_config
from ..models.network import stream_params, transitions
from ..ops import precision
from ..models.params import init_synthetic, load_npz, params_to_torch, validate
from ..signal.fast5 import read_raw
from ..signal.preprocess import normalise_signal, trim_and_segment
from .flappie import expand_files, fast_stream, segmentation_pair, trim_pair

MODEL = "rle_r941_native"


def _device_runnie(params, signal, lengths, cfg, temperature, viterbi_only,
                   stream=torch.float32):
    """Batched forward + run-length decode: (nblocks, score, path int8
    [B, T], shape_sel [B, T], scale_sel [B, T]), the shape and scale
    weights of each block's path base -- all runs_from_selected needs to
    rebuild the .run records bit for bit (~9 bytes a block).  ``stream``:
    the recurrent stack's stream dtype."""
    out, nblocks = transitions(params, cfg, signal, lengths, temperature, stream=stream)
    if not viterbi_only:
        out = rle_transpost(out, nblocks, cfg.nbase)
    score, path = rle_viterbi(out, nblocks, cfg.nbase)
    base = torch.where(path < cfg.nbase, path, path - cfg.nbase).to(torch.int64)[..., None]
    shape_sel = torch.gather(out, 2, base)[..., 0]
    scale_sel = torch.gather(out, 2, cfg.nbase + base)[..., 0]
    return nblocks, score, path.to(torch.int8), shape_sel, scale_sel


def _pack_runnie_out(nblocks, path, shape_sel, scale_sel):
    """[B, T path int8 | 4T shape f32 | 4T scale f32 | 4 nblocks i32] bytes."""
    B, T = path.shape

    def as_bytes(x):
        return x.contiguous().view(torch.uint8).reshape(B, -1)

    return torch.cat([as_bytes(path), as_bytes(shape_sel), as_bytes(scale_sel),
                      as_bytes(nblocks.to(torch.int32)[:, None])], dim=1)


def _device_runnie_packed(params, buf, cfg, temperature, viterbi_only, stream=torch.float32):
    """f32 wire: [B, bucket+4] (host-normalised signal + float-encoded
    length, basecall.pack_chunk_inputs) in, the byte matrix out."""
    nblocks, _, path, shape_sel, scale_sel = _device_runnie(
        params, buf[:, :-4], buf[:, -4].to(torch.int32), cfg, temperature, viterbi_only,
        stream)
    return _pack_runnie_out(nblocks, path, shape_sel, scale_sel)


def _device_runnie_packed_i16(params, buf, cfg, temperature, viterbi_only,
                              stream=torch.float32):
    """int16 wire: [B, bucket+16] ADC counts with their calibration and
    normalisation scalars, normalised on the device as the flappie
    programs do (basecall._unpack_i16); the same byte matrix out."""
    sig, lengths, _qlo, _qhi = _unpack_i16(buf)
    nblocks, _, path, shape_sel, scale_sel = _device_runnie(
        params, sig, lengths, cfg, temperature, viterbi_only, stream)
    return _pack_runnie_out(nblocks, path, shape_sel, scale_sel)


def _unpack_runnie(buf: np.ndarray, T: int):
    path = buf[:, :T].astype(np.int8)
    shape_sel = buf[:, T : 5 * T].copy().view(np.float32)
    scale_sel = buf[:, 5 * T : 9 * T].copy().view(np.float32)
    nblocks = buf[:, 9 * T : 9 * T + 4].copy().view(np.int32)[:, 0]
    return nblocks, path, shape_sel, scale_sel


def build_parser():
    p = argparse.ArgumentParser(
        prog="runnie", description="Runnie basecaller -- basecall from raw signal")
    # nargs="*" so --licence/--version work with no inputs
    p.add_argument("files", nargs="*", metavar="fast5")
    p.add_argument("--version", action="version",
                   version=f"runnie {__version__} (flappie-tpu-torch)")
    p.add_argument("--delta", "-d", type=float, default=0.0, metavar="factor")
    p.add_argument("--limit", "-l", type=int, default=0, metavar="nreads")
    p.add_argument("--output", "-o", default=None, metavar="filename")
    p.add_argument("--prefix", "-p", default="", metavar="string")
    p.add_argument("--temperature", type=float, default=1.0, metavar="factor")
    p.add_argument("--trim", "-t", type=trim_pair, default=(200, 10), metavar="start:end")
    p.add_argument("--viterbi", "-v", dest="viterbi", action="store_true", default=False)
    p.add_argument("--no-viterbi", "--fb", dest="viterbi", action="store_false")
    p.add_argument("--licence", "--license", action="store_true", default=False)
    p.add_argument("--segmentation", type=segmentation_pair, default=(100, 0.0),
                   metavar="chunk:percentile")
    p.add_argument("--uuid", dest="uuid", action="store_true", default=True)
    p.add_argument("--no-uuid", dest="uuid", action="store_false")
    p.add_argument("--checkpoint", default=None, metavar="npz")
    p.add_argument("--batch", type=int, default=32, metavar="B",
                   help="Maximum device batch size (reads bucket by padded length "
                        "and batch within a bucket)")
    p.add_argument("--fast", action="store_true", default=False,
                   help="Speed mode: stream the recurrent layers' tensors in "
                        "bfloat16 (the bf16 stream: x, the block affine and "
                        "each layer's output in bf16; the state and the step "
                        "product stay f32).  Outputs shift within an accuracy "
                        "band instead of being byte-equal to the exact stream "
                        "(the band measured on the card: PERF.md); a model "
                        "whose recurrent stack is not fused runs f32")
    # port extension
    p.add_argument("--device", default="cuda", metavar="name",
                   help="Torch device to run on (default cuda; 'cpu' runs the "
                        "kernels' plain PyTorch versions)")
    return p


def main(argv=None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)
    if args.licence:
        print("runnie-tpu-torch: a PyTorch/CUDA port of runnie-tpu, a reimplementation "
              "of the Runnie basecaller.")
        print("Original Runnie is (c) Oxford Nanopore Technologies, Ltd (ONT Public Licence).")
        return 0
    if not args.files:
        parser.error("the following arguments are required: fast5")

    device = resolve_device(args.device)
    cfg = get_model_config(MODEL)
    params = load_npz(args.checkpoint) if args.checkpoint else init_synthetic(cfg, seed=0)
    validate(params, cfg)
    stream = precision.check_stream(fast_stream(args.fast))
    # under the bf16 stream each layer's iW is rounded once, here
    params = stream_params(params_to_torch(params, device), cfg, stream)
    queue = _DeviceQueue(device)

    files = expand_files(args.files)
    if args.limit > 0:
        files = files[: args.limit]
    trim_start, trim_end = args.trim
    varseg_chunk, varseg_thresh = args.segmentation

    # Preprocess every read, bucket by padded length, batch within a
    # bucket; results are written in input order
    order = []  # per input position: the read or None
    for fn in files:
        rt = read_raw(fn, scale_to_pA=True)
        if rt.raw is not None:
            rt = trim_and_segment(rt, trim_start, trim_end, varseg_chunk, varseg_thresh)
        if rt.raw is None or not rt.valid:
            print(f"No basecall returned for {fn}", file=sys.stderr)
            order.append(None)
            continue
        normalise_signal(rt, args.delta)
        order.append(rt)
    by_bucket: dict = {}
    for pos, rt in enumerate(order):
        if rt is not None:
            by_bucket.setdefault(bucket_length(rt.active().size), []).append((pos, rt))

    def _dispatch(items, bucket):
        i16, buf = pack_bucket(items, bucket)
        program = _device_runnie_packed_i16 if i16 else _device_runnie_packed
        return (items, bucket), queue.run(
            lambda dev: program(params, dev, cfg, args.temperature, args.viterbi, stream), buf)

    results = {}  # input position -> list[RunRecord]

    def _collect(tag, out):
        items, bucket = tag
        T = -(-bucket // cfg.total_stride)
        nblocks, path, shape_sel, scale_sel = _unpack_runnie(out, T)
        for j, (pos, _) in enumerate(items):
            results[pos] = runs_from_selected(
                path[j], shape_sel[j], scale_sel[j], int(nblocks[j]), cfg.nbase)

    pipe = _Pipeline(_collect)
    for bucket, items in sorted(by_bucket.items()):
        for ofs in range(0, len(items), args.batch):
            pipe.push(*_dispatch(items[ofs : ofs + args.batch], bucket))
    pipe.drain()

    out = open(args.output, "w") if args.output else sys.stdout
    try:
        for pos, rt in enumerate(order):
            if rt is not None:
                # Reference quirk: the .run header is always "# <uuid>";
                # --prefix and --uuid/--no-uuid are parsed but never read
                # (src/runnie.c:277)
                write_run_record(out, rt.uuid, results[pos])
    finally:
        if out is not sys.stdout:
            out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
