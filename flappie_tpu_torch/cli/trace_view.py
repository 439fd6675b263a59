"""Trace viewer: plot signal + per-state flip-flop probabilities.

A copy of the JAX package's trace viewer, the equivalent of
misc/trace_flipflop.py: reads flappie trace HDF5 files (``--trace``)
*and* Guppy basecalled fast5 files (single- or multi-read, detected by
the `file_version` attribute exactly as the reference does,
misc/trace_flipflop.py:140-165).  Top panel the normalised signal,
bottom panel the per-base state-occupancy bands - flip states solid,
flop states dashed (or negated with --flipflops).

Files open through h5py where it is installed, else through
signal/hdf5_min.py behind ``MinFile``; ``iter_traces`` needs neither h5py
nor matplotlib, and ``main`` imports matplotlib only to plot.  Run as
``python -m flappie_tpu_torch.cli.trace_view --output plots/ trace.h5``.
"""

from __future__ import annotations

import argparse
import contextlib
import posixpath
import sys

import numpy as np

from ..signal import hdf5_min

BASE = "ACGTZ"
COLOURS = {
    "classic": {"A": "green", "C": "blue", "G": "black", "T": "red", "Z": "purple"},
    "friendly": {"A": "#1b9e77", "C": "#7570b3", "G": "#666666", "T": "#d95f02", "Z": "#e7298a"},
}


def build_parser():
    p = argparse.ArgumentParser(prog="trace_flipflop", description=__doc__)
    p.add_argument("--analysis", default=0, type=int,
                   help="Guppy analysis number (Basecall_1D_NNN group)")
    p.add_argument("--colours", "--colors", default="classic", choices=sorted(COLOURS))
    p.add_argument("--depop", default=None, type=float,
                   help="Zero signal values with magnitude above threshold")
    p.add_argument("--limit", default=10, type=int, help="Maximum reads to plot")
    p.add_argument("--flipflops", default=False, action="store_true",
                   help="Plot the flop states as negative probabilities")
    p.add_argument("--output", default=None,
                   help="Write plots to PNG files with this prefix instead of showing")
    p.add_argument("hdf5")
    return p


class MinFile:
    """An hdf5_min.Node through the part of h5py's File/Group/Dataset
    interface that iter_traces uses: ``attrs``, ``keys()``, ``in``,
    indexing by a name or a path (KeyError where there is none) and
    ``[()]`` for a dataset's array."""

    def __init__(self, node: hdf5_min.Node):
        self.node = node

    @property
    def attrs(self) -> dict:
        return self.node.attrs

    def keys(self) -> list:
        return sorted(self.node.children, key=str.encode)  # h5py's name order

    def __contains__(self, path: str) -> bool:
        return self.node.get(path) is not None

    def __getitem__(self, key):
        if key == ():
            if self.node.data is None:
                raise KeyError("not a dataset")
            return self.node.data.copy()  # a fresh array, as h5py reads one
        node = self.node.get(key)
        if node is None:
            raise KeyError(key)
        return MinFile(node)


def open_file(path: str):
    """-> a context manager giving h5py's File, or a MinFile without h5py."""
    try:
        import h5py
    except ImportError:
        return contextlib.nullcontext(MinFile(hdf5_min.read(path)))
    return h5py.File(path, "r")


def classify(h5) -> str:
    """File-type sniff (misc/trace_flipflop.py:146-153): fast5 files
    carry a `file_version` root attribute; single-read fast5 have a
    root `Raw` group, multi-read fast5 one group per read."""
    if "file_version" in h5.attrs:
        return "single_read_fast5" if "Raw" in h5 else "multi_read_fast5"
    return "flappie_trace"


def iter_traces(h5, path: str, analysis: int):
    """Yield (read_name, signal, trace) per read, any supported layout.

    Flappie traces: per-read groups with float `signal` and uint8
    `trace` (scaled to [0,1]).  Guppy fast5: raw `Signal` scaled by 255
    and the `Basecall_1D_NNN/BaseCalled_template/Trace` table cropped to
    the template segment - same arithmetic as the reference viewer
    (misc/trace_flipflop.py:166-210, including its unscaled Guppy trace
    values).
    """
    ftype = classify(h5)
    if ftype == "flappie_trace":
        for read in list(h5.keys()):
            try:
                sig = h5[read]["signal"][()]
                trace = h5[read]["trace"][()] / 255.0
            except KeyError:
                print(f"Error: failed to read signal and trace for {read} "
                      "(Flappie trace file)", file=sys.stderr)
                continue
            yield read, sig, trace
        return

    reads = [path] if ftype == "single_read_fast5" else list(h5.keys())
    for read in reads:
        if ftype == "single_read_fast5":
            readh5 = h5
            try:
                readno = list(readh5["Raw/Reads"].keys())[0]
                sig = readh5[posixpath.join("Raw", "Reads", readno, "Signal")][()] / 255.0
            except (KeyError, IndexError):
                print(f"Error: failed to read signal for {read} "
                      "(Guppy single-read file)", file=sys.stderr)
                continue
        else:
            readh5 = h5[read]
            try:
                sig = readh5["Raw/Signal"][()] / 255.0
            except KeyError:
                print(f"Error: failed to read signal for {read} "
                      "(Guppy multi-read file)", file=sys.stderr)
                continue
        try:
            trace = readh5[posixpath.join(
                "Analyses", f"Basecall_1D_{analysis:03d}",
                "BaseCalled_template", "Trace")][()]
        except KeyError:
            print(f"Error: trace table for {read} not found in file -- "
                  "did Guppy write it?", file=sys.stderr)
            continue
        segpath = posixpath.join(
            "Analyses", f"Segmentation_{analysis:03d}", "Summary", "segmentation")
        try:
            sig_start = readh5[segpath].attrs["first_sample_template"]
            sig_length = readh5[segpath].attrs["duration_template"]
        except KeyError:
            print(f"Error: segmentation information for {read} not found in file",
                  file=sys.stderr)
            continue
        yield read, sig[sig_start : sig_start + sig_length], np.asarray(trace, float)


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    import matplotlib

    if args.output:
        matplotlib.use("Agg")
    import matplotlib.pyplot as pp

    colours = COLOURS[args.colours]
    nplotted = 0
    with open_file(args.hdf5) as h5:
        for read, sig, trace in iter_traces(h5, args.hdf5, args.analysis):
            if nplotted >= args.limit:
                break
            nbase = trace.shape[1] // 2
            assert nbase * 2 == trace.shape[1], "Trace table incorrect shape"
            assert nbase in (4, 5), "Unsupported number of bases"
            if args.flipflops:
                trace[:, nbase:] *= -1
            if args.depop is not None:
                sig = np.where(np.abs(sig) > args.depop, 0.0, sig)
            down = round(len(sig) / float(len(trace)))

            fig = pp.figure(figsize=(12, 6))
            ax1 = pp.subplot(211)
            pp.title(read)
            pp.ylabel("Normalised signal")
            pp.plot(np.arange(len(sig)), sig, color="grey", linewidth=0.5)
            pp.subplot(212, sharex=ax1)
            pp.xlabel("time (samples)")
            pp.ylabel("State probability")
            x2 = down * np.arange(len(trace))
            for i in range(nbase):
                c = colours[BASE[i]]
                pp.fill_between(x2, trace[:, i], color=c, alpha=0.3)
                pp.fill_between(x2, trace[:, i + nbase], color=c, alpha=0.3)
                pp.plot(x2, trace[:, i], color=c)
                pp.plot(x2, trace[:, i + nbase], color=c, linestyle="dashed")
            pp.grid()
            if args.output:
                fname = f"{args.output}{read.replace('/', '_')}.png"
                fig.savefig(fname, dpi=100)
                print(f"wrote {fname}")
                pp.close(fig)
            else:
                pp.show()
            nplotted += 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
