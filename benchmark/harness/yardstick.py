"""The arithmetic of the per-layer metrics: the card's peaks, a kernel's
least time, the model's operations, and the launch shapes a job's reads
need.

The bound is a frozen copy of chip_smoke.py ``bound`` with its peak
table, and the operation and byte counts of the recurrent layers (K1,
K7 with their affines) and of the CRF scans (K3/K4, K5, K6) follow
chip_smoke.py ``check_layer``, ``check_crf_scans`` and
``check_viterbi_traceback``, counted over valid rows and steps only.
The batching follows the program's public behaviour (flappie_tpu_torch/
basecall.py): reads longer than a chunk are cut into chunks
(``reference.signal.plan_chunks``) that fill batches of ``chunk_batch``
in read order; the others go by power-of-two bucket (from 2048 samples)
in batches of at most ``batch``.
"""

from __future__ import annotations

from typing import List, NamedTuple, Sequence

from ..reference.signal import plan_chunks

# NVIDIA's data sheets, dense rates: f32 outside the tensor cores, bf16 on
# them, HBM bandwidth; the SXM part at its 700 W limit, and the PCIe part
PEAKS = {
    "sxm": {"f32_ops": 67e12, "bf16_ops": 989e12, "bytes": 3.35e12},
    "pcie": {"f32_ops": 51e12, "bf16_ops": 756e12, "bytes": 2.0e12},
}
GATES = {"lstm": 4, "grumod": 3}
MIN_BUCKET = 2048


def peaks(kind: str) -> dict:
    return PEAKS["pcie" if "PCIe" in kind else "sxm"]


def bound_s(bytes_: float, ops: float, peak: dict) -> float:
    """The least time: the larger of the bytes at the memory rate and the
    f32 operations at the f32 rate."""
    return max(bytes_ / peak["bytes"], ops / peak["f32_ops"])


def stride(widths: dict) -> int:
    s = 1
    for c in widths["convs"]:
        s *= c["stride"]
    return s


def model_ops(widths: dict, nsample: int) -> float:
    """Multiply-adds x 2 of the network on one read of ``nsample``
    (trimmed) samples, each block once: the convolutions, the recurrent
    layers' affine and recurrent products, the head."""
    ops, n, c_in = 0.0, nsample, 1
    for c in widths["convs"]:
        n = -(-n // c["stride"])
        ops += 2.0 * n * c["winlen"] * c["in_ch"] * c["out_ch"]
        c_in = c["out_ch"]
    for r in widths["rnns"]:
        g = GATES[r["kind"]] * r["size"]
        ops += 2.0 * n * (c_in + r["size"]) * g
        c_in = r["size"]
    nb = widths["nbase"]
    return ops + 2.0 * n * c_in * 2 * nb * (nb + 1)


class Launch(NamedTuple):
    rows: int
    nvalid: int  # valid blocks over the rows


def bucket_length(n: int) -> int:
    b = MIN_BUCKET
    while b < n:
        b *= 2
    return b


def launches(trimmed: Sequence[int], widths: dict, decode: dict) -> List[Launch]:
    """The device batches one job of reads of these trimmed lengths
    gives, in the program's order."""
    s = stride(widths)
    chunk = decode["chunk_samples"] - decode["chunk_samples"] % s
    chunks, buckets = [], {}
    for n in trimmed:
        if n > chunk:
            chunks += [-(-c.length // s) for c in plan_chunks(n, s, chunk, decode["overlap"])[1]]
        else:
            buckets.setdefault(bucket_length(n), []).append(-(-n // s))
    out = []
    cb = decode["chunk_batch"]
    for k in range(0, len(chunks), cb):
        part = chunks[k:k + cb]
        out.append(Launch(len(part), sum(part)))
    for b in sorted(buckets):
        items = buckets[b]
        for k in range(0, len(items), decode["batch"]):
            part = items[k:k + decode["batch"]]
            out.append(Launch(len(part), sum(part)))
    return out


def rnn_bound_s(launch: Sequence[Launch], widths: dict, peak: dict) -> float:
    """Least time of every recurrent layer (its affine and recurrence,
    one kernel pair a layer) over these launches."""
    total = 0.0
    for ln in launch:
        c_in = widths["convs"][-1]["out_ch"]
        for r in widths["rnns"]:
            H = r["size"]
            G = GATES[r["kind"]] * H
            bytes_ = 4 * (ln.nvalid * c_in + c_in * G + G + H * G + ln.rows + ln.nvalid * H)
            total += bound_s(bytes_, 2.0 * ln.nvalid * (c_in + H) * G, peak)
            c_in = H
    return total


# sum-semiring scans a launch: the head's partition, then the posterior's
# forward and backward
SUM_SCANS = 3


def crf_bound_s(launch: Sequence[Launch], widths: dict, peak: dict) -> float:
    """Least time of the CRF kernels of these launches: SUM_SCANS
    sum scans (K3/K4), the Viterbi scan (K5), the traceback (K6)."""
    S = 2 * widths["nbase"]
    total = 0.0
    for ln in launch:
        nv, B = ln.nvalid, ln.rows
        dense = 4 * nv * S * S
        total += SUM_SCANS * bound_s(dense + 4 * nv + 4 * (nv + B) * S,
                                     nv * (5 * S * S + 5 * S), peak)
        total += bound_s(dense + 4 * nv + 4 * S * S + 4 * nv * S + 4 * S * B,
                         nv * (4 * S * S + 3 * S), peak)
        total += bound_s(4 * nv * S + 4 * nv + 4 * B + 4 * (nv + B), nv * S, peak)
    return total
