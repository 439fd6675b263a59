"""Seeded synthetic reads and the fast5 files that carry them.

Frozen copies, each from the file named above it: the signal generator,
and a minimal HDF5 writer (contiguous datasets only, the classic
structures libhdf5 writes with its default settings, so h5py and the
program's own reader both read the files).  The single-read layout is
the one the original flappie reads (``/Raw/Reads/Read_<n>`` with its
``Signal`` and ``read_id``, ``/UniqueGlobalKey/channel_id``); the
multi-read layout has one ``read_<uuid>`` group a read, each with its own
``channel_id``.
"""

from __future__ import annotations

import struct
from typing import Dict, Optional

import numpy as np

# fast5 calibration of every synthetic read (a MinION channel's)
CHANNEL = {"digitisation": 8192.0, "offset": 16.0, "range": 1373.41, "sampling_rate": 4000.0}


# -- flappie_tpu_torch/signal/synthetic.py synthetic_adc --------------------------

def synthetic_adc(n: int, rng: np.random.Generator, mean_dwell: float = 9.0) -> np.ndarray:
    """[n] int16 ADC counts: piecewise-constant levels with geometric
    dwells (``mean_dwell`` samples a base) plus Gaussian noise."""
    nevent = int(n / mean_dwell) + 16
    dwell = rng.geometric(1.0 / mean_dwell, size=nevent)
    level = 500.0 + 60.0 * rng.standard_normal(nevent)
    sig = np.repeat(level, dwell)[:n]
    if sig.size < n:
        sig = np.concatenate([sig, np.full(n - sig.size, level[-1])])
    sig = sig + 12.0 * rng.standard_normal(n)
    return np.clip(np.round(sig), -32768, 32767).astype(np.int16)


# -- flappie_tpu_torch/signal/hdf5_min.py, the writer (contiguous datasets) ------

SIGNATURE = b"\x89HDF\r\n\x1a\n"
UNDEF = 0xFFFFFFFFFFFFFFFF
LEAF_K, NODE_K = 4, 16


class Node:
    """A group (``children``) or a contiguous dataset (``data``)."""

    def __init__(self, attrs=None, children=None, data=None):
        self.attrs: Dict[str, object] = dict(attrs or {})
        self.children: Dict[str, "Node"] = dict(children or {})
        self.data: Optional[np.ndarray] = data


def _pad8(b: bytes) -> bytes:
    return b + b"\0" * (-len(b) % 8)


def _dtype_msg(value) -> bytes:
    if isinstance(value, bytes):
        return struct.pack("<B3BI", 0x13, 0x01, 0, 0, len(value))
    dt = np.asarray(value).dtype
    size = dt.itemsize
    if dt.kind == "f" and size in (4, 8):
        sign, exp_loc, exp_size, bias = (31, 23, 8, 127) if size == 4 else (63, 52, 11, 1023)
        return struct.pack("<B3BIHHBBBBI", 0x11, 0x20, sign, 0, size, 0, 8 * size,
                           exp_loc, exp_size, 0, exp_loc, bias)
    if dt.kind in "iu":
        return struct.pack("<B3BIHH", 0x10, 0x08 if dt.kind == "i" else 0, 0, 0, size, 0,
                           8 * size)
    raise ValueError(f"unsupported type {dt}")


def _dataspace_msg(shape) -> bytes:
    return struct.pack("<BBBBI", 1, len(shape), 0, 0, 0) + b"".join(
        struct.pack("<Q", n) for n in shape)


def _message(mtype: int, data: bytes, flags: int = 0) -> bytes:
    data = _pad8(data)
    return struct.pack("<HHB3x", mtype, len(data), flags) + data


def _object_header(messages) -> bytes:
    body = b"".join(messages)
    return struct.pack("<BBHII4x", 1, 0, len(messages), 1, len(body)) + body


def _attribute(name: str, value) -> bytes:
    if isinstance(value, str):
        value = value.encode()
    dt = _dtype_msg(value)
    raw = value if isinstance(value, bytes) else np.asarray(value).tobytes()
    ds = _dataspace_msg(())
    nm = name.encode() + b"\0"
    return _message(0x0C, struct.pack("<BBHHH", 1, 0, len(nm), len(dt), len(ds))
                    + _pad8(nm) + _pad8(dt) + _pad8(ds) + raw)


class _Writer:
    def __init__(self):
        self.buf = bytearray(96)  # superblock, written last

    def _put(self, blob: bytes) -> int:
        addr = len(self.buf)
        self.buf += _pad8(blob)
        return addr

    def _tree(self, ntype: int, children: list, keys: list, width: int) -> int:
        key_size = len(keys[0])
        size = 24 + 8 * width + key_size * (width + 1)
        step = size + (-size % 8)
        level = 0
        while True:
            spans = [range(i, min(i + width, len(children)))
                     for i in range(0, len(children), width)] or [range(0)]
            base = len(self.buf)
            up_children, up_keys = [], []
            for k, span in enumerate(spans):
                left = base + (k - 1) * step if k else UNDEF
                right = base + (k + 1) * step if k + 1 < len(spans) else UNDEF
                node = b"TREE" + struct.pack("<BBHQQ", ntype, level, len(span), left, right)
                for i in span:
                    node += keys[i] + struct.pack("<Q", children[i])
                node += keys[span.stop]
                up_children.append(self._put(node + b"\0" * (size - len(node))))
                up_keys.append(keys[span.start])
            if len(spans) == 1:
                return up_children[0]
            children, keys, level = up_children, up_keys + [keys[len(children)]], level + 1

    def dataset(self, node: Node) -> int:
        data = np.ascontiguousarray(node.data)
        addr = self._put(data.tobytes())
        msgs = [_message(0x01, _dataspace_msg(data.shape)),
                _message(0x03, _dtype_msg(data.dtype.type(0)), flags=1),
                _message(0x05, struct.pack("<BBBB", 2, 1, 2, 0)),
                _message(0x08, struct.pack("<BBQQ", 3, 1, addr, data.nbytes))]
        msgs += [_attribute(k, v) for k, v in node.attrs.items()]
        return self._put(_object_header(msgs))

    def group(self, node: Node):
        entries, heap = [], bytearray(8)
        for name in sorted(node.children, key=str.encode):
            child = node.children[name]
            offset = len(heap)
            heap += _pad8(name.encode() + b"\0")
            if child.data is not None:
                entries.append((offset, self.dataset(child), 0, 0, 0))
            else:
                oh, bt, hp = self.group(child)
                entries.append((offset, oh, 1, bt, hp))
        heap_data = self._put(bytes(heap))
        heap_addr = self._put(b"HEAP" + struct.pack("<B3xQQQ", 0, len(heap), 1, heap_data))
        snods, keys = [], [struct.pack("<Q", 0)]
        for i in range(0, len(entries), 2 * LEAF_K):
            part = entries[i : i + 2 * LEAF_K]
            snod = b"SNOD" + struct.pack("<BBH", 1, 0, len(part))
            for off, oh, cache, bt, hp in part:
                snod += struct.pack("<QQII", off, oh, cache, 0) + struct.pack("<QQ", bt, hp)
            snods.append(self._put(snod + b"\0" * (40 * (2 * LEAF_K - len(part)))))
            keys.append(struct.pack("<Q", part[-1][0]))
        bt_addr = self._tree(0, snods, keys, 2 * NODE_K)
        msgs = [_message(0x11, struct.pack("<QQ", bt_addr, heap_addr))]
        msgs += [_attribute(k, v) for k, v in node.attrs.items()]
        return self._put(_object_header(msgs)), bt_addr, heap_addr


def write_hdf5(filename: str, root: Node) -> None:
    w = _Writer()
    oh, bt, hp = w.group(root)
    sb = SIGNATURE + struct.pack("<BBBBBBBBHHI", 0, 0, 0, 0, 0, 8, 8, 0, LEAF_K, NODE_K, 0)
    sb += struct.pack("<QQQQ", 0, UNDEF, len(w.buf), UNDEF)
    sb += struct.pack("<QQII", 0, oh, 1, 0) + struct.pack("<QQ", bt, hp)
    w.buf[:96] = sb
    with open(filename, "wb") as fh:
        fh.write(bytes(w.buf))


# -- the fast5 layouts (flappie_tpu_torch/signal/fast5.py write_single_read_fast5) --

def _channel() -> Node:
    return Node(attrs={**{k: np.float64(v) for k, v in CHANNEL.items()},
                       "channel_number": np.bytes_("1")})


def write_single_read(filename: str, adc: np.ndarray, read_id: str) -> None:
    read = Node(attrs={"read_id": np.bytes_(read_id), "read_number": np.int32(1)},
                children={"Signal": Node(data=np.asarray(adc, np.int16))})
    write_hdf5(filename, Node(children={
        "Raw": Node(children={"Reads": Node(children={"Read_1": read})}),
        "UniqueGlobalKey": Node(children={"channel_id": _channel()}),
    }))


def write_multi_read(filename: str, reads) -> None:
    """``reads``: (read id, int16 ADC) pairs, one ``read_<id>`` group each."""
    groups = {f"read_{uuid}": Node(children={
        "Raw": Node(attrs={"read_id": np.bytes_(uuid)},
                    children={"Signal": Node(data=np.asarray(adc, np.int16))}),
        "channel_id": _channel(),
    }) for uuid, adc in reads}
    write_hdf5(filename, Node(attrs={"file_version": np.bytes_("2.0")}, children=groups))
