"""A minimal HDF5 reader and writer for the fast5 layouts.

Used by signal/fast5.py only where h5py is not installed.  It writes
the single-read layout (and any tree of at most 8 entries a group) and
reads the single- and multi-read layouts: the reader walks a group's
B-tree to any depth, so a multi-read file that libhdf5 wrote with
hundreds of ``read_*`` groups reads as well.  The writer
emits the classic HDF5 structures (superblock version 0, version-1
object headers, symbol-table groups with a version-1 B-tree, a local
heap and one symbol-table node, contiguous datasets, compact attributes)
that libhdf5 itself writes with its default settings, so h5py reads the
files it makes.  The reader walks the same structures: groups, their
attributes (fixed-point, floating-point and fixed-length string
scalars) and contiguous numeric datasets.  Anything else -- chunked or
compressed datasets, dense attribute storage, version-2 object headers
-- raises ValueError, which fast5.read_raw turns into an invalid read.
"""

from __future__ import annotations

import struct
from typing import Dict, Optional

import numpy as np

SIGNATURE = b"\x89HDF\r\n\x1a\n"
UNDEF = 0xFFFFFFFFFFFFFFFF
LEAF_K, NODE_K = 4, 16  # symbol-table node and group B-tree K values


class Node:
    """A group (``children``) or a dataset (``data``), with attributes."""

    def __init__(self, attrs=None, children=None, data=None):
        self.attrs: Dict[str, object] = dict(attrs or {})
        self.children: Dict[str, "Node"] = dict(children or {})
        self.data: Optional[np.ndarray] = data

    def get(self, path: str) -> Optional["Node"]:
        node = self
        for part in [p for p in path.split("/") if p]:
            node = node.children.get(part)
            if node is None:
                return None
        return node


def _pad8(b: bytes) -> bytes:
    return b + b"\0" * (-len(b) % 8)


# -- writer ------------------------------------------------------------------


def _dtype_msg(value) -> bytes:
    if isinstance(value, bytes):  # fixed-length ASCII string, null-padded
        return struct.pack("<B3BI", 0x13, 0x01, 0, 0, len(value))
    arr = np.asarray(value)
    if arr.dtype.kind == "f" and arr.dtype.itemsize == 8:
        return struct.pack("<B3BIHHBBBBI", 0x11, 0x20, 0x3F, 0, 8, 0, 64, 52, 11, 0, 52, 1023)
    if arr.dtype.kind == "i":
        return struct.pack("<B3BIHH", 0x10, 0x08, 0, 0, arr.dtype.itemsize, 0,
                           8 * arr.dtype.itemsize)
    raise ValueError(f"hdf5_min: unsupported type {arr.dtype}")


def _dataspace_msg(shape) -> bytes:
    return struct.pack("<BBBBI", 1, len(shape), 0, 0, 0) + b"".join(
        struct.pack("<Q", n) for n in shape)


def _message(mtype: int, data: bytes) -> bytes:
    data = _pad8(data)
    return struct.pack("<HHB3x", mtype, len(data), 0) + data


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

    def dataset(self, node: Node) -> int:
        data = np.ascontiguousarray(node.data)
        addr = self._put(data.tobytes())
        msgs = [
            _message(0x01, _dataspace_msg(data.shape)),
            _message(0x03, _dtype_msg(data.dtype.type(0))),
            _message(0x05, struct.pack("<BBBB", 2, 1, 2, 0)),  # fill value: none
            _message(0x08, struct.pack("<BBQQ", 3, 1, addr, data.nbytes)),
        ] + [_attribute(k, v) for k, v in node.attrs.items()]
        return self._put(_object_header(msgs))

    def group(self, node: Node):
        """-> (object header, B-tree, local heap) addresses."""
        names = sorted(node.children)
        if len(names) > 2 * LEAF_K:
            raise ValueError("hdf5_min: at most 8 entries per group")
        entries, heap, offsets = [], bytearray(8), []
        for name in names:
            child = node.children[name]
            offsets.append(len(heap))
            heap += _pad8(name.encode() + b"\0")
            if child.data is not None:
                entries.append((offsets[-1], self.dataset(child), 0, 0, 0))
            else:
                oh, bt, hp = self.group(child)
                entries.append((offsets[-1], oh, 1, bt, hp))
        heap_data = self._put(bytes(heap))
        # free-list head 1 is libhdf5's "no free block" (H5HL_FREE_NULL)
        heap_addr = self._put(b"HEAP" + struct.pack("<B3xQQQ", 0, len(heap), 1, heap_data))
        snod = b"SNOD" + struct.pack("<BBH", 1, 0, len(entries))
        for off, oh, cache, bt, hp in entries:
            snod += struct.pack("<QQII", off, oh, cache, 0) + struct.pack("<QQ", bt, hp)
        snod += b"\0" * (40 * (2 * LEAF_K - len(entries)))
        keys = [0] + ([offsets[-1]] if entries else [])
        children = [self._put(snod)] if entries else []
        tree = b"TREE" + struct.pack("<BBHQQ", 0, 0, len(children), UNDEF, UNDEF)
        for i in range(2 * NODE_K):
            tree += struct.pack("<Q", keys[i] if i < len(keys) else 0)
            tree += struct.pack("<Q", children[i] if i < len(children) else 0)
        tree += struct.pack("<Q", keys[-1] if len(keys) > 2 * NODE_K else 0)
        bt_addr = self._put(tree)
        msgs = [_message(0x11, struct.pack("<QQ", bt_addr, heap_addr))]
        msgs += [_attribute(k, v) for k, v in node.attrs.items()]
        return self._put(_object_header(msgs)), bt_addr, heap_addr


def write(filename: str, root: Node) -> None:
    """Write the tree under ``root`` as an HDF5 file."""
    w = _Writer()
    oh, bt, hp = w.group(root)
    sb = SIGNATURE + struct.pack("<BBBBBBBBHHI", 0, 0, 0, 0, 0, 8, 8, 0, LEAF_K, NODE_K, 0)
    sb += struct.pack("<QQQQ", 0, UNDEF, len(w.buf), UNDEF)
    sb += struct.pack("<QQII", 0, oh, 1, 0) + struct.pack("<QQ", bt, hp)
    w.buf[:96] = sb
    with open(filename, "wb") as fh:
        fh.write(bytes(w.buf))


# -- reader ------------------------------------------------------------------


class _Reader:
    def __init__(self, raw: bytes):
        self.raw = raw

    def u(self, fmt: str, off: int):
        return struct.unpack_from("<" + fmt, self.raw, off)

    def messages(self, addr: int):
        version, _, nmsg, _, size = self.u("BBHII", addr)
        if version != 1:
            raise ValueError("hdf5_min: only version-1 object headers")
        blocks, out = [(addr + 16, size)], []
        while blocks and len(out) < nmsg:
            pos, size = blocks.pop(0)
            end = pos + size
            while pos + 8 <= end and len(out) < nmsg:
                mtype, msize, _flags = self.u("HHB", pos)
                data = self.raw[pos + 8 : pos + 8 + msize]
                if mtype == 0x10:  # continuation
                    blocks.append(struct.unpack_from("<QQ", data))
                out.append((mtype, data))
                pos += 8 + msize
        return out

    @staticmethod
    def dtype(data: bytes):
        """-> numpy dtype, or 'str' for a fixed-length string."""
        cls, size = data[0] & 0x0F, struct.unpack_from("<I", data, 4)[0]
        if cls == 0:
            signed = bool(data[1] & 0x08)
            return np.dtype(f"<{'i' if signed else 'u'}{size}")
        if cls == 1:
            return np.dtype(f"<f{size}")
        if cls == 3:
            return "str"
        raise ValueError(f"hdf5_min: unsupported datatype class {cls}")

    @staticmethod
    def shape(data: bytes):
        version, rank = data[0], data[1]
        base = 8 if version == 1 else 4
        return tuple(struct.unpack_from(f"<{rank}Q", data, base)) if rank else ()

    def attribute(self, data: bytes):
        version, _, nlen, dtlen, dslen = struct.unpack_from("<BBHHH", data)
        if version != 1:
            raise ValueError("hdf5_min: only version-1 attribute messages")
        pos = 8
        name = data[pos : pos + nlen - 1].decode()
        pos += nlen + (-nlen % 8)
        dt = self.dtype(data[pos : pos + dtlen])
        size = struct.unpack_from("<I", data, pos + 4)[0]
        pos += dtlen + (-dtlen % 8)
        shape = self.shape(data[pos : pos + dslen])
        pos += dslen + (-dslen % 8)
        n = int(np.prod(shape)) if shape else 1
        raw = data[pos : pos + n * size]
        if dt == "str":
            val = np.bytes_(raw.rstrip(b"\0"))
        else:
            val = np.frombuffer(raw, dt).reshape(shape)
            val = val[()] if not shape else val
        return name, val

    def node(self, addr: int) -> Node:
        msgs = self.messages(addr)
        node = Node()
        shape, dt, layout = None, None, None
        for mtype, data in msgs:
            if mtype == 0x0C:
                k, v = self.attribute(data)
                node.attrs[k] = v
            elif mtype == 0x11:
                bt, heap = struct.unpack_from("<QQ", data)
                node.children = self.group(bt, heap)
            elif mtype == 0x01:
                shape = self.shape(data)
            elif mtype == 0x03:
                dt = self.dtype(data)
            elif mtype == 0x08:
                if data[0] != 3 or data[1] != 1:
                    raise ValueError("hdf5_min: only contiguous version-3 layouts")
                layout = struct.unpack_from("<QQ", data, 2)
        if layout is not None:
            if dt is None or dt == "str" or shape is None:
                raise ValueError("hdf5_min: unsupported dataset")
            daddr, size = layout
            n = int(np.prod(shape)) if shape else 1
            node.data = (np.zeros(shape, dt) if daddr == UNDEF else
                         np.frombuffer(self.raw, dt, n, daddr).reshape(shape).copy())
        return node

    def group(self, btree: int, heap: int) -> Dict[str, Node]:
        if self.raw[heap : heap + 4] != b"HEAP":
            raise ValueError("hdf5_min: bad local heap")
        heap_data = self.u("Q", heap + 24)[0]
        out: Dict[str, Node] = {}
        stack = [btree]
        while stack:
            addr = stack.pop()
            if self.raw[addr : addr + 4] != b"TREE":
                raise ValueError("hdf5_min: bad group B-tree node")
            _ntype, level, used = self.u("BBH", addr + 4)
            for i in range(used):
                child = self.u("Q", addr + 24 + 16 * i + 8)[0]
                if level > 0:
                    stack.append(child)
                    continue
                if self.raw[child : child + 4] != b"SNOD":
                    raise ValueError("hdf5_min: bad symbol-table node")
                nsym = self.u("H", child + 6)[0]
                for j in range(nsym):
                    off, oh = self.u("QQ", child + 8 + 40 * j)
                    end = self.raw.index(b"\0", heap_data + off)
                    out[self.raw[heap_data + off : end].decode()] = self.node(oh)
        return out


def read(filename: str) -> Node:
    """Read an HDF5 file of the supported subset into a Node tree."""
    with open(filename, "rb") as fh:
        raw = fh.read()
    if raw[:8] != SIGNATURE or raw[8] != 0:
        raise ValueError("hdf5_min: not an HDF5 file with a version-0 superblock")
    root_oh = struct.unpack_from("<Q", raw, 24 + 32 + 8)[0]
    return _Reader(raw).node(root_oh)
