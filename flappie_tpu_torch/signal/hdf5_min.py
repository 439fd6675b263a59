"""A minimal HDF5 reader and writer for the fast5 and trace layouts.

Used where h5py is not installed: by signal/fast5.py (single- and
multi-read fast5) and io/trace_h5.py (the flappie ``--trace`` file).  The
writer emits the classic HDF5 structures that libhdf5 itself writes with
its default settings (h5py's ``libver="earliest"``), so h5py reads the
files it makes: superblock version 0, version-1 object headers,
symbol-table groups (a local heap, symbol-table nodes of up to 8 entries
under a version-1 B-tree of as many levels as the entries need, so a
group holds any number of entries), compact attributes, and datasets
that are contiguous or chunked.  A chunked dataset has a version-3
layout message of class 2 indexed by a version-1 B-tree of node type 1,
and optionally a version-1 filter pipeline of shuffle (filter 2) then
deflate (filter 1, a zlib stream), h5py's order; an edge chunk is stored
padded to the full chunk shape, as libhdf5 stores it.

The reader walks the same structures: groups of any size, attributes
(fixed-point, floating-point and fixed-length string scalars) and
numeric datasets, contiguous or chunked with any of the shuffle and
deflate filters -- so it reads the files that h5py wrote with its
defaults, the JAX package's trace files included.  Anything else --
other filters, other layouts, dense attribute storage, version-2 object
headers -- raises ValueError, which fast5.read_raw turns into an invalid
read.
"""

from __future__ import annotations

import itertools
import struct
import zlib
from typing import Dict, Optional, Tuple

import numpy as np

SIGNATURE = b"\x89HDF\r\n\x1a\n"
UNDEF = 0xFFFFFFFFFFFFFFFF
LEAF_K, NODE_K = 4, 16  # symbol-table node and group B-tree K values
ISTORE_K = 32  # chunk B-tree K (superblock version 0 does not store it)
DEFLATE, SHUFFLE = 1, 2  # filter ids


class Node:
    """A group (``children``) or a dataset (``data``), with attributes.

    A dataset with ``chunks`` is stored chunked, filtered by shuffle when
    ``shuffle`` is set and by deflate at level ``compression`` when it is
    above 0; without ``chunks`` it is contiguous and unfiltered."""

    def __init__(self, attrs=None, children=None, data=None, chunks=None,
                 compression: int = 0, shuffle: bool = False):
        self.attrs: Dict[str, object] = dict(attrs or {})
        self.children: Dict[str, "Node"] = dict(children or {})
        self.data: Optional[np.ndarray] = data
        self.chunks: Optional[Tuple[int, ...]] = tuple(chunks) if chunks is not None else None
        self.compression = int(compression)
        self.shuffle = bool(shuffle)

    def get(self, path: str) -> Optional["Node"]:
        node = self
        for part in [p for p in path.split("/") if p]:
            node = node.children.get(part)
            if node is None:
                return None
        return node


def _pad8(b: bytes) -> bytes:
    return b + b"\0" * (-len(b) % 8)


def _shuffle(raw: bytes, itemsize: int) -> bytes:
    """HDF5's shuffle filter: byte j of every element, for each j in turn."""
    return np.frombuffer(raw, np.uint8).reshape(-1, itemsize).T.tobytes()


def _unshuffle(raw: bytes, itemsize: int) -> bytes:
    return np.frombuffer(raw, np.uint8).reshape(itemsize, -1).T.tobytes()


# -- writer ------------------------------------------------------------------


def _dtype_msg(value) -> bytes:
    if isinstance(value, bytes):  # fixed-length ASCII string, null-padded
        return struct.pack("<B3BI", 0x13, 0x01, 0, 0, len(value))
    dt = np.asarray(value).dtype
    size = dt.itemsize
    if dt.kind == "f" and size in (4, 8):  # IEEE little-endian
        sign, exp_loc, exp_size, bias = (31, 23, 8, 127) if size == 4 else (63, 52, 11, 1023)
        return struct.pack("<B3BIHHBBBBI", 0x11, 0x20, sign, 0, size, 0, 8 * size,
                           exp_loc, exp_size, 0, exp_loc, bias)
    if dt.kind in "iu":
        return struct.pack("<B3BIHH", 0x10, 0x08 if dt.kind == "i" else 0, 0, 0, size, 0,
                           8 * size)
    raise ValueError(f"hdf5_min: unsupported type {dt}")


def _dataspace_msg(shape) -> bytes:
    return struct.pack("<BBBBI", 1, len(shape), 0, 0, 0) + b"".join(
        struct.pack("<Q", n) for n in shape)


def _pipeline_msg(itemsize: int, level: int, shuffle: bool) -> bytes:
    """Filter pipeline message, version 1 (names padded to 8, an odd
    number of client values padded with one more)."""
    filters = ([(SHUFFLE, b"shuffle", itemsize)] if shuffle else []) + (
        [(DEFLATE, b"deflate", level)] if level else [])
    out = struct.pack("<BB6x", 1, len(filters))
    for fid, name, value in filters:
        name = _pad8(name + b"\0")
        # flags 1: optional, as H5Pset_shuffle and H5Pset_deflate set it
        out += struct.pack("<HHHH", fid, len(name), 1, 1) + name + struct.pack("<II", value, 0)
    return out


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
        """A version-1 B-tree over ``children`` (addresses) whose keys
        ``keys`` (encoded; one more than the children) bracket them:
        children[i] lies between keys[i] and keys[i+1].  Nodes hold at
        most ``width`` children and are written at the full size libhdf5
        allocates; a level is added until one node remains.  -> the root."""
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

    def _chunks(self, data: np.ndarray, chunks, level: int, shuffle: bool) -> int:
        """Store ``data`` chunk by chunk (an edge chunk padded with zeros
        to the full chunk shape), filtered; -> the chunk B-tree's address,
        or UNDEF when the dataset is empty."""
        if len(chunks) != data.ndim or any(c < 1 for c in chunks) or any(
                n and c > n for c, n in zip(chunks, data.shape)):
            raise ValueError(f"hdf5_min: chunks {chunks} do not fit shape {data.shape}")
        itemsize = data.dtype.itemsize
        addrs, keys = [], []
        for origin in itertools.product(*(range(0, n, c) for n, c in zip(data.shape, chunks))):
            part = data[tuple(slice(o, o + c) for o, c in zip(origin, chunks))]
            block = np.zeros(chunks, data.dtype)
            block[tuple(slice(0, n) for n in part.shape)] = part
            raw = block.tobytes()
            if shuffle:
                raw = _shuffle(raw, itemsize)
            if level:
                raw = zlib.compress(raw, level)
            addrs.append(self._put(raw))
            keys.append(struct.pack(f"<II{data.ndim + 1}Q", len(raw), 0, *origin, 0))
        if not addrs:
            return UNDEF
        # the right key of the last chunk: one chunk further in every
        # dimension, the element's too, as libhdf5 writes it
        keys.append(struct.pack(f"<II{data.ndim + 1}Q", 0, 0,
                                *(o + c for o, c in zip(origin, chunks)), itemsize))
        return self._tree(1, addrs, keys, 2 * ISTORE_K)

    def dataset(self, node: Node) -> int:
        data = np.ascontiguousarray(node.data)
        msgs = [_message(0x01, _dataspace_msg(data.shape)),
                _message(0x03, _dtype_msg(data.dtype.type(0)), flags=1)]
        if node.chunks is None:
            if node.compression or node.shuffle:
                raise ValueError("hdf5_min: filters need a chunked dataset")
            addr = self._put(data.tobytes())
            msgs += [
                _message(0x05, struct.pack("<BBBB", 2, 1, 2, 0)),  # fill value: none
                _message(0x08, struct.pack("<BBQQ", 3, 1, addr, data.nbytes)),
            ]
        else:
            chunks = tuple(int(c) for c in node.chunks)
            tree = self._chunks(data, chunks, node.compression, node.shuffle)
            # fill value: allocated incrementally, written if set, the default 0
            msgs.append(_message(0x05, struct.pack("<BBBBI", 2, 3, 2, 1, 0), flags=1))
            if node.compression or node.shuffle:
                msgs.append(_message(0x0B, _pipeline_msg(data.dtype.itemsize, node.compression,
                                                         node.shuffle), flags=1))
            dims = chunks + (data.dtype.itemsize,)
            msgs.append(_message(0x08, struct.pack(f"<BBBQ{len(dims)}I", 3, 2, len(dims), tree,
                                                   *dims)))
        msgs += [_attribute(k, v) for k, v in node.attrs.items()]
        return self._put(_object_header(msgs))

    def group(self, node: Node):
        """-> (object header, B-tree, local heap) addresses."""
        entries, heap = [], bytearray(8)
        for name in sorted(node.children, key=str.encode):  # strcmp order
            child = node.children[name]
            offset = len(heap)
            heap += _pad8(name.encode() + b"\0")
            if child.data is not None:
                entries.append((offset, self.dataset(child), 0, 0, 0))
            else:
                oh, bt, hp = self.group(child)
                entries.append((offset, oh, 1, bt, hp))
        heap_data = self._put(bytes(heap))
        # free-list head 1 is libhdf5's "no free block" (H5HL_FREE_NULL)
        heap_addr = self._put(b"HEAP" + struct.pack("<B3xQQQ", 0, len(heap), 1, heap_data))
        # symbol-table nodes of up to 2 * LEAF_K entries; the key after a
        # node is the heap offset of its last (greatest) name
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

    @staticmethod
    def pipeline(data: bytes) -> list:
        """-> [(filter id, client values)] in the order they were applied."""
        if data[0] != 1:
            raise ValueError("hdf5_min: only version-1 filter pipelines")
        pos, out = 8, []
        for _ in range(data[1]):
            fid, nlen, _flags, nval = struct.unpack_from("<HHHH", data, pos)
            pos += 8 + nlen
            values = struct.unpack_from(f"<{nval}I", data, pos)
            pos += 4 * (nval + nval % 2)
            if fid not in (DEFLATE, SHUFFLE):
                raise ValueError(f"hdf5_min: unsupported filter {fid}")
            out.append((fid, values))
        return out

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

    def chunked(self, tree: int, shape, dt, chunks, filters) -> np.ndarray:
        """A chunked dataset: every chunk under the type-1 B-tree at
        ``tree`` unfiltered (the filters undone in reverse, but those its
        filter mask skipped) and cropped into place."""
        out = np.zeros(shape, dt)
        if tree == UNDEF:
            return out
        ndims = len(shape) + 1
        key_size = 8 + 8 * ndims
        stack = [tree]
        while stack:
            addr = stack.pop()
            if self.raw[addr : addr + 4] != b"TREE" or self.raw[addr + 4] != 1:
                raise ValueError("hdf5_min: bad chunk B-tree node")
            level, used = self.u("BH", addr + 5)
            for i in range(used):
                pos = addr + 24 + i * (key_size + 8)
                nbytes, mask = self.u("II", pos)
                origin = self.u(f"{ndims - 1}Q", pos + 8)
                child = self.u("Q", pos + key_size)[0]
                if level > 0:
                    stack.append(child)
                    continue
                raw = self.raw[child : child + nbytes]
                for k in reversed(range(len(filters))):
                    if mask >> k & 1:
                        continue
                    raw = (zlib.decompress(raw) if filters[k][0] == DEFLATE
                           else _unshuffle(raw, dt.itemsize))
                block = np.frombuffer(raw, dt).reshape(chunks)
                dest = tuple(slice(o, min(o + c, n)) for o, c, n in zip(origin, chunks, shape))
                out[dest] = block[tuple(slice(0, s.stop - s.start) for s in dest)]
        return out

    def node(self, addr: int) -> Node:
        msgs = self.messages(addr)
        node = Node()
        shape, dt, layout, filters = None, None, None, []
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
            elif mtype == 0x0B:
                filters = self.pipeline(data)
            elif mtype == 0x08:
                if data[0] != 3 or data[1] not in (1, 2):
                    raise ValueError("hdf5_min: only contiguous or chunked version-3 layouts")
                if data[1] == 1:
                    layout = ("contiguous",) + struct.unpack_from("<QQ", data, 2)
                else:
                    dims = struct.unpack_from(f"<{data[2]}I", data, 11)
                    layout = ("chunked", struct.unpack_from("<Q", data, 3)[0], dims[:-1])
        if layout is not None:
            if dt is None or dt == "str" or shape is None:
                raise ValueError("hdf5_min: unsupported dataset")
            if layout[0] == "chunked":
                node.chunks = tuple(int(c) for c in layout[2])
                node.shuffle = any(fid == SHUFFLE for fid, _ in filters)
                node.compression = next((v[0] for fid, v in filters if fid == DEFLATE), 0)
                node.data = self.chunked(layout[1], shape, dt, node.chunks, filters)
            else:
                if filters:
                    raise ValueError("hdf5_min: filters on a contiguous dataset")
                _, daddr, size = layout
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
            kids = [self.u("Q", addr + 24 + 16 * i + 8)[0] for i in range(used)]
            if level > 0:
                stack.extend(reversed(kids))  # walked in name order
                continue
            for child in kids:
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
