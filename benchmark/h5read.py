"""A reader of the HDF5 files that the predict path writes, on the standard
library and NumPy alone (the card's machine has no h5py).

It reads what the format's version-0 superblock, version-1 object headers
and symbol-table groups hold: groups (a version-1 B-tree of type 0 over
symbol-table nodes, names in a local heap), and datasets whose dataspace,
datatype (fixed-point and IEEE floats), layout (version 3: contiguous or
chunked under a version-1 B-tree of type 1) and filter pipeline (shuffle,
DEFLATE) it decodes. Anything else the file holds raises
:class:`H5Error`, so a file the reader cannot take reads as wrong, not as
empty. Attributes are not read.
"""

from __future__ import annotations

import struct
import zlib
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

SIGNATURE = b"\x89HDF\r\n\x1a\n"
UNDEF = 0xFFFFFFFFFFFFFFFF
_DATASPACE, _DATATYPE, _LAYOUT, _FILTERS, _CONTINUATION, _SYMBOL_TABLE = 0x1, 0x3, 0x8, 0xB, 0x10, 0x11
_SHUFFLE, _DEFLATE = 2, 1


class H5Error(ValueError):
    pass


class H5File:
    """One file's bytes; :meth:`datasets` walks its groups."""

    def __init__(self, fn: str):
        with open(fn, "rb") as f:
            self.buf = f.read()
        b = self.buf
        if b[:8] != SIGNATURE:
            raise H5Error(f"{fn}: no HDF5 signature")
        version, offsets, lengths = b[8], b[13], b[14]
        if version != 0 or offsets != 8 or lengths != 8:
            raise H5Error(f"{fn}: superblock version {version}, offsets {offsets}, lengths {lengths}")
        base = self._q(24)
        if base != 0:
            raise H5Error(f"{fn}: base address {base}")
        self.root = self._q(64)  # the root's symbol-table entry at 56: name offset, object header

    def _q(self, at: int) -> int:
        return struct.unpack_from("<Q", self.buf, at)[0]

    def _messages(self, addr: int) -> List[Tuple[int, bytes]]:
        """The (type, body) messages of the version-1 object header at
        ``addr``, continuation blocks followed."""
        b = self.buf
        version, _, count, _, size = struct.unpack_from("<BBHII", b, addr)
        if version != 1:
            raise H5Error(f"object header version {version} at {addr}")
        blocks, out = [(addr + 16, size)], []
        while blocks and len(out) < count:
            at, size = blocks.pop(0)
            end = at + size
            while at + 8 <= end and len(out) < count:
                mtype, msize, _ = struct.unpack_from("<HHB", b, at)
                body = b[at + 8 : at + 8 + msize]
                out.append((mtype, body))
                if mtype == _CONTINUATION:
                    blocks.append(struct.unpack_from("<QQ", body))
                at += 8 + msize
        return out

    def _group(self, msgs) -> Optional[Tuple[int, int]]:
        for t, body in msgs:
            if t == _SYMBOL_TABLE:
                return struct.unpack_from("<QQ", body)
        return None

    def _members(self, btree: int, heap: int) -> Iterator[Tuple[str, int]]:
        """(name, object header) of a group's members."""
        b = self.buf
        if b[heap : heap + 4] != b"HEAP":
            raise H5Error(f"no local heap at {heap}")
        data = self._q(heap + 24)
        for snod in self._btree(btree, 0, 8):
            if b[snod : snod + 4] != b"SNOD":
                raise H5Error(f"no symbol-table node at {snod}")
            for k in range(struct.unpack_from("<H", b, snod + 6)[0]):
                name_off, header = struct.unpack_from("<QQ", b, snod + 8 + 40 * k)
                start = data + name_off
                yield b[start : b.index(b"\0", start)].decode("utf-8"), header

    def _btree(self, addr: int, node_type: int, key_size: int, keys: bool = False) -> Iterator:
        """The level-0 children of a version-1 B-tree, in order; with
        ``keys`` as (left key, child)."""
        b = self.buf
        if b[addr : addr + 4] != b"TREE" or b[addr + 4] != node_type:
            raise H5Error(f"no B-tree node of type {node_type} at {addr}")
        level, used = b[addr + 5], struct.unpack_from("<H", b, addr + 6)[0]
        at = addr + 24
        for _ in range(used):
            key, child = b[at : at + key_size], self._q(at + key_size)
            at += key_size + 8
            if level:
                yield from self._btree(child, node_type, key_size, keys)
            else:
                yield (key, child) if keys else child

    def datasets(self) -> Dict[str, int]:
        """Every dataset's path (``a/b`` below the root) and object header."""
        out = {}

        def walk(header: int, prefix: str):
            g = self._group(self._messages(header))
            if g is None:
                out[prefix] = header
                return
            for name, child in self._members(*g):
                walk(child, f"{prefix}/{name}" if prefix else name)

        walk(self.root, "")
        out.pop("", None)
        return out

    def read(self, header: int) -> np.ndarray:
        """The dataset at object header ``header`` as an array."""
        msgs = dict(self._messages(header))
        if not {_DATASPACE, _DATATYPE, _LAYOUT} <= set(msgs):
            raise H5Error(f"object at {header} is not a dataset")
        shape = _dataspace(msgs[_DATASPACE])
        dtype = _datatype(msgs[_DATATYPE])
        filters = _filters(msgs[_FILTERS]) if _FILTERS in msgs else []
        lay = msgs[_LAYOUT]
        if lay[0] != 3:
            raise H5Error(f"layout version {lay[0]}")
        n = int(np.prod(shape, dtype=np.int64))
        if lay[1] == 1:  # contiguous
            addr, size = struct.unpack_from("<QQ", lay, 2)
            if n == 0:
                return np.zeros(shape, dtype)
            if size != n * dtype.itemsize:
                raise H5Error(f"contiguous data of {size} bytes for {shape} {dtype}")
            return np.frombuffer(self.buf, dtype, n, addr).reshape(shape).copy()
        if lay[1] != 2:
            raise H5Error(f"layout class {lay[1]}")
        rank1 = lay[2]
        index = struct.unpack_from("<Q", lay, 3)[0]
        dims = struct.unpack_from(f"<{rank1}I", lay, 11)
        chunk, elem = tuple(dims[:-1]), dims[-1]
        if len(chunk) != len(shape) or elem != dtype.itemsize:
            raise H5Error(f"chunks {dims} for {shape} {dtype}")
        out = np.zeros(shape, dtype)
        if index == UNDEF:
            return out
        key_size = 8 + 8 * rank1
        for key, addr in self._btree(index, 1, key_size, keys=True):
            nbytes, mask = struct.unpack_from("<II", key)
            offset = struct.unpack_from(f"<{rank1}Q", key, 8)[:-1]
            raw = self.buf[addr : addr + nbytes]
            for i, (fid, value) in reversed(list(enumerate(filters))):
                if mask >> i & 1:
                    continue
                if fid == _DEFLATE:
                    raw = zlib.decompress(raw)
                elif fid == _SHUFFLE:
                    raw = np.frombuffer(raw, np.uint8).reshape(value, -1).T.tobytes()
                else:
                    raise H5Error(f"filter {fid}")
            block = np.frombuffer(raw, dtype).reshape(chunk)
            dst = tuple(slice(o, min(o + c, s)) for o, c, s in zip(offset, chunk, shape))
            out[dst] = block[tuple(slice(0, d.stop - d.start) for d in dst)]
        return out


def _dataspace(body: bytes) -> Tuple[int, ...]:
    version, rank = body[0], body[1]
    if version != 1:
        raise H5Error(f"dataspace version {version}")
    return struct.unpack_from(f"<{rank}Q", body, 8)


def _datatype(body: bytes) -> np.dtype:
    cls, version = body[0] & 0x0F, body[0] >> 4
    bits, size = body[1], struct.unpack_from("<I", body, 4)[0]
    if version != 1 or bits & 1:
        raise H5Error(f"datatype version {version}, big-endian {bits & 1}")
    if cls == 0:
        return np.dtype(f"<{'i' if bits & 0x08 else 'u'}{size}")
    if cls == 1 and size in (2, 4, 8):
        return np.dtype(f"<f{size}")
    raise H5Error(f"datatype class {cls} of {size} bytes")


def _filters(body: bytes) -> List[Tuple[int, int]]:
    """(filter id, first client value) of a version-1 pipeline, in order."""
    if body[0] != 1:
        raise H5Error(f"filter pipeline version {body[0]}")
    out, at = [], 8
    for _ in range(body[1]):
        fid, name_len, _, nvals = struct.unpack_from("<4H", body, at)
        at += 8 + name_len
        vals = struct.unpack_from(f"<{nvals}I", body, at)
        at += 4 * (nvals + nvals % 2)
        out.append((fid, vals[0] if vals else 0))
    return out


def read_datasets(fn: str, names=None) -> Dict[str, np.ndarray]:
    """The datasets of ``fn`` (those of ``names`` only, if given) by path."""
    f = H5File(fn)
    headers = f.datasets()
    wanted = headers if names is None else {n: headers[n] for n in names if n in headers}
    return {n: f.read(h) for n, h in wanted.items()}
