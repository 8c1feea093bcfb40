"""HDF5 export stream node, written without h5py.

Counterpart of ``maze_image_processing_pipeline_tpu/dataio/hdf5.py:HDF5Writer``
with the same constructor and stream semantics: one dataset per object
(``dataset_mode="create"``) or columns appended along axis 0
(``"append"``), gzip (DEFLATE) with the byte-shuffle filter, the adaptive
stored blocks of incompressible streams, and root attributes
(``file_attrs``). h5py is not on the card's machine, so the file is written
here, byte by byte, in a subset of the format that every HDF5 ≥ 1.8 (and
h5py) reads:

* superblock version 0, object headers version 1;
* groups as symbol tables: a version-1 B-tree of type 0 over symbol-table
  nodes (SNOD, 2·4 entries) and a local heap of the names; more than 256
  entries (32 SNODs) take more B-tree levels;
* datasets: dataspace (with maximum dimensions; unlimited in append mode),
  datatype (integers, IEEE floats of 2, 4 and 8 bytes, fixed-length
  NULLPAD ASCII strings), fill value, layout version 3 (chunked, indexed by
  a version-1 B-tree of type 1 with 2·32 entries a node, more levels beyond
  64 chunks; contiguous when compression is off in create mode) and filter
  pipeline version 1 (shuffle, id 2, then deflate, id 1);
* root attributes: variable-length UTF-8 strings in a global heap
  collection (as h5py stores a ``str``) and numeric scalars or arrays.

Chunk data is written as it arrives (DEFLATE by the native
``hdf5_chunk_pack`` / ``zlib_compress``, stdlib :mod:`zlib` without them);
the metadata is written when the file closes and the superblock is patched
last, so memory holds metadata, not prediction maps. Append mode buffers
rows until a chunk is full. The file records no modification times: two
writes of the same stream give the same bytes. The node closes its files in
``finally``, so the file stays readable after an exception in the stream.

Chunking differs from h5py's where h5py chooses (arrays over 16 MB in
create mode, append mode): create mode takes the whole array as one chunk
up to 16 MB, else row blocks of at most 16 MB; append mode takes blocks of
rows of about 64 KB (at least one row). Values, shapes, maximum shapes,
types and filters are h5py's.
"""

from __future__ import annotations

import os
import struct
import zlib
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .. import tracing
from ..engine.core import Node, RawOrVariable, Stream, closing_if_closable

__all__ = ["HDF5Writer"]

UNDEF = 0xFFFFFFFFFFFFFFFF  # the undefined address
_SUPERBLOCK_SIZE = 96
_GROUP_LEAF_K = 4  # an SNOD holds 2·4 symbols
_GROUP_NODE_K = 16  # a group B-tree node has 2·16 children
_CHUNK_NODE_K = 32  # a chunk B-tree node has 2·32 children (the format's default)
_GCOL_SIZE = 4096  # the smallest global heap collection
_ONE_CHUNK_MAX = 16 * 1024 * 1024  # create mode: one whole-array chunk up to this
_APPEND_CHUNK_BYTES = 64 * 1024  # append mode: rows a chunk, about this many bytes
_FILTER_SHUFFLE, _FILTER_DEFLATE = 2, 1
_MSG_DATASPACE, _MSG_DATATYPE, _MSG_FILL, _MSG_LAYOUT = 0x1, 0x3, 0x5, 0x8
_MSG_FILTERS, _MSG_ATTRIBUTE, _MSG_SYMBOL_TABLE = 0xB, 0xC, 0x11
_CONSTANT = 1  # message flag, as HDF5 sets it on datatype and fill value


def _shuffle_bytes(arr: np.ndarray) -> bytes:
    """Apply HDF5's byte-shuffle filter (H5Z_FILTER_SHUFFLE) in numpy:
    all first bytes of the chunk's elements, then all second bytes, ..."""
    itemsize = arr.dtype.itemsize
    flat = np.ascontiguousarray(arr).view(np.uint8).reshape(-1, itemsize)
    return flat.T.tobytes()


@tracing.span("h5.pack")
def _pack(arr: np.ndarray, level: int, shuffle: bool) -> bytes:
    """Shuffle (optional) + DEFLATE one chunk, as HDF5's filters decode it:
    the native one-call path, else the numpy shuffle with the native or the
    stdlib zlib."""
    from ..native import hdf5_chunk_pack, zlib_compress

    comp = hdf5_chunk_pack(arr, level, shuffle)
    if comp is None:
        raw = _shuffle_bytes(arr) if shuffle else np.ascontiguousarray(arr).tobytes()
        comp = zlib_compress(raw, level)
        if comp is None:
            comp = zlib.compress(raw, level)
    return comp


def _pad8(b: bytes) -> bytes:
    return b + b"\0" * (-len(b) % 8)


# -- the file format's pieces ---------------------------------------------------


def _datatype(dtype: np.dtype) -> bytes:
    """A datatype message body for a numpy type h5py stores natively."""
    n = dtype.itemsize
    if dtype.kind in "iu":
        return struct.pack("<4BI2H", 0x10, 0x08 if dtype.kind == "i" else 0, 0, 0, n, 0, 8 * n)
    if dtype.kind == "f" and n in (2, 4, 8):
        exp_loc, exp_size, mant_size, bias = {2: (10, 5, 10, 15), 4: (23, 8, 23, 127), 8: (52, 11, 52, 1023)}[n]
        return struct.pack("<4BI2H4BI", 0x11, 0x20, 8 * n - 1, 0, n, 0, 8 * n, exp_loc, exp_size, 0, mant_size, bias)
    if dtype.kind == "S":
        return struct.pack("<4BI", 0x13, 0x01, 0, 0, n)  # fixed length, NULLPAD, ASCII
    raise TypeError(f"HDF5Writer: cannot store dtype {dtype}")


# A variable-length UTF-8 string over unsigned bytes: h5py's ``str``.
_VLEN_UTF8 = struct.pack("<4BI", 0x19, 0x01, 0x01, 0, 16) + _datatype(np.dtype(np.uint8))


def _dataspace(shape: Tuple[int, ...], maxshape: Optional[Tuple[Optional[int], ...]] = None) -> bytes:
    """A dataspace message body (version 1); rank 0 is a scalar."""
    out = struct.pack("<4B4x", 1, len(shape), 1 if shape else 0, 0)
    out += b"".join(struct.pack("<Q", d) for d in shape)
    if shape:
        maxshape = shape if maxshape is None else maxshape
        out += b"".join(struct.pack("<Q", UNDEF if d is None else d) for d in maxshape)
    return out


def _filters(level: int, shuffle: bool, itemsize: int) -> bytes:
    """A filter pipeline message body (version 1): shuffle, then deflate."""
    entries = []
    if shuffle:
        entries.append((_FILTER_SHUFFLE, b"shuffle\0", itemsize))
    entries.append((_FILTER_DEFLATE, b"deflate\0", level))
    out = struct.pack("<BB6x", 1, len(entries))
    for fid, name, value in entries:
        out += struct.pack("<4H", fid, len(name), 1, 1) + _pad8(name) + _pad8(struct.pack("<I", value))
    return out


def _object_header(messages: Sequence[Tuple[int, bytes, int]]) -> bytes:
    """A version-1 object header: (type, body, flags) messages, each padded
    to 8 bytes, after the 16-byte prefix."""
    body = b"".join(struct.pack("<HHB3x", t, len(_pad8(b)), flags) + _pad8(b) for t, b, flags in messages)
    return struct.pack("<BBHII4x", 1, 0, len(messages), 1, len(body)) + body


def _btree_node(node_type: int, level: int, left: int, right: int, keys: List[bytes], children: List[int],
                k: int, key_size: int) -> bytes:
    """A version-1 B-tree node, padded to its full size (2k children)."""
    out = b"TREE" + struct.pack("<BBHQQ", node_type, level, len(children), left, right)
    for key, child in zip(keys, children):
        out += key + struct.pack("<Q", child)
    out += keys[len(children)]
    return out + b"\0" * (_btree_size(k, key_size) - len(out))


def _btree_size(k: int, key_size: int) -> int:
    return 24 + (2 * k + 1) * key_size + 2 * k * 8


class _Out:
    """The file being written: bytes are appended at its end."""

    def __init__(self, fn: str):
        self.f = open(fn, "wb")
        self.f.write(b"\0" * _SUPERBLOCK_SIZE)
        self.end = _SUPERBLOCK_SIZE

    def put(self, data: bytes) -> int:
        addr = self.end
        self.f.write(data)
        self.end += len(data)
        return addr


def _btree(out: _Out, node_type: int, leaves: List[Tuple[bytes, bytes, int]], k: int, key_size: int) -> int:
    """Write a B-tree over ``leaves`` (left key, right key, child address) in
    order, level by level with up to 2k children a node; returns the root's
    address. Each node's keys are its children's left keys and the last
    child's right key; siblings link left and right on every level."""
    if not leaves:
        return out.put(_btree_node(node_type, 0, UNDEF, UNDEF, [b"\0" * key_size], [], k, key_size))
    level, items = 0, leaves
    size = _btree_size(k, key_size)
    while True:
        groups = [items[i : i + 2 * k] for i in range(0, len(items), 2 * k)]
        base = out.end
        addrs = [base + i * size for i in range(len(groups))]
        nodes = []
        for i, g in enumerate(groups):
            left = addrs[i - 1] if i > 0 else UNDEF
            right = addrs[i + 1] if i + 1 < len(groups) else UNDEF
            keys = [lk for lk, _, _ in g] + [g[-1][1]]
            out.put(_btree_node(node_type, level, left, right, keys, [c for _, _, c in g], k, key_size))
            nodes.append((g[0][0], g[-1][1], addrs[i]))
        if len(nodes) == 1:
            return nodes[0][2]
        level, items = level + 1, nodes


class _Dataset:
    """A dataset's type, shape and storage, recorded as its data is written."""

    def __init__(self, dtype: np.dtype, shape, maxshape, chunks, level: Optional[int], shuffle: bool):
        self.dtype, self.shape, self.maxshape = dtype, tuple(shape), maxshape
        self.chunks = None if chunks is None else tuple(chunks)
        self.level, self.shuffle = level, shuffle
        self.chunk_index: List[Tuple[Tuple[int, ...], int, int]] = []  # (offset, nbytes, address)
        self.contiguous = (UNDEF, 0)

    def write_metadata(self, out: _Out) -> int:
        msgs = [(_MSG_DATASPACE, _dataspace(self.shape, self.maxshape), 0),
                (_MSG_DATATYPE, _datatype(self.dtype), _CONSTANT)]
        if self.chunks is None:
            msgs += [(_MSG_FILL, struct.pack("<4BI", 2, 2, 2, 1, 0), _CONSTANT),
                     (_MSG_LAYOUT, struct.pack("<BBQQ", 3, 1, *self.contiguous), 0)]
        else:
            rank = len(self.shape)
            key_size = 8 + 8 * (rank + 1)
            elem = self.dtype.itemsize

            def key(offset, nbytes):
                return struct.pack("<II", nbytes, 0) + b"".join(struct.pack("<Q", o) for o in (*offset, 0))

            leaves = []
            for offset, nbytes, addr in sorted(self.chunk_index):
                end = tuple(o + c for o, c in zip(offset, self.chunks))
                right = struct.pack("<II", 0, 0) + b"".join(struct.pack("<Q", o) for o in (*end, elem))
                leaves.append((key(offset, nbytes), right, addr))
            index = _btree(out, 1, leaves, _CHUNK_NODE_K, key_size) if leaves else UNDEF
            layout = struct.pack("<BBBQ", 3, 2, rank + 1, index)
            layout += b"".join(struct.pack("<I", c) for c in (*self.chunks, elem))
            msgs += [(_MSG_FILL, struct.pack("<4BI", 2, 3, 2, 1, 0), _CONSTANT), (_MSG_LAYOUT, layout, 0)]
            if self.level is not None:
                msgs.append((_MSG_FILTERS, _filters(self.level, self.shuffle, elem), _CONSTANT))
        return out.put(_object_header(msgs))


class _Group:
    """A group: its members by name (datasets and groups)."""

    def __init__(self):
        self.members: Dict[str, object] = {}

    def write_metadata(self, out: _Out, extra_messages=()) -> Tuple[int, int, int]:
        """Write the members, then the local heap of their names, the SNODs,
        the B-tree and this group's object header; returns (object header,
        B-tree, heap) addresses."""
        names = sorted(self.members, key=lambda s: s.encode("utf-8"))
        headers = {}
        for name in names:
            member = self.members[name]
            headers[name] = member.write_metadata(out)
            if isinstance(member, _Group):
                headers[name] = headers[name][0]
        heap_data, offsets = bytearray(8), {}  # offset 0: the empty name
        for name in names:
            offsets[name] = len(heap_data)
            heap_data += _pad8(name.encode("utf-8") + b"\0")
        heap_addr = out.put(b"HEAP" + struct.pack("<B3xQQQ", 0, len(heap_data), 1, out.end + 32) + bytes(heap_data))
        leaves, prev = [], 0
        for i in range(0, len(names), 2 * _GROUP_LEAF_K):
            chunk = names[i : i + 2 * _GROUP_LEAF_K]
            snod = b"SNOD" + struct.pack("<BBH", 1, 0, len(chunk))
            for name in chunk:
                snod += struct.pack("<QQI4x16x", offsets[name], headers[name], 0)
            snod += b"\0" * (8 + 2 * _GROUP_LEAF_K * 40 - len(snod))
            last = offsets[chunk[-1]]
            leaves.append((struct.pack("<Q", prev), struct.pack("<Q", last), out.put(snod)))
            prev = last
        btree = _btree(out, 0, leaves, _GROUP_NODE_K, 8)
        msgs = [(_MSG_SYMBOL_TABLE, struct.pack("<QQ", btree, heap_addr), 0), *extra_messages]
        return out.put(_object_header(msgs)), btree, heap_addr


class _File:
    """One HDF5 file written as a stream."""

    def __init__(self, fn: str, attrs: Dict[str, object]):
        os.makedirs(os.path.dirname(os.path.abspath(fn)), exist_ok=True)
        self.out = _Out(fn)
        self.root = _Group()
        self.attrs = dict(attrs)
        self.columns: Dict[str, "_Column"] = {}

    def _parent(self, name: str) -> Tuple[_Group, str]:
        parts = [p for p in name.split("/") if p]
        if not parts:
            raise ValueError(f"HDF5Writer: invalid dataset name {name!r}")
        group = self.root
        for p in parts[:-1]:
            member = group.members.setdefault(p, _Group())
            if not isinstance(member, _Group):
                raise ValueError(f"HDF5Writer: {p!r} of {name!r} is a dataset, not a group")
            group = member
        if parts[-1] in group.members:
            raise ValueError(f"HDF5Writer: unable to create {name!r}: name already exists")
        return group, parts[-1]

    def add(self, name: str, ds: _Dataset, write=None) -> None:
        """Add the dataset ``name``; ``write()``, if given, writes its data
        first, so a dataset whose writing fails is left out of the file."""
        group, leaf = self._parent(name)
        if write is not None:
            write()
        group.members[leaf] = ds

    def put_chunk(self, ds: _Dataset, offset, data: np.ndarray, level: Optional[int]) -> int:
        """Write one chunk (``data`` has the chunk's full shape); returns its
        stored size."""
        raw = np.ascontiguousarray(data)
        comp = raw.tobytes() if level is None else _pack(raw, level, ds.shuffle)
        tracing.count("h5.raw_bytes", raw.nbytes)
        tracing.count("h5.stored_bytes", len(comp))
        ds.chunk_index.append((tuple(offset), len(comp), self.out.put(comp)))
        return len(comp)

    @tracing.span("h5.close")
    def close(self) -> None:
        out = self.out
        try:
            for col in self.columns.values():
                col.flush()
            attr_msgs = self._attributes()
            root_header, btree, heap = self.root.write_metadata(out, attr_msgs)
            eof = out.end
            out.f.seek(0)
            out.f.write(b"\x89HDF\r\n\x1a\n" + struct.pack("<8BHHI", 0, 0, 0, 0, 0, 8, 8, 0, _GROUP_LEAF_K,
                                                            _GROUP_NODE_K, 0)
                        + struct.pack("<4Q", 0, UNDEF, eof, UNDEF)
                        + struct.pack("<QQI4xQQ", 0, root_header, 1, btree, heap))
        finally:
            out.f.close()

    def _attributes(self) -> List[Tuple[int, bytes, int]]:
        """The root's attribute messages; strings go to one global heap
        collection written here."""
        strings = [v.encode("utf-8") for v in self.attrs.values() if isinstance(v, str)]
        gcol = None
        if strings:
            objects = b"".join(struct.pack("<HH4xQ", i + 1, 0, len(s)) + _pad8(s) for i, s in enumerate(strings))
            free = _GCOL_SIZE - 16 - len(objects)
            if free < 16:
                raise ValueError("HDF5Writer: string attributes larger than one global heap collection")
            gcol = self.out.put(b"GCOL" + struct.pack("<B3xQ", 1, _GCOL_SIZE) + objects
                                + struct.pack("<HH4xQ", 0, 0, free) + b"\0" * (free - 16))
        msgs, index = [], 0
        for name, value in self.attrs.items():
            if isinstance(value, str):
                index += 1
                dt, space = _VLEN_UTF8, _dataspace(())
                data = struct.pack("<IQI", len(strings[index - 1]), gcol, index)
            else:
                arr = np.asarray(value)
                if arr.dtype.kind not in "iufS":
                    raise TypeError(f"HDF5Writer: cannot store attribute {name!r} of type {type(value).__name__}")
                arr = arr.astype(arr.dtype.newbyteorder("<"))
                dt, space, data = _datatype(arr.dtype), _dataspace(arr.shape), arr.tobytes()
            enc = name.encode("utf-8") + b"\0"
            body = struct.pack("<BBHHH", 1, 0, len(enc), len(dt), len(space)) + _pad8(enc) + _pad8(dt)
            msgs.append((_MSG_ATTRIBUTE, body + _pad8(space) + data, 0))
        return msgs


class _Column:
    """An append-mode dataset: rows are buffered until a chunk is full."""

    def __init__(self, file: _File, name: str, row: np.ndarray, level: Optional[int], shuffle: bool):
        self.file = file
        self.rows_per_chunk = max(1, _APPEND_CHUNK_BYTES // max(1, row.nbytes))
        self.row_shape, self.dtype = row.shape, row.dtype
        self.ds = _Dataset(row.dtype, (0,) + row.shape, (None,) + row.shape,
                           (self.rows_per_chunk,) + tuple(max(1, d) for d in row.shape), level, shuffle)
        self.buffer: List[np.ndarray] = []
        file.add(name, self.ds)

    def append(self, value: np.ndarray) -> None:
        if value.shape != self.row_shape:
            raise ValueError(f"HDF5Writer: row of shape {value.shape} appended to rows of shape {self.row_shape}")
        self.buffer.append(value.astype(self.dtype, casting="unsafe"))
        self.ds.shape = (self.ds.shape[0] + 1,) + self.row_shape
        if len(self.buffer) == self.rows_per_chunk:
            self.flush()

    def flush(self) -> None:
        if not self.buffer:
            return
        block = np.zeros(self.ds.chunks, self.dtype)
        rows = np.stack(self.buffer)
        block[(slice(0, len(rows)),) + tuple(slice(0, d) for d in self.row_shape)] = rows
        start = self.ds.shape[0] - len(self.buffer)
        self.file.put_chunk(self.ds, (start,) + (0,) * len(self.row_shape), block, self.ds.level)
        self.buffer = []


def _to_array(value) -> np.ndarray:
    arr = np.asarray(value)
    if arr.dtype == object or arr.dtype.kind == "U":
        arr = arr.astype("S")
    if arr.dtype.kind not in "iufS":
        raise TypeError(f"HDF5Writer: cannot store dtype {arr.dtype}")
    return arr.astype(arr.dtype.newbyteorder("<"), copy=False)


class HDF5Writer(Node):
    """Stream objects into HDF5 files.

    Args:
        file_fn: target file path (Raw or Variable; may vary per object).
        items: ``[(name, value), ...]`` pairs. In ``create`` mode, ``name``
            is typically a Variable (e.g. object_id) naming one dataset per
            object (a ``/`` in it makes intermediate groups); in ``append``
            mode, names are fixed column names whose values are appended
            along the first axis.
        dataset_mode: ``"create"`` or ``"append"``.
        compression: ``"gzip"`` or None.
        compression_opts: DEFLATE level 0-9; None = level 4 (h5py's
            default).
        shuffle: byte-shuffle filter before compression.
        adaptive_store: in create mode, when the stream's chunks measure
            near-incompressible (DEFLATE ratio EMA > 0.92), write DEFLATE
            *stored* blocks instead of compressing, re-probing the
            configured level every 32 chunks (the JAX package's rule; the
            file stays standard gzip-filtered HDF5).
        file_attrs: optional ``{name: value}`` attributes written to the
            root group of every file this node creates (``str`` values as
            variable-length UTF-8 strings, numbers as numeric scalars).
    """

    def __init__(
        self,
        file_fn: RawOrVariable[str],
        items: Sequence[Tuple[RawOrVariable[str], RawOrVariable]],
        dataset_mode: str = "create",
        compression: Optional[str] = "gzip",
        compression_opts: Optional[int] = None,
        shuffle: bool = True,
        adaptive_store: bool = True,
        file_attrs: Optional[Dict[str, object]] = None,
    ) -> None:
        if dataset_mode not in ("create", "append"):
            raise ValueError(f"Unknown dataset_mode: {dataset_mode!r}")
        if compression not in ("gzip", None):
            raise ValueError(f"HDF5Writer: compression must be 'gzip' or None, got {compression!r}")
        self.file_fn = file_fn
        self.items = list(items)
        self.dataset_mode = dataset_mode
        self.compression = compression
        self.compression_opts = compression_opts
        self.shuffle = shuffle
        self.adaptive_store = adaptive_store
        self.file_attrs = dict(file_attrs or {})
        self._ratio_ema: Optional[float] = None
        self._stored_since_probe = 0
        super().__init__()

    @property
    def _level(self) -> Optional[int]:
        if self.compression is None:
            return None
        return 4 if self.compression_opts is None else int(self.compression_opts)

    def _chunk_level(self, value: np.ndarray, level: int) -> int:
        """The DEFLATE level of a whole-array chunk: stored blocks (0) while
        the stream measures incompressible (the JAX package's rule)."""
        if (
            self.adaptive_store
            and level > 0
            and value.nbytes >= 4096
            and self._ratio_ema is not None
            and self._ratio_ema > 0.92
            and self._stored_since_probe < 32
        ):
            return 0
        return level

    def _record(self, value: np.ndarray, use_level: int, stored: int) -> None:
        if use_level == 0:
            self._stored_since_probe += 1
        elif value.nbytes >= 4096:
            ratio = stored / value.nbytes
            self._ratio_ema = ratio if self._ratio_ema is None else 0.7 * self._ratio_ema + 0.3 * ratio
            self._stored_since_probe = 0

    @tracing.span("h5.create")
    def _create(self, h5: _File, name: str, value: np.ndarray) -> None:
        level = self._level
        shuffle = self.shuffle and level is not None
        if level is None:
            ds = _Dataset(value.dtype, value.shape, None, None, None, False)

            def write():
                if value.size:
                    data = np.ascontiguousarray(value).tobytes()
                    tracing.count("h5.raw_bytes", len(data))
                    tracing.count("h5.stored_bytes", len(data))
                    ds.contiguous = (h5.out.put(data), len(data))

            h5.add(name, ds, write)
            return
        if value.ndim == 0:
            raise TypeError(f"HDF5Writer: scalar dataset {name!r} cannot be chunked or compressed")
        row_bytes = max(1, value.nbytes // max(1, value.shape[0]))
        one = value.size > 0 and value.nbytes <= _ONE_CHUNK_MAX
        rows = value.shape[0] if one else max(1, min(value.shape[0], _ONE_CHUNK_MAX // row_bytes))
        chunks = (max(1, rows),) + tuple(max(1, d) for d in value.shape[1:])
        ds = _Dataset(value.dtype, value.shape, None, chunks, level, shuffle)

        def write():
            if one:
                use_level = self._chunk_level(value, level)
                self._record(value, use_level, h5.put_chunk(ds, (0,) * value.ndim, value, use_level))
                return
            for start in range(0, value.shape[0], rows):
                block = value[start : start + rows]
                if block.shape != chunks:  # the edge chunk holds the full chunk's shape
                    full = np.zeros(chunks, value.dtype)
                    full[tuple(slice(0, d) for d in block.shape)] = block
                    block = full
                h5.put_chunk(ds, (start,) + (0,) * (value.ndim - 1), block, level)

        h5.add(name, ds, write)

    def transform_stream(self, stream: Stream) -> Stream:
        files: Dict[str, _File] = {}

        def get_file(fn: str) -> _File:
            if fn not in files:
                files[fn] = _File(fn, self.file_attrs)
            return files[fn]

        try:
            with closing_if_closable(stream):
                for obj in stream:
                    h5 = get_file(str(self.prepare_input(obj, "file_fn")))
                    for name_var, value_var in self.items:
                        name = str(self._resolve(obj, name_var))
                        value = _to_array(self._resolve(obj, value_var))
                        if self.dataset_mode == "create":
                            self._create(h5, name, value)
                        elif name in h5.columns:
                            h5.columns[name].append(value)
                        else:
                            col = h5.columns[name] = _Column(h5, name, value, self._level,
                                                             self.shuffle and self._level is not None)
                            col.append(value)
                    yield obj
        finally:
            for h5 in files.values():
                h5.close()
