"""The port's HDF5 writer (no h5py) against the JAX package's ``HDF5Writer``.

The same stream goes through both writers; both files are read back with
h5py and must hold the same groups and datasets: names, shapes, maximum
shapes, dtypes, exact values, ``compression`` / ``compression_opts`` /
``shuffle``, and root attributes with their read-back types. Chunk shapes
are the writers' own choice and are not compared. The cases follow
``tests/test_dataio.py`` (``TestHDF5``) and ``tests/test_engine_core.py``
(append with workers), plus groups of 0-2100 datasets (several B-tree
levels beyond 256), append columns of 1-300 rows (more than 64 chunks),
float16, uint8, ``|S`` ids, a name with ``/``, compression off, an
exception in the middle of the stream, arrays over 16 MB, and two writes of
one stream giving the same bytes.
"""

import os

import h5py
import numpy as np
import pytest

from maze_image_processing_pipeline_tpu.dataio import HDF5Writer as JaxWriter
from maze_image_processing_pipeline_tpu.engine import Call as JCall
from maze_image_processing_pipeline_tpu.engine import DataParallelPipeline as JDataParallel
from maze_image_processing_pipeline_tpu.engine import Pipeline as JPipeline
from maze_image_processing_pipeline_tpu.engine import Unpack as JUnpack
from maze_image_processing_pipeline_tpu_torch import native
from maze_image_processing_pipeline_tpu_torch.dataio import HDF5Writer
from maze_image_processing_pipeline_tpu_torch.dataio import hdf5 as thdf5
from maze_image_processing_pipeline_tpu_torch.engine import Call, DataParallelPipeline, Pipeline, Unpack

SIDES = {
    "jax": (JaxWriter, JPipeline, JUnpack, JCall, JDataParallel),
    "torch": (HDF5Writer, Pipeline, Unpack, Call, DataParallelPipeline),
}


def write(side, fn, values, items, n_workers=0, fail_at=None, **kw):
    """Stream objects 0..len(values)-1 into ``fn``; ``items(oid, value)``
    gives the writer's items from the object id (``obj<i>``) and value
    variables. Returns the writer node."""
    Writer, Pipe, Unp, C, DataParallel = SIDES[side]

    def value_of(i):
        if i == fail_at:
            raise RuntimeError("the stream fails here")
        return values[i]

    with Pipe() as p:
        i = Unp(list(range(len(values))))
        if n_workers:
            with DataParallel(executor=n_workers):
                v = C(value_of, i)
        else:
            v = C(value_of, i)
        oid = C(lambda x: f"obj{x}", i)
        node = Writer(fn, items(oid, v), **kw)
    p.run()
    return node


def summary(fn):
    """Everything the comparison holds equal, read back with h5py."""
    out = {}
    with h5py.File(fn, "r") as h5:
        out["/attrs"] = {k: (type(v), v) for k, v in h5.attrs.items()}

        def visit(name, obj):
            if isinstance(obj, h5py.Dataset):
                out[name] = dict(shape=obj.shape, maxshape=obj.maxshape, dtype=obj.dtype, value=obj[()],
                                 compression=obj.compression, compression_opts=obj.compression_opts,
                                 shuffle=obj.shuffle)
            else:
                out[name] = "group"

        h5.visititems(visit)
    return out


def assert_same(ref, ours):
    assert list(ref) == list(ours)
    for name, r in ref.items():
        o = ours[name]
        if name == "/attrs":
            assert o.keys() == r.keys()
            for k in r:
                assert o[k][0] is r[k][0], k
                np.testing.assert_array_equal(o[k][1], r[k][1], err_msg=k)
        elif r == "group":
            assert o == "group", name
        else:
            for k in ("shape", "maxshape", "dtype", "compression", "compression_opts", "shuffle"):
                assert o[k] == r[k], (name, k, o[k], r[k])
            np.testing.assert_array_equal(o["value"], r["value"], err_msg=name)


def both(tmp_path, values, items, **kw):
    """Write the stream with both writers; compare; return the summary."""
    files = {side: str(tmp_path / f"{side}.h5") for side in SIDES}
    for side, fn in files.items():
        write(side, fn, values, items, **kw)
    ref, ours = summary(files["jax"]), summary(files["torch"])
    assert_same(ref, ours)
    return ours


def create_items(oid, v):
    return [(oid, v)]


def append_items(oid, v):
    return [("object_id", oid), ("predictions", v)]


RAW_ATTRS = {
    "float32": {"raw_dtype": "float32"},
    "float16": {"raw_dtype": "float16"},
    "uint8": {"raw_dtype": "uint8", "raw_scale": 1.0 / 255.0},
}


@pytest.mark.parametrize("rung", list(RAW_ATTRS))
@pytest.mark.parametrize("mode", ["create", "append"])
def test_prediction_maps_match_jax(tmp_path, rung, mode):
    """The predict pipeline's streams: maps of each ``raw_h5_dtype`` rung,
    DEFLATE level 1 + shuffle, the rung's root attributes."""
    rng = np.random.default_rng(0)
    shape = (64, 48, 2) if mode == "append" else None
    values = []
    for i in range(6):
        p = rng.random(shape or (int(rng.integers(20, 90)), int(rng.integers(20, 90)), 2))
        values.append((p * 255).round().astype(np.uint8) if rung == "uint8" else p.astype(rung))
    ours = both(tmp_path, values, create_items if mode == "create" else append_items, dataset_mode=mode,
                compression="gzip", compression_opts=1, file_attrs=RAW_ATTRS[rung])
    assert ours["/attrs"]["raw_dtype"] == (str, rung)
    if rung == "uint8":
        assert ours["/attrs"]["raw_scale"][0] is np.float64


@pytest.mark.parametrize("n", [0, 1, 9, 300, 2100])
def test_datasets_in_one_group_match_jax(tmp_path, n):
    """One group of n datasets: 300 take a second B-tree level (256 per
    level-0 node), 2100 a third SNOD level's worth of nodes; 0 objects make
    no file (both writers open a file at the first object)."""
    values = [np.full((3, 4), i, np.float32) for i in range(n)]
    if n == 0:
        for side in SIDES:
            write(side, str(tmp_path / f"{side}.h5"), values, create_items)
            assert not os.path.exists(tmp_path / f"{side}.h5")
        return
    ours = both(tmp_path, values, create_items, compression_opts=1)
    assert len(ours) == n + 1


def test_objects_without_items_give_a_file_of_attributes(tmp_path):
    ours = both(tmp_path, [0, 1], lambda oid, v: [], file_attrs={"raw_dtype": "float16", "n": 3})
    assert list(ours) == ["/attrs"] and ours["/attrs"]["n"][0] is np.int64


@pytest.mark.parametrize("rows,shape", [(1, (8,)), (200, (8,)), (300, (64, 64))])
def test_append_columns_match_jax(tmp_path, rows, shape):
    """Append columns: one row, 200 rows, and 300 rows of 16 KB (more than
    64 chunks of the port's 64 KB: a chunk B-tree of two levels). The
    ``|S`` ids take the first row's length (``obj0``: later ids are cut to
    4 bytes, as h5py casts them)."""
    rng = np.random.default_rng(1)
    values = [rng.random(shape).astype(np.float32) for _ in range(rows)]
    ours = both(tmp_path, values, append_items, dataset_mode="append")
    assert ours["object_id"]["dtype"] == np.dtype("S4") and ours["predictions"]["maxshape"] == (None,) + shape
    if rows == 300:
        with h5py.File(tmp_path / "torch.h5") as h5:
            assert h5["predictions"].id.get_num_chunks() > 64


def test_direct_chunk_types_match_jax(tmp_path):
    """``tests/test_dataio.py``'s direct-chunk cases: float16, uint8,
    int64, and strings."""
    rng = np.random.default_rng(2)
    values = [rng.random((37, 21, 2)).astype(np.float16), (rng.random((5, 9)) * 255).astype(np.uint8),
              np.arange(11, dtype=np.int64), np.array([b"ab", b"cde"]), np.arange(6, dtype=np.int32).reshape(2, 3)]
    both(tmp_path, values, create_items, compression="gzip", compression_opts=1)


def test_names_with_a_slash_make_groups(tmp_path):
    values = [np.arange(4, dtype=np.float32) + i for i in range(4)]
    for side in SIDES:
        C = SIDES[side][3]
        write(side, str(tmp_path / f"{side}.h5"), values,
              lambda oid, v, C=C: [(C(lambda o: f"grp/sub{int(o[3:]) % 2}/{o}", oid), v)], compression_opts=1)
    ref, ours = summary(str(tmp_path / "jax.h5")), summary(str(tmp_path / "torch.h5"))
    assert_same(ref, ours)
    assert ours["grp"] == "group" and ours["grp/sub1"] == "group" and "grp/sub1/obj3" in ours


@pytest.mark.parametrize("mode", ["create", "append"])
def test_compression_off_matches_jax(tmp_path, mode):
    rng = np.random.default_rng(3)
    values = [rng.random((5, 7)).astype(np.float32) for _ in range(5)]
    ours = both(tmp_path, values, create_items if mode == "create" else append_items, dataset_mode=mode,
                compression=None)
    assert all(d["compression"] is None and not d["shuffle"] for k, d in ours.items() if k != "/attrs")


@pytest.mark.parametrize("mode", ["create", "append"])
def test_an_exception_mid_stream_leaves_a_readable_file(tmp_path, mode):
    """Object 5 of 9 raises: both writers close their files in ``finally``
    and the objects before it read back."""
    values = [np.full((30, 20), i, np.float32) for i in range(9)]
    files = {side: str(tmp_path / f"{side}.h5") for side in SIDES}
    for side, fn in files.items():
        with pytest.raises(RuntimeError, match="fails here"):
            write(side, fn, values, create_items if mode == "create" else append_items, dataset_mode=mode,
                  fail_at=5, compression_opts=1)
    ref, ours = summary(files["jax"]), summary(files["torch"])
    assert_same(ref, ours)
    assert (len(ours) == 6) if mode == "create" else (ours["predictions"]["shape"][0] == 5)


def test_append_with_workers_keeps_row_order(tmp_path):
    """``tests/test_engine_core.py``: four workers feeding append mode."""
    values = [float(x) * 2 for x in range(24)]
    files = {side: str(tmp_path / f"{side}.h5") for side in SIDES}
    for side, fn in files.items():
        C = SIDES[side][3]
        write(side, fn, values, lambda oid, v, C=C: [("idx", C(lambda s: int(s[3:]), oid)), ("val", v)],
              dataset_mode="append", n_workers=4)
    ref, ours = summary(files["jax"]), summary(files["torch"])
    assert_same(ref, ours)
    assert list(ours["idx"]["value"]) == list(range(24)) and list(ours["val"]["value"]) == values


def test_arrays_over_16_mb_match_jax(tmp_path):
    """Beyond 16 MB both writers chunk the array (each its own way)."""
    big = np.arange(2100 * 2100, dtype=np.float32).reshape(2100, 2100) % 977
    both(tmp_path, [big, big[:10]], create_items, compression_opts=1)
    with h5py.File(tmp_path / "torch.h5") as h5:
        assert h5["obj0"].id.get_num_chunks() == 2


def test_two_writes_give_the_same_bytes(tmp_path):
    rng = np.random.default_rng(4)
    values = [rng.random((int(rng.integers(5, 60)), 40, 2)).astype(np.float16) for _ in range(40)]
    blobs = []
    for k in range(2):
        fn = str(tmp_path / f"w{k}.h5")
        write("torch", fn, values, create_items, compression_opts=1, file_attrs=RAW_ATTRS["float16"])
        with open(fn, "rb") as f:
            blobs.append(f.read())
    assert blobs[0] == blobs[1] and blobs[0][:8] == b"\x89HDF\r\n\x1a\n"


def test_adaptive_store_for_incompressible_streams(tmp_path):
    """``tests/test_dataio.py``'s adaptive-store rule: noisy payloads switch
    to stored blocks, compressible ones keep compressing, ``adaptive_store=
    False`` always compresses; the values equal the JAX writer's."""
    rng = np.random.default_rng(5)
    noisy = [rng.integers(0, 256, (64, 64, 2), dtype=np.uint8) for _ in range(40)]
    node = write("torch", str(tmp_path / "noisy.h5"), noisy, create_items, compression_opts=1)
    assert node._ratio_ema is not None and node._ratio_ema > 0.92 and node._stored_since_probe > 0
    write("jax", str(tmp_path / "noisy_jax.h5"), noisy, create_items, compression_opts=1)
    assert_same(summary(str(tmp_path / "noisy_jax.h5")), summary(str(tmp_path / "noisy.h5")))

    smooth = [np.zeros((64, 64, 2), np.float16) for _ in range(10)]
    node = write("torch", str(tmp_path / "smooth.h5"), smooth, create_items, compression_opts=1)
    assert node._ratio_ema is not None and node._ratio_ema < 0.5
    assert os.path.getsize(tmp_path / "smooth.h5") < 10 * 64 * 64 * 2 * 2 / 4

    node = write("torch", str(tmp_path / "off.h5"), noisy[:5], create_items, compression_opts=1,
                 adaptive_store=False)
    assert node._stored_since_probe == 0


def test_without_the_native_library_the_values_are_the_same(tmp_path, monkeypatch):
    """Without the native shuffle + DEFLATE, numpy shuffles and stdlib zlib
    compresses: the same values read back."""
    rng = np.random.default_rng(6)
    values = [rng.random((33, 17, 2)).astype(np.float32) for _ in range(3)]
    write("torch", str(tmp_path / "native.h5"), values, create_items, compression_opts=1)
    monkeypatch.setattr(native, "hdf5_chunk_pack", lambda *a, **k: None)
    monkeypatch.setattr(native, "zlib_compress", lambda *a, **k: None)
    write("torch", str(tmp_path / "stdlib.h5"), values, create_items, compression_opts=1)
    assert_same(summary(str(tmp_path / "native.h5")), summary(str(tmp_path / "stdlib.h5")))


def test_writer_rejects_what_it_cannot_store(tmp_path):
    with pytest.raises(ValueError, match="compression"):
        HDF5Writer(str(tmp_path / "x.h5"), [], compression="lzf")
    with pytest.raises(ValueError, match="dataset_mode"):
        HDF5Writer(str(tmp_path / "x.h5"), [], dataset_mode="update")
    with pytest.raises(TypeError, match="scalar"):
        write("torch", str(tmp_path / "s.h5"), [np.float32(1)], create_items)
    with pytest.raises(ValueError, match="already exists"):
        write("torch", str(tmp_path / "d.h5"), [np.ones(2), np.zeros(2)], lambda oid, v: [("same", v)])
    np.testing.assert_array_equal(summary(str(tmp_path / "d.h5"))["same"]["value"], np.ones(2))
    assert thdf5.UNDEF == 2**64 - 1
