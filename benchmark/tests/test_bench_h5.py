"""The benchmark's HDF5 reader on files of the program's writer: every
dataset back bit for bit, groups, row chunks, stored and filtered blocks;
a file it cannot take raises."""

import os
import sys

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from benchmark.h5read import H5Error, read_datasets  # noqa: E402


def _write(fn, values, level=1, **kw):
    from maze_image_processing_pipeline_tpu_torch.dataio import hdf5

    node = hdf5.HDF5Writer("unused", [], compression_opts=level, **kw)
    f = hdf5._File(fn, {"raw_dtype": "float16"})
    for name, v in values.items():
        node._create(f, name, v)
    f.close()


@pytest.mark.parametrize("level, shuffle", [(1, True), (1, False), (None, False)])
def test_every_dataset_reads_back(tmp_path, level, shuffle):
    rng = np.random.default_rng(3)
    values = {f"obj{i:04d}": rng.random((int(rng.integers(5, 90)), int(rng.integers(5, 90)), 2)).astype(np.float16)
              for i in range(70)}  # more than one symbol-table node and B-tree level
    values["a/b/labels"] = rng.integers(-5, 5, (7, 9)).astype(np.int32)
    for i in range(4):  # incompressible: the writer turns to stored blocks
        values[f"noise{i}"] = rng.integers(0, 2**16, (300, 40), dtype=np.uint16).view(np.float16)
    fn = str(tmp_path / "x.h5")
    _write(fn, values, shuffle=shuffle, compression="gzip" if level else None)
    got = read_datasets(fn)
    assert set(got) == set(values)
    for k, v in values.items():
        assert got[k].dtype == v.dtype and got[k].shape == v.shape
        assert got[k].tobytes() == np.ascontiguousarray(v).tobytes(), k


def test_row_chunks_of_a_large_array(tmp_path):
    big = np.arange(2100 * 2100, dtype=np.float32).reshape(2100, 2100) % 977  # 17.6 MB: row blocks of 16 MB
    fn = str(tmp_path / "big.h5")
    _write(fn, {"big": big})
    assert np.array_equal(read_datasets(fn)["big"], big)


def test_names_select_datasets(tmp_path):
    fn = str(tmp_path / "s.h5")
    _write(fn, {"a": np.ones((3, 3), np.float16), "b": np.zeros((2, 2), np.float16)})
    assert set(read_datasets(fn, ["b", "missing"])) == {"b"}


def test_a_file_it_cannot_take_raises(tmp_path):
    fn = tmp_path / "bad.h5"
    fn.write_bytes(b"not an hdf5 file" * 10)
    with pytest.raises(H5Error):
        read_datasets(str(fn))
