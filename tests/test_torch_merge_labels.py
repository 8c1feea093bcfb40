"""``ops/merge_labels.py`` of the PyTorch port against the JAX package.

The same seeded label frames go through both ``merge_labels``; the port's
distance fields come from its own ``squared_edt`` (integers, so exact) and
its greedy loop is the same numpy code, so the merged labels and the merge
distances must be equal, with ``max_distance`` set and ``None``, with an
explicit ``index`` and an output buffer.
"""

import numpy as np
import pytest
import scipy.ndimage as ndi
import torch

from maze_image_processing_pipeline_tpu.ops.merge_labels import merge_labels as j_merge
from maze_image_processing_pipeline_tpu_torch.ops.merge_labels import merge_labels


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the parallel test workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _labels(seed, shape=(48, 64)):
    rng = np.random.default_rng(seed)
    m = ndi.binary_dilation(rng.random(shape) < 0.012, iterations=2)
    lab, n = ndi.label(m, np.ones((3, 3)))
    assert n >= 4
    return lab.astype(np.int32)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("max_distance", [3, 8, None])
def test_merge_labels_matches_jax(seed, max_distance):
    lab = _labels(seed)
    ref, ref_d = j_merge(lab, max_distance=max_distance, return_merge_distances=True)
    ours, our_d = merge_labels(lab, max_distance=max_distance, return_merge_distances=True, device="cpu")
    np.testing.assert_array_equal(ours, ref)
    assert our_d == ref_d
    np.testing.assert_array_equal(merge_labels(lab, max_distance=max_distance, device="cpu"), ref)
    if max_distance is None:
        assert len(np.unique(ours[ours > 0])) == 1  # everything merged


def test_merge_labels_index_and_output_buffer_match_jax():
    lab = _labels(3)
    index = [int(v) for v in np.unique(lab)[1:4]]
    ref = j_merge(lab, index=list(index), max_distance=10, labels_out=np.zeros_like(lab))
    out = np.zeros_like(lab)
    ours = merge_labels(lab, index=list(index), max_distance=10, labels_out=out, device="cpu")
    assert ours is out
    np.testing.assert_array_equal(ours, ref)
    single = merge_labels(lab, index=index[:1], labels_out=np.zeros_like(lab), device="cpu")
    np.testing.assert_array_equal(single, lab)
