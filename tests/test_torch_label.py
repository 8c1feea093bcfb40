"""CCL and label utilities of the PyTorch port against the JAX package.

Same seeded masks through ``maze_image_processing_pipeline_tpu.ops.label``
(its associative-scan path on the CPU) and the port; every result must be
equal, bit for bit.
"""

import numpy as np
import pytest
import scipy.ndimage as ndi
import torch

from maze_image_processing_pipeline_tpu.ops import label as jl
from maze_image_processing_pipeline_tpu_torch.ops import label as tl


def _mask(shape, density, seed, grow=1):
    rng = np.random.default_rng(seed)
    m = rng.random(shape) < density
    if grow:
        m = ndi.binary_dilation(m, structure=np.ones((1,) * (m.ndim - 2) + (3, 3)), iterations=grow)
    return m


def _serpentine(H=64, W=48):
    mask = np.zeros((H, W), bool)
    for k, y in enumerate(range(0, H - 2, 4)):
        mask[y, 1:-1] = True
        x = W - 2 if k % 2 == 0 else 1
        mask[y : y + 5, x] = True
    mask[-1, :] = False
    return mask


@pytest.mark.parametrize("connectivity", [1, 2])
@pytest.mark.parametrize(
    "shape,density,grow",
    [((2, 40, 56), 0.05, 1), ((1, 33, 70), 0.4, 0), ((3, 24, 31), 0.15, 2)],
)
def test_label_matches_jax(connectivity, shape, density, grow):
    m = _mask(shape, density, seed=shape[1], grow=grow)
    ref, n_ref = jl.label(m, connectivity=connectivity)
    ours, n = tl.label(torch.from_numpy(m), connectivity=connectivity)
    np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))
    np.testing.assert_array_equal(n.numpy(), np.asarray(n_ref))
    assert ours.dtype == torch.int32 and n.dtype == torch.int32


@pytest.mark.parametrize("connectivity", [1, 2])
def test_label_serpentine_matches_jax(connectivity):
    m = _serpentine()
    ref, n_ref = jl.label(m, connectivity=connectivity)
    ours, n = tl.label(torch.from_numpy(m), connectivity=connectivity)
    np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))
    assert int(n) == int(n_ref) == 1


def test_label_iteration_cap_matches_jax():
    # One sweep is too few for the snake's turns: both stop at the same
    # partial labelling.
    m = np.rot90(_serpentine(96, 64)).copy()
    ref, n_ref = jl.label(m, connectivity=2, max_iters=1)
    ours, n = tl.label(torch.from_numpy(m), connectivity=2, max_iters=1)
    np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))
    assert int(n) == int(n_ref)


def test_label_rejects_bad_connectivity():
    with pytest.raises(ValueError):
        tl.label(torch.zeros(4, 4, dtype=torch.bool), connectivity=3)


@pytest.fixture(scope="module")
def labels():
    m = _mask((3, 48, 64), 0.05, seed=5)
    return np.asarray(jl.label(m, connectivity=2)[0])


@pytest.mark.parametrize("num_segments", [8, 64])
def test_region_areas_matches_jax(labels, num_segments):
    ref = np.asarray(jl.region_areas(labels, num_segments))
    ours = tl.region_areas(torch.from_numpy(labels), num_segments)
    np.testing.assert_array_equal(ours.numpy(), ref)


@pytest.mark.parametrize("num_segments,min_area", [(64, 12), (16, 5), (64, 0), (1, 12), (1, 0)])
def test_remove_small_objects_matches_jax(labels, num_segments, min_area):
    ref, n_ref = jl.remove_small_objects(labels, min_area, num_segments=num_segments)
    ours, n = tl.remove_small_objects(torch.from_numpy(labels), min_area, num_segments)
    np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))
    np.testing.assert_array_equal(n.numpy(), np.asarray(n_ref))


@pytest.mark.parametrize("num_segments,min_area", [(64, 12), (16, 0)])
def test_remove_small_objects_one_region_covering_each_frame_matches_jax(labels, num_segments, min_area):
    lab = np.full_like(labels, 3)
    ref, n_ref = jl.remove_small_objects(lab, min_area, num_segments=num_segments)
    ours, n = tl.remove_small_objects(torch.from_numpy(lab), min_area, num_segments)
    np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))
    np.testing.assert_array_equal(n.numpy(), np.asarray(n_ref))
    assert n.tolist() == [num_segments - 1 if min_area == 0 else 1] * labels.shape[0]  # 0: absent ids kept too


@pytest.mark.parametrize("num_segments", [64, 16])
def test_clear_border_matches_jax(labels, num_segments):
    ref, n_ref = jl.clear_border(labels, num_segments=num_segments)
    ours, n = tl.clear_border(torch.from_numpy(labels), num_segments)
    np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))
    np.testing.assert_array_equal(n.numpy(), np.asarray(n_ref))


@pytest.mark.parametrize("R", [16, 48])
def test_relabel_keep_maps_ids_beyond_the_table_to_zero(labels, R):
    # R = 16 and 48 take the JAX package's two formulations (one-hot and
    # nibble-factored); ids >= R map to 0 on both and in the port.
    rng = np.random.default_rng(R)
    keep = rng.random((labels.shape[0], R)) < 0.6
    assert labels.max() >= R or R == 48
    ref = np.asarray(jl._relabel_keep(labels, keep))
    ours = tl._relabel_keep(torch.from_numpy(labels), torch.from_numpy(keep))
    np.testing.assert_array_equal(ours.numpy(), ref)
