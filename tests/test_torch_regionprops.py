"""Region measurement, filled area and device crops of the PyTorch port
against the JAX package.

Integer results (counts, areas, bounding boxes, histograms, extremes) must be
equal; float statistics agree to rtol 1e-5, with atol 1e-3 for values that
cancel to about zero: ``mu11`` of a symmetric region is 0 in the port, which
accumulates moments in float64, and carries the JAX package's float32
rounding (5e-4 seen) there.
"""

import numpy as np
import pytest
import scipy.ndimage as ndi
import torch

from maze_image_processing_pipeline_tpu.ops import label as jl
from maze_image_processing_pipeline_tpu.ops.crops import UNPACK_LUT as J_LUT
from maze_image_processing_pipeline_tpu.ops.crops import extract_region_crops as j_crops
from maze_image_processing_pipeline_tpu.ops.fill_holes import region_filled_extra as j_filled
from maze_image_processing_pipeline_tpu.ops.regionprops import _marching_squares_length
from maze_image_processing_pipeline_tpu.ops.regionprops_fused import regionprops_fused as j_props
from maze_image_processing_pipeline_tpu_torch.ops.crops import UNPACK_LUT, extract_region_crops
from maze_image_processing_pipeline_tpu_torch.ops.fill_holes import region_filled_extra
from maze_image_processing_pipeline_tpu_torch.ops.regionprops import marching_squares_length
from maze_image_processing_pipeline_tpu_torch.ops.regionprops_fused import regionprops_fused

EXACT = {
    "area", "min_row", "max_row", "min_col", "max_col", "histogram",
    "intensity_min", "intensity_max",
}


@pytest.fixture(scope="module")
def scene():
    rng = np.random.default_rng(1)
    m = ndi.binary_dilation(rng.random((2, 40, 60)) < 0.03, iterations=2)
    yy, xx = np.mgrid[:40, :60]
    rr = (yy - 20) ** 2 + (xx - 30) ** 2
    m[1] |= (rr <= 64) & (rr >= 16)  # a ring: one hole
    labels = np.asarray(jl.label(m, connectivity=2)[0])
    image = rng.integers(0, 256, m.shape).astype(np.uint8)
    return labels, image


def _compare(ref, ours):
    assert set(ref) == set(ours)
    for k in ref:
        r, o = np.asarray(ref[k]), ours[k].numpy()
        assert r.shape == o.shape, k
        if k in EXACT:
            np.testing.assert_array_equal(o, r, err_msg=k)
        else:
            np.testing.assert_allclose(o, r, rtol=1e-5, atol=1e-3, err_msg=k)


@pytest.mark.parametrize("R", [8, 64])
@pytest.mark.parametrize("intensity", ["uint8", "float32", None])
def test_regionprops_fused_matches_jax(scene, R, intensity):
    labels, image = scene
    inten = None if intensity is None else image.astype(intensity)
    ref = j_props(labels, inten, num_segments=R)
    ours = regionprops_fused(
        torch.from_numpy(labels), None if inten is None else torch.from_numpy(inten), num_segments=R
    )
    _compare(ref, ours)


def test_regionprops_fused_without_feret_and_histogram(scene):
    labels, image = scene
    kw = dict(num_segments=16, n_feret_angles=0, compute_histogram=False)
    ref = j_props(labels, image, **kw)
    ours = regionprops_fused(torch.from_numpy(labels), torch.from_numpy(image), **kw)
    assert "feret_diameter_max" not in ours and "histogram" not in ours
    _compare(ref, ours)


def test_marching_squares_length_matches_jax(scene):
    fg = scene[0] > 0
    ref = np.asarray(_marching_squares_length(fg))
    np.testing.assert_array_equal(marching_squares_length(torch.from_numpy(fg)).numpy(), ref)


def _filled_scene():
    lab = np.zeros((3, 32, 40), np.int32)
    yy, xx = np.mgrid[:32, :40]
    rr = (yy - 12) ** 2 + (xx - 14) ** 2
    lab[0][(rr <= 49) & (rr >= 9)] = 1  # ring with a hole of 21 px
    lab[0][25:30, 30:36] = 2
    lab[1][(rr <= 64) & (rr >= 25)] = 1  # ring ...
    lab[1][10:15, 12:17] = 2  # ... with another region inside its hole
    lab[2][:, :20] = 3  # many one-pixel background components (overflow)
    lab[2][1:-1:2, 1:19:2] = 0
    lab[2][10:20, 25:35] = 1
    return lab


@pytest.mark.parametrize("bg_segments", [8, 64])
def test_region_filled_extra_matches_jax(bg_segments):
    lab = _filled_scene()
    ref_extra, ref_amb = j_filled(lab, num_segments=4, bg_segments=bg_segments)
    extra, amb = region_filled_extra(torch.from_numpy(lab), num_segments=4, bg_segments=bg_segments)
    np.testing.assert_array_equal(extra.numpy(), np.asarray(ref_extra))
    np.testing.assert_array_equal(amb.numpy(), np.asarray(ref_amb))
    assert extra.numpy()[0, 1] > 0  # the ring's hole is attributed
    assert amb.numpy()[1, 1:3].all() and amb.numpy()[2].any()


@pytest.mark.parametrize("include_intensity", [True, False])
@pytest.mark.parametrize("pack_bits", [True, False])
def test_extract_region_crops_matches_jax(scene, include_intensity, pack_bits):
    labels, image = scene
    ids = np.asarray([1, 2, 3, 1, 5], np.int32)
    bidx = np.asarray([0, 1, 0, 1, 1], np.int32)
    y0 = np.asarray([0, 5, 30, 3, 20], np.int32)  # starts past H - size_h clamp
    x0 = np.asarray([0, 10, 50, 7, 100], np.int32)
    kw = dict(size_h=16, size_w=32, include_intensity=include_intensity, pack_bits=pack_bits)
    ref = np.asarray(j_crops(image, labels, ids, bidx, y0, x0, **kw))
    ours = extract_region_crops(
        torch.from_numpy(image), torch.from_numpy(labels),
        *(torch.from_numpy(a) for a in (ids, bidx, y0, x0)), **kw,
    )
    assert ours.dtype == torch.uint8
    np.testing.assert_array_equal(ours.numpy(), ref)
    np.testing.assert_array_equal(UNPACK_LUT, J_LUT)


def test_extract_region_crops_pack_bits_needs_width_multiple_of_four(scene):
    labels, image = scene
    one = torch.zeros(1, dtype=torch.int32)
    with pytest.raises(ValueError):
        extract_region_crops(
            torch.from_numpy(image), torch.from_numpy(labels), one, one, one, one,
            size_h=8, size_w=10, pack_bits=True,
        )
