"""The port's plain region measurement and small-object removal against the
JAX package at id ranges past the card's shared-memory routes.

On the card these R take the device-memory routes of the region
measurement (K7 with K3) and of K8, which are held bit for bit to the plain
versions (tests marked ``cuda``, ``chip_smoke.py`` phase 2). Here the plain
versions, those routes' oracle, are held to the reference: the JAX
package's ``regionprops_fused`` and ``remove_small_objects`` (one-hot over
R) on frames whose ids run past 3760 (the shared route's largest R at
loki's width) and past 38,712 (K8's cluster route's), at the tolerances of
``test_torch_regionprops.py``: integer keys and the histogram exact, the
rest within rtol 1e-5 / atol 1e-3.
"""

import numpy as np
import pytest
import torch

from maze_image_processing_pipeline_tpu.ops import label as jl
from maze_image_processing_pipeline_tpu.ops.regionprops_fused import regionprops_fused as j_props
from maze_image_processing_pipeline_tpu_torch.ops import label as tl
from maze_image_processing_pipeline_tpu_torch.ops.regionprops_fused import regionprops_fused

EXACT = {"area", "min_row", "max_row", "min_col", "max_col", "histogram", "intensity_min", "intensity_max"}


def _frames(shape, R, seed):
    """Label frames of 2x2 blocks and a few rectangles with ids drawn from
    [R - 1300, R + 20) (beyond R too), background and negative ids between
    them, the largest id R - 1 present; uint8 intensity."""
    rng = np.random.default_rng(seed)
    B, H, W = shape
    ids = rng.integers(R - 1300, R + 20, (B, H // 2, W // 2))
    ids[rng.random(ids.shape) < 0.3] = 0
    ids[rng.random(ids.shape) < 0.05] = -2
    lab = np.repeat(np.repeat(ids, 2, axis=1), 2, axis=2).astype(np.int32)
    for b in range(B):
        for _ in range(4):
            h, w = rng.integers(2, 9, 2)
            y, x = rng.integers(0, H - h), rng.integers(0, W - w)
            lab[b, y : y + h, x : x + w] = rng.integers(R - 1300, R)
    lab[:, -1, -3:] = R - 1
    return lab, rng.integers(0, 256, shape).astype(np.uint8)


@pytest.mark.parametrize("R", [5000, 40000])
def test_plain_regionprops_fused_matches_jax_at_large_r(R):
    lab, img = _frames((1, 24, 40), R, seed=R)
    assert lab.max() >= R and (lab[(lab > 3760) & (lab < R)]).size > 50
    ref = j_props(lab, img, num_segments=R)
    ours = regionprops_fused(torch.from_numpy(lab), torch.from_numpy(img), num_segments=R)
    assert set(ref) == set(ours)
    for k in ref:
        r, o = np.asarray(ref[k]), ours[k].numpy()
        assert r.shape == o.shape, k
        if k in EXACT:
            np.testing.assert_array_equal(o, r, err_msg=k)
        else:
            np.testing.assert_allclose(o, r, rtol=1e-5, atol=1e-3, err_msg=k)
    assert ours["area"][0, R - 1] >= 3


@pytest.mark.parametrize("R", [5000, 40000])
@pytest.mark.parametrize("min_area", [0, 1, 5])
def test_plain_remove_small_objects_matches_jax_at_large_r(R, min_area):
    lab, _ = _frames((2, 24, 40), R, seed=R + 1)
    ref, n_ref = jl.remove_small_objects(lab, min_area, num_segments=R)
    ours, n = tl.remove_small_objects(torch.from_numpy(lab), min_area, R)
    np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))
    np.testing.assert_array_equal(n.numpy(), np.asarray(n_ref))
    assert int(ours.max()) > 0
