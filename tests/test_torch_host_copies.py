"""The port's copies of host (numpy) code stay equal to their originals.

``ops/host_props.py``, ``ops/zooprocess.py`` and the image nodes of
``engine/image.py`` are carried into the port because the originals are
reachable only through a package ``__init__`` that imports jax. The same
inputs go through original and copy; the outputs must be identical.
"""

import numpy as np
import pytest
import scipy.ndimage as ndi

from maze_image_processing_pipeline_tpu.engine import Call, Pipeline, Unpack
from maze_image_processing_pipeline_tpu.engine import image as j_image
from maze_image_processing_pipeline_tpu.ops import host_props as j_host_props
from maze_image_processing_pipeline_tpu.ops import zooprocess as j_zoo
from maze_image_processing_pipeline_tpu_torch.engine import image as t_image
from maze_image_processing_pipeline_tpu_torch.ops import host_props as t_host_props
from maze_image_processing_pipeline_tpu_torch.ops import zooprocess as t_zoo


def _scene(seed=0, shape=(60, 80)):
    rng = np.random.default_rng(seed)
    m = ndi.binary_dilation(rng.random(shape) < 0.01, iterations=3)
    m[25:35, 30:50] = True
    m[29:31, 38:42] = False  # a hole
    labels, n = ndi.label(m, structure=np.ones((3, 3)))
    image = rng.integers(0, 256, shape).astype(np.uint8)
    return labels.astype(np.int32), n, image


def _assert_same(a, b):
    assert type(a) is type(b) or (np.isscalar(a) and np.isscalar(b))
    if isinstance(a, dict):
        assert list(a) == list(b)
        for k in a:
            _assert_same(a[k], b[k])
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("seed", [0, 1])
def test_host_region_props_copy(seed):
    labels, n, image = _scene(seed)
    for r in range(1, n + 1):
        mask = labels == r
        for inten in (image, None):
            _assert_same(
                t_host_props.host_region_props(mask, inten),
                j_host_props.host_region_props(mask, inten),
            )


def test_zooprocess_copy():
    labels, n, image = _scene(2)
    props = j_host_props.host_region_props(labels == 1, image)
    for area_filled in (None, float(props["area"][1]) + 4.0):
        _assert_same(
            t_zoo.zooprocess_features(props, 1, area_filled=area_filled, prefix="object_"),
            j_zoo.zooprocess_features(props, 1, area_filled=area_filled, prefix="object_"),
        )
    assert t_zoo.N_FEATURES == j_zoo.N_FEATURES


def _run_nodes(mod, frames, alpha, keep_background, bg_color, padding, min_area):
    out = []
    with Pipeline() as p:
        labels, image = Unpack(frames).unpack(2)
        region = mod.FindRegions(labels, image, padding=padding, min_area=min_area)
        roi = mod.ExtractROI(
            image, region, alpha=alpha, bg_color=bg_color,
            keep_background=keep_background, labels=labels,
        )
        meta = mod.CalculateZooProcessFeatures(region, {"k": 1}, prefix="object_")
        Call(lambda r, o, m: out.append((r, o, m)), region, roi, meta)
    p.run()
    return out


@pytest.mark.parametrize(
    "alpha,keep_background,bg_color",
    [(0, True, 0), (1, True, "white"), (1, False, "quantile:0.25")],
)
def test_image_nodes_copy(alpha, keep_background, bg_color):
    frames = [_scene(s)[::2] for s in (3, 4)]
    ref = _run_nodes(j_image, frames, alpha, keep_background, bg_color, padding=4, min_area=5)
    ours = _run_nodes(t_image, frames, alpha, keep_background, bg_color, padding=4, min_area=5)
    assert len(ours) == len(ref) > 2
    for (rr, ro, rm), (tr, to, tm) in zip(ref, ours):
        assert isinstance(tr, t_image.RegionInfo)
        for slot in j_image.RegionInfo.__slots__:
            _assert_same(getattr(tr, slot), getattr(rr, slot))
        _assert_same(to, ro)
        _assert_same(tm, rm)


def test_region_info_slots_match():
    assert t_image.RegionInfo.__slots__ == j_image.RegionInfo.__slots__
    r = t_image.RegionInfo(1, (0, 0, 2, 2), (0, 0, 2, 2), np.ones((2, 2), bool), None, {"area": 4.0}, 4.0)
    assert r.area == 4.0 and r.other_mask is None
