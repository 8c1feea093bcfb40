"""The LOKI segmentation slice of the PyTorch port against the JAX package.

Both sides run a 1×1-conv "threshold oracle" model, sigmoid(500·(x − 60/255))
on every channel sum, registered with each package's model registry, so the
scores are ~0 or ~1 and no pixel sits at the 0.5 threshold. The frames keep
clear of the threshold too (noise below 40, objects from 100 up). Region
counts, bounding boxes, masks and filled areas must be equal; the float
statistics agree to rtol 1e-5 (atol 1e-3 for values that cancel to ~0, as
in ``test_torch_regionprops.py``). Each package's nodes run in that
package's own engine; the port's run on the CPU, asked for by name. The
whole segmentation stage (``build_torch_segmentation``) and its label-frame
options: ``tests/test_torch_device_seg_stage.py``.
"""

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from maze_image_processing_pipeline_tpu import engine as j_engine
from maze_image_processing_pipeline_tpu.engine import image as j_image
from maze_image_processing_pipeline_tpu.loki import device_seg as jseg
from maze_image_processing_pipeline_tpu.loki.config_schema import (
    JaxSegmentationConfig,
    SegmentationPostprocessingConfig,
)
from maze_image_processing_pipeline_tpu.models import load_model as j_load
from maze_image_processing_pipeline_tpu.models import model_io as j_model_io
from maze_image_processing_pipeline_tpu.models import save_model
from maze_image_processing_pipeline_tpu_torch import engine as t_engine
from maze_image_processing_pipeline_tpu_torch.engine import image as t_image
from maze_image_processing_pipeline_tpu_torch.loki import device_seg as tseg
from maze_image_processing_pipeline_tpu_torch.models import model_io as t_model_io

ARCH = "threshold_net_parity"


class ThresholdNet(nn.Module):
    threshold: float = 60.0 / 255.0
    scale: float = 500.0

    @nn.compact
    def __call__(self, x):
        w = self.param("w", lambda k: jnp.full((1, 1, 3, 1), self.scale / 3))
        b = self.param("b", lambda k: jnp.full((1,), -self.scale * self.threshold))
        return jax.lax.conv_general_dilated(
            x.astype(jnp.float32), w, (1, 1), "SAME",
            dimension_numbers=("NHWC", "HWIO", "NHWC"),
        ) + b


class TorchThresholdNet(torch.nn.Module):
    """The same model for the port; parameters named as in flax."""

    def __init__(self, threshold: float = 60.0 / 255.0, scale: float = 500.0) -> None:
        super().__init__()
        self.w = torch.nn.Parameter(torch.zeros(1, 1, 3, 1))
        self.b = torch.nn.Parameter(torch.zeros(1))

    def forward(self, x):
        return torch.einsum("bhwc,co->bhwo", x.float(), self.w[0, 0]) + self.b


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    j_model_io._ARCHITECTURES[ARCH] = ThresholdNet
    t_model_io._ARCHITECTURES[ARCH] = TorchThresholdNet
    path = str(tmp_path_factory.mktemp("model") / "thrnet")
    module = ThresholdNet()
    save_model(path, module, module.init(jax.random.key(0), jnp.zeros((1, 8, 8, 3))))
    return path


def _frames(n=4, shape=(256, 384), blobs=7, seed=5):
    rng = np.random.default_rng(seed)
    H, W = shape
    yy, xx = np.mgrid[:H, :W]
    out = []
    for _ in range(n):
        img = (rng.random((H, W)) * 40).astype(np.uint8)
        for _ in range(blobs):
            cy, cx, r = rng.integers(0, H), rng.integers(0, W), rng.integers(4, 18)
            img[(yy - cy) ** 2 + (xx - cx) ** 2 <= r * r] = rng.integers(100, 250)
        ring = ((yy - 128) ** 2 + (xx - 60) ** 2 <= 400) & ((yy - 128) ** 2 + (xx - 60) ** 2 >= 100)
        img[ring] = 180  # a region with a hole
        out.append(img)
    return out


POST = dict(min_area=20, closing_radius=2, opening_radius=1, max_regions=6)


def _configs(model_dir, **kw):
    cfg = JaxSegmentationConfig(
        model_fn=model_dir, dtype="float32", tile_size=128, tile_stride=96,
        frame_batch=2, batch_size=4, padding=5, **kw,
    )
    return cfg, SegmentationPostprocessingConfig(**POST)


def _run(node, frames, model, cfg, post, **kw):
    """``node`` over ``frames`` in its own package's engine."""
    engine, image = (t_engine, t_image) if node is tseg.DeviceTiledSegmentation else (j_engine, j_image)
    out = []
    with engine.Pipeline() as p:
        img = engine.Unpack(frames)
        labels, props, n, regions = node(img, model, cfg, post, **kw)
        engine.Call(lambda lab, pr, nn_: out.append(("frame", lab, pr, int(nn_))), labels, props, n)
        region = image.FindRegions(labels, img, padding=cfg.padding, props=props, regions=regions)
        engine.Call(lambda r: out.append(("region", r)), region)
    p.run()
    return out


def _compare_runs(ref, ours):
    assert [o[0] for o in ours] == [r[0] for r in ref]
    for r, o in zip(ref, ours):
        if r[0] == "frame":
            assert o[3] == r[3]  # n_regions
            assert (o[1] is None) == (r[1] is None)
            if r[1] is not None:
                np.testing.assert_array_equal(o[1], r[1])
            for k in r[2]:
                np.testing.assert_allclose(o[2][k], r[2][k], rtol=1e-5, atol=1e-3, err_msg=k)
            continue
        ra, rb = r[1], o[1]
        assert (ra.label, ra.bbox, ra.bbox_padded) == (rb.label, rb.bbox, rb.bbox_padded)
        np.testing.assert_array_equal(rb.image, ra.image)
        np.testing.assert_array_equal(rb.image_intensity, ra.image_intensity)
        if ra.other_mask is not None:
            np.testing.assert_array_equal(rb.other_mask, ra.other_mask)
        assert rb.area_filled == ra.area_filled
        assert set(rb.props) == set(ra.props)
        for k in ra.props:
            np.testing.assert_allclose(rb.props[k], ra.props[k], rtol=1e-5, atol=1e-3, err_msg=k)


def test_slice_matches_jax(model_dir):
    cfg, post = _configs(model_dir)
    frames = _frames()
    ref = _run(jseg.DeviceTiledSegmentation, frames, j_load(model_dir, dtype="float32"), cfg, post)
    ours = _run(tseg.DeviceTiledSegmentation, frames, t_model_io.load_model(model_dir, dtype="float32"), cfg, post, device="cpu")
    n_regions = [o[3] for o in ours if o[0] == "frame"]
    # max_regions=6 overflows on some frames: the host fallback is covered.
    assert max(n_regions) > post.max_regions - 1 and sum(n_regions) > 10
    assert any(o[1].area_filled > o[1].props["area"] for o in ours if o[0] == "region")
    _compare_runs(ref, ours)


def test_frame_chain_buffer_matches_jax():
    rng = np.random.default_rng(0)
    img = np.stack(_frames(n=2, shape=(96, 128), blobs=5, seed=1))
    pred = (img > 60).astype(np.float32) * 0.8 + 0.1 * rng.random(img.shape).astype(np.float32)
    post = SegmentationPostprocessingConfig(**{**POST, "clear_border": True})
    j_chain, j_keys = jseg._build_frame_chain(post, use_pallas=False, include_labels=False, compute_filled=True)
    t_chain, t_keys = tseg._build_frame_chain(post)
    ref_labels, ref = (np.asarray(a) for a in j_chain(pred, img))
    labels, ours = (t.numpy() for t in t_chain(torch.from_numpy(pred), torch.from_numpy(img)))
    assert t_keys == j_keys and ours.shape == ref.shape
    np.testing.assert_array_equal(labels, ref_labels)
    np.testing.assert_array_equal(ours[:2], ref[:2])  # region counts
    np.testing.assert_allclose(ours, ref, rtol=1e-5, atol=1e-3)


def test_mixed_shape_buckets_keep_arrival_order(model_dir):
    cfg, post = _configs(model_dir)
    rng = np.random.default_rng(3)
    frames, counts = [], []
    for H, W in [(200, 260), (300, 380), (200, 260), (200, 260), (300, 380)]:
        img = (rng.random((H, W)) * 40).astype(np.uint8)
        n = int(rng.integers(1, 4))
        yy, xx = np.mgrid[:H, :W]
        for b in range(n):
            img[(yy - 30 - 60 * b) ** 2 + (xx - int(rng.integers(30, W - 30))) ** 2 <= 100] = 200
        frames.append(img)
        counts.append(n)
    out = _run(tseg.DeviceTiledSegmentation, frames, t_model_io.load_model(model_dir), cfg, post, device="cpu")
    assert [o[3] for o in out if o[0] == "frame"] == counts
