"""The LOKI segmentation stage of the PyTorch port against the JAX package.

``build_torch_segmentation`` against ``build_jax_segmentation`` on stitched
vignettes, with the threshold oracle model of
``tests/test_torch_device_seg.py`` (its fixture and settings are imported
from there), and with each option that takes the label frames to the host:
segment merging, device crops off, the host blend and the full-frame debug
archive. ROI images and masks equal, metadata floats within rtol 1e-5 /
atol 1e-3. Split from ``tests/test_torch_device_seg.py`` so that the two
halves run on two workers of a parallel run (``pytest -n 6 --dist
loadfile`` puts a whole file on one worker).
"""

import numpy as np
import pytest

from maze_image_processing_pipeline_tpu import engine as j_engine
from maze_image_processing_pipeline_tpu.loki import device_seg as jseg
from maze_image_processing_pipeline_tpu.loki.config_schema import (
    JaxSegmentationConfig,
    SegmentationPostprocessingConfig,
)
from maze_image_processing_pipeline_tpu_torch import engine as t_engine
from maze_image_processing_pipeline_tpu_torch.loki import device_seg as tseg
from test_torch_device_seg import POST, model_dir  # noqa: F401 (model_dir is a fixture)


def _stitched_items():
    """Three frames of three 60×80 vignettes each, pasted 90 px apart."""
    rng = np.random.default_rng(9)
    items = []
    for f in range(3):
        for k in range(3):
            crop = (rng.random((60, 80)) * 40).astype(np.uint8)
            crop[15:45, 20:60] = 200
            meta = {
                "object_frame_id": f"20200101 12000{f}  {f}",
                "object_posy": 20 + 70 * k, "object_posx": 30 + 90 * k,
                "object_date": "20200101", "object_time": f"12000{f}",
                "object_milliseconds": f,
            }
            items.append((crop, meta))
    return items


def _run_stage(engine, build, items, cfg, target_dir, **kw):
    out = []
    with engine.Pipeline() as p:
        img, meta = engine.Unpack(items).unpack(2)
        roi, meta_out, mask = build(cfg, target_dir, img, meta, {}, **kw)
        engine.Call(lambda *a: out.append(a), roi, meta_out, mask)
    p.run()
    return out


def _compare_objects(ref, ours):
    assert len(ours) == len(ref)
    for (r_roi, r_meta, r_mask), (o_roi, o_meta, o_mask) in zip(ref, ours):
        np.testing.assert_array_equal(o_roi, r_roi)
        np.testing.assert_array_equal(o_mask, r_mask)
        assert set(o_meta) == set(r_meta) and o_meta["object_id"] == r_meta["object_id"]
        for k, v in r_meta.items():
            if isinstance(v, float):
                np.testing.assert_allclose(o_meta[k], v, rtol=1e-5, atol=1e-3, err_msg=k)
            else:
                assert o_meta[k] == v, k


def test_build_torch_segmentation_matches_jax(model_dir):
    """The segmentation stage with stitching, against build_jax_segmentation."""
    cfg = JaxSegmentationConfig(
        model_fn=model_dir, dtype="float32", tile_size=128, tile_stride=96, frame_batch=2,
        batch_size=4, padding=5, postprocess=SegmentationPostprocessingConfig(**POST),
    )
    items = _stitched_items()
    ref = _run_stage(j_engine, jseg.build_jax_segmentation, items, cfg, "")
    ours = _run_stage(t_engine, tseg.build_torch_segmentation, items, cfg, "", device="cpu")
    assert len(ref) == 9
    _compare_objects(ref, ours)


# The options that take the label frames to the host: segment merging (the
# vignettes' blobs lie 64 px apart, so 70 merges each frame's three), device
# crops off, the host blend, and the full-frame debug archive (host blend
# too). Each against build_jax_segmentation.
OPTIONS = {
    "merge": (dict(), dict(merge_segments_distance=70)),
    "device_crops_false": (dict(device_crops=False), dict()),
    "device_blend_false": (dict(device_blend=False), dict()),
    "full_frame_archive": (dict(full_frame_archive_fn="frames_{object_date}.zip"), dict(merge_segments_distance=20)),
}


@pytest.mark.parametrize("option", sorted(OPTIONS))
def test_label_frame_options_match_jax(model_dir, tmp_path, option):
    seg_kw, post_kw = OPTIONS[option]
    cfg = JaxSegmentationConfig(
        model_fn=model_dir, dtype="float32", tile_size=128, tile_stride=96, frame_batch=2,
        batch_size=4, padding=5, postprocess=SegmentationPostprocessingConfig(**{**POST, **post_kw}), **seg_kw,
    )
    items = _stitched_items()
    ref = _run_stage(j_engine, jseg.build_jax_segmentation, items, cfg, str(tmp_path / "jax"))
    ours = _run_stage(t_engine, tseg.build_torch_segmentation, items, cfg, str(tmp_path / "torch"), device="cpu")
    assert len(ref) == (3 if option == "merge" else 9)
    _compare_objects(ref, ours)
    if option == "full_frame_archive":
        import chip_smoke

        fn = "frames_20200101.zip"  # a row and three images (input, overlay, score) per frame
        ref_fn, our_fn = str(tmp_path / "jax" / fn), str(tmp_path / "torch" / fn)
        assert chip_smoke.compare_archives(ref_fn, our_fn, one_level=("score/",)) == 3
