"""Phase 9's distillation batches on the CPU.

* ``synth.vignette_batches``: tiles of stitched LOKI frames (a black canvas,
  ``make_loki_tree``'s vignettes, ellipses on both sides of the threshold)
  with the threshold's targets, the same draws for the same seed.
* A narrow U-Net (``UNet(1, 8, 3)`` float32) distilled by ``fit`` on them
  for phase 9's 200 steps finds in two stitched frames of ``make_loki_tree``
  exactly the objects that the threshold finds
  (``tools/distill_probe.py``'s ``threshold_count``, phase 6's
  postprocess).
"""

import numpy as np
import torch

from maze_image_processing_pipeline_tpu_torch.models.train_loop import fit
from maze_image_processing_pipeline_tpu_torch.models.unet import UNet
from maze_image_processing_pipeline_tpu_torch.tools import distill_probe, synth


def test_vignette_batches_are_stitched_frame_tiles():
    x, y = next(synth.vignette_batches(2, size=128, batch=16, seed=3))
    assert x.shape == (16, 128, 128, 3) and x.dtype == np.float32 and y.shape == (16, 128, 128, 2)
    v = np.rint(x[..., 0] * 255)
    np.testing.assert_array_equal(x[..., 1], x[..., 0])
    np.testing.assert_array_equal(x[..., 2], x[..., 0])
    np.testing.assert_array_equal(y[..., 0], v > 100)
    np.testing.assert_array_equal(y[..., 1], v > 180)
    # Black canvas, vignette noise below 20, ellipses at 30-250.
    assert set(np.unique(v)) <= set(range(20)) | set(range(30, 251))
    assert (v == 0).mean() > 0.3 and all((t > 0).any() for t in v)
    assert ((v >= 30) & (v <= 100)).any() and (v > 180).any()
    again, _ = next(synth.vignette_batches(2, size=128, batch=16, seed=3))
    np.testing.assert_array_equal(again, x)


def test_distilled_unet_finds_the_thresholds_objects(tmp_path):
    data = synth.make_loki_tree(str(tmp_path), n_frames=2, objects_per_frame=20, frame_shape=(1024, 1280), seed=8)
    frames = distill_probe.stitched_frames(data)
    expected = distill_probe.threshold_count(data)
    assert len(frames) == 2 and 30 <= expected <= 40
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 4))
    try:
        module = UNet(out_channels=1, base_features=8, depth=3, dtype="float32")
        fit(module, synth.vignette_batches(1), 200, input_shape=(8, 128, 128, 3), log_interval=1e9, device="cpu")
        module.eval()
        found = 0
        with torch.no_grad():
            for frame in frames:
                # Black padding to a multiple of the U-Net's 2³, as the tiles of phase 6 pad.
                frame = np.pad(frame, [(0, -s % 8) for s in frame.shape])
                x = torch.from_numpy(frame.astype(np.float32) / 255)[None, ..., None].expand(-1, -1, -1, 3)
                found += distill_probe.count_objects(torch.sigmoid(module(x.contiguous()))[0, ..., 0].numpy() > 0.5)
    finally:
        torch.set_num_threads(n)
    assert found == expected
