"""The A/B wall script (``tools/ab_walls.py`` of the port) on the CPU: its
worker runs the loki task in a process of its own that imports the named
checkout's package; the script itself takes walls on the card only."""

import os

import pytest
import torch

from maze_image_processing_pipeline_tpu_torch.tools import ab_walls
from maze_image_processing_pipeline_tpu_torch.tools.synth import make_loki_tree, write_unet

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_worker_runs_the_checkouts_loki_task(tmp_path, monkeypatch):
    data = make_loki_tree(str(tmp_path / "data"), n_frames=2, objects_per_frame=3, frame_shape=(256, 320), seed=8)
    unet = write_unet(str(tmp_path / "unet"), dict(out_channels=1, base_features=8, depth=2), "float32", seed=0,
                      gain=1000.0)
    monkeypatch.setattr(ab_walls, "LOKI_SEGMENTATION", dict(ab_walls.LOKI_SEGMENTATION, device="cpu", batch_size=4,
                                                            frame_batch=1, tile_size=256, tile_stride=192))
    walls = ab_walls.run_tree(REPO, data, unet, str(tmp_path / "out"))
    assert len(walls) == ab_walls.WALLS and all(w > 0 for w in walls)
    assert sorted(os.listdir(tmp_path / "out")) == sorted([str(i) for i in range(ab_walls.WALLS)] + ["warm"])
    assert os.path.exists(tmp_path / "out" / "0" / "LOKI_PS122-1_7.zip")


def test_worker_failure_names_the_checkout(tmp_path):
    with pytest.raises(RuntimeError, match="rc 1"):
        ab_walls.run_tree(str(tmp_path), str(tmp_path / "no-data"), str(tmp_path / "no-unet"), str(tmp_path / "o"))


def test_walls_need_a_card(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        ab_walls.main([REPO, "--workdir", str(tmp_path / "w")])
    assert not os.path.exists(tmp_path / "w")
