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
    monkeypatch.setenv("OMP_NUM_THREADS", "1")  # the worker's intra-op threads: the test workers share the cores
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


def test_relabel_mode_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        ab_walls.main([REPO, "--relabel"])


@pytest.mark.parametrize("mode", ["--anchor", "--fixpoint"])
def test_anchor_and_fixpoint_modes_need_a_card(monkeypatch, mode):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        ab_walls.main([REPO, mode])
    assert ab_walls.ANCHOR_SHAPES == ((8, 1024, 1024), (8, 2048, 2560))
    assert "anchor" in ab_walls._ANCHOR_WORKER and "transpose(1, 2)" in ab_walls._ANCHOR_WORKER


def test_region_mode_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        ab_walls.main([REPO, "--region"])
    assert ab_walls.REGION_CASES == (((8, 1024, 1280), 64), ((256, 64, 128), 2))
    assert "region_props_partials_plain" in ab_walls._REGION_WORKER


def test_l2_cold_inputs_exceed_twice_the_l2():
    """--relabel's clock: the copies it rotates over hold distinct storage
    and together exceed twice the L2, and each call takes the next one."""
    import chip_smoke

    lab = torch.zeros((2, 1024, 1280), dtype=torch.int32)
    copies = chip_smoke.l2_cold_inputs(lab)
    assert len(copies) * lab.numel() * 4 >= 2 * chip_smoke.L2_BYTES > (len(copies) - 1) * lab.numel() * 4
    assert len({c[0].data_ptr() for c in copies}) == len(copies) and all(torch.equal(c[0], lab) for c in copies)
    seen = []
    call = chip_smoke._caller(lambda x: seen.append(x.data_ptr()), copies)
    for i in range(len(copies) + 1):
        call(i)
    assert seen == [c[0].data_ptr() for c in copies] + [copies[0][0].data_ptr()]
