"""The port's end-to-end haul driver (``tools/bench_e2e.py`` of the port) on
the CPU, and the synthetic hauls it makes.

* ``synth.make_loki_tree`` against ``tests/fixtures.py:make_loki_sample``
  (the JAX haul driver's inputs) with each haul's options at a small size:
  the same files, text equal, decoded vignettes equal.
* The driver end to end on one frame of 384×512 with narrow models
  (``UNet(1, 4, 1)`` distilled for 40 steps) and small tiles (loki 256,
  semseg 64, polytaxo input 64): the JSON line has ``tools/bench_e2e.py``'s
  keys, the loki stage finds objects, semseg writes its ``.h5``, and cached
  models are reused.
* The driver as ``--device cpu --frames 1 --distill-steps 2 --repeat 1`` at
  full width: about a minute on eight cores, so it is marked ``slow``.
"""

import json
import os

import numpy as np
import pytest
import torch

from fixtures import make_loki_sample
from maze_image_processing_pipeline_tpu_torch.dataio.imageio import decode_image
from maze_image_processing_pipeline_tpu_torch.tools import bench_e2e, synth

KEYS = {"metric", "haul", "frames", "objects", "model_prep_s", "loki_s", "semseg_s", "polytaxo_s",
        "loki_s_steady", "semseg_s_steady", "polytaxo_s_steady", "value_first", "value", "frames_per_sec_loki"}


def _tree(root):
    files = {}
    for d, _, names in os.walk(root):
        for n in names:
            path = os.path.join(d, n)
            with open(path, "rb") as f:
                data = f.read()
            files[os.path.relpath(path, root)] = decode_image(data) if n.endswith(".png") else data
    return files


@pytest.mark.parametrize("haul", ["standard", "dense", "sparse"])
def test_synthetic_haul_matches_the_jax_fixture(tmp_path, haul):
    _, objects, _, crop_range = bench_e2e.HAULS[haul]
    kw = dict(n_frames=3, objects_per_frame=objects if haul != "standard" else 4, frame_shape=(300, 420), seed=0)
    make_loki_sample(str(tmp_path / "jax"), crop_size_range=crop_range, **kw)
    synth.make_loki_tree(str(tmp_path / "torch"), crop_size_range=crop_range, **kw)
    ref, ours = _tree(tmp_path / "jax"), _tree(tmp_path / "torch")
    assert sorted(ours) == sorted(ref) and len(ref) > 5
    for name, r in ref.items():
        np.testing.assert_array_equal(ours[name], r, err_msg=name) if isinstance(r, np.ndarray) \
            else (ours[name] == r or pytest.fail(name))


def test_haul_driver_runs_on_the_cpu(tmp_path, monkeypatch, capsys):
    monkeypatch.setitem(bench_e2e.HAULS, "standard", (1, 6, (384, 512), None))
    monkeypatch.setattr(bench_e2e, "LOKI_UNET", dict(out_channels=1, base_features=4, depth=1))
    monkeypatch.setattr(bench_e2e, "SEMSEG_UNET", dict(out_channels=2, base_features=4, depth=1))
    monkeypatch.setattr(bench_e2e, "CLASSIFIER", dict(n_outputs=8, features=[4, 8]))
    monkeypatch.setattr(bench_e2e, "LOKI_SEGMENTATION", dict(bench_e2e.LOKI_SEGMENTATION, batch_size=4,
                                                             frame_batch=1, tile_size=256, tile_stride=192))
    monkeypatch.setattr(bench_e2e, "SEMSEG_MODEL", dict(batch_size=8, tiling={"size": 64, "stride": 48,
                                                                               "chunk_size": 8}))
    monkeypatch.setattr(bench_e2e, "POLYTAXO_MODEL", dict(batch_size=8, input_size=64))
    argv = ["--device", "cpu", "--distill-steps", "40", "--repeat", "1",
            "--model-dir", str(tmp_path / "models"), "--workdir", str(tmp_path / "work")]
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        result = bench_e2e.main(argv)
        lines = capsys.readouterr().out.strip().splitlines()
        assert lines[-2] == "device=cpu" and json.loads(lines[-1]) == result
        assert set(result) == KEYS and result["metric"] == "e2e_haul_objects_per_sec"
        assert result["frames"] == 1 and result["objects"] > 0
        assert all(np.isfinite(result[k]) and result[k] > 0 for k in KEYS - {"metric", "haul", "frames", "objects"})
        assert sorted(os.listdir(tmp_path / "models")) == ["loki-unet", "polytaxo-cnn", "semseg-unet"]
        for out in ("semseg_out0/LOKI_PS122-1_7.h5", "semseg_out0/LOKI_PS122-1_7.segmentation.zip",
                    "poly_out0/LOKI_PS122-1_7.polytaxo.zip"):
            assert os.path.exists(tmp_path / "work" / out), out
        stamps = {d: os.path.getmtime(tmp_path / "models" / d / "meta.json") for d in os.listdir(tmp_path / "models")}
        bench_e2e.ensure_models(str(tmp_path / "models"), 40, torch.device("cpu"))  # the cached models are reused
        assert stamps == {d: os.path.getmtime(tmp_path / "models" / d / "meta.json") for d in stamps}
    finally:
        torch.set_num_threads(n)


def test_haul_driver_needs_a_card_unless_asked_for_the_cpu(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        bench_e2e.main(["--model-dir", str(tmp_path / "m"), "--workdir", str(tmp_path / "w")])
    assert not os.path.exists(tmp_path / "m")


@pytest.mark.slow
def test_haul_driver_full_width_on_the_cpu(tmp_path, capsys):
    result = bench_e2e.main(["--device", "cpu", "--frames", "1", "--distill-steps", "2", "--repeat", "1",
                             "--model-dir", str(tmp_path / "models"), "--workdir", str(tmp_path / "work")])
    assert set(result) == KEYS and result["objects"] > 0
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == result


def test_loki_unet_distils_on_vignette_tiles_and_semseg_batches_stay(tmp_path, monkeypatch):
    """``ensure_models`` distils the loki U-Net on ``synth.vignette_batches``
    and the semseg U-Net on the batches it had before: ``distill_batches``
    of one generator (seed 0) after ``distill_steps`` loki batches of
    ``tools/bench_e2e.py``."""
    from maze_image_processing_pipeline_tpu_torch.models import train_loop

    seen = {}

    def record(module, batches, n_steps, **kw):
        seen[module.out_channels] = [next(batches) for _ in range(2)]

    monkeypatch.setattr(train_loop, "fit", record)
    monkeypatch.setattr(bench_e2e, "LOKI_UNET", dict(out_channels=1, base_features=4, depth=1))
    monkeypatch.setattr(bench_e2e, "SEMSEG_UNET", dict(out_channels=2, base_features=4, depth=1))
    monkeypatch.setattr(bench_e2e, "CLASSIFIER", dict(n_outputs=8, features=[4, 8]))
    bench_e2e.ensure_models(str(tmp_path / "m"), 3, torch.device("cpu"))
    assert sorted(seen) == [1, 2]
    vignettes = synth.vignette_batches(1)
    for got in seen[1]:
        for g, w in zip(got, next(vignettes)):
            np.testing.assert_array_equal(g, w)
    rng = np.random.default_rng(0)
    old_loki = synth.distill_batches(1, rng=rng)
    for _ in range(3):
        next(old_loki)
    semseg = synth.distill_batches(2, rng=rng)
    for got in seen[2]:
        for g, w in zip(got, next(semseg)):
            np.testing.assert_array_equal(g, w)
    assert float(seen[1][0][0].min()) == 0.0  # the black canvas of stitched frames
