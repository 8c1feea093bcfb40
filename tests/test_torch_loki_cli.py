"""``maze-ipp loki`` of the PyTorch port against the JAX package, on the CPU.

The same task file goes through the JAX ``Runner._configure_and_run`` and the
port's, on a synthetic LOKI haul (``fixtures.make_loki_sample``: 3 frames of
180×230, 2 objects each; stitching on, closing radius 2, opening radius 1,
min_area 20, max_regions 16, padding 10, masks stored). Two models:

* the threshold oracle of ``test_loki_jax_segmentation.py`` (a 1×1 conv,
  sigmoid(500·(x − 60/255))), with a torch counterpart registered in the
  port's architecture table;
* ``UNet(1, 8, 2)`` in float32 with seeded random weights, written by the
  port's ``save_model`` (so the JAX package reads the port's checkpoint), its
  head scaled so that no logit lies within float noise of the threshold.

The archives must be equal (``chip_smoke.compare_archives``): the same
members in the same order, the same TSV columns and rows, integer and text
columns exact, floats within rtol 1e-5 / atol 1e-3 (the port sums moments in
float64), decoded images and masks equal. The columns that name the run
(``process_pipeline``, ``process_datetime``, ``process_id``) are left out. The PNG encoder is ``mazecore.cpp``
on both sides (the port builds its own copy of the JAX package's source).
"""

import os
import subprocess
import sys

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from fixtures import make_loki_sample
from maze_image_processing_pipeline_tpu.loki.pipeline import Runner as JaxRunner
from maze_image_processing_pipeline_tpu.models import model_io as j_model_io
from maze_image_processing_pipeline_tpu.models.unet import UNet as JaxUNet
from maze_image_processing_pipeline_tpu_torch.loki.pipeline import Runner as TorchRunner
from maze_image_processing_pipeline_tpu_torch.models import model_io as t_model_io
from maze_image_processing_pipeline_tpu_torch.models.unet import UNet as TorchUNet

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCH = "threshold_net_cli"
ARCHIVE = "LOKI_PS122-1_7.zip"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the parallel test workers share the cores, and
    torch's per-worker thread pools oversubscribe them many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


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
        self.threshold, self.scale = threshold, scale
        self.w = torch.nn.Parameter(torch.full((1, 1, 3, 1), scale / 3))
        self.b = torch.nn.Parameter(torch.full((1,), -scale * threshold))

    def forward(self, x):
        return torch.einsum("bhwc,co->bhwo", x.float(), self.w[0, 0]) + self.b


@pytest.fixture(scope="module")
def haul(tmp_path_factory):
    root = tmp_path_factory.mktemp("haul")
    make_loki_sample(str(root / "data"), n_frames=3, objects_per_frame=2, frame_shape=(180, 230))
    return root


@pytest.fixture(scope="module")
def models(haul):
    j_model_io._ARCHITECTURES[ARCH] = ThresholdNet
    t_model_io._ARCHITECTURES[ARCH] = TorchThresholdNet
    thr = str(haul / "thrnet")
    module = ThresholdNet()
    j_model_io.save_model(thr, module, module.init(jax.random.key(0), jnp.zeros((1, 8, 8, 3))))
    unet = chip_smoke.write_unet(str(haul / "unet"), chip_smoke.SMALL_UNET, "float32", seed=0, gain=1000.0)
    return {"threshold_net": thr, "unet": unet}


def _task(data, model_fn, target_dir):
    return {
        "input": {"path": str(data)},
        "segmentation": {
            "jax": {
                "model_fn": model_fn,
                "device": "cpu",
                "dtype": "float32",
                "batch_size": 4,
                "tile_size": 128,
                "tile_stride": 96,
                "stitch": True,
                "postprocess": {
                    "closing_radius": 2,
                    "opening_radius": 1,
                    "min_area": 20,
                    "clear_border": False,
                    "max_regions": 16,
                },
                "padding": 10,
            }
        },
        "postprocess": {},
        "output": {"target_dir": str(target_dir), "store_mask": True},
    }


@pytest.mark.parametrize("model", ["threshold_net", "unet"])
def test_loki_archive_matches_jax(haul, models, model):
    ref_dir, our_dir = haul / f"jax_{model}", haul / f"torch_{model}"
    JaxRunner._configure_and_run(_task(haul / "data", models[model], ref_dir))
    TorchRunner._configure_and_run(_task(haul / "data", models[model], our_dir))
    rows = chip_smoke.compare_archives(str(ref_dir / ARCHIVE), str(our_dir / ARCHIVE))
    assert rows >= 5
    assert chip_smoke.check_archive(str(our_dir / ARCHIVE)) == (rows, 2 * rows)


def test_loki_host_blend_merge_full_frame_matches_jax(haul, models):
    """The host blend (tiles → inference → blend on the host →
    DeviceFramePostprocess), segment merging and the full-frame debug
    archive in one task: both archives equal the JAX Runner's, the debug
    archive's score images (probabilities ×255, truncated) within one grey
    level."""
    tasks = {}
    for name in ("jax_host_blend", "torch_host_blend"):
        task = _task(haul / "data", models["unet"], haul / name)
        seg = task["segmentation"]["jax"]
        seg.update(device_blend=False, full_frame_archive_fn="full_frames.zip")
        seg["postprocess"]["merge_segments_distance"] = 20
        tasks[name] = task
    JaxRunner._configure_and_run(tasks["jax_host_blend"])
    TorchRunner._configure_and_run(tasks["torch_host_blend"])
    ref, ours = haul / "jax_host_blend", haul / "torch_host_blend"
    assert chip_smoke.compare_archives(str(ref / ARCHIVE), str(ours / ARCHIVE)) >= 4
    frames = chip_smoke.compare_archives(str(ref / "full_frames.zip"), str(ours / "full_frames.zip"), one_level=("score/",))
    assert frames == 3


def test_cli_runs_loki_and_prints_the_config(haul, models, tmp_path):
    import yaml

    task_fn = tmp_path / "task.yaml"
    task_fn.write_text(yaml.safe_dump(_task(haul / "data", models["unet"], tmp_path / "out")))
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""), OMP_NUM_THREADS="1")
    cli = [sys.executable, "-m", "maze_image_processing_pipeline_tpu_torch.cli"]
    res = subprocess.run(cli + ["loki", str(task_fn)], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    assert chip_smoke.check_archive(str(tmp_path / "out" / ARCHIVE))[0] >= 5
    res = subprocess.run(cli + ["config", "loki"], env=env, capture_output=True, text=True, timeout=120)
    assert res.returncode == 0 and "segmentation:" in res.stdout and "pytorch:" in res.stdout
    res = subprocess.run(cli + ["config", "predict"], env=env, capture_output=True, text=True, timeout=120)
    assert res.returncode == 0 and "polytaxo:" in res.stdout and "tiling:" in res.stdout


def test_save_model_round_trips_with_jax(tmp_path):
    cfg = dict(out_channels=1, base_features=8, depth=2)
    # JAX writes, the port reads, the port writes the same bytes back.
    j_module = JaxUNet(**cfg, dtype=jnp.float32)
    params = j_module.init(jax.random.key(3), jnp.zeros((1, 32, 32, 3)))
    j_model_io.save_model(str(tmp_path / "jax"), j_module, params)
    loaded = t_model_io.load_model(str(tmp_path / "jax"))
    t_model_io.save_model(str(tmp_path / "torch"), loaded.module)
    assert (tmp_path / "torch" / "params.msgpack").read_bytes() == (tmp_path / "jax" / "params.msgpack").read_bytes()
    # The port writes, JAX reads: the same parameters and the same outputs.
    t_module = TorchUNet(**cfg, dtype="float32")
    t_module.load_state_dict(t_model_io.params_from_jax(t_model_io.init_unet_params(cfg, seed=5)))
    t_model_io.save_model(str(tmp_path / "port"), t_module, outputs={"pred": {"channel_names": ["fg"]}})
    j_loaded = j_model_io.load_model(str(tmp_path / "port"))
    assert j_loaded.meta["outputs"] == {"pred": {"channel_names": ["fg"]}}
    x = np.random.default_rng(0).random((1, 32, 32, 3), dtype=np.float32)
    with torch.no_grad():
        ours = t_module(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(np.asarray(j_loaded(jnp.asarray(x))), ours, rtol=1e-4, atol=1e-4)
