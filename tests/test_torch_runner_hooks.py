"""The environment hooks of the port's Runner (``runner.py``), on the CPU.

* ``MAZE_IPP_PROFILE_DIR``: ``PipelineRunner.run`` on a task file writes a
  Chrome trace into the directory (relative to where it was called), one
  that ``json`` reads and that holds events; nothing is written without it.
* ``MAZE_IPP_PLATFORM``: ``cpu`` runs a ``device: tpu`` loki task (the JAX
  package's task file, which the port reads as the card) on the CPU, with
  the archive of the same task with ``device: cpu``; it also points the
  threshold measurement and predict's model at the CPU; ``cuda`` asks for
  the card by name (so without one it raises); any other value raises and
  names the accepted ones.
"""

import json
import logging
import os
import sys

import pytest
import torch
import yaml

import chip_smoke
from fixtures import make_loki_sample
from maze_image_processing_pipeline_tpu_torch.loki.config_schema import SegmentationPipelineConfig
from maze_image_processing_pipeline_tpu_torch.loki.pipeline import Runner
from maze_image_processing_pipeline_tpu_torch.predict.config_schema import PredictionPipelineConfig
from maze_image_processing_pipeline_tpu_torch.runner import PLATFORMS, apply_platform

ARCHIVE = "LOKI_PS122-1_7.zip"


@pytest.fixture(scope="module")
def haul(tmp_path_factory):
    root = tmp_path_factory.mktemp("haul")
    make_loki_sample(str(root / "data"), n_frames=2, objects_per_frame=2, frame_shape=(180, 230))
    chip_smoke.write_unet(str(root / "unet"), chip_smoke.SMALL_UNET, "float32", seed=0, gain=1000.0)
    return root


def _task(haul, target, device):
    return {
        "input": {"path": str(haul / "data")},
        "segmentation": {
            "jax": {
                "model_fn": str(haul / "unet"),
                "device": device,
                "dtype": "float32",
                "batch_size": 4,
                "tile_size": 128,
                "tile_stride": 96,
                "postprocess": {"closing_radius": 2, "min_area": 20, "max_regions": 16},
            }
        },
        "postprocess": {},
        "output": {"target_dir": str(target)},
    }


@pytest.fixture
def runner_state():
    """``PipelineRunner.run`` adds handlers to the root logger, sets
    ``sys.excepthook`` and changes directory: put them back."""
    root = logging.getLogger()
    handlers, level, hook, cwd = list(root.handlers), root.level, sys.excepthook, os.getcwd()
    yield
    for h in root.handlers[:]:
        if h not in handlers:
            root.removeHandler(h)
            h.close()
    root.setLevel(level)
    sys.excepthook = hook
    os.chdir(cwd)


def test_profile_dir_writes_a_chrome_trace(haul, tmp_path, monkeypatch, runner_state):
    task_fn = tmp_path / "task" / "loki.yaml"
    task_fn.parent.mkdir()
    task_fn.write_text(yaml.safe_dump(_task(haul, tmp_path / "out", "cpu")))
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("MAZE_IPP_PROFILE_DIR", "prof")
    Runner.run(str(task_fn))
    traces = sorted((tmp_path / "prof").glob("loki-*.pt.trace.json"))
    assert len(traces) == 1
    events = json.loads(traces[0].read_text())["traceEvents"]
    assert len(events) > 0 and any(e.get("ph") == "X" for e in events)
    assert (tmp_path / "out" / ARCHIVE).exists()

    monkeypatch.delenv("MAZE_IPP_PROFILE_DIR")
    os.chdir(tmp_path)
    task_fn.write_text(yaml.safe_dump(_task(haul, tmp_path / "out2", "cpu")))
    Runner.run(str(task_fn))
    assert sorted((tmp_path / "prof").glob("*.json")) == traces


def test_platform_cpu_runs_a_tpu_task_on_the_cpu(haul, tmp_path, monkeypatch):
    Runner._configure_and_run(_task(haul, tmp_path / "cpu", "cpu"))
    monkeypatch.setenv("MAZE_IPP_PLATFORM", "cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)  # a card would not be used either
    Runner._configure_and_run(_task(haul, tmp_path / "tpu", "tpu"))
    n = chip_smoke.compare_archives(str(tmp_path / "cpu" / ARCHIVE), str(tmp_path / "tpu" / ARCHIVE))
    assert n > 0


def test_platform_points_every_device_field(monkeypatch):
    loki = SegmentationPipelineConfig.model_validate({
        "input": {"path": "x"}, "segmentation": {"threshold": {"threshold_brighter": 50}}, "postprocess": {},
        "output": {"target_dir": "y"}, "parallel": True,
    })
    predict = PredictionPipelineConfig.model_validate({
        "input": {"path": "x"}, "model": {"model_fn": "m", "device": "tpu"}, "target_dir": "y",
    })
    host = SegmentationPipelineConfig.model_validate({
        "input": {"path": "x"}, "segmentation": {"threshold": {"threshold_brighter": 50, "device": False}},
        "postprocess": {}, "output": {"target_dir": "y"},
    })
    assert apply_platform(loki) is loki and loki.segmentation.threshold.device == "auto"  # unset: untouched
    monkeypatch.setenv("MAZE_IPP_PLATFORM", "CPU")
    assert apply_platform(loki).segmentation.threshold.device == "cpu"
    assert apply_platform(predict).model.device == "cpu"
    assert apply_platform(host).segmentation.threshold.device is False  # the host path stays
    for value in ("cuda", "gpu"):
        monkeypatch.setenv("MAZE_IPP_PLATFORM", value)
        assert apply_platform(predict).model.device == "cuda"
    assert sorted(PLATFORMS) == ["cpu", "cuda", "gpu"]


def test_platform_cuda_asks_for_the_card_and_others_raise(haul, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setenv("MAZE_IPP_PLATFORM", "cuda")
    with pytest.raises(RuntimeError, match="no CUDA card"):
        Runner._configure_and_run(_task(haul, tmp_path / "a", "cpu"))
    monkeypatch.setenv("MAZE_IPP_PLATFORM", "tpu")
    with pytest.raises(ValueError, match="MAZE_IPP_PLATFORM='tpu': accepted values are 'cpu', 'cuda', 'gpu'"):
        Runner._configure_and_run(_task(haul, tmp_path / "b", "cpu"))
