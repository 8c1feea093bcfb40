"""The port stands alone: no JAX, no JAX package, nothing the card lacks.

* An AST check over every ``.py`` file of the port and ``chip_smoke.py``:
  no ``import`` or ``from`` of ``maze_image_processing_pipeline_tpu`` or its
  submodules (the ``_torch`` package is the port itself).
* A subprocess blocks what the card's machine does not have (``jax``,
  ``jaxlib``, ``flax``, ``optax``, ``orbax``, ``h5py``) and the JAX package itself
  (``sys.modules[name] = None`` makes any import of them fail), imports
  every module of the port and ``chip_smoke``, runs one frame group of the
  segmentation slice on the CPU through the same code as ``chip_smoke.py``'s
  phase 5, runs the port's ``loki`` Runner on a tiny LOKI haul built by
  ``chip_smoke.make_loki_tree``, as its phases 6 and 8 do (U-Net, the
  host-blend task with merging and the full-frame archive, threshold
  segmentation), its ``predict`` Runner as phase 7 does, and ``fit`` with
  checkpoints on ``chip_smoke.vignette_batches`` as phase 9 does, at a small
  size, and its ``.h5`` export (``save_raw_h5: true``, the port's own
  writer) with h5py blocked. ``optax`` and ``orbax`` are blocked too: the
  port's training carries JAX states and checkpoints without them.
"""

import ast
import os
import subprocess
import sys
from pathlib import Path

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_PACKAGE = "maze_image_processing_pipeline_tpu"
PORT = JAX_PACKAGE + "_torch"

BLOCKED = ["jax", "jaxlib", "flax", "optax", "orbax", "h5py", JAX_PACKAGE]

SCRIPT = r"""
import sys
BLOCKED = {blocked!r}
for name in BLOCKED:
    sys.modules[name] = None

import importlib
import os
import pkgutil
import tempfile
import types

import maze_image_processing_pipeline_tpu_torch as pkg

names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
assert "maze_image_processing_pipeline_tpu_torch.loki.pipeline" in names

import numpy as np
import torch

import chip_smoke as cs
from maze_image_processing_pipeline_tpu_torch.models.model_io import (
    LoadedModel, init_unet_params, params_from_jax,
)
from maze_image_processing_pipeline_tpu_torch.models.unet import UNet

cfg = dict(out_channels=1, base_features=8, depth=2)
module = UNet(**cfg, dtype="float32")
module.load_state_dict(params_from_jax(init_unet_params(cfg, seed=0)))
seg = types.SimpleNamespace(**{{**vars(cs.SEGMENTATION), "tile_size": 128, "tile_stride": 96,
                              "batch_size": 4, "frame_batch": 2, "padding": 8}})
frames = cs.make_frames(2, 160, 200, 3, seed=1)
per_frame, objects = cs.run_slice(torch.device("cpu"), frames, LoadedModel(module, {{}}), seg_cfg=seg)
n = cs.check_objects(frames, per_frame, objects)
print("frames", len(per_frame), "objects", n)

work = tempfile.mkdtemp()
data = os.path.join(work, "data")
cs.make_loki_tree(data, n_frames=2, objects_per_frame=3, frame_shape=(180, 230), seed=2)
unet = cs.write_unet(os.path.join(work, "unet"), cs.SMALL_UNET, "float32", seed=0, gain=1000.0)
task = cs.loki_task(data, unet, os.path.join(work, "out"), device="cpu", dtype="float32",
                    tile_size=128, tile_stride=96, batch_size=4, frame_batch=2)
cs.run_loki(task)
rows, members = cs.check_archive(os.path.join(work, "out", "LOKI_PS122-1_7.zip"))
print("archive rows", rows)

cs.run_loki(cs.threshold_task(data, os.path.join(work, "thr"), device="cpu"))
rows, members = cs.check_archive(os.path.join(work, "thr", "LOKI_PS122-1_7.zip"))
print("threshold rows", rows)
task = cs.loki_task(data, unet, os.path.join(work, "hb"), device="cpu", dtype="float32", tile_size=128,
                    tile_stride=96, batch_size=4, frame_batch=2, device_blend=False,
                    full_frame_archive_fn="frames.zip",
                    postprocess={{**cs.LOKI_POSTPROCESS, "merge_segments_distance": 20}})
cs.run_loki(task)
print("full frames", cs.compare_archives(*[os.path.join(work, "hb", "frames.zip")] * 2))

from maze_image_processing_pipeline_tpu_torch.predict.pipeline import Runner as PredictRunner
crops = cs.make_crop_archive(os.path.join(work, "crops", "crops.zip"), [(40, 50), (70, 90)], seed=3)
unet2 = cs.write_unet(os.path.join(work, "unet2"), cs.SMALL_SEMSEG_UNET, "float32", seed=0, gain=1000.0,
                      channel_names=cs.CHANNELS)
clf = cs.write_classifier(os.path.join(work, "clf"), cs.SMALL_CLASSIFIER, "float32", seed=0)
PredictRunner._configure_and_run(cs.semseg_task(crops, unet2, os.path.join(work, "semseg"), device="cpu",
                                                dtype="float32", batch_size=2, tiling={{"size": 64, "stride": 48}}))
PredictRunner._configure_and_run(cs.polytaxo_task(crops, clf, os.path.join(work, "poly"),
                                                  cs.make_taxonomy_files(os.path.join(work, "tax")),
                                                  device="cpu", dtype="float32", batch_size=2, input_size=64))
n = cs.compare_archives(*[os.path.join(work, "semseg", "crops.segmentation.zip")] * 2)
m = cs.compare_archives(*[os.path.join(work, "poly", "crops.polytaxo.zip")] * 2)
print("predict rows", n, m)
task = cs.semseg_task(crops, unet2, os.path.join(work, "h5"), device="cpu", dtype="float32", batch_size=2,
                      tiling={{"size": 64, "stride": 48}})
PredictRunner._configure_and_run({{**task, "save_raw_h5": True, "raw_h5_dtype": "uint8"}})
with open(os.path.join(work, "h5", "crops.h5"), "rb") as f:
    head = f.read(8)
print("h5 written", head == b"\x89HDF\r\n\x1a\n")

from maze_image_processing_pipeline_tpu_torch.models import fit, save_model
module = UNet(out_channels=1, base_features=4, depth=1, dtype="float32")
batches = ((x[:, :32, :32], y[:, :32, :32]) for x, y in cs.vignette_batches(1, size=32, batch=2))
state = fit(module, batches, 2, input_shape=(2, 32, 32, 3), checkpoint_dir=os.path.join(work, "ckpt"),
            checkpoint_every=1, log_interval=1e9, device="cpu")
save_model(os.path.join(work, "trained"), module, outputs={{"pred": {{"channel_names": ["foreground"]}}}})
leaked = [m for m in BLOCKED if sys.modules.get(m) is not None]
assert not leaked, leaked
print("trained steps", state.step)
"""


def _port_files():
    return sorted(Path(REPO, PORT).rglob("*.py")) + [Path(REPO, "chip_smoke.py")]


def _imports_jax_package(node) -> bool:
    if isinstance(node, ast.Import):
        names = [a.name for a in node.names]
    elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
        names = [node.module]
    else:
        return False
    return any(n == JAX_PACKAGE or n.startswith(JAX_PACKAGE + ".") for n in names)


def test_port_source_imports_nothing_of_the_jax_package():
    files = _port_files()
    assert len(files) > 30
    offenders = [
        f"{path.relative_to(REPO)}:{node.lineno}"
        for path in files
        for node in ast.walk(ast.parse(path.read_text(), str(path)))
        if _imports_jax_package(node)
    ]
    assert not offenders, offenders


def test_port_runs_without_the_packages_the_card_lacks():
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    res = subprocess.run(
        [sys.executable, "-c", SCRIPT.format(blocked=BLOCKED)],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300,
    )
    assert res.returncode == 0, res.stdout + res.stderr
    assert "frames 2" in res.stdout
    assert "archive rows" in res.stdout
    assert "threshold rows 6" in res.stdout
    assert "full frames 2" in res.stdout
    assert "predict rows 2 2" in res.stdout
    assert "h5 written True" in res.stdout
    assert "trained steps 2" in res.stdout
