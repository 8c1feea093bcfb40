"""The port runs without the packages that the CUDA machines do not have.

A subprocess blocks jax, flax, pandas, pydantic, yaml, cv2, PIL, h5py and
msgpack (``sys.modules[name] = None`` makes any import of them fail), imports
every module of the port and ``chip_smoke``, and runs one frame group of the
segmentation slice on the CPU through the same code as ``chip_smoke.py``'s
end-to-end phase, at a small size.
"""

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

BLOCKED = ["jax", "jaxlib", "flax", "pandas", "pydantic", "yaml", "cv2", "PIL", "h5py", "msgpack"]

SCRIPT = r"""
import sys
BLOCKED = {blocked!r}
for name in BLOCKED:
    sys.modules[name] = None

import importlib
import pkgutil
import types

import maze_image_processing_pipeline_tpu_torch as pkg

names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
assert "maze_image_processing_pipeline_tpu_torch.loki.device_seg" in names

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
leaked = [m for m in BLOCKED if sys.modules.get(m) is not None]
assert not leaked, leaked
print("frames", len(per_frame), "objects", n)
"""


def test_port_runs_without_the_packages_the_card_lacks():
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    res = subprocess.run(
        [sys.executable, "-c", SCRIPT.format(blocked=BLOCKED)],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300,
    )
    assert res.returncode == 0, res.stdout + res.stderr
    assert "frames 2" in res.stdout
