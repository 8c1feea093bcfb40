"""``maze-ipp loki`` on the sparse haul's inputs: the port's Runner against the
JAX package's, on the CPU.

The sparse haul of the haul driver (``tools/bench_e2e.py:HAULS["sparse"]`` of
the port, after the JAX driver's) plants 0-3 objects a frame, crops drawn
log-uniformly from 16×20 to 48×64 px, on 1024×1280 frames, and segments them
with tiles of 1024 at stride 896, postprocess ``min_area`` 30 and
``closing_radius`` 2. Here the frames and tiles are shrunk with their ratios
kept: 256×320 frames, tiles of 256 at stride 224; the crops, the objects a
frame and the postprocess are the haul's. ``synth.make_loki_tree`` draws the
haul (seed 3 leaves frames with no object at all). Both Runners read the
same saved ``UNet(1, 8, 2)`` in float32 (``chip_smoke.write_unet``, seed 0,
its head scaled so that no logit lies within float noise of the
threshold), as ``tests/test_torch_loki_cli.py`` does.

The archives must be equal (``chip_smoke.compare_archives``: the same
members in the same order, the same TSV rows, integers and text exact,
floats within rtol 1e-5 / atol 1e-3, decoded images and masks equal).
"""

import os

import pytest
import torch

import chip_smoke
from maze_image_processing_pipeline_tpu.loki.pipeline import Runner as JaxRunner
from maze_image_processing_pipeline_tpu_torch.loki.pipeline import Runner as TorchRunner
from maze_image_processing_pipeline_tpu_torch.tools import bench_e2e, synth

ARCHIVE = "LOKI_PS122-1_7.zip"
FRAMES, FRAME_SHAPE, SEED = 8, (256, 320), 3
TILE, STRIDE = 256, 224  # the haul's 1024 / 896, shrunk with the frames


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the parallel test workers share the cores, and
    torch's per-worker thread pools oversubscribe them many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _objects_per_frame(sample: str) -> list:
    """Planted objects by frame time, from the tree's picture names."""
    counts = {}
    for name in os.listdir(os.path.join(sample, "Pictures", "20220103 12")):
        t = name.split()[1]
        counts[t] = counts.get(t, 0) + 1
    telemetry = sorted(os.listdir(os.path.join(sample, "Telemetrie")))
    return [counts.get(fn.split()[1].split(".")[0], 0) for fn in telemetry]


@pytest.fixture(scope="module")
def sparse_haul(tmp_path_factory):
    root = tmp_path_factory.mktemp("sparse")
    _, objects, _, crop_range = bench_e2e.HAULS["sparse"]
    sample = synth.make_loki_tree(str(root / "data"), n_frames=FRAMES, objects_per_frame=objects,
                                  frame_shape=FRAME_SHAPE, seed=SEED, crop_size_range=crop_range)
    unet = chip_smoke.write_unet(str(root / "unet"), chip_smoke.SMALL_UNET, "float32", seed=0, gain=1000.0)
    return root, sample, unet


def _task(data, model_fn, target_dir):
    seg = dict(bench_e2e.LOKI_SEGMENTATION, tile_size=TILE, tile_stride=STRIDE, batch_size=4)
    return {
        "input": {"path": str(data)},
        "segmentation": {"jax": {"model_fn": model_fn, "device": "cpu", "dtype": "float32", **seg}},
        "postprocess": {},
        "output": {"target_dir": str(target_dir), "store_mask": True},
    }


def test_sparse_haul_inputs_have_empty_frames(sparse_haul):
    _, sample, _ = sparse_haul
    per_frame = _objects_per_frame(sample)
    assert len(per_frame) == FRAMES and 0 in per_frame and max(per_frame) <= 3 and sum(per_frame) >= 5


def test_sparse_haul_archive_matches_jax(sparse_haul):
    root, _, unet = sparse_haul
    assert bench_e2e.LOKI_SEGMENTATION["postprocess"] == {"min_area": 30, "closing_radius": 2}
    JaxRunner._configure_and_run(_task(root / "data", unet, root / "jax"))
    TorchRunner._configure_and_run(_task(root / "data", unet, root / "torch"))
    rows = chip_smoke.compare_archives(str(root / "jax" / ARCHIVE), str(root / "torch" / ARCHIVE))
    assert rows >= 3
    assert chip_smoke.check_archive(str(root / "torch" / ARCHIVE)) == (rows, 2 * rows)
