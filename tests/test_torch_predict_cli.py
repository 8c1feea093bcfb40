"""``maze-ipp predict`` of the PyTorch port against the JAX package, on the CPU.

The same task goes through the JAX ``Runner._configure_and_run`` and the
port's (``model.device: cpu``), on an archive of blob crops written by the
port's ``EcotaxaWriter``:

* semseg: ``UNet(2, 4, 1)`` float32 with seeded random weights, written by the
  port's ``save_model`` with its head scaled (no probability within float
  noise of 0.5), tiles 64 / stride 48, ``fill_holes``; the device blend
  with fused measurement, the host blend with the re-uploading
  ``BatchedSegmentMeasure``, and the host blend with host measurement and
  drawn overlays;
* polytaxo: ``ConvClassifier(4, (4, 8))`` float32 and the taxonomy of
  ``tests/test_predict_pipeline.py``, on crops with and without validated
  annotations.

The archives must be equal (``chip_smoke.compare_archives``): the same
members, columns and rows; text and integers exact, floats within rtol 1e-5
/ atol 1e-3; decoded images equal. The CLI runs ``predict``, ``semseg``,
``polytaxo`` and ``config predict``; ``save_raw_h5: true`` raises.
"""

import logging
import sys

import numpy as np
import pytest
import torch
import yaml
from click.testing import CliRunner

import chip_smoke
from maze_image_processing_pipeline_tpu.predict.pipeline import Runner as JaxRunner
from maze_image_processing_pipeline_tpu_torch.cli import cli
from maze_image_processing_pipeline_tpu_torch.predict.pipeline import Runner as TorchRunner
from test_predict_pipeline import TAXONOMY_YAML


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the parallel test workers share the cores, and
    torch's per-worker thread pools oversubscribe them many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

SIZES = [(64, 64), (100, 90), (40, 56), (90, 120), (170, 170), (150, 200), (64, 64)]
SEGMENTATION = "crops.segmentation.zip"
POLYTAXO = "crops.polytaxo.zip"


@pytest.fixture(scope="module")
def work(tmp_path_factory):
    root = tmp_path_factory.mktemp("predict")
    return {
        "root": root,
        "archive": chip_smoke.make_crop_archive(str(root / "in" / "crops.zip"), SIZES, seed=0),
        "annotated": chip_smoke.make_crop_archive(str(root / "in_ann" / "crops.zip"), SIZES[:4], seed=1,
                                                  with_annotations=True),
        "unet": chip_smoke.write_unet(str(root / "unet"), chip_smoke.SMALL_SEMSEG_UNET, "float32", seed=0,
                                      gain=1000.0, channel_names=chip_smoke.CHANNELS),
        "clf": chip_smoke.write_classifier(str(root / "clf"), chip_smoke.SMALL_CLASSIFIER, "float32", seed=0),
        "taxonomy": chip_smoke.make_taxonomy_files(str(root / "tax")),
    }


def _semseg(work, target, **kw):
    return chip_smoke.semseg_task(work["archive"], work["unet"], str(target), device="cpu", dtype="float32",
                                  batch_size=2, tiling={"size": 64, "stride": 48, **kw.pop("tiling", {})}, **kw)


SEMSEG_VARIANTS = {
    "fused": {},
    "batched_measure": dict(tiling={"device_blend": False}, segmentation={"device": True}),
    "host_draw": dict(tiling={"device_blend": False}, segmentation={"draw": True}),
}


@pytest.mark.parametrize("variant", list(SEMSEG_VARIANTS))
def test_semseg_archive_matches_jax(work, variant):
    ref, ours = work["root"] / f"jax_{variant}", work["root"] / f"torch_{variant}"
    JaxRunner._configure_and_run(_semseg(work, ref, **SEMSEG_VARIANTS[variant]))
    TorchRunner._configure_and_run(_semseg(work, ours, **SEMSEG_VARIANTS[variant]))
    rows = chip_smoke.compare_archives(str(ref / SEGMENTATION), str(ours / SEGMENTATION))
    assert rows == len(SIZES)
    df = chip_smoke._read_archive_tsv(__import__("zipfile").ZipFile(ours / SEGMENTATION))
    assert (df["object_prosoma_area"] > 0).any()  # the model finds segments


@pytest.mark.parametrize("archive", ["archive", "annotated"])
def test_polytaxo_archive_matches_jax(work, archive):
    assert chip_smoke.TAXONOMY_YAML == TAXONOMY_YAML
    ref, ours = work["root"] / f"jax_poly_{archive}", work["root"] / f"torch_poly_{archive}"
    for runner, target in ((JaxRunner, ref), (TorchRunner, ours)):
        runner._configure_and_run(chip_smoke.polytaxo_task(
            work[archive], work["clf"], str(target), work["taxonomy"], device="cpu", dtype="float32",
            batch_size=3, input_size=64, polytaxo={"save_raw_descriptions": True}))
    rows = chip_smoke.compare_archives(str(ref / POLYTAXO), str(ours / POLYTAXO))
    assert rows > 0


@pytest.fixture
def restore_runner_state(monkeypatch):
    """``PipelineRunner.run`` changes the directory and adds log handlers."""
    root = logging.getLogger()
    handlers = list(root.handlers)
    monkeypatch.setattr(sys, "excepthook", sys.excepthook)
    yield
    for h in root.handlers[len(handlers):]:
        root.removeHandler(h)
        h.close()


def test_cli_runs_predict_semseg_polytaxo(work, tmp_path, monkeypatch, restore_runner_state):
    monkeypatch.chdir(tmp_path)
    runner = CliRunner()
    tasks = {
        "predict": _semseg(work, tmp_path / "predict"),
        "semseg": _semseg(work, tmp_path / "semseg"),
        "polytaxo": chip_smoke.polytaxo_task(work["archive"], work["clf"], str(tmp_path / "polytaxo"),
                                             work["taxonomy"], device="cpu", dtype="float32", batch_size=2,
                                             input_size=64),
    }
    for command, task in tasks.items():
        task_fn = tmp_path / f"{command}.yaml"
        task_fn.write_text(yaml.safe_dump(task))
        res = runner.invoke(cli, [command, str(task_fn)])
        assert res.exit_code == 0, res.output
        monkeypatch.chdir(tmp_path)
    ref = work["root"] / "torch_fused" / SEGMENTATION
    if ref.exists():
        chip_smoke.compare_archives(str(ref), str(tmp_path / "semseg" / SEGMENTATION))
    chip_smoke.compare_archives(str(tmp_path / "predict" / SEGMENTATION), str(tmp_path / "semseg" / SEGMENTATION))
    assert chip_smoke.compare_archives(str(tmp_path / "polytaxo" / POLYTAXO), str(tmp_path / "polytaxo" / POLYTAXO)) == len(SIZES)
    res = runner.invoke(cli, ["config", "predict"])
    assert res.exit_code == 0 and "polytaxo:" in res.output and "tiling:" in res.output


def test_save_raw_h5_raises(work, tmp_path):
    task = _semseg(work, tmp_path / "out")
    task["save_raw_h5"] = True
    with pytest.raises(NotImplementedError, match="ROADMAP A3b"):
        TorchRunner._configure_and_run(task)


def test_predict_runner_raises_without_a_card(work, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    task = _semseg(work, tmp_path / "out")
    del task["model"]["device"]
    with pytest.raises(RuntimeError, match="no CUDA card"):
        TorchRunner._configure_and_run(task)
    np.testing.assert_equal(sorted(p.name for p in (tmp_path / "out").iterdir()), [])
