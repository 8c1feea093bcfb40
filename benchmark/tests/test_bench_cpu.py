"""Whole runs of test-only cells on the CPU: the reference agrees with the
program, the control and planted faults come out not correct, and a cell,
configuration, architecture, traffic mix and metric added as files run
without an edit.

The cells live in ``benchmark/tests/data`` (tiny U-Nets in float32, small
frames and crops; ``tiny-seeded`` names a test-only architecture,
``archs/SeededUNet.py``) and are found by name beside the benchmark's own
files.
Their control is the reference in bfloat16, the precision below float32 on
a CPU (which has no TF32). A card's cells are tested by ``test_cells_on_card``
(marked ``cuda``).
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from benchmark import harness  # noqa: E402

DATA = os.path.join(ROOT, "benchmark", "tests", "data")
DIRS = [DATA, os.path.join(ROOT, "benchmark")]
LOKI, SEMSEG, SEEDED = "tiny-loki.sparse", "tiny-semseg.crops", "tiny-seeded.crops"
SPEC = {
    "workloads": [{"name": LOKI, "config": "tiny-loki", "traffic": "tiny-sparse", "chips": 1},
                  {"name": SEMSEG, "config": "tiny-semseg", "traffic": "tiny-crops", "chips": 1},
                  {"name": SEEDED, "config": "tiny-seeded", "traffic": "tiny-crops", "chips": 1}],
    "end_to_end": [{"name": "loki_frames_per_s", "unit": "frames/s", "workloads": [LOKI]},
                   {"name": "predict_objects_per_s", "unit": "objects/s", "workloads": [SEMSEG, SEEDED]},
                   {"name": "test_units_per_s", "unit": "units/s", "workloads": [LOKI]},
                   {"name": "setup_s", "unit": "s"}],
    "per_layer": [{"name": "host_outside_nodes_share.loki", "unit": "%", "moves": "loki_frames_per_s",
                   "workloads": [LOKI]},
                  {"name": "mfu.predict", "unit": "%", "moves": "predict_objects_per_s",
                   "workloads": [SEMSEG, SEEDED]},
                  {"name": "h5_write_share.predict", "unit": "%", "moves": "predict_objects_per_s",
                   "workloads": [SEMSEG]}],
}
SEED = 2**31 + 12345


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def run(cell, trace=False, seed=SEED):
    return harness.run_cell(SPEC, cell, seed, 0.5, trace, device="cpu", dirs=DIRS, log=lambda m: None)


def failed_checks(result):
    return sorted(k for k, c in result["checks"].items() if c["value"] > c["limit"])


@pytest.mark.parametrize("cell", [LOKI, SEMSEG, SEEDED])
def test_reference_agrees_with_the_program(cell):
    r = run(cell)
    assert r["correct"], r["checks"]
    assert r["failed"] == 0 and r["attempted"] >= 1
    assert r["device"]["platform"] == "cpu"
    assert "setup_s" in r["metrics"]


def test_added_files_run_without_an_edit():
    # test_units_per_s is a metric file of the tests' own, for a cell of
    # their own: found by name, like a later change's files.
    r = run(LOKI)
    assert r["metrics"]["test_units_per_s"]["unit"] == "units/s"
    assert r["metrics"]["test_units_per_s"]["value"] > 0
    assert set(r["metrics"]) == {"loki_frames_per_s", "test_units_per_s", "setup_s"}


def test_an_architecture_added_as_files(tmp_path):
    """``archs/SeededUNet.py`` (test data) makes the weights from a seed
    with no distillation; the checkpoint it writes loads in the program with
    the same parameters, and ``mfu`` counts its FLOPs."""
    from benchmark import weights
    from benchmark.unet_ref import state_dict_of
    from maze_image_processing_pipeline_tpu_torch.models.model_io import load_model

    config = harness.load_json(DIRS, "configs", "tiny-seeded")
    assert "distill" not in config
    w = weights.ensure_weights(config, str(tmp_path), torch.device("cpu"), DIRS)
    assert w["made"] and w["loss"] is None
    assert w["arch"].__name__ == "benchmark.archs.SeededUNet"
    unet = harness.load_module(DIRS, "archs", "UNet")
    want = state_dict_of(unet.init_plain_unet(config["model"], config["model"]["init_seed"], "cpu"))
    assert set(w["state"]) == set(want) and all(torch.equal(w["state"][k], want[k]) for k in want)
    program = load_model(w["model_dir"]).module.state_dict()
    assert all(torch.equal(program[k].float(), want[k]) for k in want)
    again = weights.ensure_weights(config, str(tmp_path), torch.device("cpu"), DIRS)
    assert not again["made"] and again["model_dir"] == w["model_dir"]

    r = run(SEEDED, trace=True)
    assert r["correct"], r["checks"]
    assert r["metrics"]["mfu.predict"]["value"] > 0


def test_traced_run_reports_per_layer_metrics():
    r = run(SEMSEG, trace=True)
    assert r["correct"]
    assert set(r["metrics"]) <= {"mfu.predict", "h5_write_share.predict"}
    assert 0 < r["metrics"]["h5_write_share.predict"]["value"] < 100
    assert r["device"]["window_s"] > 0 and "breakdown" in r


@pytest.mark.parametrize("cell", [LOKI, SEMSEG, SEEDED])
def test_control_is_not_correct(cell):
    """The control: the reference in bfloat16 put in the program's place,
    judged on the same captures as the program."""
    r = harness.run_cell(SPEC, cell, SEED + 1, 0.5, False, device="cpu", dirs=DIRS, log=lambda m: None,
                         controls=("bfloat16",))
    assert r["correct"]
    control = r["controls"]["bfloat16"]
    assert any(control[k] > r["checks"][k]["limit"] for k in ("map_max_gap", "map_mean_gap"))


def test_half_the_tiles_left_out(monkeypatch):
    from maze_image_processing_pipeline_tpu_torch.loki import device_seg

    cls = device_seg.DeviceTiledSegmentation.node_class
    orig = cls._predict

    def half(self, frames, jobs, hs, ws, device):
        return orig(self, frames, jobs[: max(1, len(jobs) // 2)], hs, ws, device)

    monkeypatch.setattr(cls, "_predict", half)
    r = run(LOKI)
    assert not r["correct"] and "map_max_gap" in failed_checks(r)


def test_half_the_crop_tiles_left_out(monkeypatch):
    from maze_image_processing_pipeline_tpu_torch.models import inference

    cls = inference.DeviceTiledInference.node_class
    orig = cls._forward

    def half(self, tiles, k):
        out = orig(self, tiles, k)
        out[len(out) // 2 :] = 0
        return out

    monkeypatch.setattr(cls, "_forward", half)
    r = run(SEMSEG)
    assert not r["correct"] and "map_max_gap" in failed_checks(r)


def test_an_answer_altered_where_it_is_produced(monkeypatch):
    from maze_image_processing_pipeline_tpu_torch.loki import device_seg

    orig = device_seg.regionprops_fused

    def altered(*a, **k):
        props = orig(*a, **k)
        props["area"] = props["area"] + 1
        return props

    monkeypatch.setattr(device_seg, "regionprops_fused", altered)
    r = run(LOKI)
    assert not r["correct"] and "feature_mismatches" in failed_checks(r)


def test_a_measurement_altered_where_it_is_produced(monkeypatch):
    from maze_image_processing_pipeline_tpu_torch.ops import segment_measure

    orig = segment_measure.measure_largest_component

    def altered(*a, **k):
        props, raw, extremes, overflow = orig(*a, **k)
        return props, raw + 1, extremes, overflow

    monkeypatch.setattr(segment_measure, "measure_largest_component", altered)
    r = run(SEMSEG)
    assert not r["correct"] and "measure_mismatches" in failed_checks(r)


def test_h5_maps_altered_where_they_are_written(monkeypatch):
    # The chunks DEFLATEd without the byte shuffle that the file declares.
    import zlib

    from maze_image_processing_pipeline_tpu_torch.dataio import hdf5

    monkeypatch.setattr(hdf5, "_pack", lambda arr, level, shuffle: zlib.compress(
        np.ascontiguousarray(arr).tobytes(), level))
    r = run(SEMSEG)
    assert not r["correct"] and failed_checks(r) == ["h5_mismatch"]


def test_labels_altered(monkeypatch):
    from maze_image_processing_pipeline_tpu_torch.loki import device_seg

    orig = device_seg.label

    def shifted(mask, connectivity=2, **k):
        labels, n = orig(mask, connectivity, **k)
        return torch.roll(labels, 1, dims=-1), n

    monkeypatch.setattr(device_seg, "label", shifted)
    r = run(LOKI)
    assert not r["correct"] and "labels_mismatch_px" in failed_checks(r)


def test_same_seed_same_inputs(tmp_path):
    from benchmark.synth import make_crop_archive

    a = make_crop_archive(str(tmp_path / "a.zip"), [(20, 30), (40, 50)], seed=2**40 + 1)
    b = make_crop_archive(str(tmp_path / "b.zip"), [(20, 30), (40, 50)], seed=2**40 + 1)
    assert all(np.array_equal(a[k], b[k]) for k in a)
    assert (tmp_path / "a.zip").read_bytes() == (tmp_path / "b.zip").read_bytes()


def test_no_card_no_result():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload", "loki-unet.sparse", "--seed", "1",
                          "--seconds", "1", "--trace", "0"], cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert out.returncode != 0 and out.stdout.strip() == ""


@pytest.mark.cuda
def test_cells_on_card():
    """Every cell once on the card at the benchmark's own window (a shorter
    one checks too few frames or objects to be correct)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        spec = json.load(f)
    for cell in [w["name"] for w in spec["workloads"]]:
        out = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload", cell, "--seed", str(SEED),
                              "--seconds", str(spec["run_seconds"]), "--trace", "0"], cwd=ROOT,
                             capture_output=True, text=True, timeout=1500)
        assert out.returncode == 0, out.stderr[-3000:]
        result = json.loads(out.stdout.strip().splitlines()[-1])
        assert result["correct"], (cell, result["checks"])
