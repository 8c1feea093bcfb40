"""The benchmark's arithmetic on hand-made inputs: FLOPs, bytes, rates, the
idle union, the trace's attribution and the check for forbidden modules."""

import os
import sys
from types import SimpleNamespace

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from benchmark.harness import find, forbidden_modules, load_json, load_module  # noqa: E402
from benchmark.spans import union_seconds  # noqa: E402
from benchmark.trace import Trace  # noqa: E402
from benchmark.unet_ref import conv_layers, forward_flops  # noqa: E402

METRICS = [os.path.join(ROOT, "benchmark")]


def test_forward_flops_by_hand():
    # UNet(out 1, base 2, depth 1) on 4×4: level 0 at 16 px, level 1 at 4 px.
    # down: 3→2 (3×3), 2→2 (3×3) at 16; bottom 2→4, 4→4 at 4; up: 2×2 4→2,
    # block 4→2, 2→2 at 16; head 2→1 (1×1) at 16.
    macs = (3 * 2 * 9 + 2 * 2 * 9) * 16 + (2 * 4 * 9 + 4 * 4 * 9) * 4 + (4 * 2 * 4 + 4 * 2 * 9 + 2 * 2 * 9) * 16 \
        + 2 * 1 * 16
    assert forward_flops(4, 4, 1, 2, 1) == 2 * macs
    assert len(conv_layers(1, 32, 4)) == 2 * 5 + 3 * 4 + 1
    assert abs(forward_flops(1024, 1024, 1, 32, 4) - 0.4378e12) < 1e9


def _run(**kw):
    base = dict(spans={}, shapes={}, counters={}, trace=None, work={}, window=(0.0, 2.0), window_s=2.0,
                config={"model": {"out_channels": 1, "base_features": 2, "depth": 1},
                        "task": {"segmentation": {"tile_size": 4}, "model": {"tiling": {"size": 4}}}},
                kind=load_module(METRICS, "kinds", "loki"), arch=load_module(METRICS, "archs", "UNet"))
    base.update(kw)
    return SimpleNamespace(**base)


@pytest.mark.parametrize("config, flops", [("loki-unet", 0.4378e12), ("predict-semseg", 27.37e9)])
def test_unet_architecture_counts_the_plain_unets_flops(config, flops):
    c = load_json(METRICS, "configs", config)
    m, ts = c["model"], load_module(METRICS, "kinds", c["kind"]).tile_size(c)
    got = load_module(METRICS, "archs", c["model"]["arch"]).forward_flops(m, ts, ts)
    assert got == forward_flops(ts, ts, m["out_channels"], m["base_features"], m["depth"])
    assert got == pytest.approx(flops, rel=1e-3)


def test_mfu_takes_the_flops_from_the_architecture():
    m = load_module(METRICS, "metrics", "mfu.predict")
    arch = SimpleNamespace(forward_flops=lambda model_cfg, h, w: 1e9 * h * w)
    run = _run(counters={"tiles": 2}, window_s=0.5, kind=load_module(METRICS, "kinds", "predict"), arch=arch)
    assert m.read(run) == pytest.approx(100.0 * 2 * 1e9 * 16 / (0.5 * 989e12))


def test_rates_are_all_work_over_all_time():
    m = load_module(METRICS, "metrics", "loki_frames_per_s")
    assert m.read(_run(work={"frames": 300.0}, window_s=6.0)) == 50.0
    p = load_module(METRICS, "metrics", "predict_objects_per_s")
    assert p.read(_run(work={"objects": 960.0 + 480.0}, window_s=12.0)) == 120.0
    assert p.read(_run(work={"frames": 1.0})) is None


def test_union_counts_overlaps_once():
    assert union_seconds([(0, 2), (1, 3), (5, 6)], 0, 10) == 4
    assert union_seconds([(0, 2), (0, 2), (0.5, 1)], 0, 10) == 2
    assert union_seconds([(-1, 2), (9, 12)], 0, 10) == 3
    assert union_seconds([], 0, 1) == 0


def _trace():
    t = Trace()
    t.annotations["window"] = [(0, 1000)]
    t.annotations["group_norm"] = [(100, 200), (500, 600)]
    t.launch_ns = {1: 150, 2: 550, 3: 300}
    # two overlapping kernels of the norm's calls, one launched outside them
    t.device = [(160, 260, "gn_fwd", 1), (200, 300, "gn_fwd", 2), (700, 800, "other", 3)]
    return t


def test_trace_busy_and_attribution():
    t = _trace()
    assert t.window_seconds() == pytest.approx(1e-6)
    assert t.busy_seconds() == pytest.approx(240e-9)  # 160-300 and 700-800: the overlap once
    assert t.device_seconds_in("group_norm") == pytest.approx(200e-9)
    assert t.device_seconds_in("absent") is None
    gaps = dict(t.idle_gaps())
    assert sum(gaps.values()) == pytest.approx(760e-9)
    idle = load_module(METRICS, "metrics", "device_idle_share.loki")
    assert idle.read(_run(trace=t)) == pytest.approx(76.0)


def test_group_norm_roofline_bytes():
    t = _trace()
    shape = ((16, 32, 1024, 1024), 2)
    run = _run(trace=t, shapes={"group_norm": [([shape, ((32,), 4), ((32,), 4)], [shape])] * 2})
    m = load_module(METRICS, "metrics", "group_norm_roofline.loki")
    nbytes = 2 * 2 * (16 * 32 * 1024 * 1024 * 2)
    assert m.read(run) == pytest.approx(100.0 * nbytes / 3.35e12 / 200e-9)


def test_label_roofline_bytes():
    t = _trace()
    t.annotations["label"] = t.annotations.pop("group_norm")
    mask, labels, n = ((8, 64, 64), 1), ((8, 64, 64), 4), ((8,), 4)
    run = _run(trace=t, shapes={"label": [([mask], [labels, n])]})
    m = load_module(METRICS, "metrics", "label_roofline.predict")
    assert m.read(run) == pytest.approx(100.0 * (8 * 64 * 64 * 5 + 32) / 3.35e12 / 200e-9)


def test_mfu_counts_tiles():
    m = load_module(METRICS, "metrics", "mfu.loki")
    run = _run(counters={"tiles": 10}, window_s=0.5)
    assert m.read(run) == pytest.approx(100.0 * 10 * forward_flops(4, 4, 1, 2, 1) / (0.5 * 989e12))
    assert m.read(_run()) is None


def test_shares_from_spans():
    m = load_module(METRICS, "metrics", "host_outside_nodes_share.loki")
    run = _run(spans={"loki.dispatch": [(0.0, 0.5), (0.4, 0.6)], "loki.finish": [(1.0, 1.5)]})
    assert m.read(run) == pytest.approx(45.0)
    ms = load_module(METRICS, "metrics", "seg_node_ms_per_frame.loki")
    run.work = {"frames": 10.0}
    assert ms.read(run) == pytest.approx(1000 * (0.5 + 0.2 + 0.5) / 10)


@pytest.mark.parametrize("name, file", [("mfu.loki", "mfu.py"), ("mfu.predict", "mfu.py"),
                                        ("device_idle_share.loki", "device_idle_share.py"),
                                        ("group_norm_roofline.loki", "group_norm_roofline.loki.py"),
                                        ("setup_s", "setup_s.py")])
def test_a_metric_finds_its_own_reader_else_the_shared_one(name, file):
    assert os.path.basename(find(METRICS, "metrics", name, ".py")) == file


def test_shared_readers_take_the_kind():
    m = load_module(METRICS, "metrics", "host_outside_nodes_share.predict")
    kind = load_module(METRICS, "kinds", "predict")
    assert m.spans(kind) == kind.NODE_SPANS
    run = _run(spans={"predict.chunk": [(0.0, 1.0)], "predict.unpack": [(0.5, 1.5)]}, kind=kind)
    assert m.read(run) == pytest.approx(25.0)
    mfu = load_module(METRICS, "metrics", "mfu.predict")
    run = _run(counters={"tiles": 3}, window_s=0.5, kind=kind)
    assert mfu.read(run) == pytest.approx(100.0 * 3 * forward_flops(4, 4, 1, 2, 1) / (0.5 * 989e12))


def test_forbidden_modules_compare_whole_names():
    assert forbidden_modules(["maze_image_processing_pipeline_tpu.x"]) == ["maze_image_processing_pipeline_tpu"]
    assert forbidden_modules(["jax.numpy", "numpy"]) == ["jax"]
    assert forbidden_modules(["maze_image_processing_pipeline_tpu_torch.x", "jaxtyping", "flaxen"]) == []
    assert forbidden_modules(["flax.linen", "jaxlib"]) == ["flax", "jaxlib"]
