"""BENCHMARK.json and the data files it names: the contract's shape.

Run from the root of the checkout: ``python -m pytest benchmark/tests -q``.
"""

import json
import math
import os
import re
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from benchmark.harness import find  # noqa: E402
BENCH = os.path.join(ROOT, "benchmark")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


@pytest.fixture(scope="module")
def spec():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_top_level_keys(spec):
    assert set(spec) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert spec["paths"] == ["benchmark"]
    assert 1 <= spec["run_seconds"] <= 51 and isinstance(spec["run_seconds"], int)
    assert len(spec["command"]) <= 32 and not any(w.startswith("/") or ".." in w for w in spec["command"])
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024


def test_names_units_and_text_fields(spec):
    names = [e["name"] for key in ("configs", "workloads", "end_to_end", "per_layer") for e in spec[key]]
    assert all(NAME.match(n) for n in names), names
    assert len({e["name"] for e in spec["end_to_end"] + spec["per_layer"]}) == len(spec["end_to_end"]) + len(
        spec["per_layer"])
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher") and m["source"] in SOURCES
    for e in spec["configs"] + spec["workloads"]:
        assert 1 <= len(e["why"]) <= 200 and "\n" not in e["why"] and "\t" not in e["why"]


def test_each_cell_names_a_known_configuration_and_traffic(spec):
    configs = {c["name"]: c for c in spec["configs"]}
    pairs = set()
    for w in spec["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["config"] in configs and w["chips"] in (1, 4)
        assert os.path.exists(os.path.join(BENCH, "traffic", w["traffic"] + ".json"))
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
    used = {w["config"] for w in spec["workloads"]}
    for c in spec["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"} and c["name"] in used
        with open(os.path.join(ROOT, c["file"])) as f:
            body = json.load(f)
        assert body["name"] == c["name"] and body["source"] == c["source"]
        assert os.path.exists(os.path.join(BENCH, "kinds", body["kind"] + ".py"))
        assert os.path.exists(os.path.join(BENCH, "archs", body["model"]["arch"] + ".py"))
        # Each architecture compares its own numbers; a U-Net's maps are
        # probabilities, so their gaps lie in (0, 1).
        assert body["limits"] and all(v > 0 and math.isfinite(v) for v in body["limits"].values())
        if body["model"]["arch"] == "UNet":
            for k in ("map_max_gap", "map_mean_gap"):
                assert 0 < body["limits"][k] < 1


@pytest.mark.parametrize("config, key", [("loki-unet", "20a119e6b505f053"), ("predict-semseg", "10784378d9b358c7")])
def test_weight_cache_keys_are_pinned(config, key):
    # The key names a configuration's weight cache; it changes only with the
    # settings that make the weights (values of the tree before archs/).
    from benchmark.weights import cache_key

    with open(os.path.join(BENCH, "configs", config + ".json")) as f:
        assert cache_key(json.load(f)) == key


def test_data_files_parse():
    for sub in ("configs", "traffic"):
        for fn in os.listdir(os.path.join(BENCH, sub)):
            with open(os.path.join(BENCH, sub, fn)) as f:
                assert isinstance(json.load(f), dict), fn


def test_metrics_have_readers_and_bounds(spec):
    cells = {w["name"] for w in spec["workloads"]}
    e2e = {m["name"]: m for m in spec["end_to_end"]}
    assert "setup_s" in e2e and "workloads" not in e2e["setup_s"]
    for m in spec["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
        assert find([BENCH], "metrics", m["name"], ".py")
    for m in spec["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in e2e and find([BENCH], "metrics", m["name"], ".py")
        moved = e2e[m["moves"]]
        for w in m["workloads"]:  # every cell that reports it reports what it moves
            assert w in cells and ("workloads" not in moved or w in moved["workloads"])
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"
    for w in cells:  # every cell: setup_s, another end-to-end metric and a per-layer metric
        own = [m for m in spec["end_to_end"] if "workloads" not in m or w in m["workloads"]]
        assert len(own) >= 2 and any(w in m["workloads"] for m in spec["per_layer"])
    layers = {}
    for m in spec["per_layer"]:
        layers.setdefault(m["layer"], set()).add(m["name"])
    with open(os.path.join(ROOT, "PERF.md")) as f:
        perf = f.read()
    for layer in layers:
        assert layer in perf, layer


def test_check_budget_fits(spec):
    # 2 + 14 × 24 cells of run_seconds + 60, 2 × 90 a cell, 1200 spare: within 43200 s.
    n = 24
    assert (2 + 14 * n) * (spec["run_seconds"] + 60) + n * 2 * 90 + 1200 <= 43200
