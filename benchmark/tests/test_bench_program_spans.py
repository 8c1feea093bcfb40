"""The readers of the program's own spans (``metrics/input_wait_share.py``,
``output_wait_share.py``, ``unit_build_share.py``, ``fetch_wait_share.py``,
``launch_idle_share.py``), on synthetic spans and trace intervals with known
answers; without the program's ``tracing`` module they read nothing and
install nothing; and one traced run of each test cell on the CPU reads all
ten metrics.
"""

import os
import sys
from types import SimpleNamespace

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from benchmark import harness  # noqa: E402
from maze_image_processing_pipeline_tpu_torch import tracing  # noqa: E402

BENCH = os.path.join(ROOT, "benchmark")
READERS = ["input_wait_share", "output_wait_share", "unit_build_share", "fetch_wait_share", "launch_idle_share"]
S = 1_000_000_000  # ns a second
T1, T2 = 101, 102  # thread idents


def reader(name):
    return harness.load_module([BENCH], "metrics", name)


def sp(name, start_s, end_s, thread=T1, unit=1):
    return tracing.Span(name, 0, 0, thread, unit, int(start_s * S), int(end_s * S), None)


def window_run(kind, trace=None):
    """A window of 10 s from 10 s on the host clock."""
    return SimpleNamespace(config={"kind": kind}, window=(10.0, 20.0), window_s=10.0, trace=trace)


@pytest.fixture
def program(monkeypatch):
    """The program's recorded spans and clock offset, as the test sets them."""
    state = SimpleNamespace(spans=[], offset=0)
    monkeypatch.setattr(tracing, "spans", lambda: list(state.spans))
    monkeypatch.setattr(tracing, "clock_offset_ns", lambda: state.offset)
    return state


@pytest.mark.parametrize("name,wait", [("input_wait_share", "queue.get_wait"),
                                       ("output_wait_share", "queue.put_wait")])
@pytest.mark.parametrize("kind,node", [("loki", "loki.dispatch"), ("predict", "predict.chunk")])
def test_queue_waits_of_the_node_thread(program, name, wait, kind, node):
    program.spans = [
        sp(node, 10.5, 10.6),
        sp(wait, 11, 12), sp(wait, 11.5, 13),  # overlapping: 2 s
        sp(wait, 19, 21),  # 1 s inside the window
        sp(wait, 14, 15, thread=T2),  # another thread
        sp(wait, 15, 16, unit=2),  # the same thread ident in a unit where it ran no dispatch
        sp("queue.get_wait" if wait == "queue.put_wait" else "queue.put_wait", 16, 18),  # the other wait
    ]
    assert reader(f"{name}.{kind}").read(window_run(kind)) == pytest.approx(30.0)
    program.spans = [s for s in program.spans if s.name != node]
    assert reader(f"{name}.{kind}").read(window_run(kind)) is None  # the node never ran
    program.spans = [sp(node, 10.5, 10.6)]
    assert reader(f"{name}.{kind}").read(window_run(kind)) == 0.0  # never waited


def test_unit_build_share(program):
    program.spans = [sp("unit.build", 9, 11), sp("unit.build", 15, 16, thread=T2), sp("unit", 10, 20)]
    assert reader("unit_build_share.loki").read(window_run("loki")) == pytest.approx(20.0)
    program.spans = [sp("unit", 10, 20)]
    assert reader("unit_build_share.predict").read(window_run("predict")) is None


@pytest.mark.parametrize("kind", ["loki", "predict"])
def test_fetch_wait_share(program, kind):
    other = "predict" if kind == "loki" else "loki"
    program.spans = [sp(f"{kind}.fetch_wait", 12, 12.5), sp(f"{kind}.fetch_wait", 12.25, 13, thread=T2),
                     sp(f"{other}.fetch_wait", 14, 18)]
    assert reader(f"fetch_wait_share.{kind}").read(window_run(kind)) == pytest.approx(10.0)


@pytest.mark.parametrize("kind,node", [("loki", "loki.dispatch"), ("predict", "predict.chunk")])
def test_launch_idle_share(program, kind, node):
    # Host clock + 500 ns = the trace's clock; the trace's window 1000-2000 ns.
    program.offset = 500
    program.spans = [tracing.Span(node, 0, 0, T1, 1, 600, 800, None),  # 1100-1300 on the trace's clock
                     tracing.Span(node, 0, 0, T1, 1, 1400, 1700, None),  # 1900-2200: 100 inside the window
                     tracing.Span("unit", 0, 0, T1, 1, 0, 3000, None)]
    device = [(1150, 1200, "k", 1), (1250, 1400, "k", 2), (1180, 1190, "k", 3), (1950, 2500, "k", 4)]
    trace = SimpleNamespace(window=(1000, 2000), device=device)
    # Idle inside the spans: 1100-1150, 1200-1250 and 1900-1950.
    assert reader(f"launch_idle_share.{kind}").read(window_run(kind, trace)) == pytest.approx(15.0)
    assert reader(f"launch_idle_share.{kind}").read(window_run(kind, None)) is None  # an untraced run
    program.spans = program.spans[2:]
    assert reader(f"launch_idle_share.{kind}").read(window_run(kind, trace)) is None


def test_without_the_programs_spans_nothing_is_read(monkeypatch):
    """A program without ``tracing`` (a parent checkout): install does
    nothing and every reader returns None."""
    monkeypatch.setitem(sys.modules, "maze_image_processing_pipeline_tpu_torch.tracing", None)
    run = window_run("loki", SimpleNamespace(window=(0, 10), device=[]))
    for name in READERS:
        r = reader(name + ".loki")
        r.install(None, {}, None)
        assert r.read(run) is None, name


def test_traced_cpu_runs_read_all_ten():
    """The readers through the harness, in a traced run of each test cell
    on the CPU (no device operations: the node's dispatch is all idle)."""
    loki, semseg = "tiny-loki.sparse", "tiny-semseg.crops"
    spec = {
        "workloads": [{"name": loki, "config": "tiny-loki", "traffic": "tiny-sparse", "chips": 1},
                      {"name": semseg, "config": "tiny-semseg", "traffic": "tiny-crops", "chips": 1}],
        "end_to_end": [{"name": "loki_frames_per_s", "unit": "frames/s", "workloads": [loki]},
                       {"name": "predict_objects_per_s", "unit": "objects/s", "workloads": [semseg]},
                       {"name": "setup_s", "unit": "s"}],
        "per_layer": [{"name": f"{m}.{kind}", "unit": "%", "moves": e2e, "workloads": [cell]} for m in READERS
                      for kind, e2e, cell in (("loki", "loki_frames_per_s", loki),
                                              ("predict", "predict_objects_per_s", semseg))],
    }
    dirs = [os.path.join(BENCH, "tests", "data"), BENCH]
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        for cell, kind in ((loki, "loki"), (semseg, "predict")):
            r = harness.run_cell(spec, cell, 2**31 + 99, 0.5, True, device="cpu", dirs=dirs, log=lambda m: None)
            assert r["correct"], r["checks"]
            assert set(r["metrics"]) == {f"{m}.{kind}" for m in READERS}
            for name, m in r["metrics"].items():
                assert 0 <= m["value"] <= 100 and m["unit"] == "%", (name, m)
            assert r["metrics"][f"launch_idle_share.{kind}"]["value"] > 0
    finally:
        torch.set_num_threads(n)
        tracing.disable()
        tracing.reset()
