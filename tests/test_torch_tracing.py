"""The port's program spans and counters (``tracing.py``), on the CPU.

* Off, a span records nothing, is one shared object a name, reads no clock,
  allocates nothing that stays and opens no profiler annotation, even under
  a running profiler; counters stay empty.
* On, spans nest by thread and carry their unit's id; a function decorated
  while tracing was off is traced once it is on; counters add, and
  ``count_launch`` adds ``launches.<kernel>``; many threads at once lose no
  count and no span.
* The stream engine's queue (``engine/stream.py`` imports ``tracing.queue``)
  records a ``get`` that waits behind a slow producer and a ``put`` that
  waits in front of a slow consumer, in the thread that waited, with the
  queue's ``maxsize``.
* A tiny loki haul (``device: cpu``) and a tiny semseg archive with
  ``save_raw_h5`` through the Runners record every named span, and the
  counters of frames, tiles, objects, canvases and ``.h5`` bytes equal the
  counts the inputs give; the predict node counts ``predict.chunks_ahead``,
  0 on the CPU.
* A torch operator inside a span has its profiler event inside the span's
  interval once :func:`tracing.clock_offset_ns` is added (within 1 ms).
* ``MAZE_IPP_PROFILE_DIR``'s Chrome trace holds every span as a ``maze::``
  annotation, those of the pipeline's threads too;
  ``MAZE_IPP_TRACE_DIR`` gets each unit's spans and summary, and no span
  stays in memory after the unit.
* On the card (``cuda``): the device interval of a kernel launched inside a
  span lies inside it on the profiler's clock.
"""

import glob
import json
import logging
import os
import sys
import threading
import time
import tracemalloc
import zipfile

import numpy as np
import pandas as pd
import pytest
import torch
import yaml

import chip_smoke
from maze_image_processing_pipeline_tpu_torch import engine, tracing
from maze_image_processing_pipeline_tpu_torch.engine.tiles import _tile_starts
from maze_image_processing_pipeline_tpu_torch.loki.pipeline import Runner as LokiRunner
from maze_image_processing_pipeline_tpu_torch.ops.row_scan import count_launch
from maze_image_processing_pipeline_tpu_torch.predict.pipeline import Runner as PredictRunner

ARCHIVE = "LOKI_PS122-1_7.zip"
CROPS = [(64, 64), (100, 90), (40, 56), (90, 120), (170, 170)]
LOKI_SPANS = {"unit", "unit.build", "model.load", "queue.get_wait", "loki.dispatch", "loki.tile_select",
              "loki.upload", "loki.forward", "loki.chain", "loki.finish", "loki.fetch_wait", "loki.crops",
              "group_norm", "label"}
PREDICT_SPANS = {"unit", "unit.build", "model.load", "queue.get_wait", "predict.chunk", "predict.tile_cut",
                 "predict.forward", "measure", "predict.unpack", "predict.fetch_wait", "group_norm", "label",
                 "h5.create", "h5.pack", "h5.close"}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _tracing_off():
    """Every test starts and ends with tracing off and nothing recorded."""
    tracing.disable()
    tracing.reset()
    yield
    tracing.disable()
    tracing.reset()


@pytest.fixture(scope="module")
def haul(tmp_path_factory):
    root = tmp_path_factory.mktemp("haul")
    chip_smoke.make_loki_tree(str(root / "data"), n_frames=3, objects_per_frame=2, frame_shape=(180, 230), seed=0)
    chip_smoke.write_unet(str(root / "unet"), chip_smoke.SMALL_UNET, "float32", seed=0, gain=1000.0)
    return root


def _loki_task(haul, target, **seg):
    return {
        "input": {"path": str(haul / "data")},
        "segmentation": {"jax": {"model_fn": str(haul / "unet"), "device": "cpu", "dtype": "float32",
                                 "batch_size": 4, "tile_size": 128, "tile_stride": 96, "frame_batch": 2,
                                 "postprocess": {"closing_radius": 2, "min_area": 20, "max_regions": 16},
                                 **seg}},
        "postprocess": {},
        "output": {"target_dir": str(target)},
    }


def _rows(fn) -> int:
    with zipfile.ZipFile(fn) as z:
        return len(pd.read_csv(z.open("ecotaxa_export.tsv"), sep="\t", skiprows=[1]))


def _names(spans):
    return {s.name for s in spans}


def test_off_records_nothing_reads_no_clock_and_opens_no_annotation(monkeypatch):
    calls = []

    @tracing.span("decorated")
    def f(x):
        return x + 1

    class NoClock:
        def __getattr__(self, name):
            calls.append(name)
            raise AssertionError(f"tracing read time.{name} while off")

    monkeypatch.setattr(tracing, "time", NoClock())
    assert tracing.span("x") is tracing.span("x") and tracing.span("x") is not tracing.span("y")
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        for _ in range(3):
            with tracing.span("x", n=1):
                torch.ones(4).add_(1)
            assert f(1) == 2
            tracing.count("c")
            q = tracing.queue.Queue(maxsize=1)
            q.put(1)
            assert q.get() == 1
    assert calls == []
    assert tracing.spans() == [] and tracing.counters() == {}
    assert not [e.name for e in prof.events() if e.name.startswith("maze::")]

    def many():
        for _ in range(20000):
            with tracing.span("x"):
                pass
            f(1)

    many()
    tracemalloc.start()
    try:
        before = tracemalloc.get_traced_memory()[0]
        tracemalloc.reset_peak()
        many()
        now, peak = tracemalloc.get_traced_memory()
    finally:
        tracemalloc.stop()
    assert now - before < 1024 and peak - before < 4096


def test_nesting_threads_decorators_and_units():
    @tracing.span("work")
    def work():
        with tracing.span("inner"):
            pass

    tracing.enable()
    assert tracing.enabled()
    with tracing.span("before"):
        pass

    def in_thread():
        with tracing.span("thread"):
            work()

    with tracing.unit("test") as uid:
        with tracing.span("outer", k=3):
            work()
            t = threading.Thread(target=in_thread)
            t.start()
            t.join()
    by = {s.name: [x for x in tracing.spans() if x.name == s.name] for s in tracing.spans()}
    assert len(by["work"]) == len(by["inner"]) == 2
    (unit,), (outer,), (before,), (thread,) = by["unit"], by["outer"], by["before"], by["thread"]
    main = threading.get_ident()
    assert before.unit is None and before.parent == 0
    assert unit.unit == outer.unit == thread.unit == uid is not None and unit.attrs == {"kind": "test"}
    assert outer.parent == unit.id and outer.attrs == {"k": 3}
    assert thread.thread != main and thread.parent == 0  # a new thread opens no span of the main thread's
    works = {w.thread: w for w in by["work"]}
    assert works[main].parent == outer.id and works[thread.thread].parent == thread.id
    for inner in by["inner"]:
        assert inner.parent == works[inner.thread].id
    for s in tracing.spans():
        assert s.start_ns <= s.end_ns
    assert unit.start_ns <= outer.start_ns and outer.end_ns <= unit.end_ns
    # Self time leaves the children out.
    summ = tracing.summary(tracing.spans(), {"c": 1})
    assert summ["spans"]["outer"]["count"] == 1 and summ["counters"] == {"c": 1}
    assert summ["spans"]["outer"]["self_ms"] <= summ["spans"]["outer"]["total_ms"]
    with tracing.unit("next") as uid2:
        pass
    assert uid2 == uid + 1


def test_counters_add_and_count_launch_adds_launches():
    def kernel():
        pass

    kernel.launches = 0
    count_launch(kernel, torch.device("cpu"))  # off: the attribute counts, the program counter does not
    assert kernel.launches == 1 and tracing.counters() == {}
    tracing.enable()
    tracing.count("a")
    tracing.count("a", 2.5)
    count_launch(kernel, torch.device("cpu"), route="r")
    count_launch(kernel, torch.device("cpu"))
    assert tracing.counters() == {"a": 3.5, "launches.kernel": 2}
    assert kernel.launches == 3 and kernel.launches_by_route == {"r": 1}
    spans, counters = tracing.take()
    assert counters == {"a": 3.5, "launches.kernel": 2} and tracing.counters() == {} and tracing.spans() == []


def test_threads_lose_no_count_or_span():
    """More threads than cores counting and opening spans at once, the
    interpreter switching threads as often as it can."""
    tracing.enable()
    n_threads, n = 4 * (os.cpu_count() or 1), 500

    def work():
        for _ in range(n):
            with tracing.span("s"):
                tracing.count("c")
                tracing.count("d", 2)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert tracing.counters() == {"c": n_threads * n, "d": 2 * n_threads * n}
    recorded = tracing.spans()
    assert len(recorded) == n_threads * n and len({s.id for s in recorded}) == len(recorded)
    assert all(s.parent == 0 for s in recorded)


def _stream(items, upstream_s, downstream_s, maxsize):
    out = []
    with engine.Pipeline() as p:
        x = engine.Unpack(items)
        engine.Call(lambda v: time.sleep(upstream_s), x)
        engine.StreamBuffer(maxsize)
        engine.Call(lambda v: time.sleep(downstream_s), x)
        engine.Call(out.append, x)
    p.run()
    return out


def test_traced_queue_records_waits_in_the_thread_that_waited():
    tracing.enable()
    assert _stream(list(range(4)), 0.05, 0.0, 2) == list(range(4))
    gets = [s for s in tracing.spans() if s.name == "queue.get_wait"]
    assert {s.thread for s in gets} == {threading.get_ident()}  # the consumer: this thread
    assert all(s.attrs == {"maxsize": 2} for s in gets)
    assert sum(s.end_ns - s.start_ns for s in gets) > 0.1e9  # behind four 50 ms items
    assert not [s for s in tracing.spans() if s.name == "queue.put_wait"]

    tracing.reset()
    assert _stream(list(range(6)), 0.0, 0.05, 1) == list(range(6))
    puts = [s for s in tracing.spans() if s.name == "queue.put_wait"]
    assert puts and threading.get_ident() not in {s.thread for s in puts}  # the producer's thread
    assert all(s.attrs == {"maxsize": 1} for s in puts)
    assert sum(s.end_ns - s.start_ns for s in puts) > 0.1e9


def test_loki_haul_records_every_span_and_counts(haul, tmp_path):
    tracing.enable()
    LokiRunner._configure_and_run(_loki_task(haul, tmp_path / "out", skip_empty_tiles=False))
    spans, counters = tracing.spans(), tracing.counters()
    assert LOKI_SPANS <= _names(spans)
    # Three frames of 180 x 230 in one 256 x 256 bucket, frame groups of two:
    # two groups, every tile of both slots of each run (nothing skipped).
    per_frame = len(_tile_starts(256, 128, 96)) ** 2
    assert counters["frames"] == 3 and counters["frame_groups"] == 2
    assert counters["tiles"] == 2 * 2 * per_frame and counters["tiles_skipped"] == 0
    assert counters["objects"] == _rows(tmp_path / "out" / ARCHIVE) > 0
    assert counters["label.bytes"] > 0 and counters["group_norm.bytes"] > 0
    (unit,) = [s for s in spans if s.name == "unit"]
    assert {s.unit for s in spans} == {unit.unit}
    # The node's dispatch and its input waits share a thread, not the Runner's.
    node = {s.thread for s in spans if s.name == "loki.dispatch"}
    assert len(node) == 1 and threading.get_ident() not in node
    for child, parent in [("loki.tile_select", "loki.dispatch"), ("loki.forward", "loki.dispatch"),
                          ("loki.crops", "loki.finish"), ("model.load", "unit.build")]:
        ids = {s.id for s in spans if s.name == parent}
        assert all(s.parent in ids for s in spans if s.name == child), child

    tracing.reset()
    LokiRunner._configure_and_run(_loki_task(haul, tmp_path / "skip"))
    counters = tracing.counters()
    assert counters["tiles"] + counters["tiles_skipped"] == 2 * 2 * per_frame and counters["tiles_skipped"] > 0


def test_semseg_archive_with_h5_records_every_span_and_counts(tmp_path):
    archive = chip_smoke.make_crop_archive(str(tmp_path / "in" / "crops.zip"), CROPS, seed=0)
    unet = chip_smoke.write_unet(str(tmp_path / "unet"), chip_smoke.SMALL_SEMSEG_UNET, "float32", seed=0,
                                 gain=1000.0, channel_names=chip_smoke.CHANNELS)
    task = chip_smoke.semseg_task(archive, unet, str(tmp_path / "out"), device="cpu", dtype="float32",
                                  batch_size=2, tiling={"size": 64, "stride": 48, "chunk_size": 2})
    task["save_raw_h5"] = True
    tracing.enable()
    PredictRunner._configure_and_run(task)
    spans, counters = tracing.spans(), tracing.counters()
    assert PREDICT_SPANS <= _names(spans)
    assert counters["chunks"] == 3 and counters["canvases"] == len(CROPS)
    assert counters["tiles"] == sum(len(_tile_starts(h, 64, 48)) * len(_tile_starts(w, 64, 48)) for h, w in CROPS)
    # Each object's two float16 maps, one whole-array chunk each.
    assert counters["h5.raw_bytes"] == sum(h * w * 2 * 2 for h, w in CROPS)
    assert 0 < counters["h5.stored_bytes"] and len([s for s in spans if s.name == "h5.create"]) == len(CROPS)
    assert _rows(tmp_path / "out" / "crops.segmentation.zip") == len(CROPS)
    chunk_ids = {s.id for s in spans if s.name == "predict.chunk"}
    measure_ids = {s.id for s in spans if s.name == "measure"}
    assert measure_ids and all(s.parent in chunk_ids for s in spans if s.name in ("measure", "predict.tile_cut"))
    assert all(s.parent in measure_ids for s in spans if s.name == "label")


def test_predict_node_counts_chunks_ahead_zero_on_the_cpu():
    """``predict.chunks_ahead`` is counted at every chunk; on the CPU no
    work is ever queued ahead."""
    from maze_image_processing_pipeline_tpu_torch.models.inference import DeviceTiledInference
    from maze_image_processing_pipeline_tpu_torch.models.model_io import LoadedModel

    crops = [np.full(s, 9, np.uint8) for s in CROPS]
    out = []
    tracing.enable()
    with engine.Pipeline() as p:
        pred, _ = DeviceTiledInference(LoadedModel(torch.nn.Identity(), {}), engine.Unpack(crops), tile_size=64,
                                       tile_stride=48, batch_size=2, chunk_size=2, device="cpu")
        engine.Call(out.append, pred)
    p.run()
    counters = tracing.counters()
    assert len(out) == len(CROPS) and counters["chunks"] == 3
    assert "predict.chunks_ahead" in counters and counters["predict.chunks_ahead"] == 0


def test_a_torch_op_lies_inside_its_span_on_the_profiler_clock():
    tracing.enable()
    a = torch.rand(256, 256)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        for _ in range(5):
            with tracing.span("mm"):
                torch.mm(a, a)
            time.sleep(0.002)
    off = tracing.clock_offset_ns()
    spans = [s for s in tracing.spans() if s.name == "mm"]
    events = sorted((e.start_ns(), e.start_ns() + e.duration_ns()) for e in prof.profiler.kineto_results.events()
                    if e.name() == "aten::mm")
    assert len(events) == len(spans) == 5
    for s, (e0, e1) in zip(sorted(spans, key=lambda s: s.start_ns), events):
        assert s.start_ns + off - 1_000_000 <= e0 and e1 <= s.end_ns + off + 1_000_000


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


def test_profile_dir_annotates_and_trace_dir_writes_each_unit(haul, tmp_path, monkeypatch, runner_state):
    task_fn = tmp_path / "task" / "loki.yaml"
    task_fn.parent.mkdir()
    task_fn.write_text(yaml.safe_dump(_loki_task(haul, tmp_path / "out")))
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("MAZE_IPP_PROFILE_DIR", "prof")
    LokiRunner.run(str(task_fn))
    (trace,) = glob.glob(str(tmp_path / "prof" / "loki-*.pt.trace.json"))
    names = {e.get("name") for e in json.loads(open(trace).read())["traceEvents"]}
    assert {"maze::" + name for name in LOKI_SPANS} <= names  # the node's thread's too
    assert not tracing.enabled() and tracing.spans() == []

    monkeypatch.delenv("MAZE_IPP_PROFILE_DIR")
    monkeypatch.setenv("MAZE_IPP_TRACE_DIR", "spans")
    os.chdir(tmp_path)
    LokiRunner.run(str(task_fn))
    assert not tracing.enabled() and tracing.spans() == [] and tracing.counters() == {}
    (summary_fn,) = glob.glob(str(tmp_path / "spans" / "loki-*-unit*.summary.json"))
    (spans_fn,) = glob.glob(str(tmp_path / "spans" / "loki-*-unit*.spans.jsonl"))
    summary = json.loads(open(summary_fn).read())
    assert LOKI_SPANS <= set(summary["spans"]) and summary["counters"]["frames"] == 3
    lines = [json.loads(line) for line in open(spans_fn)]
    assert {d["name"] for d in lines} == set(summary["spans"])
    assert sum(d["name"] == "loki.dispatch" for d in lines) == summary["spans"]["loki.dispatch"]["count"]
    assert {"name", "id", "parent", "thread", "unit", "start_ns", "end_ns", "attrs"} == set(lines[0])


@pytest.mark.cuda
def test_cuda_kernel_lies_inside_its_span_on_the_profiler_clock():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from torch._C._autograd import DeviceType

    from maze_image_processing_pipeline_tpu_torch.ops.label import label

    dev = torch.device("cuda")
    mask = torch.from_numpy(np.random.default_rng(0).random((4, 512, 640)) < 0.3).to(dev)
    label(mask)  # builds and warms the kernels
    torch.cuda.synchronize()
    tracing.enable()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(3):
            with tracing.span("outer"):
                label(mask)
                torch.cuda.synchronize()
            time.sleep(0.005)
    off = tracing.clock_offset_ns()
    outer = sorted(((s.start_ns + off, s.end_ns + off) for s in tracing.spans() if s.name == "outer"))
    kernels = [(e.start_ns(), e.start_ns() + e.duration_ns()) for e in prof.profiler.kineto_results.events()
               if e.device_type() == DeviceType.CUDA and "walk_kernel" in e.name()]
    assert len(outer) == 3 and len(kernels) >= 6  # two fixpoint launches a label()
    for k0, k1 in kernels:
        assert any(s0 - 1_000_000 <= k0 and k1 <= s1 + 1_000_000 for s0, s1 in outer), (k0, k1, outer)
