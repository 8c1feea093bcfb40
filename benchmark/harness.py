"""One run of one cell: set-up, the measured window, the trace, the check.

Everything that belongs to one configuration, traffic mix or metric is a
file found by its name: ``configs/<config>.json`` (its ``kind`` names the
driver ``kinds/<kind>.py``, its ``model.arch`` the architecture
``archs/<arch>.py``: weights, checkpoint, FLOPs), ``traffic/<traffic>.json``
and ``metrics/<metric>.py``, else, for a metric of one kind of cell such as
``mfu.loki``, the reader shared by the name before the first dot
(``metrics/mfu.py``), which takes what differs from the kind's module.
:func:`run_cell` takes a cell as ``BENCHMARK.json`` gives it and returns
the result line's object.

The window runs the cell's units (a haul or an archive, drawn from the
seed) back to back through the program's Runner and ends at the first unit
that ends past ``seconds``; a rate is all the work of the window over all
of its wall time. With ``trace`` the profiler runs over the same window and
the per-layer readers take their numbers from it and from the spans.
"""

from __future__ import annotations

import contextlib
import importlib.util
import json
import os
import shutil
import tempfile
import time
import traceback
from types import SimpleNamespace
from typing import Dict, List, Optional

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
CACHE = os.path.join(HERE, "_cache")
# Where the program builds its CUDA kernels and its native codec, in the
# checkout: a run that adds a file there built them (its set-up compiled).
PORT = os.path.join(os.path.dirname(HERE), "maze_image_processing_pipeline_tpu_torch")
BUILDS = (os.path.join(PORT, "build"), os.path.join(PORT, "native", "build"))
FORBIDDEN = ("jax", "jaxlib", "flax", "maze_image_processing_pipeline_tpu")


def forbidden_modules(names) -> List[str]:
    """Top-level names among ``names`` (module names) that a run may not
    load, compared whole: ``maze_image_processing_pipeline_tpu_torch``
    passes, ``maze_image_processing_pipeline_tpu.x`` does not."""
    return sorted({n.split(".")[0] for n in names} & set(FORBIDDEN))


def find(dirs, sub: str, name: str, ext: str) -> str:
    """``<dir>/<sub>/<name><ext>`` in the first of ``dirs`` that holds it;
    else the same for the name before its first dot."""
    for n in dict.fromkeys((name, name.split(".")[0])):
        for d in dirs:
            p = os.path.join(d, sub, n + ext)
            if os.path.exists(p):
                return p
    raise FileNotFoundError(f"no {sub}/{name}{ext} under {dirs}")


def load_json(dirs, sub: str, name: str) -> dict:
    with open(find(dirs, sub, name, ".json")) as f:
        return json.load(f)


def load_module(dirs, sub: str, name: str):
    path = find(dirs, sub, name, ".py")
    spec = importlib.util.spec_from_file_location(f"benchmark.{sub}.{os.path.basename(path)[:-3]}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell_metrics(spec: dict, cell: str):
    """The cell's end-to-end and per-layer metric entries."""
    def applies(m):
        return "workloads" not in m or cell in m["workloads"]

    e2e = [m for m in spec["end_to_end"] if applies(m)]
    names = {m["name"] for m in e2e}
    layer = [m for m in spec["per_layer"] if applies(m) and m["moves"] in names]
    return e2e, layer


def built_files() -> set:
    return {os.path.join(d, f) for d in BUILDS if os.path.isdir(d) for f in os.listdir(d)}


def derive_seed(seed: int, *salt: int) -> int:
    """A 63-bit seed for unit ``salt`` of the run ``seed``."""
    return int(np.random.SeedSequence([int(seed) & (2**64 - 1), *salt]).generate_state(1, np.uint64)[0] >> 1)


def run_cell(spec: dict, cell_name: str, seed: int, seconds: float, trace: bool, device: str = "cuda",
             dirs: Optional[List[str]] = None, t_start: Optional[float] = None, log=print,
             controls=()) -> dict:
    """Run one cell once; returns the result object (``correct``,
    ``attempted``, ``failed``, ``metrics``, ``device``, [``breakdown``],
    ``first_run``: whether set-up made the weights or built the kernels,
    ``checks``). Each mode of ``controls`` (``"fp8"``, ``"bfloat16"``)
    also judges the reference in that mode in the program's place, on the
    same captures, under ``result["controls"][mode]`` (the calibration's
    upper readings; the benchmark's runs ask for none)."""
    import torch

    from .spans import Recorder
    from .synth import bytes_of_tree
    from .weights import ensure_weights

    t_start = time.perf_counter() if t_start is None else t_start
    dirs = dirs or [HERE]
    cell = next(c for c in spec["workloads"] if c["name"] == cell_name)
    config = load_json(dirs, "configs", cell["config"])
    traffic = load_json(dirs, "traffic", cell["traffic"])
    kind = load_module(dirs, "kinds", config["kind"])
    e2e, layer = cell_metrics(spec, cell_name)
    readers = {m["name"]: load_module(dirs, "metrics", m["name"]) for m in (e2e if not trace else layer)}
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)

    built_before = built_files()
    weights = ensure_weights(config, CACHE, dev, dirs)
    log(f"weights: {'made' if weights['made'] else 'cached'} in {weights['seconds']:.3f} s"
        + (f", last loss {weights['loss']}" if weights["loss"] is not None else ""))
    workdir = tempfile.mkdtemp(prefix="maze-bench-")
    written = 0
    try:
        pool = kind.make_pool(config, traffic, seed, os.path.join(workdir, "in"))
        written += bytes_of_tree(os.path.join(workdir, "in"))
        state = kind.State(config, traffic, seed)
        t_warm = time.perf_counter()
        found = kind.warm_up(config, weights, pool, os.path.join(workdir, "warm"), dev)
        warm_s = time.perf_counter() - t_warm
        written += bytes_of_tree(os.path.join(workdir, "warm"))
        shutil.rmtree(os.path.join(workdir, "warm"), ignore_errors=True)
        log(f"warm-up: {found}")

        rec = Recorder()
        counters: Dict[str, float] = {}
        kind.install_captures(rec, state)
        spans: Dict[str, str] = {}
        shapes = set()
        for r in readers.values():
            spans.update(r.spans(kind) if hasattr(r, "spans") else getattr(r, "SPANS", {}))
            shapes |= set(getattr(r, "SHAPES", ()))
            if hasattr(r, "install"):
                r.install(rec, counters, kind)
        for span, target in spans.items():
            rec.wrap(target, span=span, shapes=span in shapes)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        setup_s = time.perf_counter() - t_start
        # A checkout's first run makes the weights and builds inside its
        # set-up; the line says whether this run was one, so its set-up can be
        # kept apart.
        first_run = {"weights_made": weights["made"], "kernels_built": bool(built_files() - built_before),
                     "weights_s": weights["seconds"], "warm_up_s": warm_s}
        log(f"set-up: {setup_s:.3f} s; {first_run}")
        prof = None
        if trace:
            # The Runners' nodes run in threads of their own: profile them all.
            prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                      torch.profiler.ProfilerActivity.CUDA],
                                          experimental_config=torch._C._profiler._ExperimentalConfig(
                                              profile_all_threads=True))
            prof.start()
            rec.profiling = True
        rec.active = True
        failed = attempted = 0
        work: Dict[str, float] = {}
        window = torch.profiler.record_function("bench::window") if trace else None
        if window is not None:
            window.__enter__()
        w0 = time.perf_counter()
        i = 0
        unit_s = []
        while True:
            u0 = time.perf_counter()
            unit = pool[i % len(pool)]
            out_dir = os.path.join(workdir, f"out{i}")
            state.begin(i, unit)
            attempted += 1
            try:
                with torch.profiler.record_function("bench::unit") if trace else contextlib.nullcontext():
                    kind.run_unit(config, unit, weights["model_dir"], out_dir, dev)
                ok = True
            except Exception:
                traceback.print_exc()
                failed += 1
                ok = False
            unit_s.append(time.perf_counter() - u0)
            for k, v in unit.work.items():
                work[k] = work.get(k, 0) + v
            written += bytes_of_tree(out_dir)
            state.end(i, unit, out_dir, ok, os.path.join(workdir, "kept"))
            shutil.rmtree(out_dir, ignore_errors=True)
            i += 1
            if time.perf_counter() - w0 >= seconds:
                break
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        w1 = time.perf_counter()
        if window is not None:
            window.__exit__(None, None, None)
        rec.active = False
        tr = None
        if prof is not None:
            prof.stop()
            from .trace import Trace

            t_tr = time.perf_counter()
            tr = Trace.from_profiler(prof)
            del prof
            log(f"trace: {len(tr.device)} device operations read in {time.perf_counter() - t_tr:.3f} s")
        rec.remove()
        mem_peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
        log(f"window: {i} units, {work}, {w1 - w0:.6f} s; bytes written {written}")
        log(f"units: {' '.join(f'{u:.3f}' for u in unit_s)} s")

        run = SimpleNamespace(setup_s=setup_s, window_s=w1 - w0, work=work, spans=rec.spans, shapes=rec.shapes,
                              counters=counters, trace=tr, config=config, traffic=traffic, cell=cell,
                              window=(w0, w1), kind=kind, arch=weights["arch"])
        log(f"card: {power_limit()}")
        metrics = {}
        for m in (layer if trace else e2e):
            v = readers[m["name"]].read(run)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        result = {"correct": False, "attempted": attempted, "failed": failed, "metrics": metrics,
                  "device": device_info(dev, mem_peak)}
        if tr is not None:
            result["device"]["busy_s"] = tr.busy_seconds()
            result["device"]["window_s"] = tr.window_seconds()
            result["breakdown"] = {"device_ops": tr.top_device_ops(), "idle_gaps": tr.idle_gaps()}
        del tr, run
        t_check = time.perf_counter()
        picks = kind.collect(config, state, dev)
        checks = kind.judge(config, weights, picks, state, dev, log)
        log(f"check: {time.perf_counter() - t_check:.3f} s")
        checks["units_failed"] = (float(failed), 0.0)
        result["correct"] = all(v <= lim for v, lim in checks.values())
        if controls:
            result["controls"] = {mode: {k: v for k, (v, _) in kind.judge(
                config, weights, picks, state, dev, log, control_mode=mode).items()} for mode in controls}
        result["first_run"] = first_run
        result["checks"] = {k: {"value": v, "limit": lim} for k, (v, lim) in checks.items()}
        return result
    finally:
        shutil.rmtree(workdir, ignore_errors=True)


def power_limit() -> Optional[str]:
    """The card's name and power limit by ``nvidia-smi`` (None without it)."""
    import subprocess

    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=20)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout.strip() else None
    except (OSError, subprocess.SubprocessError):
        return None


def device_info(dev, mem_peak: int) -> dict:
    import torch

    if dev.type == "cuda":
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(dev), "count": 1,
                "memory_peak_bytes": int(mem_peak)}
    return {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
