"""A/B walls of checkouts: the ``maze-ipp loki`` Runner's wall (or, with
``--predict``, the ``maze-ipp predict`` Runner's; with ``--norms``, the
GroupNorm kernels' times; with ``--relabel``, K8's; with ``--anchor``, K9's;
with ``--fixpoint``, the CCL fixpoint's; with ``--region``, the region
measurement's) for two or more checkouts of this
repo, in turns, on one set of inputs::

    python -m maze_image_processing_pipeline_tpu_torch.tools.ab_walls TREE [TREE ...] [--workdir DIR]
    python -m maze_image_processing_pipeline_tpu_torch.tools.ab_walls TREE [TREE ...] --predict [--workdir DIR]
    python -m maze_image_processing_pipeline_tpu_torch.tools.ab_walls TREE [TREE ...] --norms [--iters N]
    python -m maze_image_processing_pipeline_tpu_torch.tools.ab_walls TREE [TREE ...] --relabel [--iters N]
    python -m maze_image_processing_pipeline_tpu_torch.tools.ab_walls TREE [TREE ...] --anchor [--iters N]
    python -m maze_image_processing_pipeline_tpu_torch.tools.ab_walls TREE [TREE ...] --fixpoint [--iters N]
    python -m maze_image_processing_pipeline_tpu_torch.tools.ab_walls TREE [TREE ...] --region [--iters N]

The task is ``chip_smoke.py``'s phase 6: the standard haul's loki task
(24 frames of 1024×1280, 20 vignettes a frame, a ``UNet(1, 32, 4)`` bf16 of
seeded random weights, masks stored). The inputs are made once, here, by
:mod:`.synth`; each TREE then runs in a process of its own that imports
that checkout's package (its kernels built at the first call into its own
``build/``), runs the task once to warm up and ``WALLS`` times more.
Name the trees in the order they should run, for example parent, change,
change, parent. One line is printed per run, then a JSON object of the
walls by tree. Times are taken on the card only.

``--predict`` runs instead ``chip_smoke.py``'s phase 7 tasks: semseg
(``UNet(2, 32, 4)`` bf16, tiles 256 / 192, the device blend with fused
measurement) and polytaxo (``ConvClassifier(8)`` bf16) on 480 crops, their
inputs made once by the running checkout's ``chip_smoke.predict_inputs``;
each TREE's process runs each task once to warm up and ``WALLS`` times more.

``--norms`` times instead, in each TREE's process, K5 (``group_norm``) and
K6 (``group_norm_bwd``) in bfloat16 with G = 8, NCHW and channels_last: K5
at the norms of the haul's path, the train step's and the distillation's
shapes, K6 at the train step's and the distillation's shapes. A kernel's
time is its device time with the stream's queue kept full
(``chip_smoke.queued_ms``: the card sleeps while the calls are enqueued, so
the wrapper's host time drops out), mean of ``--iters`` calls after one
warm-up; beside it the time by CUDA events around calls paced by the host.
Then the full-width train step of the checkout's
``chip_smoke.full_width_step`` (``UNet(2, 32, 4)`` bf16, batch 8 of 512²):
ms a step over ten steps after three warm-ups.

``--relabel`` times instead, in each TREE's process, K8
(``remove_small_objects``, R = 256, min_area 30) on ``chip_smoke``'s
rectangle label frames at ``RELABEL_SHAPES``: loki's frames (8, 1024,
1280), the perf lab's (8, 1024, 1024) and the dense haul's (8, 2048,
2560). Three times a shape, each the mean of ``--iters`` calls: queue full
with L2 cold (the calls rotate over copies of the labels that together
exceed twice the L2, ``chip_smoke.l2_cold_inputs``), queue full on one
input (L2 warm), and CUDA events around calls paced by the host; each
output is checked bit for bit against the plain version first. Every TREE
is timed by the clock of the checkout that runs this tool (its
``chip_smoke.py``, loaded by path), so that the trees differ only in their
kernels; a tree whose wrapper shows its plan reports its route.

``--anchor`` times instead, in each TREE's process, K9 (``anchor``) on bool
masks at ``ANCHOR_SHAPES``: the perf lab's (8, 1024, 1024) and the dense
haul's (8, 2048, 2560), each contiguous and as the transposed view, and
beside each, in the same process, its library call (``Tensor.clone()`` of
the contiguous mask, ``.contiguous()`` of the transposed view). Three times
each, the mean of ``--iters`` calls: queue full with L2 cold, queue full on
one input (L2 warm) and host-paced, timed by the running checkout's
``chip_smoke.py`` as ``--relabel``; each output checked bit for bit first.

``--fixpoint`` times instead, in each TREE's process, one ``label()``
fixpoint (``_fixpoint`` on the raster seed) at ``chip_smoke.FIXPOINT_SHAPES``
on that script's masks (loki-like frames, blob canvases), both
connectivities, by CUDA events around ``--iters`` calls (a call lasts
milliseconds), timed by the running checkout's ``chip_smoke.py``; each
tree's labels and sweep counts are printed as a checksum.

``--region`` times instead, in each TREE's process, the region-measurement
kernel (K7 with K3) at the paths' shapes, ``REGION_CASES``: loki's (8,
1024, 1280) with R = 64 on ``chip_smoke.make_frames``' labelled blobs (the
fused launch, ``region_props_partials``, and the histogram alone,
``region_histogram``) and the threshold path's (256, 64, 128) bucket with R
= 2 (the fused launch); queue full and host-paced, the mean of ``--iters``
calls, timed by the running checkout's ``chip_smoke.py``; each output
checked bit for bit against the plain versions first.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
from typing import Dict, List, Optional

from .bench_e2e import LOKI_SEGMENTATION, LOKI_UNET
from .synth import make_loki_tree, write_unet

WALLS = 3  # timed runs a process, after one warm-up

# --norms: the shapes (B, C, H, W) of the haul's path, the train step and the distillation.
PATH = ((16, 32, 1024, 1024), (64, 32, 256, 256), (256, 32, 128, 128))
TRAIN = ((8, 32, 512, 512), (8, 64, 256, 256), (8, 128, 128, 128), (8, 256, 64, 64), (8, 512, 32, 32))
DISTILL = ((8, 32, 128, 128), (8, 64, 64, 64), (8, 128, 32, 32), (8, 256, 16, 16), (8, 512, 8, 8))
NORM_CASES = [("fwd", s) for s in PATH + TRAIN + DISTILL] + [("bwd", s) for s in TRAIN + DISTILL]

# --relabel: K8's (B, H, W) on loki's path, in the perf lab and in the dense haul.
RELABEL_SHAPES = ((8, 1024, 1280), (8, 1024, 1024), (8, 2048, 2560))
RELABEL_R, RELABEL_MIN_AREA = 256, 30
# --region: (B, H, W) and R of the region measurement on loki's path and on
# the threshold path.
REGION_CASES = (((8, 1024, 1280), 64), ((256, 64, 128), 2))
# --anchor: K9's (B, H, W) bool masks in the perf lab and in the dense haul.
ANCHOR_SHAPES = ((8, 1024, 1024), (8, 2048, 2560))
SMOKE = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))), "chip_smoke.py")

# Runs in the checkout's process: argv = data, model, output root, walls, segmentation.
_WORKER = """
import json, sys, time, torch
from maze_image_processing_pipeline_tpu_torch.loki.pipeline import Runner
data, unet, out, n = sys.argv[1], sys.argv[2], sys.argv[3], int(sys.argv[4])
seg = json.loads(sys.argv[5])

def wall(tag):
    t0 = time.perf_counter()
    Runner._configure_and_run({"input": {"path": data}, "segmentation": {"jax": {"model_fn": unet, **seg}},
                               "postprocess": {}, "output": {"target_dir": f"{out}/{tag}", "store_mask": True}})
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    return time.perf_counter() - t0

wall("warm")
print("WALLS " + json.dumps([wall(i) for i in range(n)]), flush=True)
"""

# --predict, in the checkout's process: argv = tasks by name, walls.
_PREDICT_WORKER = """
import json, sys, time, torch
from maze_image_processing_pipeline_tpu_torch.predict.pipeline import Runner
tasks, n = json.loads(sys.argv[1]), int(sys.argv[2])

def wall(task, tag):
    t0 = time.perf_counter()
    Runner._configure_and_run(dict(task, target_dir=f"{task['target_dir']}/{tag}"))
    torch.cuda.synchronize()
    return time.perf_counter() - t0

out = {}
for name, task in tasks.items():
    wall(task, "warm")
    out[name] = [wall(task, i) for i in range(n)]
print("WALLS " + json.dumps(out), flush=True)
"""

# --norms, in the checkout's process: argv = cases, iters.
_NORMS_WORKER = """
import json, sys, time, torch
from chip_smoke import cuda_ms, full_width_step, queued_ms
from maze_image_processing_pipeline_tpu_torch.models import layers
cases, iters = json.loads(sys.argv[1]), int(sys.argv[2])
dev = torch.device("cuda", 0)
gen = torch.Generator(device=dev).manual_seed(0)
out = {}
for kind, shape in cases:
    C, G = shape[1], 8
    w = torch.rand(C, device=dev, generator=gen) + 0.5
    b = torch.randn(C, device=dev, generator=gen)
    for layout in ("NCHW", "channels_last"):
        fmt = torch.channels_last if layout == "channels_last" else torch.contiguous_format
        x = torch.randn(shape, device=dev, generator=gen).to(torch.bfloat16).contiguous(memory_format=fmt)
        if kind == "fwd":
            fn = lambda: layers.group_norm(x, w, b, G)
        else:
            ct = torch.randn(shape, device=dev, generator=gen).to(torch.bfloat16).contiguous(memory_format=fmt)
            stats = layers.group_stats_plain(x, G)
            fn = lambda: layers.group_norm_bwd(x, ct, w, stats, G)
        out[f"{kind} {tuple(shape)} {layout}"] = [queued_ms(fn, iters), cuda_ms(fn, iters)]
        del x, fn
step, state, x, y = full_width_step(dev)
for _ in range(3):
    step(state, x, y)
torch.cuda.synchronize()
t = time.perf_counter()
for _ in range(10):
    step(state, x, y)
torch.cuda.synchronize()
out["train step"] = [(time.perf_counter() - t) / 10 * 1e3]
print("TIMES " + json.dumps(out), flush=True)
"""


# --relabel, in the checkout's process: argv = chip_smoke.py to time by, shapes, R, min_area, iters.
_RELABEL_WORKER = """
import importlib.util, json, sys, torch
spec = importlib.util.spec_from_file_location("smoke_clock", sys.argv[1])
clock = importlib.util.module_from_spec(spec)
spec.loader.exec_module(clock)
from maze_image_processing_pipeline_tpu_torch.ops import label as tl
shapes, R, min_area, iters = json.loads(sys.argv[2]), int(sys.argv[3]), int(sys.argv[4]), int(sys.argv[5])
dev = torch.device("cuda", 0)
out = {}
for shape in shapes:
    lab = torch.from_numpy(clock.region_labels(tuple(shape), R, seed=2)).to(dev)
    fn = lambda x: tl.remove_small_objects(x, min_area, R)
    got, ref = fn(lab), tl.remove_small_objects_plain(lab, min_area, R)
    assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1]), f"K8 differs from its plain version at {shape}"
    cold = clock.l2_cold_inputs(lab)
    plan = getattr(tl, "remove_small_objects_plan", None)
    out[str(tuple(shape))] = [clock.queued_ms(fn, iters, cold), clock.queued_ms(lambda: fn(lab), iters),
                              clock.cuda_ms(lambda: fn(lab), iters), plan(lab, R).route if plan else "three launches"]
    del lab, cold, got, ref
print("TIMES " + json.dumps(out), flush=True)
"""

# --region, in the checkout's process: argv = chip_smoke.py to time by, cases, iters.
_REGION_WORKER = """
import importlib.util, json, sys, torch
import scipy.ndimage as ndi, numpy as np
spec = importlib.util.spec_from_file_location("smoke_clock", sys.argv[1])
clock = importlib.util.module_from_spec(spec)
spec.loader.exec_module(clock)
from maze_image_processing_pipeline_tpu_torch.ops import region_histogram as rh
from maze_image_processing_pipeline_tpu_torch.ops import regionprops_fused as rf
cases, iters = json.loads(sys.argv[2]), int(sys.argv[3])
dev = torch.device("cuda", 0)
out = {}
for shape, R in cases:
    frames = clock.make_frames(*shape, 20, seed=15)
    lab_np = np.stack([ndi.label(f > 60, np.ones((3, 3)))[0] for f in frames]).astype(np.int32)
    lab, img = torch.from_numpy(lab_np).to(dev), torch.from_numpy(frames).to(dev)
    got, ref = rf.region_props_partials(lab, img, R), rf.region_props_partials_plain(lab, img, R)
    assert all(torch.equal(a, b) for a, b in zip(got, ref)), f"the partials differ at {shape}"
    assert torch.equal(got[-1].float(), rh.region_histogram_plain(lab, img, R)), f"the histogram differs at {shape}"
    fns = {"fused": lambda: rf.region_props_partials(lab, img, R),
           "histogram": lambda: rh.region_histogram(lab, img, R)}
    for name, fn in fns.items():
        if name == "histogram" and R == 2:
            continue
        out[f"{tuple(shape)} R={R} {name}"] = [clock.queued_ms(fn, iters), clock.cuda_ms(fn, iters)]
    del lab, img, got, ref
print("TIMES " + json.dumps(out), flush=True)
"""

# --anchor, in the checkout's process: argv = chip_smoke.py to time by, shapes, iters.
_ANCHOR_WORKER = """
import importlib.util, json, sys, torch
spec = importlib.util.spec_from_file_location("smoke_clock", sys.argv[1])
clock = importlib.util.module_from_spec(spec)
spec.loader.exec_module(clock)
from maze_image_processing_pipeline_tpu_torch.ops.anchor import anchor
shapes, iters = json.loads(sys.argv[2]), int(sys.argv[3])
dev = torch.device("cuda", 0)
gen = torch.Generator(device=dev).manual_seed(13)
out = {}
for shape in shapes:
    mask = torch.rand(tuple(shape), device=dev, generator=gen) < 0.3
    cold = clock.l2_cold_inputs(mask)
    for view, lib, pick in (("contiguous", lambda m: m.clone(), lambda m: m),
                            ("transposed", lambda m: m.contiguous(), lambda m: m.transpose(1, 2))):
        x, xs = pick(mask), [(pick(c[0]),) for c in cold]
        assert torch.equal(anchor(x), x.contiguous()), f"K9 differs from its plain version at {shape} {view}"
        for name, fn in (("anchor", anchor), ("library", lib)):
            out[f"{tuple(shape)} {view} {name}"] = [clock.queued_ms(fn, iters, xs), clock.queued_ms(lambda: fn(x), iters),
                                                   clock.cuda_ms(lambda: fn(x), iters)]
    del mask, cold
print("TIMES " + json.dumps(out), flush=True)
"""

# --fixpoint, in the checkout's process: argv = chip_smoke.py to time by, iters.
_FIXPOINT_WORKER = """
import importlib.util, json, sys, torch
spec = importlib.util.spec_from_file_location("smoke_clock", sys.argv[1])
clock = importlib.util.module_from_spec(spec)
spec.loader.exec_module(clock)
from maze_image_processing_pipeline_tpu_torch.ops import label as tl
iters = int(sys.argv[2])
dev = torch.device("cuda", 0)
out = {}
for shape in clock.FIXPOINT_SHAPES:
    B, H, W = shape
    fg_np = clock.make_frames(B, H, W, 20, seed=11) > 50 if shape == clock.FIXPOINT_SHAPES[0] else clock.blob_masks(shape, seed=12)
    fg = torch.from_numpy(fg_np).to(dev)
    lin = torch.arange(1, H * W + 1, dtype=torch.int32, device=dev).reshape(H, W)
    lab0 = torch.where(fg, lin, 2**30)
    for conn in (2, 1):
        lab, sweeps = tl._fixpoint(lab0, fg, conn, 256)
        out[f"{tuple(shape)} {4 * conn}-connected"] = [clock.cuda_ms(lambda: tl._fixpoint(lab0, fg, conn, 256), iters),
                                                     f"labels {int(lab.sum())} sweeps {sweeps.tolist()}"]
print("TIMES " + json.dumps(out), flush=True)
"""


def run_worker(tree: str, worker: str, argv: List[str], marker: str):
    """Runs ``worker`` (Python source) with ``argv`` in a process of its own
    that imports ``tree``'s package; returns the JSON of its line that
    starts with ``marker``."""
    env = dict(os.environ, PYTHONPATH=tree)
    proc = subprocess.run([sys.executable, "-c", worker, *argv], cwd=tree, env=env, capture_output=True, text=True)
    for line in proc.stdout.splitlines():
        if line.startswith(marker + " "):
            return json.loads(line[len(marker) + 1:])
    raise RuntimeError(f"{tree}: rc {proc.returncode}\n{proc.stdout[-2000:]}\n{proc.stderr[-4000:]}")


def run_tree(tree: str, data: str, unet: str, out: str) -> List[float]:
    """The walls of one run of ``tree``'s package, in its own process."""
    return run_worker(tree, _WORKER, [data, unet, out, str(WALLS), json.dumps(LOKI_SEGMENTATION)], "WALLS")


def run_norms(tree: str, iters: int) -> Dict[str, List[float]]:
    """The GroupNorm times of one run of ``tree``'s package (``--norms``)."""
    return run_worker(tree, _NORMS_WORKER, [json.dumps(NORM_CASES), str(iters)], "TIMES")


def run_relabel(tree: str, iters: int) -> Dict[str, list]:
    """K8's times of one run of ``tree``'s package (``--relabel``)."""
    argv = [SMOKE, json.dumps(RELABEL_SHAPES), str(RELABEL_R), str(RELABEL_MIN_AREA), str(iters)]
    return run_worker(tree, _RELABEL_WORKER, argv, "TIMES")


def run_region(tree: str, iters: int) -> Dict[str, list]:
    """The region measurement's times of one run of ``tree``'s package (``--region``)."""
    return run_worker(tree, _REGION_WORKER, [SMOKE, json.dumps(REGION_CASES), str(iters)], "TIMES")


def run_anchor(tree: str, iters: int) -> Dict[str, list]:
    """K9's times of one run of ``tree``'s package (``--anchor``)."""
    return run_worker(tree, _ANCHOR_WORKER, [SMOKE, json.dumps(ANCHOR_SHAPES), str(iters)], "TIMES")


def run_fixpoint(tree: str, iters: int) -> Dict[str, list]:
    """The CCL fixpoint's times of one run of ``tree``'s package (``--fixpoint``)."""
    return run_worker(tree, _FIXPOINT_WORKER, [SMOKE, str(iters)], "TIMES")


def main(argv: Optional[List[str]] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("trees", nargs="+", help="checkouts of this repo, in the order they run")
    ap.add_argument("--workdir", default=None, help="inputs and outputs (default: a new temporary directory)")
    ap.add_argument("--predict", action="store_true", help="time the predict tasks (semseg, polytaxo) instead")
    ap.add_argument("--norms", action="store_true", help="time the GroupNorm kernels instead of the loki task")
    ap.add_argument("--relabel", action="store_true", help="time K8 (small-object removal) instead")
    ap.add_argument("--anchor", action="store_true", help="time K9 (the layout anchor) instead")
    ap.add_argument("--fixpoint", action="store_true", help="time the CCL fixpoint instead")
    ap.add_argument("--region", action="store_true", help="time the region measurement (K7 with K3) instead")
    ap.add_argument("--iters", type=int, default=50,
                    help="--norms, --relabel, --anchor, --fixpoint, --region: timed calls a case")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA card: the walls are taken on the card")
    if args.norms or args.relabel or args.anchor or args.fixpoint or args.region:
        print(f"device={torch.cuda.get_device_name(0)}", flush=True)
        times: Dict[str, List[Dict[str, list]]] = {}
        run = (run_region if args.region else run_fixpoint if args.fixpoint else run_anchor if args.anchor
               else run_relabel if args.relabel else run_norms)
        for tree in map(os.path.abspath, args.trees):
            t = run(tree, args.iters)
            times.setdefault(tree, []).append(t)
            print(f"{tree}: " + ", ".join(f"{k} {' / '.join(v if isinstance(v, str) else f'{v:.4f}' for v in vs)}"
                                          for k, vs in t.items()), flush=True)
        print(json.dumps(times), flush=True)
        return times
    work = args.workdir or tempfile.mkdtemp(prefix="ab_walls_")
    if args.predict:
        return _predict_walls(args.trees, work)
    data = make_loki_tree(os.path.join(work, "data"), n_frames=24, objects_per_frame=20, frame_shape=(1024, 1280),
                          seed=8)
    unet = write_unet(os.path.join(work, "unet"), LOKI_UNET, "bfloat16", seed=6)
    print(f"device={torch.cuda.get_device_name(0)}", flush=True)
    results: Dict[str, List[List[float]]] = {}
    for i, tree in enumerate(args.trees):
        tree = os.path.abspath(tree)
        walls = run_tree(tree, data, unet, os.path.join(work, f"out{i}"))
        results.setdefault(tree, []).append(walls)
        print(f"run {i} {tree}: loki walls {walls}", flush=True)
    print(json.dumps(results), flush=True)
    return results


def _predict_walls(trees: List[str], work: str) -> dict:
    import importlib.util

    import torch

    spec = importlib.util.spec_from_file_location("smoke_tasks", SMOKE)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    inp = smoke.predict_inputs(work)
    print(f"device={torch.cuda.get_device_name(0)}", flush=True)
    results: Dict[str, List[Dict[str, List[float]]]] = {}
    for i, tree in enumerate(trees):
        tree = os.path.abspath(tree)
        tasks = {"semseg": smoke.semseg_task(inp["archive"], inp["unet"], os.path.join(work, f"semseg{i}")),
                 "polytaxo": smoke.polytaxo_task(inp["archive"], inp["clf"], os.path.join(work, f"poly{i}"),
                                                 inp["taxonomy"])}
        walls = run_worker(tree, _PREDICT_WORKER, [json.dumps(tasks), str(WALLS)], "WALLS")
        results.setdefault(tree, []).append(walls)
        print(f"run {i} {tree}: " + "; ".join(f"{k} walls {v}" for k, v in walls.items()), flush=True)
    print(json.dumps(results), flush=True)
    return results


if __name__ == "__main__":
    main()
