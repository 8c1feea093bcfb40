"""The device operations one call of K5 (``group_norm``) and of K6
(``group_norm_bwd``), with ``--relabel`` of K8 (``remove_small_objects``),
with ``--anchor`` of K9 (``anchor``) and its library calls, or with
``--routes`` of the device-memory routes of K8 and the region measurement
(K7 with K3), makes on the card, counted by ``torch.profiler``.

    python -m maze_image_processing_pipeline_tpu_torch.tools.norm_ops [--shape B,C,H,W ...]
    python -m maze_image_processing_pipeline_tpu_torch.tools.norm_ops --relabel [--shape B,H,W ...]
    python -m maze_image_processing_pipeline_tpu_torch.tools.norm_ops --anchor [--shape B,H,W ...]
    python -m maze_image_processing_pipeline_tpu_torch.tools.norm_ops --routes

For each shape (default: the norms of the haul's path, of the full-width
train step and of the distillation's U-Net), in NCHW and channels_last,
bfloat16, G = 8: one warm-up call of each kernel (the build, the occupancy
query, the counters' buffer), then one call under ``torch.profiler``, in a
session that runs a control kernel first and counts only where it saw
the control (``device_activities``); the session synchronises and pauses
2 ms before and after the call. Prints one JSON line,
``{"cases": [{"shape", "layout", "mode_fwd", "mode_bwd", "fwd": {activity:
count}, "bwd": {...}}, ...], "blind_sessions": n}``: every kernel, memset
and copy on the device during the call, and the sessions discarded. With
``--relabel``, for each shape (default ``RELABEL_SHAPES``: loki's frames,
the perf lab's and the dense haul's) int32 labels with ids in [-2, R + 44),
R = 256, min_area 30: one warm-up call, then one under the profiler;
prints ``{"relabel": [{"shape", "route", "cluster", "ops": {activity:
count}}, ...], "blind_sessions": n}``. With ``--anchor``, for each shape
(default ``ANCHOR_SHAPES``: the perf lab's and the dense haul's) a bool mask,
contiguous and as its transposed view: one call of K9 and one of the
library call that computes the same (``Tensor.clone()``, ``.contiguous()``)
under the profiler; prints ``{"anchor": [{"shape", "view", "anchor":
{activity: count}, "library": {...}}, ...], "blind_sessions": n}``. With
``--routes``, for each of ``ROUTE_CASES`` (the device-memory routes'
cases that ``chip_smoke.py`` times, on ``synth.large_id_labels``' frames):
one warm-up call, then one under the profiler; prints ``{"routes":
[{"kernel", "shape", "R", "route", "ops": {activity: [count, device
us]}}, ...], "blind_sessions": n}``. Ends with ``os._exit(0)``: a
process that ran ``torch.profiler`` on the card may not exit by itself.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

SHAPES = (
    (16, 32, 1024, 1024), (64, 32, 256, 256), (256, 32, 128, 128),  # loki, semseg, classifier
    (8, 32, 512, 512), (8, 512, 32, 32),  # the train step's first and last
    (8, 32, 128, 128), (8, 64, 64, 64), (8, 128, 32, 32), (8, 256, 16, 16), (8, 512, 8, 8),  # distillation
)


RELABEL_SHAPES = ((8, 1024, 1280), (8, 1024, 1024), (8, 2048, 2560))
RELABEL_R, RELABEL_MIN_AREA = 256, 30
ANCHOR_SHAPES = ((8, 1024, 1024), (8, 2048, 2560))
# (wrapper, (B, H, W), R, labels' seed) of the device-memory routes: K8 on
# loki's frames with R = 40000 and at R = 70000, the fused measurement at R
# = 4096 and the histogram alone at R = 2^15 (chip_smoke.py's
# RELABEL_C5[0] and DEVICE_ROUTE_TIMED, the same seeds; intensity of seed 41).
ROUTE_CASES = (
    ("remove_small_objects", (8, 1024, 1280), 40000, 30),
    ("remove_small_objects", (1, 512, 512), 70000, 31),
    ("regionprops_fused", (2, 256, 1280), 4096, 40),
    ("region_histogram", (2, 256, 1280), 1 << 15, 40),
)

PAUSE_S = 0.002  # idle time in a session before and after the profiled call
BLIND_WAIT_S, BLIND_SESSIONS = 5.0, 60  # a session that saw no device activity: wait, run it again
CONTROL = "spin_kernel"  # the kernel of torch.cuda._sleep, each session's control


def device_activities(fn, timed: bool = False) -> dict:
    """{name: count} (with ``timed``, {name: [count, device us]}) of the
    device activities while ``fn()`` runs, in one
    profiler session that also runs a control kernel (``torch.cuda._sleep``)
    before the call. A session whose trace lacks the control recorded
    nothing on the device (the profiler was blind: on the card whole
    minutes of sessions came back empty, in every checkout alike, then
    none); it is discarded and run again after ``BLIND_WAIT_S``, up to
    ``BLIND_SESSIONS`` times. The control is left out of the counts."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(BLIND_SESSIONS):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            torch.cuda._sleep(1000)
            torch.cuda.synchronize()
            time.sleep(PAUSE_S)
            fn()
            torch.cuda.synchronize()
            time.sleep(PAUSE_S)
        found = {e.key: [e.count, e.device_time_total] for e in prof.key_averages()
                 if e.device_type == DeviceType.CUDA and not e.is_user_annotation}
        if any(CONTROL in k for k in found):
            return {k: v if timed else v[0] for k, v in found.items() if CONTROL not in k}
        device_activities.blind += 1
        time.sleep(BLIND_WAIT_S)
    raise RuntimeError(f"torch.profiler recorded no device activity in {BLIND_SESSIONS} sessions")


device_activities.blind = 0  # sessions discarded as blind in this process


def count(shapes) -> list:
    import torch

    from ..models import layers

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    cases = []
    for shape in shapes:
        C, G = shape[1], 8
        w = torch.rand(C, device=dev, generator=gen) + 0.5
        b = torch.randn(C, device=dev, generator=gen)
        for layout in ("NCHW", "channels_last"):
            fmt = torch.channels_last if layout == "channels_last" else torch.contiguous_format
            x = torch.randn(shape, device=dev, generator=gen).to(torch.bfloat16).contiguous(memory_format=fmt)
            ct = torch.randn(shape, device=dev, generator=gen).to(torch.bfloat16).contiguous(memory_format=fmt)
            _, stats = layers._group_norm_forward(x, w, b, G, 1e-6)
            layers.group_norm_bwd(x, ct, w, stats, G)
            cases.append({
                "shape": list(shape), "layout": layout,
                "mode_fwd": layers.group_norm_plan(x, G).mode,
                "mode_bwd": layers.group_norm_plan(x, G, backward=True).mode,
                "fwd": device_activities(lambda: layers._group_norm_forward(x, w, b, G, 1e-6)),
                "bwd": device_activities(lambda: layers.group_norm_bwd(x, ct, w, stats, G)),
            })
            del x, ct, stats
    return cases


def count_relabel(shapes) -> list:
    import torch

    from ..ops import label as tl

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    cases = []
    for shape in shapes:
        lab = torch.randint(-2, RELABEL_R + 44, shape, device=dev, generator=gen, dtype=torch.int32)
        tl.remove_small_objects(lab, RELABEL_MIN_AREA, RELABEL_R)
        plan = tl.remove_small_objects_plan(lab, RELABEL_R)
        ops = device_activities(lambda: tl.remove_small_objects(lab, RELABEL_MIN_AREA, RELABEL_R))
        cases.append({"shape": list(shape), "route": plan.route, "cluster": plan.cluster, "ops": ops})
        del lab
    return cases


def count_anchor(shapes) -> list:
    import torch

    from ..ops.anchor import anchor

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    cases = []
    for shape in shapes:
        mask = torch.rand(shape, device=dev, generator=gen) < 0.3
        for view, x, library in (("contiguous", mask, mask.clone), ("transposed", mask.transpose(1, 2),
                                                                      mask.transpose(1, 2).contiguous)):
            anchor(x)
            library()
            cases.append({"shape": list(shape), "view": view, "anchor": device_activities(lambda: anchor(x)),
                          "library": device_activities(library)})
        del mask
    return cases


def count_routes() -> list:
    import numpy as np
    import torch

    from ..ops import label as tl
    from ..ops import region_histogram as rh
    from ..ops import regionprops_fused as rf
    from .synth import large_id_labels

    dev = torch.device("cuda", 0)
    cases = []
    for kernel, shape, R, seed in ROUTE_CASES:
        lab = torch.from_numpy(large_id_labels(shape, R, seed)).to(dev)
        img = torch.from_numpy(np.random.default_rng(41).integers(0, 256, shape, dtype=np.uint8)).to(dev)
        if kernel == "remove_small_objects":
            route = tl.remove_small_objects_plan(lab, R).route
            fn = lambda: tl.remove_small_objects(lab, RELABEL_MIN_AREA, R)  # noqa: E731
        else:
            route = rh.region_measure_plan(shape[-1], R, kernel == "regionprops_fused", True).route
            fn = ((lambda: rf.region_props_partials(lab, img, R)) if kernel == "regionprops_fused"
                  else (lambda: rh.region_histogram(lab, img, R)))
        fn()
        cases.append({"kernel": kernel, "shape": list(shape), "R": R, "route": route,
                      "ops": device_activities(fn, timed=True)})
        del lab, img
    return cases


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--shape", action="append", default=None,
                    help="B,C,H,W, or B,H,W with --relabel or --anchor (repeatable)")
    ap.add_argument("--relabel", action="store_true", help="count K8's device operations instead")
    ap.add_argument("--anchor", action="store_true", help="count K9's and its library calls' device operations")
    ap.add_argument("--routes", action="store_true", help="time the device-memory routes' device operations")
    args = ap.parse_args(argv)
    shapes = [tuple(int(v) for v in s.split(",")) for s in args.shape] if args.shape else None
    if args.routes:
        out = {"routes": count_routes()}
    elif args.anchor:
        out = {"anchor": count_anchor(shapes or ANCHOR_SHAPES)}
    elif args.relabel:
        out = {"relabel": count_relabel(shapes or RELABEL_SHAPES)}
    else:
        out = {"cases": count(shapes or SHAPES)}
    print(json.dumps(dict(out, blind_sessions=device_activities.blind)), flush=True)
    sys.stderr.flush()
    os._exit(0)


if __name__ == "__main__":
    main()
