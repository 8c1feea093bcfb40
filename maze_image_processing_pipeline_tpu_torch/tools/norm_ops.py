"""The device operations one call of K5 (``group_norm``) and of K6
(``group_norm_bwd``) makes on the card, counted by ``torch.profiler``.

    python -m maze_image_processing_pipeline_tpu_torch.tools.norm_ops [--shape B,C,H,W ...]

For each shape (default: the norms of the haul's path, of the full-width
train step and of the distillation's U-Net), in NCHW and channels_last,
bfloat16, G = 8: one warm-up call of each kernel (the build, the occupancy
query, the counters' buffer), then one call under ``torch.profiler``. The
profiler is warmed once a process (a first session, discarded), and each
session synchronises and pauses 2 ms before and after the call, so that
the call's device activity lies inside the session's window (one session
on the card that launched the kernel once reported no device activity at
all; a kernel that starts at the edge of the window is the suspect, not
confirmed). Prints one JSON line, ``{"cases": [{"shape", "layout",
"mode_fwd", "mode_bwd", "fwd": {activity: count}, "bwd": {...}}, ...]}``:
every kernel, memset and copy on the device during the call. Ends with
``os._exit(0)``: a process that ran ``torch.profiler`` on the card may not
exit by itself.
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


PAUSE_S = 0.002  # idle time in a session before and after the profiled call


def device_activities(fn) -> dict:
    """{name: count} of the device activities while ``fn()`` runs, in one
    profiler session."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        time.sleep(PAUSE_S)
        fn()
        torch.cuda.synchronize()
        time.sleep(PAUSE_S)
    return {e.key: e.count for e in prof.key_averages() if e.device_type == DeviceType.CUDA and not e.is_user_annotation}


def count(shapes) -> list:
    import torch

    from ..models import layers

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    warm = torch.zeros(1, device=dev)
    device_activities(lambda: warm.add_(1))  # the process's first session, discarded
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


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--shape", action="append", default=None, help="B,C,H,W (repeatable)")
    args = ap.parse_args(argv)
    shapes = [tuple(int(v) for v in s.split(",")) for s in args.shape] if args.shape else SHAPES
    print(json.dumps({"cases": count(shapes)}), flush=True)
    sys.stderr.flush()
    os._exit(0)


if __name__ == "__main__":
    main()
