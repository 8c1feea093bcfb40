"""Phase 9's distillation gate for two or more checkouts of this repo:
how many of phase 6's 480 planted objects a distilled loki U-Net finds,
and how far each checkout's GroupNorm statistics lie from float64 on the
activations of that run::

    python -m maze_image_processing_pipeline_tpu_torch.tools.distill_probe TREE [TREE ...]
        [--seeds 0 ...] [--lr-jitter 0 ...] [--cross] [--workdir DIR]

Run from the root of a checkout. The loki inputs (24 frames of 1024×1280,
20 planted objects each) are made once, here. Each TREE then runs in a
process of its own that imports that checkout's package and, for each seed
and jitter, distils ``UNet(1, 32, 4)`` bf16 by ``fit`` for 200 steps of
``vignette_batches(1)`` at (8, 128, 128, 3) with TF32 off, as phase 9 does
(``fit``'s ``seed`` sets the initial weights; jitter k scales the learning
rate by 1 + k·1e-6, a perturbation that touches no GroupNorm), and saves
the model. Then each TREE runs phase 6's loki task on the models it saved
or, with ``--cross``, on every saved model, so that a count can be told
apart by the kernels that trained the model and the kernels that ran it.

Every K5 call of a run is audited: the rstd it returns against the rstd of
float64 sums of the same input (the formula's own error, ``rstd_rel``),
beside the same for the plain version (``group_stats_plain``) on that
input, and the largest mean²/var of a group (how much the formula's
E[x²] − mean² cancels). Prints the count that the distillation's teacher
(a threshold) finds in the same frames, one line a run and a JSON object
of all runs. Takes the card.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
from typing import List, Optional

from .ab_walls import run_worker

# Runs in the checkout's process: argv = jobs (JSON), data, workdir, tag.
_WORKER = """
import hashlib, json, os, sys, torch
sys.path.insert(0, os.getcwd())
from chip_smoke import LOKI_UNET, check_archive, loki_task, run_loki
from maze_image_processing_pipeline_tpu_torch.models import layers, train_loop
from maze_image_processing_pipeline_tpu_torch.models.model_io import save_model
from maze_image_processing_pipeline_tpu_torch.models.unet import UNet
from maze_image_processing_pipeline_tpu_torch.tools.synth import vignette_batches
jobs, data, work, tag = json.loads(sys.argv[1]), sys.argv[2], sys.argv[3], sys.argv[4]
torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
dev = torch.device("cuda", 0)
forward = layers._group_norm_forward
audit = {}

def audited(x, w, b, G, eps):
    y, stats = forward(x, w, b, G, eps)
    with torch.no_grad():
        B = x.shape[0]
        xd = x.double().contiguous().reshape(B, G, -1)
        mean = xd.mean(-1)
        var = ((xd - mean[..., None]) ** 2).mean(-1)
        rstd = torch.rsqrt(var + eps).reshape(-1)
        ratio = float((mean * mean / var.clamp_min(1e-300)).max())
        plain = layers.group_stats_plain(x, G, eps)[1].double()
        err = float(((stats[1].double() - rstd).abs() / rstd).max())
        perr = float(((plain - rstd).abs() / rstd).max())
    key = f"{tuple(x.shape)} {'CL' if not x.is_contiguous() else 'NCHW'}"
    a = audit.setdefault(key, [0, 0.0, 0.0, 0.0])
    a[0] += 1
    a[1], a[2], a[3] = max(a[1], err), max(a[2], perr), max(a[3], ratio)
    return y, stats

layers._group_norm_forward = audited
make_step = train_loop.make_train_step

def summary():
    out = {k: {"calls": v[0], "rstd_rel": v[1], "plain_rstd_rel": v[2], "mean2_over_var": v[3]}
           for k, v in sorted(audit.items())}
    audit.clear()
    return out

results = []
for job in jobs:
    if job["kind"] == "train":
        losses = []

        def recording_step(*a, **k):
            step = make_step(*a, **k)

            def run(state, images, targets):
                state, metrics = step(state, images, targets)
                losses.append(float(metrics["loss"]))
                return state, metrics
            return run

        train_loop.make_train_step = recording_step
        module = UNet(**LOKI_UNET, dtype="bfloat16")
        train_loop.fit(module, vignette_batches(1), 200, input_shape=(8, 128, 128, 3), log_interval=1e9,
                       device=dev, seed=job["seed"], learning_rate=1e-3 * (1 + 1e-6 * job["jitter"]))
        torch.cuda.synchronize()
        train_loop.make_train_step = make_step
        save_model(job["model"], module, outputs={"pred": {"channel_names": ["foreground"]}})
        h = hashlib.sha256()
        for p in module.parameters():
            h.update(p.detach().float().cpu().numpy().tobytes())
        res = {"losses": [losses[i] for i in (0, 1, 10, 50, 100, 150, 199)], "weights": h.hexdigest()[:16]}
    else:
        out = os.path.join(work, f"out_{tag}_{os.path.basename(job['model'])}")
        run_loki(loki_task(data, job["model"], out))
        res = {"objects": check_archive(os.path.join(out, "LOKI_PS122-1_7.zip"))[0]}
    res["audit"] = summary()
    results.append({**job, **res})
print("RESULTS " + json.dumps(results), flush=True)
"""


def stitched_frames(data: str) -> list:
    """Phase 6's frames: the vignettes of the LOKI sample at ``data``
    pasted at their positions on a black canvas in file-name order, a
    uint8 (H, W) array a frame."""
    import glob

    import numpy as np

    from ..dataio.imageio import decode_image

    crops = {}
    for fn in sorted(glob.glob(os.path.join(data, "Pictures", "*", "*.png"))):
        date, time, ms, _, posx, posy = os.path.basename(fn)[:-4].split()
        with open(fn, "rb") as f:
            crops.setdefault((date, time, ms), []).append((decode_image(f.read()), int(posy), int(posx)))
    frames = []
    for members in crops.values():
        frame = np.zeros((max(oy + c.shape[0] for c, oy, _ in members), max(ox + c.shape[1] for c, _, ox in members)),
                         np.uint8)
        for c, oy, ox in members:
            frame[oy : oy + c.shape[0], ox : ox + c.shape[1]] = c
        frames.append(frame)
    return frames


def count_objects(mask) -> int:
    """Objects of a boolean (H, W) mask under phase 6's postprocess: a
    closing of radius 2, then components of at least 30 pixels."""
    import numpy as np
    from scipy import ndimage as ndi

    yy, xx = np.mgrid[-2:3, -2:3]
    labels, _ = ndi.label(ndi.binary_closing(mask, yy * yy + xx * xx <= 4))
    return int((np.bincount(labels.ravel())[1:] >= 30).sum())


def threshold_count(data: str) -> int:
    """The objects that the distillation's teacher (intensity above 100)
    finds in phase 6's frames: the count of a perfectly distilled model."""
    return sum(count_objects(frame > 100) for frame in stitched_frames(data))


def run_tree(tree: str, jobs: list, data: str, work: str, tag: str) -> list:
    """The results of ``jobs`` in ``tree``'s package, in its own process."""
    return run_worker(tree, _WORKER, [json.dumps(jobs), data, work, tag], "RESULTS")


def main(argv: Optional[List[str]] = None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("trees", nargs="+", help="checkouts of this repo, in the order they run")
    ap.add_argument("--seeds", type=int, nargs="+", default=[0])
    ap.add_argument("--lr-jitter", type=int, nargs="+", default=[0])
    ap.add_argument("--cross", action="store_true", help="count every tree's models with every tree's kernels")
    ap.add_argument("--workdir", default=None, help="inputs and outputs (default: a new temporary directory)")
    args = ap.parse_args(argv)
    import torch

    from .synth import make_loki_tree

    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA card: the probe distils on the card")
    work = args.workdir or tempfile.mkdtemp(prefix="distill_probe_")
    data = make_loki_tree(os.path.join(work, "data"), n_frames=24, objects_per_frame=20, frame_shape=(1024, 1280),
                          seed=8)
    trees = [os.path.abspath(t) for t in args.trees]
    print(f"device={torch.cuda.get_device_name(0)}", flush=True)
    print(f"a threshold at 100 finds {threshold_count(data)} objects in the frames", flush=True)
    results, models = [], {}
    for i, tree in enumerate(trees):
        jobs = [{"kind": "train", "tree": i, "seed": s, "jitter": j, "model": os.path.join(work, f"unet_t{i}_s{s}_j{j}")}
                for s in args.seeds for j in args.lr_jitter]
        models[i] = [j["model"] for j in jobs]
        results += run_tree(tree, jobs, data, work, f"t{i}")
    for i, tree in enumerate(trees):
        mine = [m for k in models for m in models[k]] if args.cross else models[i]
        results += run_tree(tree, [{"kind": "count", "tree": i, "model": m} for m in mine], data, work, f"t{i}")
    for r in results:
        brief = {k: v for k, v in r.items() if k != "audit"}
        worst = max(r["audit"].values(), key=lambda a: a["rstd_rel"], default=None)
        print(f"{brief} worst K5 rstd error {worst}", flush=True)
    print(json.dumps(results), flush=True)
    return results


if __name__ == "__main__":
    main()
