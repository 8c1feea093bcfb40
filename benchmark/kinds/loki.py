"""``maze-ipp loki`` hauls: the driver of the loki configurations.

A unit is one LOKI sample tree (a haul), re-segmented by
``loki.pipeline.Runner._configure_and_run(task)`` into an EcoTaxa archive;
its work is its frames. The pool holds ``traffic["pool"]`` hauls drawn from
the seed; the window runs them in turn.

The check follows one frame group a haul (drawn from the seed) through the
device node: the stitched frames it uploaded, the blended maps of its U-Net,
the labels of its frame chain and its objects' rows in the haul's archive.
"""

from __future__ import annotations

import glob
import os
import shutil
from types import SimpleNamespace

import numpy as np
import torch

from benchmark import reference as ref
from benchmark.harness import derive_seed
from benchmark.synth import make_loki_tree, read_archive_rows

NODE = "maze_image_processing_pipeline_tpu_torch.loki.device_seg:DeviceTiledSegmentation.node_class"
# The node's calls, for the readers of host spans; the U-Net's tiles and
# their size, for the FLOP count.
NODE_SPANS = {"loki.dispatch": NODE + "._dispatch_group", "loki.finish": NODE + "._finish_group"}
TILE_CALL = (NODE + "._predict", 2)


def tile_size(config):
    return config["task"]["segmentation"]["tile_size"]


def make_pool(config, traffic, seed, root):
    pool = []
    for k in range(int(traffic["pool"])):
        path = os.path.join(root, f"haul{k}")
        crop_range = traffic.get("crop_size_range")
        _, frames = make_loki_tree(path, int(traffic["frames"]), tuple(traffic["objects_per_frame"]),
                                   tuple(traffic["frame_shape"]), seed=derive_seed(seed, k),
                                   layout_seed=derive_seed(traffic["layout_seed"], k),
                                   crop_size_range=tuple(map(tuple, crop_range)) if crop_range else None)
        pool.append(SimpleNamespace(index=k, path=path, frames=frames, work={"frames": float(len(frames))},
                                    planted=sum(len(v) for v in frames.values())))
    return pool


def task(config, unit, model_dir, out_dir, dev):
    seg = dict(config["task"]["segmentation"])
    return {"input": {"path": unit.path},
            "segmentation": {"jax": {"model_fn": model_dir, **seg, "device": dev.type}},
            "postprocess": {}, "output": {"target_dir": out_dir}}


def run_unit(config, unit, model_dir, out_dir, dev):
    from maze_image_processing_pipeline_tpu_torch.loki.pipeline import Runner

    Runner._configure_and_run(task(config, unit, model_dir, out_dir, dev))
    if not glob.glob(os.path.join(out_dir, "*.zip")):
        raise RuntimeError(f"the Runner wrote no archive to {out_dir}")


def warm_up(config, weights, pool, workdir, dev):
    """One haul through the Runner, then the U-Net at every tile batch the
    node can form (1 to ``batch_size`` tiles)."""
    from maze_image_processing_pipeline_tpu_torch.models.inference import default_device_pre
    from maze_image_processing_pipeline_tpu_torch.models.model_io import load_model

    run_unit(config, pool[0], weights["model_dir"], workdir, dev)
    rows = read_archive_rows(glob.glob(os.path.join(workdir, "*.zip"))[0])
    seg = config["task"]["segmentation"]
    module = load_model(weights["model_dir"], dtype=seg["dtype"]).module.to(dev).eval()
    ts = seg["tile_size"]
    with torch.inference_mode():
        for n in range(1, seg["batch_size"] + 1):
            module(default_device_pre(torch.zeros((n, ts, ts), dtype=torch.uint8, device=dev)))
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    del module
    return f"{len(rows)} objects found in a haul of {pool[0].planted} planted vignettes"


class State:
    """The captures: one frame group a haul, drawn from the seed."""

    def __init__(self, config, traffic, seed):
        self.rng = np.random.default_rng(derive_seed(seed, 1 << 20))
        self.span = int(traffic["check_group_range"])
        self.captured = []
        self.unit = None
        self.kept = {}

    def begin(self, i, unit):
        self.unit, self.index, self.group = unit, i, 0
        self.pick = int(self.rng.integers(0, self.span))
        self.sampled, self.pred = False, None

    def end(self, i, unit, out_dir, ok, kept_dir):
        if ok and any(c["haul"] == i for c in self.captured):
            os.makedirs(kept_dir, exist_ok=True)
            src = glob.glob(os.path.join(out_dir, "*.zip"))[0]
            self.kept[i] = shutil.move(src, os.path.join(kept_dir, f"loki{i}.zip"))


def install_captures(rec, state):
    def before_dispatch(args, kwargs):
        state.sampled = state.group == state.pick

    def after_predict(args, kwargs, out):
        if state.sampled:
            state.pred = out

    def after_dispatch(args, kwargs, g):
        if state.sampled:
            state.captured.append({"haul": state.index, "unit": state.unit, "g": g, "pred": state.pred})
            state.sampled = False
        state.group += 1

    rec.wrap(NODE + "._dispatch_group", before=before_dispatch, after=after_dispatch)
    rec.wrap(NODE + "._predict", after=after_predict)


def collect(config, state, dev):
    """The checked frame groups (drawn from the seed among the captured),
    their device results on the host; the program's tensors freed."""
    picks = [c for c in state.captured if c["haul"] in state.kept]
    if len(picks) > config["check"]["max_groups"]:
        keep = state.rng.choice(len(picks), config["check"]["max_groups"], replace=False)
        picks = [picks[j] for j in sorted(keep)]
    for c in picks:  # device results to the host, then free the program's tensors
        g = c["g"]
        c.update(imgs=g.imgs, dims=g.dims, pred=c["pred"].float().cpu().numpy(), labels=g.labels.cpu().numpy())
        del c["g"]
    state.captured = []
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return picks


def judge(config, weights, picks, state, dev, log, control_mode=None):
    """Each stage against the reference. With ``control_mode``, the
    reference in that mode stands in for the program's U-Net maps (the
    control: only the map numbers mean anything then)."""
    seg = config["task"]["segmentation"]
    post = seg["postprocess"]
    ts, stride = seg["tile_size"], seg["tile_stride"]
    limits = config["limits"]
    net = ref.reference_net(config["model"], weights["state"], dev)
    n = {"frames": 0, "stitch_mismatch": 0, "labels_mismatch_px": 0, "rows_missing": 0, "rows_extra": 0,
         "feature_mismatches": 0, "rows": 0}
    gap_max, gap_sum, gap_n, flips, fg = 0.0, 0.0, 0.0, 0.0, 0.0
    for c in picks:
        unit = c["unit"]
        by_hash = {}
        for fid, members in unit.frames.items():
            fr = ref.stitch(members)
            by_hash[(fr.shape, hash(fr.tobytes()))] = (fid, fr)
        rows = {}
        for row in read_archive_rows(state.kept[c["haul"]]):
            rows.setdefault(row["object_frame_id"], {})[int(row["object_sequence"])] = row
        Hb, Wb = c["imgs"].shape[1:]
        for b, (H, W) in enumerate(c["dims"]):
            n["frames"] += 1
            img = c["imgs"][b]
            hit = by_hash.get(((H, W), hash(img[:H, :W].tobytes())))
            if hit is None or img[H:].any() or img[:, W:].any():
                n["stitch_mismatch"] += 1
                continue
            fid, frame = hit
            want_bucket = (-(-max(H, ts) // 256) * 256, -(-max(W, ts) // 256) * 256)
            if want_bucket != (Hb, Wb):
                n["stitch_mismatch"] += 1
                continue
            want = ref.tile_maps(net, frame, (Hb, Wb), ts, stride, ref.REFERENCE, dev, skip_empty=True)[..., 0]
            got = c["pred"][b]
            if control_mode is not None:
                got = ref.tile_maps(net, frame, (Hb, Wb), ts, stride, control_mode, dev, skip_empty=True)[..., 0]
            gaps = ref.map_gaps(got, want)
            gap_max = max(gap_max, gaps["max"])
            gap_sum += gaps["sum"]
            gap_n += gaps["n"]
            flips += gaps["flips"]
            fg += float((want > 0.5).sum())
            labels = ref.frame_chain(got, post["closing_radius"], post["min_area"])
            n["labels_mismatch_px"] += int((labels != c["labels"][b]).sum())
            expect = ref.region_rows(labels[:H, :W], frame)
            have = rows.get(fid, {})
            n["rows_missing"] += len(set(expect) - set(have))
            n["rows_extra"] += len(set(have) - set(expect))
            for r in set(expect) & set(have):
                n["rows"] += 1
                for k, v in expect[r].items():
                    if k.startswith("_") or (k == "angle" and expect[r]["_round"]):
                        continue
                    if ref.feature_gap(k, float(have[r]["object_" + k]), v):
                        n["feature_mismatches"] += 1
                        if n["feature_mismatches"] <= 5:
                            log(f"feature {k} of {fid} region {r}: program {have[r]['object_' + k]}, reference {v}")
    log(f"checked {len(picks)} frame groups: {n['frames']} frames, {n['rows']} archive rows, "
        f"{fg:.0f} reference foreground pixels")
    checks = {
        "frames_checked_short": (float(max(0, config["check"]["min_frames"] - n["frames"])), 0.0),
        "stitch_mismatch": (float(n["stitch_mismatch"]), 0.0),
        "map_max_gap": (gap_max, limits["map_max_gap"]),
        "map_mean_gap": (gap_sum / max(gap_n, 1.0), limits["map_mean_gap"]),
        "mask_flip_share": (flips / max(fg, 1.0), limits["mask_flip_share"]),
        "labels_mismatch_px": (float(n["labels_mismatch_px"]), 0.0),
        "rows_missing": (float(n["rows_missing"] + n["rows_extra"]), 0.0),
        "feature_mismatches": (float(n["feature_mismatches"]), 0.0),
    }
    return checks

