"""``maze-ipp predict`` semantic segmentation: the driver of the predict
configurations.

A unit is one EcoTaxa crop archive, run by
``predict.pipeline.Runner._configure_and_run(task)``: the tiled U-Net, the
fused segment measurement, the ``.h5`` export and the measurement archive;
its work is its objects. The pool holds ``traffic["pool"]`` archives drawn
from the seed; the window runs them in turn.

The check follows one chunk an archive (drawn from the seed) through the
device node: the crops it decoded, the blended maps of every bucket, the
measurement archive's rows of its objects and their maps as the ``.h5``
file on disk holds them (read back by :mod:`benchmark.h5read`).
"""

from __future__ import annotations

import glob
import os
import shutil
import struct
import zlib
from types import SimpleNamespace

import numpy as np
import torch

from benchmark import reference as ref
from benchmark.h5read import H5Error, read_datasets
from benchmark.harness import derive_seed
from benchmark.synth import crop_sizes, make_crop_archive, read_archive_rows

NODE = "maze_image_processing_pipeline_tpu_torch.models.inference:DeviceTiledInference.node_class"
MEASURE = "maze_image_processing_pipeline_tpu_torch.ops.segment_measure:measure_channels_packed"
# The node's calls, for the readers of host spans; the U-Net's tiles and
# their size, for the FLOP count.
NODE_SPANS = {"predict.chunk": NODE + "._run_chunk", "predict.unpack": NODE + "._unpack_chunk"}
TILE_CALL = (NODE + "._forward", 1)


def tile_size(config):
    return config["task"]["model"]["tiling"]["size"]


# The fused measurement's bound: a channel of more components is measured on
# the host (``DeviceTiledInference``'s ``num_segments`` 32, the background 0).
MAX_COMPONENTS = 31


def make_pool(config, traffic, seed, root):
    os.makedirs(root, exist_ok=True)
    pool = []
    for k in range(int(traffic["pool"])):
        s = derive_seed(seed, k)
        sizes = crop_sizes(np.random.default_rng(derive_seed(traffic["layout_seed"], k)), int(traffic["objects"]),
                           tuple(map(tuple, traffic["crop_size_range"])))
        sizes = [sizes[i] for i in np.random.default_rng(s).permutation(len(sizes))]
        fn = os.path.join(root, f"archive{k}.zip")
        crops = make_crop_archive(fn, sizes, seed=derive_seed(s, 1), intensity=int(traffic["intensity"]),
                                  core=traffic.get("core_intensity"))
        by_hash = {(c.shape, hash(c.tobytes())): oid for oid, c in crops.items()}
        pool.append(SimpleNamespace(index=k, path=fn, crops=crops, by_hash=by_hash,
                                    work={"objects": float(len(crops))}))
    return pool


def task(config, unit, model_dir, out_dir, dev):
    t = config["task"]
    return {"input": {"path": unit.path},
            "model": {"model_fn": model_dir, **t["model"], "device": dev.type},
            "save_raw_h5": True, "segmentation": dict(t["segmentation"]), "target_dir": out_dir}


def run_unit(config, unit, model_dir, out_dir, dev):
    from maze_image_processing_pipeline_tpu_torch.predict.pipeline import Runner

    Runner._configure_and_run(task(config, unit, model_dir, out_dir, dev))
    if not glob.glob(os.path.join(out_dir, "*.segmentation.zip")):
        raise RuntimeError(f"the Runner wrote no measurement archive to {out_dir}")


def warm_up(config, weights, pool, workdir, dev):
    """One archive through the Runner (the U-Net runs at one batch shape)."""
    run_unit(config, pool[0], weights["model_dir"], workdir, dev)
    rows = read_archive_rows(glob.glob(os.path.join(workdir, "*.segmentation.zip"))[0])
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return f"{len(rows)} rows measured of {len(pool[0].crops)} crops"


class State:
    """The captures: one chunk an archive, drawn from the seed."""

    def __init__(self, config, traffic, seed):
        self.rng = np.random.default_rng(derive_seed(seed, 1 << 20))
        self.span = max(1, int(traffic["objects"]) // int(config["task"]["model"]["tiling"]["chunk_size"]))
        self.captured = []
        self.kept = {}
        self.bucket = None

    def begin(self, i, unit):
        self.unit, self.index, self.chunk = unit, i, 0
        self.pick = int(self.rng.integers(0, self.span))
        self.bucket = None

    def end(self, i, unit, out_dir, ok, kept_dir):
        if ok and any(c["haul"] == i for c in self.captured):
            os.makedirs(kept_dir, exist_ok=True)
            zips = glob.glob(os.path.join(out_dir, "*.segmentation.zip"))
            h5s = glob.glob(os.path.join(out_dir, "*.h5"))
            self.kept[i] = (shutil.move(zips[0], os.path.join(kept_dir, f"semseg{i}.zip")),
                            shutil.move(h5s[0], os.path.join(kept_dir, f"semseg{i}.h5")) if h5s else None)


def _key(img) -> tuple:
    """A decoded crop's (shape, hash) as the pool keys its drawn crops; a
    grey crop decoded to equal channels keys as its first."""
    img = np.asarray(img)
    if img.ndim == 3 and (img == img[..., :1]).all():
        img = img[..., 0]
    img = np.ascontiguousarray(img)
    return img.shape, hash(img.tobytes())


def install_captures(rec, state):
    def after_chunk(args, kwargs, out):
        state.chunk += 1

    def before_bucket(args, kwargs):
        _, images, idxs = args[:3]
        if state.chunk != state.pick:
            return
        ids = [state.unit.by_hash.get(_key(images[i])) for i in idxs]
        state.bucket = {"haul": state.index, "unit": state.unit, "images": [images[i] for i in idxs], "ids": ids}

    def after_measure(args, kwargs, out):
        if state.bucket is not None:
            state.bucket.update(canvas=args[0], hs=list(args[1]), ws=list(args[2]), stats=out)
            state.captured.append(state.bucket)
            state.bucket = None

    rec.wrap(NODE + "._run_chunk", after=after_chunk)
    rec.wrap(NODE + "._run_bucket", before=before_bucket)
    rec.wrap(MEASURE, after=after_measure)


def collect(config, state, dev):
    """The captured buckets, their device results on the host; the
    program's tensors freed. The measurement's buffer starts with raw
    area, area, major axis and overflow, each (C, Bo)."""
    picks = [c for c in state.captured if c["haul"] in state.kept]
    hauls = sorted({c["haul"] for c in picks})
    if len(hauls) > config["check"]["max_chunks"]:
        keep = set(state.rng.choice(hauls, config["check"]["max_chunks"], replace=False).tolist())
        picks = [c for c in picks if c["haul"] in keep]
    for c in picks:
        canvas = c.pop("canvas")
        Bo, Hq, _, C = canvas.shape
        c["canvas"] = canvas.cpu().numpy()
        small = c.pop("stats").cpu().numpy()[: C * 4 * Bo].reshape(C, 4, Bo)
        c["overflow"] = small[:, 3, :] > 0
    state.captured = []
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return picks


def judge(config, weights, picks, state, dev, log, control_mode=None):
    """Each stage against the reference. With ``control_mode``, the
    reference in that mode stands in for the program's maps (the control:
    only the map numbers mean anything then)."""
    tiling = config["task"]["model"]["tiling"]
    ts, stride = tiling["size"], tiling["stride"]
    names = config["model"]["channel_names"]
    fill = config["task"]["segmentation"]["fill_holes"]
    net = ref.reference_net(config["model"], weights["state"], dev)
    limits = config["limits"]
    n = {"objects": 0, "decode_mismatch": 0, "rows_missing": 0, "measure_mismatches": 0, "h5_mismatch": 0,
         "h5_missing": 0, "overflow_mismatch": 0, "rows": 0}
    overflowed = np.zeros(len(names), np.int64)
    gap_max, gap_sum, gap_n, flips, fg = 0.0, 0.0, 0.0, 0.0, 0.0
    rows_by_haul, h5_by_haul = {}, {}
    for c in picks:
        if c["haul"] not in rows_by_haul:
            zip_fn, h5_fn = state.kept[c["haul"]]
            rows_by_haul[c["haul"]] = {r["object_id"]: r for r in read_archive_rows(zip_fn)}
            wanted = [o for p in picks if p["haul"] == c["haul"] for o in p["ids"] if o is not None]
            try:
                h5_by_haul[c["haul"]] = read_datasets(h5_fn, wanted) if h5_fn else {}
            except (H5Error, zlib.error, ValueError, IndexError, struct.error) as e:
                log(f"the .h5 file of unit {c['haul']} does not read: {e!r}")
                h5_by_haul[c["haul"]] = {}
        rows, h5 = rows_by_haul[c["haul"]], h5_by_haul[c["haul"]]
        for bi, oid in enumerate(c["ids"]):
            n["objects"] += 1
            if oid is None:
                n["decode_mismatch"] += 1
                continue
            crop = c["unit"].crops[oid]
            h, w = crop.shape
            if (c["hs"][bi], c["ws"][bi]) != (h, w):
                n["decode_mismatch"] += 1
                continue
            got = c["canvas"][bi, :h, :w]
            want = ref.tile_maps(net, crop, (h, w), ts, stride, ref.REFERENCE, dev, skip_empty=False)
            if control_mode is not None:
                got = ref.tile_maps(net, crop, (h, w), ts, stride, control_mode, dev, skip_empty=False)
            gaps = ref.map_gaps(got, want)
            gap_max = max(gap_max, gaps["max"])
            gap_sum += gaps["sum"]
            gap_n += gaps["n"]
            flips += gaps["flips"]
            fg += float((want > 0.5).sum())
            stored = h5.get(oid)
            want16 = got.astype(np.float16)
            if stored is None:
                n["h5_missing"] += 1
            elif stored.dtype != np.float16 or stored.shape != want16.shape:
                n["h5_mismatch"] += want16.size
            else:
                n["h5_mismatch"] += int((stored.view(np.uint16) != want16.view(np.uint16)).sum())
            row = rows.get(oid)
            if row is None:
                n["rows_missing"] += 1
                continue
            n["rows"] += 1
            for ch, name in enumerate(names):
                over = bool(c["overflow"][ch, bi])
                overflowed[ch] += over
                prob = got[..., ch].astype(np.float16) if over else got[..., ch]
                m = ref.measure_channel(prob, fill)
                if not over and m["n"] > MAX_COMPONENTS:
                    n["overflow_mismatch"] += 1
                for k in ("raw_area", "area", "axis_major_length", "area_convex", "area_convex_ratio"):
                    v = float(row[f"object_{name}_{k}"])
                    if ref.measure_gap(k, v, m[k]):
                        n["measure_mismatches"] += 1
                        if n["measure_mismatches"] <= 5:
                            log(f"{name} {k} of {oid}: program {v}, reference {m[k]}")
    log(f"checked {len(picks)} buckets: {n['objects']} objects, {n['rows']} archive rows, "
        f"{fg:.0f} reference foreground pixels, {flips / max(fg, 1.0)!r} of them on the other side of 0.5 (not "
        f"compared: no limit separates the program's readings from the control's); measured on the host (over "
        f"{MAX_COMPONENTS} components): " + ", ".join(f"{name} {int(k)} of {n['rows']}" for name, k in zip(names, overflowed)))
    return {
        "objects_checked_short": (float(max(0, config["check"]["min_objects"] - n["objects"])), 0.0),
        "decode_mismatch": (float(n["decode_mismatch"]), 0.0),
        "map_max_gap": (gap_max, limits["map_max_gap"]),
        "map_mean_gap": (gap_sum / max(gap_n, 1.0), limits["map_mean_gap"]),
        "h5_mismatch": (float(n["h5_mismatch"] + n["h5_missing"]), 0.0),
        "rows_missing": (float(n["rows_missing"]), 0.0),
        "measure_mismatches": (float(n["measure_mismatches"] + n["overflow_mismatch"]), 0.0),
    }

