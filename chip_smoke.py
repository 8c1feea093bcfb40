#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card.

    python3 chip_smoke.py            # the whole smoke run
    python3 chip_smoke.py --stages   # phase 6 only, with a stage breakdown
                                     # and the device's idle share

Builds the port's CUDA kernels from ``maze_image_processing_pipeline_tpu_torch/
csrc`` and runs, one line of output per phase:

0. the card: its name and power limit (``nvidia-smi``); no card → exit 1;
1. the kernel build (one ``nvcc`` per source, all started together), timed;
2. each kernel against its plain PyTorch version on the card, bit-exact, at
   the main path's shape (8, 1024, 1280) and at edge shapes, with CUDA-event
   times of both beside the kernel's bound:
   K1 ``hpass`` and K2 ``cumsum_rows`` (fg densities 0-1, a serpentine),
   K4 ``vertical_pass`` (the same masks, both connectivities, both
   directions), K8 ``remove_small_objects`` (R = 256, min_area 30, ids
   beyond R, all-background and one-region frames);
3. the frame chain (morphology → CCL → region measurement → filled area) on
   the card against the same chain on the CPU;
4. the full-width U-Net (out_channels=1, base_features=32, depth=4) in
   float32 on the card against the CPU;
5. the LOKI segmentation slice on the card at the standard haul's size:
   DeviceTiledSegmentation → FindRegions → ExtractROI →
   CalculateZooProcessFeatures over 24 frames of 1024×1280 with 20 objects
   each, a seeded random bf16 U-Net, tiles 1024 / stride 896, batch 16,
   frame groups of 8;
6. ``maze-ipp loki`` through the port's Runner on the card, from a LOKI
   sample tree (24 frames of 1024×1280, 20 vignettes of 60×80 each, log,
   meta.yaml, telemetry) to an EcoTaxa archive, with the benchmark's task
   (``tools/bench_e2e.py``) and a ``UNet(1, 32, 4)`` bf16 checkpoint of
   seeded random weights written by the port's ``save_model``; one warm-up,
   then the timed run. Then a smaller task (2 frames, ``UNet(1, 8, 2)``
   float32, TF32 off) on the card and on the CPU: the two archives must
   agree.

Every kernel must have launched in phase 5 and in phase 6 (counts set to 0
just before each run). The last lines are a JSON object of the kernels, the
card's name and power limit, and ``{"ok": true, "device": {...}}``. Any
failure raises and exits non-zero before the last line.
"""

from __future__ import annotations

import io
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time
import zipfile
from types import SimpleNamespace

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
CSRC = "maze_image_processing_pipeline_tpu_torch/csrc"
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3 peak bandwidth

KERNELS = {
    # name: (source, TPU kernel it replaces, bytes per pixel that the
    # function must move: each input read once, each output written once)
    "hpass": (f"{CSRC}/row_scan.cu", "maze_image_processing_pipeline_tpu/ops/pallas_scan.py:111", 4 + 1 + 4),
    "cumsum_rows": (f"{CSRC}/row_scan.cu", "maze_image_processing_pipeline_tpu/ops/pallas_scan.py:77", 4 + 4),
    "vertical_pass": (f"{CSRC}/vertical_pass.cu", "attic/pallas_label.py:58", 4 + 1 + 4),
    "remove_small_objects": (f"{CSRC}/relabel.cu", "attic/pallas_relabel.py:99", 4 + 4),
}

# Frame-chain and segmentation settings of the end-to-end benchmark's loki
# stage (tools/bench_e2e.py): postprocess min_area 30, closing radius 2; the
# other fields are the defaults of loki/config_schema.py.
POSTPROCESS = SimpleNamespace(
    opening_radius=0,
    closing_radius=2,
    merge_segments_distance=0,
    min_area=30,
    clear_border=False,
    max_regions=64,
)
SEGMENTATION = SimpleNamespace(
    tile_size=1024,
    tile_stride=896,
    batch_size=16,
    frame_batch=8,
    skip_empty_tiles=True,
    padding=75,
    min_intensity=None,
)
UNET = dict(out_channels=1, base_features=32, depth=4)
SMALL_UNET = dict(out_channels=1, base_features=8, depth=2)


def say(*parts) -> None:
    print(*parts, flush=True)


def check(ok, msg: str) -> None:
    if not ok:
        raise AssertionError(msg)


def gpu_name_and_limit() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def bound_ms(name: str, pixels: int) -> float:
    """The least time the card could take for the kernel's work on
    ``pixels`` pixels: its bytes over the memory rate (every kernel here does
    a few integer operations per pixel, far below the card's integer rate)."""
    return KERNELS[name][2] * pixels / HBM_BYTES_PER_S * 1e3


def make_frames(n: int, H: int, W: int, objects: int, seed: int) -> np.ndarray:
    """Stitched-LOKI-like frames: zero background with ``objects`` pasted
    60×80 vignettes (noise up to 40, one bright ellipse each)."""
    rng = np.random.default_rng(seed)
    frames = np.zeros((n, H, W), np.uint8)
    ch, cw = min(60, H), min(80, W)
    yy, xx = np.mgrid[:ch, :cw]
    for f in range(n):
        for _ in range(objects):
            crop = (rng.random((ch, cw)) * 40).astype(np.uint8)
            ry, rx = rng.integers(4, ch // 2 - 1), rng.integers(4, cw // 2 - 1)
            crop[((yy - ch / 2) / ry) ** 2 + ((xx - cw / 2) / rx) ** 2 <= 1] = rng.integers(100, 250)
            y, x = rng.integers(0, H - ch + 1), rng.integers(0, W - cw + 1)
            frames[f, y : y + ch, x : x + cw] = crop
    return frames


def serpentine(B: int, H: int, W: int) -> np.ndarray:
    """One snake through the whole frame: the CCL's worst case."""
    mask = np.zeros((B, H, W), bool)
    for k, y in enumerate(range(0, H - 2, 4)):
        mask[:, y, 1:-1] = True
        x = W - 2 if k % 2 == 0 else 1
        mask[:, y : y + 5, x] = True
    mask[:, -1, :] = False
    return mask


def region_labels(shape, R: int, seed: int) -> np.ndarray:
    """Label frames of rectangles with ids 1..R+44 (so some lie beyond the
    R-entry table), sizes from 1 to 48 px a side, on background 0."""
    rng = np.random.default_rng(seed)
    out = np.zeros(shape, np.int32)
    H, W = shape[-2:]
    for f in np.ndindex(shape[:-2]):
        for i in range(1, R + 45):
            h, w = rng.integers(1, min(H, 48) + 1), rng.integers(1, min(W, 48) + 1)
            y, x = rng.integers(0, H - h + 1), rng.integers(0, W - w + 1)
            out[f + (slice(y, y + h), slice(x, x + w))] = i
    return out


def cuda_ms(fn, iters: int = 20) -> float:
    """Mean device time of ``fn`` in ms from CUDA events (after warm-up)."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def max_err(a, b) -> int:
    return int((a.long() - b.long()).abs().max()) if a.numel() else 0


def phase_kernels(dev, main=(8, 1024, 1280), edges=((8, 1024, 1), (8, 1024, 1000), (8, 1, 1280))) -> dict:
    """K1, K2, K4 and K8 against their plain versions on the card,
    bit-exact, at the main path's shape and at edge shapes; CUDA-event
    times at the main path's shape."""
    import torch

    from maze_image_processing_pipeline_tpu_torch.ops import label as tl
    from maze_image_processing_pipeline_tpu_torch.ops import row_scan

    rng = np.random.default_rng(1)
    cases = [(f"{main} fg={p}", main, p) for p in (0.0, 0.05, 0.5, 1.0)]
    cases += [(f"{main} serpentine", main, "serpentine")]
    cases += [(f"{s} fg=0.5", s, 0.5) for s in edges]
    err = dict.fromkeys(KERNELS, 0)
    out = {}

    def record(name, e, where):
        err[name] = max(err[name], e)
        if e:
            raise AssertionError(f"{name} differs from its plain version at {where} by {e}")

    for where, shape, p in cases:
        fg_np = serpentine(*shape) if p == "serpentine" else rng.random(shape) < p
        fg = torch.from_numpy(fg_np).to(dev)
        lab = torch.from_numpy(rng.integers(1, 2**30, shape, dtype=np.int32)).to(dev)
        ints = torch.from_numpy(rng.integers(0, 2, shape, dtype=np.int32)).to(dev)
        record("hpass", max_err(row_scan.hpass(lab, fg), row_scan.hpass_plain(lab, fg)), where)
        record("cumsum_rows", max_err(row_scan.cumsum_rows(ints), row_scan.cumsum_rows_plain(ints)), where)
        for conn in (1, 2):
            for rev in (False, True):
                e = max_err(tl.vertical_pass(lab, fg, conn, rev), tl.vertical_pass_plain(lab, fg, conn, rev))
                record("vertical_pass", e, f"{where} connectivity={conn} reverse={rev}")
        torch.cuda.synchronize()
        if shape == main and p == 0.05:
            px = lab.numel()
            out["hpass"] = dict(ms=cuda_ms(lambda: row_scan.hpass(lab, fg)),
                                plain_ms=cuda_ms(lambda: row_scan.hpass_plain(lab, fg)),
                                bound_ms=bound_ms("hpass", px), library_ms=None)
            out["cumsum_rows"] = dict(ms=cuda_ms(lambda: row_scan.cumsum_rows(ints)),
                                      plain_ms=cuda_ms(lambda: row_scan.cumsum_rows_plain(ints)),
                                      bound_ms=bound_ms("cumsum_rows", px),
                                      library_ms=cuda_ms(lambda: torch.cumsum(ints, dim=-1, dtype=torch.int32)))
            vp4 = cuda_ms(lambda: tl.vertical_pass(lab, fg, 1, False))
            out["vertical_pass"] = dict(ms=cuda_ms(lambda: tl.vertical_pass(lab, fg, 2, False)),
                                        plain_ms=cuda_ms(lambda: tl.vertical_pass_plain(lab, fg, 2, False), iters=3),
                                        bound_ms=bound_ms("vertical_pass", px), library_ms=None)
            say(f"  {where}: 8-connected vertical_pass {out['vertical_pass']['ms']:.4f} ms, "
                f"4-connected {vp4:.4f} ms")
        say(f"  {where}: hpass, cumsum_rows, vertical_pass (4/8-connected, down/up) bit-exact")

    R, min_area = 4 * POSTPROCESS.max_regions, POSTPROCESS.min_area
    lab_cases = [(f"{main} rectangles", region_labels(main, R, seed=2)),
                 (f"{main} background", np.zeros(main, np.int32)),
                 (f"{main} one region", np.ones(main, np.int32))]
    lab_cases += [(f"{s} rectangles", region_labels(s, R, seed=3)) for s in edges]
    for where, lab_np in lab_cases:
        lab = torch.from_numpy(lab_np).to(dev)
        k_out, k_n = tl.remove_small_objects(lab, min_area, R)
        p_out, p_n = tl.remove_small_objects_plain(lab, min_area, R)
        torch.cuda.synchronize()
        record("remove_small_objects", max(max_err(k_out, p_out), max_err(k_n, p_n)), where)
        say(f"  {where}: remove_small_objects bit-exact (kept per frame {k_n.tolist()})")
        if where == f"{main} rectangles":
            out["remove_small_objects"] = dict(
                ms=cuda_ms(lambda: tl.remove_small_objects(lab, min_area, R)),
                plain_ms=cuda_ms(lambda: tl.remove_small_objects_plain(lab, min_area, R)),
                bound_ms=bound_ms("remove_small_objects", lab.numel()), library_ms=None)

    for name, m in out.items():
        m.update(max_abs_err=err[name], bound_by="bytes")
        say(f"  {name} at {main}: {m['ms']:.4f} ms, plain {m['plain_ms']:.4f} ms, bound {m['bound_ms']:.4f} ms"
            + (f", library {m['library_ms']:.4f} ms" if m["library_ms"] is not None else ""))
    return out


def phase_frame_chain(dev, B=2, H=1024, W=1280) -> str:
    """The frame chain on the card (kernels) against the CPU (plain)."""
    import torch

    from maze_image_processing_pipeline_tpu_torch.loki.device_seg import _build_frame_chain

    rng = np.random.default_rng(2)
    image = make_frames(B, H, W, 20, seed=3)
    pred = np.where(image > 60, 0.9, 0.1) + 0.1 * rng.standard_normal(image.shape)
    pred = pred.astype(np.float32)
    out = {}
    for d in (dev, torch.device("cpu")):
        chain, keys = _build_frame_chain(POSTPROCESS)
        with torch.inference_mode():
            labels, flat = chain(torch.from_numpy(pred).to(d), torch.from_numpy(image).to(d))
        out[d.type] = (labels.cpu().numpy(), flat.cpu().numpy(), list(keys))
    (lg, fg_, keys), (lc, fc, keys_c) = out[dev.type], out["cpu"]
    check(keys == keys_c, f"packed keys differ: {keys} vs {keys_c}")
    if not np.array_equal(lg, lc):
        raise AssertionError(f"labels differ on {int((lg != lc).sum())} pixels")
    R, K = POSTPROCESS.max_regions, len(keys)
    n_g, n_c = fg_[:B], fc[:B]
    pg = fg_[B : B + K * B * R].reshape(K, B, R)
    pc = fc[B : B + K * B * R].reshape(K, B, R)
    hist_g, hist_c = fg_[B + K * B * R :], fc[B + K * B * R :]
    check(np.array_equal(n_g, n_c), f"region counts differ: {n_g} vs {n_c}")
    check(np.array_equal(hist_g, hist_c), "histograms differ")
    exact = ("area", "area_filled", "area_filled_ambiguous", "min_row", "max_row",
             "min_col", "max_col", "intensity_min", "intensity_max")
    worst = 0.0
    for i, k in enumerate(keys):
        if k in exact:
            check(np.array_equal(pg[i], pc[i]), f"{k} differs")
        else:
            np.testing.assert_allclose(pg[i], pc[i], rtol=1e-5, atol=1e-3, err_msg=k)
            rel = np.abs(pg[i] - pc[i]) / np.maximum(np.abs(pc[i]), 1.0)
            worst = max(worst, float(rel.max()))
    return (
        f"regions per frame {n_g.astype(int).tolist()}, labels/counts/histograms/integer "
        f"props exact, float props within rtol 1e-5 atol 1e-3 (max relative diff {worst:.3g})"
    )


def phase_unet(dev) -> str:
    """Full-width U-Net in float32, card against CPU."""
    import torch

    from maze_image_processing_pipeline_tpu_torch.models.model_io import init_unet_params, params_from_jax
    from maze_image_processing_pipeline_tpu_torch.models.unet import UNet

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    model = UNet(**UNET, dtype=torch.float32)
    model.load_state_dict(params_from_jax(init_unet_params(UNET, seed=4)))
    x = torch.from_numpy(np.random.default_rng(5).random((2, 256, 256, 3), dtype=np.float32))
    with torch.inference_mode():
        y_cpu = model.eval()(x)
        y_gpu = model.to(dev)(x.to(dev)).cpu()
    scale = max(1.0, float(y_cpu.abs().max()))
    err = float((y_gpu - y_cpu).abs().max())
    # float32 convolutions sum in other orders on the card (cuDNN) than on
    # the CPU; 13 conv layers with GroupNorm stay well inside 1e-3 relative.
    if not (math.isfinite(err) and err <= 1e-3 * scale):
        raise AssertionError(f"U-Net logits differ by {err} (scale {scale})")
    return f"logits (2, 256, 256, 1) max abs diff {err:.3g}, tolerance 1e-3 x {scale:.3g}"


def run_slice(dev, frames: np.ndarray, model, seg_cfg=SEGMENTATION, post_cfg=POSTPROCESS):
    """The segmentation slice in an engine Pipeline; returns per frame the
    (n_regions, [(RegionInfo, roi, features)]) in emission order."""
    from maze_image_processing_pipeline_tpu_torch.engine import Call, Pipeline, Unpack
    from maze_image_processing_pipeline_tpu_torch.engine.image import (
        CalculateZooProcessFeatures,
        ExtractROI,
        FindRegions,
    )
    from maze_image_processing_pipeline_tpu_torch.loki.device_seg import DeviceTiledSegmentation

    per_frame = []
    objects = []
    with Pipeline() as p:
        idx, image = Unpack([(i, f) for i, f in enumerate(frames)]).unpack(2)
        labels, props, n_regions, regions = DeviceTiledSegmentation(
            image, model, seg_cfg, post_cfg, device=dev
        )
        Call(lambda i, n: per_frame.append((int(i), int(n))), idx, n_regions)
        region = FindRegions(
            labels, image, padding=seg_cfg.padding, min_intensity=seg_cfg.min_intensity,
            props=props, regions=regions,
        )
        roi = ExtractROI(image, region, alpha=0, labels=labels)
        meta = CalculateZooProcessFeatures(region, Call(lambda i: {"frame": int(i)}, idx), prefix="object_")
        Call(lambda i, r, o, m: objects.append((int(i), r, o, m)), idx, region, roi, meta)
    p.run()
    return per_frame, objects


def check_objects(frames: np.ndarray, per_frame, objects) -> int:
    """Every frame came out in order; every object is well formed."""
    check([i for i, _ in per_frame] == list(range(len(frames))), "frames missing or out of order")
    n_regions = 0
    for i, region, roi, meta in objects:
        y0, x0, y1, x1 = region.bbox_padded
        check(region.image.shape == (y1 - y0, x1 - x0) == roi.shape, "crop shapes disagree")
        check(region.image.any(), "empty region mask")
        np.testing.assert_array_equal(roi, frames[i, y0:y1, x0:x1])
        check(all(np.isfinite(np.asarray(v, np.float64)).all() for v in region.props.values()), "non-finite props")
        feats = {k: v for k, v in meta.items() if k.startswith("object_")}
        check(feats and all(math.isfinite(float(v)) for v in feats.values()), "non-finite features")
        n_regions += 1
    return n_regions


def reset_launches() -> None:
    from maze_image_processing_pipeline_tpu_torch.ops import label as tl
    from maze_image_processing_pipeline_tpu_torch.ops import row_scan

    for fn in (row_scan.hpass, row_scan.cumsum_rows, tl.vertical_pass, tl.remove_small_objects):
        fn.launches = 0


def read_launches(where: str) -> dict:
    """The launch counts since :func:`reset_launches`; every kernel of the
    main path must have launched."""
    from maze_image_processing_pipeline_tpu_torch.ops import label as tl
    from maze_image_processing_pipeline_tpu_torch.ops import row_scan

    launches = {
        "hpass": row_scan.hpass.launches,
        "cumsum_rows": row_scan.cumsum_rows.launches,
        "vertical_pass": tl.vertical_pass.launches,
        "remove_small_objects": tl.remove_small_objects.launches,
    }
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"kernel {name} did not launch in {where}")
    return launches


def phase_slice(dev, limit: str) -> dict:
    import torch

    from maze_image_processing_pipeline_tpu_torch.models.model_io import LoadedModel, init_unet_params, params_from_jax
    from maze_image_processing_pipeline_tpu_torch.models.unet import UNet

    module = UNet(**UNET, dtype=torch.bfloat16)
    module.load_state_dict(params_from_jax(init_unet_params(UNET, seed=6)))
    model = LoadedModel(module, {})
    frames = make_frames(24, 1024, 1280, 20, seed=7)

    run_slice(dev, frames[:8], model)  # warm-up: cuDNN algorithm choice, allocator
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    per_frame, objects = run_slice(dev, frames, model)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches("phase 5")
    n_obj = check_objects(frames, per_frame, objects)
    regions = sum(n for _, n in per_frame)
    say(
        f"  frames {len(per_frame)}, regions {regions}, objects {n_obj}, wall {wall:.3f} s, "
        f"{len(per_frame) / wall:.3f} frames/s, launches {launches} [{limit}]"
    )
    return launches


# -- phase 6: maze-ipp loki through the port's Runner ------------------------

OBJECT_ID_FMT = "{date} {time}  {ms:03d}  {seq:06d} {posx:04d} {posy:04d}"


def draw_blob(rng, shape=(60, 80), r=12, intensity=180) -> np.ndarray:
    """A bright elliptical blob on dark noise: a fake plankton vignette."""
    img = (rng.random(shape) * 20).astype(np.uint8)
    yy, xx = np.mgrid[0 : shape[0], 0 : shape[1]]
    cy, cx = shape[0] // 2, shape[1] // 2
    img[((yy - cy) ** 2 / (r * r) + (xx - cx) ** 2 / (1.8 * r) ** 2) <= 1.0] = intensity
    return img


def make_loki_tree(root: str, n_frames: int, objects_per_frame: int, frame_shape, seed: int = 0) -> str:
    """A LOKI sample tree as the camera writes it: ``Log/LOKI_*.log``,
    ``meta.yaml``, ``Telemetrie/*.tmd`` and ``Pictures/<hour>/<object id>.png``
    (60×80 vignettes at random positions of ``frame_shape`` frames), in the
    layout of ``tests/fixtures.py:make_loki_sample``, encoded by the port's
    ``encode_image``. Returns the sample root."""
    from maze_image_processing_pipeline_tpu_torch.dataio.imageio import encode_image

    rng = np.random.default_rng(seed)
    sample = os.path.join(root, "LOKI_00001.01")
    for d in ("Log", "Telemetrie"):
        os.makedirs(os.path.join(sample, d), exist_ok=True)
    with open(os.path.join(sample, "Log", "LOKI_00001.log"), "w") as f:
        f.write("DEVICE: LOKI\nCRUISE: PS122\nSTATION: PS122-1\nHAUL: 7\nVESSEL: Polarstern\n"
                "REGION: Arctic Ocean\nLOCATION: Central Arctic\nGPS_LAT: 84.95\nGPS_LON: 134.72\n"
                "BOTTOM_DEPTH: 4200\n")
    with open(os.path.join(sample, "meta.yaml"), "w") as f:
        f.write("sample_program: MOSAiC\n")
    date = "20220103"
    times = [f"12{(62 + 30 * i) // 60:02d}{(62 + 30 * i) % 60:02d}" for i in range(n_frames)]
    for i, t in enumerate(times):
        with open(os.path.join(sample, "Telemetrie", f"{date} {t}.tmd"), "w") as f:
            f.write(f"GPS_LON;134.{70 + i}\nGPS_LAT;84.{90 + i}\nPRESS;{10.5 + i}\n"
                    f"TEMP;{-1.5 + 0.1 * i}\nOXY_CON;{300 + i}\nCOND_SALY;{34.2}\n")
    pic_dir = os.path.join(sample, "Pictures", f"{date} 12")
    os.makedirs(pic_dir, exist_ok=True)
    H, W = frame_shape
    ch, cw = 60, 80
    for t in times:
        for oi in range(objects_per_frame):
            r = 8 + int(rng.integers(0, 6))
            posx = int(rng.integers(0, max(1, W - cw - 10)))
            posy = int(rng.integers(0, max(1, H - ch - 10)))
            oid = OBJECT_ID_FMT.format(date=date, time=t, ms=333, seq=oi, posx=posx, posy=posy)
            with open(os.path.join(pic_dir, oid + ".png"), "wb") as f:
                f.write(encode_image(draw_blob(rng, (ch, cw), r), oid + ".png"))
    return sample


def write_unet(path: str, cfg: dict, dtype: str, seed: int, gain=None) -> str:
    """A ``UNet`` checkpoint of seeded random weights, written by the port's
    ``save_model``. ``gain`` scales the 1×1 head and sets its bias to
    ``-gain / 2``, so that logits lie far from 0 (no score within float noise
    of the 0.5 threshold) and featureless pixels score as background."""
    from maze_image_processing_pipeline_tpu_torch.models.model_io import init_unet_params, params_from_jax, save_model
    from maze_image_processing_pipeline_tpu_torch.models.unet import UNet

    params = init_unet_params(cfg, seed=seed)
    if gain is not None:
        head = params["params"][f"Conv_{cfg['depth']}"]
        head["kernel"] *= gain
        head["bias"][:] = -gain / 2
    module = UNet(**cfg, dtype=dtype)
    module.load_state_dict(params_from_jax(params))
    save_model(path, module, outputs={"pred": {"channel_names": ["foreground"]}})
    return path


def loki_task(data: str, model_fn: str, target_dir: str, **segmentation) -> dict:
    """The loki task of ``tools/bench_e2e.py`` (the standard haul's), with
    the masks stored beside the images."""
    seg = {
        "model_fn": model_fn,
        "batch_size": 16,
        "frame_batch": 8,
        "tile_size": 1024,
        "tile_stride": 896,
        "postprocess": {"min_area": 30, "closing_radius": 2},
    }
    seg.update(segmentation)
    return {
        "input": {"path": data},
        "segmentation": {"jax": seg},
        "postprocess": {},
        "output": {"target_dir": target_dir, "store_mask": True},
    }


def _read_archive_tsv(z: zipfile.ZipFile):
    from maze_image_processing_pipeline_tpu_torch.dataio.ecotaxa import read_tsv

    return read_tsv(io.StringIO(z.read("ecotaxa_export.tsv").decode()))


def check_archive(fn: str) -> tuple:
    """The archive exists, its TSV has one row per object and every image and
    mask decodes. Returns (rows, images)."""
    from maze_image_processing_pipeline_tpu_torch.dataio.imageio import decode_image

    check(os.path.exists(fn), f"no archive at {fn}")
    with zipfile.ZipFile(fn) as z:
        df = _read_archive_tsv(z)
        names = [n for n in z.namelist() if n != "ecotaxa_export.tsv"]
        check(len(df) > 0, "the archive holds no object")
        check(df["object_id"].is_unique, "object ids repeat")
        check("img_file_name_1" in df.columns, "no masks in the archive")
        check(sorted(names) == sorted([*df["img_file_name"], *df["img_file_name_1"]]),
              "archive members are not one image and one mask per row")
        for n in names:
            img = decode_image(z.read(n))
            check(img is not None and img.size > 0, f"{n} does not decode")
    return len(df), len(names)


# Columns that name the run, not its result: the pipeline's name and the
# wall-clock time of the run (and the process id made from it).
RUN_COLUMNS = ("process_pipeline", "process_datetime", "process_id")


def compare_archives(ref_fn: str, fn: str, skip_columns=RUN_COLUMNS) -> int:
    """Two EcoTaxa archives hold the same members in the same order, the same
    TSV columns and rows; integer and text columns are equal, float columns
    within rtol 1e-5 / atol 1e-3 (float64-summed moments, as the frame chain
    is held card against CPU); decoded images and masks are equal. Returns
    the number of rows."""
    from maze_image_processing_pipeline_tpu_torch.dataio.imageio import decode_image

    with zipfile.ZipFile(ref_fn) as za, zipfile.ZipFile(fn) as zb:
        check(za.namelist() == zb.namelist(), f"members differ: {za.namelist()} vs {zb.namelist()}")
        a, b = _read_archive_tsv(za), _read_archive_tsv(zb)
        check(list(a.columns) == list(b.columns), f"columns differ: {set(a.columns) ^ set(b.columns)}")
        check(len(a) == len(b), f"rows differ: {len(a)} vs {len(b)}")
        for col in a.columns:
            if col in skip_columns:
                continue
            x, y = a[col].to_numpy(), b[col].to_numpy()
            if x.dtype.kind == "f" and y.dtype.kind == "f":
                ints = np.all(np.isnan(x) | (x == np.round(x))) and np.all(np.isnan(y) | (y == np.round(y)))
                if ints:
                    np.testing.assert_array_equal(y, x, err_msg=col)
                else:
                    np.testing.assert_allclose(y, x, rtol=1e-5, atol=1e-3, err_msg=col)
            else:
                check(list(map(str, x)) == list(map(str, y)), f"column {col} differs")
        for n in za.namelist():
            if n != "ecotaxa_export.tsv":
                np.testing.assert_array_equal(decode_image(zb.read(n)), decode_image(za.read(n)), err_msg=n)
    return len(a)


def run_loki(task: dict) -> float:
    """The port's Runner on ``task``; returns the wall time in seconds,
    up to the card's last result."""
    import torch

    from maze_image_processing_pipeline_tpu_torch.loki.pipeline import Runner

    t0 = time.perf_counter()
    Runner._configure_and_run(task)
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    return time.perf_counter() - t0


def phase_loki(limit: str, work: str) -> dict:
    """``maze-ipp loki`` at the standard haul's shapes on the card, then a
    small task on the card and on the CPU."""
    import torch

    data = os.path.join(work, "data")
    make_loki_tree(data, n_frames=24, objects_per_frame=20, frame_shape=(1024, 1280), seed=8)
    unet = write_unet(os.path.join(work, "unet"), UNET, "bfloat16", seed=6)
    archive = "LOKI_PS122-1_7.zip"
    run_loki(loki_task(data, unet, os.path.join(work, "warm")))  # cuDNN choice, allocator
    reset_launches()
    wall = run_loki(loki_task(data, unet, os.path.join(work, "out")))
    launches = read_launches("phase 6")
    rows, members = check_archive(os.path.join(work, "out", archive))
    say(f"  standard haul: 24 frames, {rows} objects ({members} images and masks), wall {wall:.3f} s, "
        f"{24 / wall:.3f} frames/s, {rows / wall:.3f} objects/s, launches {launches} [{limit}]")

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    small = os.path.join(work, "small")
    make_loki_tree(small, n_frames=2, objects_per_frame=20, frame_shape=(1024, 1280), seed=9)
    unet_s = write_unet(os.path.join(work, "unet_small"), SMALL_UNET, "float32", seed=0, gain=1000.0)
    for device in ("cuda", "cpu"):
        run_loki(loki_task(small, unet_s, os.path.join(work, device), dtype="float32", batch_size=4,
                           frame_batch=2, device=device))
    n = compare_archives(os.path.join(work, "cpu", archive), os.path.join(work, "cuda", archive))
    check(n > 0, "the small task's archive holds no object")
    say(f"  small task (2 frames, UNet(1, 8, 2) float32, TF32 off): card and CPU archives agree, {n} objects")
    return launches


def stage_breakdown(dev, limit: str, work: str) -> None:
    """Phase 6's task once more with a ``torch.cuda.synchronize()`` timer
    around each stage of the segmentation node, then once under
    ``torch.profiler`` for the device's busy time."""
    import torch

    from maze_image_processing_pipeline_tpu_torch.loki import device_seg
    from maze_image_processing_pipeline_tpu_torch.ops import fill_holes, label, regionprops_fused

    data = os.path.join(work, "data")
    make_loki_tree(data, n_frames=24, objects_per_frame=20, frame_shape=(1024, 1280), seed=8)
    unet = write_unet(os.path.join(work, "unet"), UNET, "bfloat16", seed=6)
    run_loki(loki_task(data, unet, os.path.join(work, "warm")))
    plain = run_loki(loki_task(data, unet, os.path.join(work, "plain")))

    totals: dict = {}

    def timed(name, fn):
        def wrapper(*a, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                torch.cuda.synchronize()
                totals[name] = totals.get(name, 0.0) + time.perf_counter() - t0
        return wrapper

    node = device_seg.DeviceTiledSegmentation.node_class
    patches = [
        (node, "_predict", "tiles + U-Net forward + blend"),
        (node, "_crops", "crops + RegionInfo assembly"),
        (device_seg, "label", "label of the objects (K1, K2, K4)"),
        (fill_holes, "label", "label of the background in region_filled_extra (K1, K2, K4)"),
        (device_seg, "binary_closing", "closing"),
        (device_seg, "remove_small_objects", "remove_small_objects (K8)"),
        (device_seg, "regionprops_fused", "regionprops_fused"),
        (device_seg, "region_filled_extra", "region_filled_extra (all)"),
        (node, "_run_group", "segmentation node, all"),
    ]
    saved = [(obj, attr, getattr(obj, attr)) for obj, attr, _ in patches]
    for obj, attr, name in patches:
        setattr(obj, attr, timed(name, getattr(obj, attr)))
    timed_wall = run_loki(loki_task(data, unet, os.path.join(work, "timed")))
    for obj, attr, fn in saved:
        setattr(obj, attr, fn)
    say(f"stage breakdown of phase 6 (one run with a synchronize around each stage; wall {timed_wall:.3f} s, "
        f"the same run without timers {plain:.3f} s) [{limit}]:")
    for name, t in sorted(totals.items(), key=lambda kv: -kv[1]):
        say(f"  {name}: {t:.3f} s, {100 * t / timed_wall:.1f} %")

    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        wall = run_loki(loki_task(data, unet, os.path.join(work, "profiled")))
    busy_us = sum(getattr(e, "self_device_time_total", 0) for e in prof.key_averages())
    say(f"device busy {busy_us / 1e6:.3f} s in a profiled run of {wall:.3f} s: idle share {1 - busy_us / 1e6 / wall:.3f}; "
        f"against the unprofiled run's {plain:.3f} s: {1 - busy_us / 1e6 / plain:.3f}")
    top = sorted(prof.key_averages(), key=lambda e: -getattr(e, "self_device_time_total", 0))[:12]
    for e in top:
        say(f"  {e.key[:70]}: {getattr(e, 'self_device_time_total', 0) / 1e3:.1f} ms device, {e.count} calls")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available() is false)")
    sys.path.insert(0, REPO)
    from maze_image_processing_pipeline_tpu_torch import _build

    dev = torch.device("cuda", 0)
    limit = gpu_name_and_limit()
    say(f"phase 0 card: {limit}; torch {torch.__version__} cuda {torch.version.cuda}; {torch.cuda.get_device_name(0)}")

    t0 = time.perf_counter()
    libs = _build.build(verbose=True)
    _build.kernels()
    say(f"phase 1 build: {time.perf_counter() - t0:.2f} s ({', '.join(os.path.basename(p) for p in libs)})")

    work = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        if "--stages" in sys.argv[1:]:
            stage_breakdown(dev, limit, work)
            sys.stdout.flush()
            os._exit(0)  # a process that ran torch.profiler may not exit by itself

        say("phase 2 kernels against their plain versions:")
        measured = phase_kernels(dev)

        t0 = time.perf_counter()
        msg = phase_frame_chain(dev)
        say(f"phase 3 frame chain card vs CPU: {msg} ({time.perf_counter() - t0:.1f} s)")

        say(f"phase 4 U-Net float32 card vs CPU: {phase_unet(dev)}")

        say("phase 5 slice end to end:")
        phase_slice(dev, limit)

        say("phase 6 maze-ipp loki through the port's Runner:")
        t0 = time.perf_counter()
        launches = phase_loki(limit, work)
        say(f"  phase 6 took {time.perf_counter() - t0:.1f} s")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    check(not any(m == "jax" or m.startswith(("jax.", "maze_image_processing_pipeline_tpu."))
                  or m == "maze_image_processing_pipeline_tpu" for m in sys.modules),
          "jax or the JAX package was imported")

    kernels = [
        {"name": k, "route": "cuda", "source": KERNELS[k][0], "replaces": KERNELS[k][1],
         "launches": launches[k], **measured[k]}
        for k in KERNELS
    ]
    say(json.dumps({"kernels": kernels}))
    say(gpu_name_and_limit())
    say(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
