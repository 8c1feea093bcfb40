#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``maze_image_processing_pipeline_tpu_torch/
csrc`` and runs, one line of output per phase:

0. the card: its name and power limit (``nvidia-smi``); no card → exit 1;
1. the kernel build, timed;
2. each kernel against its plain PyTorch version on the card, bit-exact, at
   the main path's shape (8, 1024, 1280) and at edge shapes, with CUDA-event
   times of both;
3. the frame chain (morphology → CCL → region measurement → filled area) on
   the card against the same chain on the CPU;
4. the full-width U-Net (out_channels=1, base_features=32, depth=4) in
   float32 on the card against the CPU;
5. the LOKI segmentation slice end to end on the card at the benchmark's
   full size: DeviceTiledSegmentation → FindRegions → ExtractROI →
   CalculateZooProcessFeatures over 24 frames of 1024×1280 with 20 objects
   each, a seeded random bf16 U-Net, tiles 1024 / stride 896, batch 16,
   frame groups of 8. Every kernel must have launched in this run.

The last lines are a JSON object of the kernels, the card's name and power
limit, and ``{"ok": true, "device": {...}}``. Any failure raises and exits
non-zero before the last line.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time
from types import SimpleNamespace

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
KERNEL_SOURCE = "maze_image_processing_pipeline_tpu_torch/csrc/row_scan.cu"

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


def phase_kernels(dev) -> dict:
    """K1/K2 against their plain versions on the card, bit-exact."""
    import torch

    from maze_image_processing_pipeline_tpu_torch.ops import row_scan

    rng = np.random.default_rng(1)
    main = (8, 1024, 1280)
    cases = [(f"{main} fg={p}", main, p) for p in (0.0, 0.05, 0.5, 1.0)]
    cases += [(f"{main} serpentine", main, "serpentine")]
    cases += [(f"{s} fg=0.5", s, 0.5) for s in ((8, 1024, 1), (8, 1024, 1000), (8, 1, 1280))]
    err = {"hpass": 0, "cumsum_rows": 0}
    times = {}
    for name, shape, p in cases:
        fg_np = serpentine(*shape) if p == "serpentine" else rng.random(shape) < p
        fg = torch.from_numpy(fg_np).to(dev)
        lab = torch.from_numpy(rng.integers(1, 2**30, shape, dtype=np.int32)).to(dev)
        ints = torch.from_numpy(rng.integers(0, 2, shape, dtype=np.int32)).to(dev)
        k1, p1 = row_scan.hpass(lab, fg), row_scan.hpass_plain(lab, fg)
        k2, p2 = row_scan.cumsum_rows(ints), row_scan.cumsum_rows_plain(ints)
        torch.cuda.synchronize()
        e1 = int((k1.long() - p1.long()).abs().max())
        e2 = int((k2.long() - p2.long()).abs().max())
        err["hpass"] = max(err["hpass"], e1)
        err["cumsum_rows"] = max(err["cumsum_rows"], e2)
        if e1 or e2:
            raise AssertionError(f"kernel differs from its plain version at {name}: hpass {e1}, cumsum_rows {e2}")
        if shape == main:
            t = (
                cuda_ms(lambda: row_scan.hpass(lab, fg)),
                cuda_ms(lambda: row_scan.hpass_plain(lab, fg)),
                cuda_ms(lambda: row_scan.cumsum_rows(ints)),
                cuda_ms(lambda: row_scan.cumsum_rows_plain(ints)),
            )
            times[name] = t
            say(
                f"  {name}: hpass {t[0]:.4f} ms (plain {t[1]:.4f}), "
                f"cumsum_rows {t[2]:.4f} ms (plain {t[3]:.4f}), bit-exact"
            )
        else:
            say(f"  {name}: bit-exact")
    t = times[f"{main} fg=0.05"]
    return {
        "hpass": dict(max_abs_err=err["hpass"], ms=t[0], plain_ms=t[1]),
        "cumsum_rows": dict(max_abs_err=err["cumsum_rows"], ms=t[2], plain_ms=t[3]),
    }


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


def phase_slice(dev, limit: str) -> dict:
    import torch

    from maze_image_processing_pipeline_tpu_torch.models.model_io import LoadedModel, init_unet_params, params_from_jax
    from maze_image_processing_pipeline_tpu_torch.models.unet import UNet
    from maze_image_processing_pipeline_tpu_torch.ops import row_scan

    module = UNet(**UNET, dtype=torch.bfloat16)
    module.load_state_dict(params_from_jax(init_unet_params(UNET, seed=6)))
    model = LoadedModel(module, {})
    frames = make_frames(24, 1024, 1280, 20, seed=7)

    run_slice(dev, frames[:8], model)  # warm-up: cuDNN algorithm choice, allocator
    torch.cuda.synchronize()
    row_scan.hpass.launches = 0
    row_scan.cumsum_rows.launches = 0
    t0 = time.perf_counter()
    per_frame, objects = run_slice(dev, frames, model)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"hpass": row_scan.hpass.launches, "cumsum_rows": row_scan.cumsum_rows.launches}
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"kernel {name} did not launch on the main path")
    n_obj = check_objects(frames, per_frame, objects)
    regions = sum(n for _, n in per_frame)
    say(
        f"  frames {len(per_frame)}, regions {regions}, objects {n_obj}, wall {wall:.3f} s, "
        f"{len(per_frame) / wall:.3f} frames/s, launches {launches} [{limit}]"
    )
    return launches


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
    lib = _build.build(verbose=True)
    _build.kernels()
    say(f"phase 1 build: {time.perf_counter() - t0:.2f} s ({os.path.basename(lib)})")

    say("phase 2 kernels against their plain versions:")
    measured = phase_kernels(dev)

    t0 = time.perf_counter()
    msg = phase_frame_chain(dev)
    say(f"phase 3 frame chain card vs CPU: {msg} ({time.perf_counter() - t0:.1f} s)")

    say(f"phase 4 U-Net float32 card vs CPU: {phase_unet(dev)}")

    say("phase 5 slice end to end:")
    launches = phase_slice(dev, limit)
    check("jax" not in sys.modules, "jax was imported")

    replaces = {
        "hpass": "maze_image_processing_pipeline_tpu/ops/pallas_scan.py:111",
        "cumsum_rows": "maze_image_processing_pipeline_tpu/ops/pallas_scan.py:77",
    }
    kernels = [
        {"name": k, "route": "cuda", "source": KERNEL_SOURCE, "replaces": replaces[k],
         "launches": launches[k], **measured[k]}
        for k in ("hpass", "cumsum_rows")
    ]
    say(json.dumps({"kernels": kernels}))
    say(gpu_name_and_limit())
    say(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
