"""Frame-chain perf lab of the port: per-stage times of the segmentation
device chain (morphology → ``label`` → K8 → K7 + K3) on the card.

Counterpart of ``tools/perf_lab.py`` (the JAX package's TPU lab), with the
same experiments built from the port's ops, on the same frames (a copy of
``bench.py``'s ``make_frames`` and constants)::

    python -m maze_image_processing_pipeline_tpu_torch.tools.perf_lab [exp ...] \\
        [--shape HxW] [--device cuda|cpu]

No experiment named = all. ``--shape`` replaces the JAX lab's
``PERF_SHAPE`` variable (2048x2560 is the dense haul's frame). The card is
the default and a missing card raises; ``--device cpu`` runs the plain
versions on the CPU (for tests: CPU times say nothing of the card).

Timing: the TPU lab's in-jit ``fori_loop`` K-vs-1 differencing becomes CUDA
events around the calls: a few warm-up calls, then the mean of ``ITERS``
calls between two events, synchronised. Each line reads ``ms/batch``, the
``*_fps`` lines ``frames/s``, as the JAX lab prints them.

Experiments: ``morph``, ``morph_label``, ``morph_anchor_label`` (K9 between
the morphology and ``label``), ``label_alone``, ``morph_hpass`` (K1),
``morph_vpass`` (K4), ``morph_sweep1``, ``morph_fix``, ``props`` (K7 + K3
on fixed labels), ``rsmall`` (K8), ``chain`` and ``chain_anchor`` (with
K9; both launch K1, K2, K4, K8, K7 and K3), and, for reference only,
``props_plain`` and ``chain_plain``: the same on a CPU copy of the frames,
where every op takes its plain version, timed by the host clock (the cost
of ``device: cpu``; they replace the JAX lab's ``propsxla``, ``chainxla``
and ``chainprod``; each kernel's plain version on the card is timed by
``chip_smoke.py``'s phase 2).

Not ported: ``props8``..``props64`` (the Pallas K7's ``tile_rows``, a VMEM
strip size the CUDA K7 does not have) and ``label_alone_roll`` (a guard
against XLA hoisting a loop-invariant ``label`` out of ``fori_loop``; here
each call is timed as it is issued, so there is nothing to hoist).
"""

from __future__ import annotations

import argparse
import sys
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..models.inference import resolve_device
from ..ops import label as lm
from ..ops import morphology as morph
from ..ops.anchor import anchor
from ..ops.regionprops_fused import regionprops_fused
from ..ops.row_scan import INF, hpass

# bench.py's constants.
THRESHOLD = 60
RADIUS = 3
MIN_AREA = 50
NUM_SEGMENTS = 64
BATCH = 8
RSMALL_SEGMENTS = 256  # the lab's remove_small_objects id range

EXPERIMENTS = (
    "morph", "morph_label", "morph_anchor_label", "label_alone",
    "morph_hpass", "morph_vpass", "morph_sweep1", "morph_fix",
    "props", "props_plain", "rsmall", "chain", "chain_anchor", "chain_plain",
)
# Experiments through the plain versions, on a CPU copy of the frames:
# slow, timed over fewer calls.
PLAIN = ("props_plain", "chain_plain")
ITERS = 10  # timed calls per experiment (a fifth of them for PLAIN)


def make_frames(n: int, size: int = 1024, seed: int = 0) -> np.ndarray:
    """Synthetic LOKI-like frames: sparse bright blobs on dark noise (a copy
    of ``bench.py:make_frames``)."""
    rng = np.random.default_rng(seed)
    frames = (rng.random((n, size, size)) * 18).astype(np.uint8)
    yy, xx = np.mgrid[0:size, 0:size]
    for i in range(n):
        for _ in range(25):
            cy, cx = rng.integers(30, size - 30, 2)
            ry = rng.integers(6, 28)
            rx = rng.integers(6, 28)
            blob = ((yy - cy) ** 2 / ry**2 + (xx - cx) ** 2 / rx**2) <= 1.0
            frames[i][blob] = rng.integers(120, 250)
    return frames


def lab_frames(shape: Optional[Tuple[int, int]] = None, batch: int = BATCH) -> np.ndarray:
    """The lab's (batch, H, W) uint8 frames: ``make_frames(batch)``, or for
    a ``shape`` the top-left (H, W) of frames of the larger side, as the
    JAX lab cuts them for ``PERF_SHAPE``."""
    if shape is None:
        return make_frames(batch)
    H, W = shape
    return np.ascontiguousarray(make_frames(batch, size=max(H, W))[:, :H, :W])


def morph_chain(images: torch.Tensor) -> torch.Tensor:
    """Threshold, opening and closing by the radius-3 disk."""
    mask = images > THRESHOLD
    mask = morph.binary_opening(mask, RADIUS)
    return morph.binary_closing(mask, RADIUS)


def lab0_of(fg: torch.Tensor) -> torch.Tensor:
    """``label``'s seed: each foreground pixel's linear index + 1."""
    H, W = fg.shape[-2:]
    lin = torch.arange(H * W, dtype=torch.int32, device=fg.device).reshape(1, H, W)
    return torch.where(fg, lin + 1, torch.tensor(INF, dtype=torch.int32, device=fg.device))


def to_labels(images: torch.Tensor) -> torch.Tensor:
    """The fixed labels of ``props`` and ``rsmall``: the chain up to K8."""
    labels, _ = lm.label(morph_chain(images), connectivity=2)
    labels, _ = lm.remove_small_objects(labels, MIN_AREA, RSMALL_SEGMENTS)
    return labels


def chain(images: torch.Tensor, anchored: bool = False):
    """The frame chain: morphology → (K9) → ``label`` → K8 → K7 + K3.
    Returns (labels, kept regions per frame, props)."""
    mask = morph_chain(images)
    if anchored:
        mask = anchor(mask)
    labels, _ = lm.label(mask, connectivity=2)
    labels, n = lm.remove_small_objects(labels, MIN_AREA, RSMALL_SEGMENTS)
    return labels, n, regionprops_fused(labels, images, num_segments=NUM_SEGMENTS)


def experiments(x: torch.Tensor) -> Dict[str, Callable[[], object]]:
    """The lab's experiments on the (B, H, W) uint8 frames ``x``, by name;
    each is a call without arguments. Fixed inputs (``label_alone``'s mask,
    ``props``' and ``rsmall``'s labels, the seeds of the interior probes)
    are computed here, outside the timed calls. The ``PLAIN`` experiments
    run on CPU copies."""
    mask = morph_chain(x)
    fixed = to_labels(x)
    x_cpu, fixed_cpu = x.cpu(), fixed.cpu()

    def probe(fn):
        def run():
            fg = morph_chain(x)
            return fn(lab0_of(fg), fg)
        return run

    return {
        "morph": lambda: morph_chain(x),
        "morph_label": lambda: lm.label(morph_chain(x), connectivity=2),
        "morph_anchor_label": lambda: lm.label(anchor(morph_chain(x)), connectivity=2),
        "label_alone": lambda: lm.label(mask, connectivity=2),
        "morph_hpass": probe(hpass),
        "morph_vpass": probe(lambda lab, fg: lm.vertical_pass(lab, fg, 2, reverse=False)),
        "morph_sweep1": probe(lambda lab, fg: lm._fixpoint(lab, fg, 2, 1)),
        "morph_fix": probe(lambda lab, fg: lm._fixpoint(lab, fg, 2, 64)),
        "props": lambda: regionprops_fused(fixed, x, num_segments=NUM_SEGMENTS),
        "props_plain": lambda: regionprops_fused(fixed_cpu, x_cpu, num_segments=NUM_SEGMENTS),
        "rsmall": lambda: lm.remove_small_objects(fixed, MIN_AREA, RSMALL_SEGMENTS),
        "chain": lambda: chain(x),
        "chain_anchor": lambda: chain(x, anchored=True),
        "chain_plain": lambda: chain(x_cpu),
    }


def time_call(fn: Callable[[], object], device: torch.device, iters: int, warmup: int = 3) -> float:
    """Mean seconds of ``fn()``: on the card between two CUDA events after
    ``warmup`` calls, synchronised; on the CPU by the host clock."""
    for _ in range(warmup):
        fn()
    if device.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        return (time.perf_counter() - t0) / iters
    torch.cuda.synchronize(device)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize(device)
    return start.elapsed_time(end) / 1e3 / iters


class _Printing(dict):
    """Results that print themselves as the JAX lab's do."""

    def __setitem__(self, name, v):
        super().__setitem__(name, v)
        if name.endswith("fps"):
            print(f"{name:24s} {v:10.1f} frames/s", flush=True)
        else:
            print(f"{name:24s} {v * 1e3:10.2f} ms/batch", flush=True)


def run(which: Sequence[str] = (), shape: Optional[Tuple[int, int]] = None, device="cuda") -> Dict[str, float]:
    """Time the experiments named in ``which`` (all if empty) on the lab's
    frames; returns {name: seconds per batch, *_fps: frames per second}."""
    unknown = sorted(set(which) - set(EXPERIMENTS))
    if unknown:
        raise ValueError(f"unknown experiments {unknown}; known: {', '.join(EXPERIMENTS)}")
    device = resolve_device(device)
    frames = lab_frames(shape)
    x = torch.from_numpy(frames).to(device)
    name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    print(f"device={name} batch={tuple(frames.shape)}", flush=True)
    results = _Printing()
    with torch.inference_mode():
        exps = experiments(x)
        for exp in EXPERIMENTS:
            if which and exp not in which:
                continue
            if exp in PLAIN:
                t = time_call(exps[exp], torch.device("cpu"), iters=ITERS // 5, warmup=1)
            else:
                t = time_call(exps[exp], device, iters=ITERS)
            results[exp] = t
            if exp.startswith("chain"):
                results[f"{exp}_fps"] = frames.shape[0] / t
    return dict(results)


def parse_shape(text: str) -> Tuple[int, int]:
    H, W = (int(v) for v in text.lower().split("x"))
    return H, W


def main(argv: Optional[List[str]] = None) -> Dict[str, float]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("experiments", nargs="*", help=f"any of {', '.join(EXPERIMENTS)} (default: all)")
    ap.add_argument("--shape", type=parse_shape, default=None, help="frame HxW (default 1024x1024)")
    ap.add_argument("--device", default="cuda", help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    return run(args.experiments, shape=args.shape, device=args.device)


if __name__ == "__main__":
    main(sys.argv[1:])
