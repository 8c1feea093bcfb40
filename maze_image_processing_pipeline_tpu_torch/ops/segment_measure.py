"""Measurement of semantic-segmentation channels (predict workload).

Counterpart of ``maze_image_processing_pipeline_tpu/ops/segment_measure.py``,
with the same results. For a batch of thresholded channel masks, on the
device that holds them:

* the raw area of each mask;
* optional hole filling: a hole is a 4-connected background component that
  does not touch the border (right/bottom zero padding is itself
  border-connected background, so padded crops measure like their true
  extents);
* the largest 8-connected component (the first maximum in raster id order):
  its area, ``axis_major_length`` and per-row x extremes, from which the
  host computes the exact filled convex hull
  (:func:`convex_area_from_extremes`);
* an overflow flag where a mask has more components than the bounds the JAX
  package measures (``num_segments`` foreground, ``n_bg_segments``
  background ids), so that the caller falls back to the host path exactly
  where the JAX package does.

Labels come from :func:`.label.label` (the CCL kernels K1, K2 and K4 on the
card). Per-id tables use :func:`.label._per_frame_bincount` instead of the
JAX package's one-hot reductions; the moment sums accumulate in float64 and
are returned as float32. On the card nothing here waits for the device:
the extents go up from page-locked memory without blocking, and the border
pixels are picked by a cached index rather than a boolean mask.
"""

from __future__ import annotations

import functools
from typing import Dict, Sequence, Tuple

import numpy as np
import torch

from .. import tracing
from .label import _per_frame_bincount, label

__all__ = [
    "measure_largest_component",
    "measure_channels_packed",
    "unpack_channel_stats",
    "convex_area_from_extremes",
    "cast_for_transfer",
]


@functools.lru_cache(maxsize=64)
def _border_index(H: int, W: int, device: torch.device) -> torch.Tensor:
    """int64 flat positions of an (H, W) frame's border pixels in raster
    order: the pixels a boolean border mask selects, made on ``device``
    from ranges alone (a mask selection reads its count back to the host)."""
    if H <= 2 or W <= 2:  # every pixel lies on the border
        return torch.arange(H * W, device=device)
    rows = torch.arange(1, H - 1, device=device) * W
    sides = torch.stack([rows, rows + (W - 1)], dim=1).reshape(-1)
    return torch.cat([torch.arange(W, device=device), sides, torch.arange((H - 1) * W, H * W, device=device)])


def measure_largest_component(
    masks: torch.Tensor,
    *,
    fill_holes: bool,
    num_segments: int = 32,
    n_bg_segments: int = 64,
) -> Tuple[Dict[str, torch.Tensor], torch.Tensor, torch.Tensor, torch.Tensor]:
    """Measure the largest 8-connected component of each mask in a batch.

    Args:
        masks: (N, H, W) thresholded channel predictions (zero padded).
        fill_holes: fill enclosed background before labelling.
        num_segments / n_bg_segments: the foreground / background component
            counts beyond which a mask is flagged as overflowing.

    Returns:
        (props, raw_area, extremes, overflow): ``props`` maps area /
        axis_major_length / centroid_row / centroid_col / orientation to (N,)
        float32 tensors (zero for an empty mask); ``raw_area`` is the
        pre-fill int32 pixel count (N,); ``extremes`` is (N, H, 3) float32
        ``[rowminx, rowmaxx, row_present]`` of the largest component;
        ``overflow`` is (N,) bool, true where the JAX package's one-hot
        bounds cannot measure the mask (the caller must measure it on the
        host).
    """
    masks = masks.bool()
    N, H, W = masks.shape
    dev = masks.device
    raw_area = masks.sum(dim=(1, 2), dtype=torch.int32)

    n_bg = None
    if fill_holes:
        bg_lab, n_bg = label(~masks, connectivity=1)
        border_ids = bg_lab.reshape(N, H * W).index_select(1, _border_index(H, W, dev))  # (N, border pixels)
        touches = _per_frame_bincount(border_ids, n_bg_segments) > 0  # (N, n_bg_segments)
        inside = bg_lab < n_bg_segments
        # Components beyond the bound stay unfilled (as in the JAX package).
        outer = torch.gather(touches, 1, torch.where(inside, bg_lab, 0).reshape(N, -1)).reshape(N, H, W)
        outer = outer | ~inside
        masks = masks | (~masks & ~outer)

    labels, n = label(masks, connectivity=2)
    areas_r = _per_frame_bincount(labels.reshape(N, -1), num_segments)
    areas_r[:, 0] = 0  # background
    best = torch.argmax(areas_r, dim=1)  # first maximum: raster id order
    area = torch.gather(areas_r, 1, best[:, None])[:, 0].double()
    has = area > 0

    bm = (labels == best[:, None, None].to(labels.dtype)) & masks
    bmf = bm.double()
    yy = torch.arange(H, dtype=torch.float64, device=dev)[None, :, None]
    xx = torch.arange(W, dtype=torch.float64, device=dev)[None, None, :]
    safe = torch.clamp(area, min=1.0)
    cy = (bmf * yy).sum(dim=(1, 2)) / safe
    cx = (bmf * xx).sum(dim=(1, 2)) / safe
    dy = yy - cy[:, None, None]
    dx = xx - cx[:, None, None]
    m20 = (bmf * dy * dy).sum(dim=(1, 2)) / safe
    m02 = (bmf * dx * dx).sum(dim=(1, 2)) / safe
    m11 = (bmf * dy * dx).sum(dim=(1, 2)) / safe
    common = torch.sqrt(torch.clamp((m20 - m02) ** 2 + 4 * m11 * m11, min=0.0))
    lam1 = (m20 + m02 + common) / 2
    axis_major = 4.0 * torch.sqrt(torch.clamp(lam1, min=0.0))
    orientation = 0.5 * torch.atan2(2 * m11, m20 - m02)

    zero = torch.zeros((), dtype=torch.float64, device=dev)
    props = {
        "area": torch.where(has, area, zero),
        "axis_major_length": torch.where(has, axis_major, zero),
        "centroid_row": torch.where(has, cy, zero),
        "centroid_col": torch.where(has, cx, zero),
        "orientation": torch.where(has, orientation, zero),
    }
    props = {k: v.float() for k, v in props.items()}
    xs = torch.arange(W, dtype=torch.float32, device=dev)[None, None, :]
    row_present = bm.any(dim=2)
    rowminx = torch.where(bm, xs, float(W)).amin(dim=2)
    rowmaxx = torch.where(bm, xs, -1.0).amax(dim=2)
    extremes = torch.stack(
        [
            torch.where(row_present, rowminx, 0.0),
            torch.where(row_present, rowmaxx, 0.0),
            row_present.float(),
        ],
        dim=-1,
    )
    overflow = n > num_segments - 1
    if n_bg is not None:
        overflow = overflow | (n_bg > n_bg_segments - 1)
    return props, raw_area, extremes, overflow


@tracing.span("measure")
def measure_channels_packed(
    canvas: torch.Tensor,
    hs: Sequence[int],
    ws: Sequence[int],
    *,
    fill_channels: Sequence[bool],
    num_segments: int = 32,
    n_bg_segments: int = 64,
) -> torch.Tensor:
    """Measure every channel of a chunk of blended predictions where they
    lie (the fused measurement of ``DeviceTiledInference``).

    Args:
        canvas: (Bo, Hb, Wb, C) float32 probabilities; content beyond each
            object's true extent is not measured.
        hs / ws: (Bo,) true per-object extents.
        fill_channels: per-channel hole filling.

    Returns:
        flat float32 of ``(4 + 3*Hb) * C * Bo`` values: raw_area, area,
        axis_major_length, overflow — each (C, Bo) — then row extremes
        (C, Bo, Hb, 3), the layout of the JAX package's
        ``measure_channels_packed``. Decode with :func:`unpack_channel_stats`.
    """
    Bo, Hb, Wb, C = canvas.shape
    dev = canvas.device
    # Page-locked and asynchronous on the card: a copy from pageable memory
    # would wait for the work queued before it.
    host = torch.tensor([list(hs), list(ws)], dtype=torch.int64, pin_memory=dev.type == "cuda")
    hs_t, ws_t = host.to(dev, non_blocking=True)
    extent = (torch.arange(Hb, device=dev)[None, :, None] < hs_t[:, None, None]) & (
        torch.arange(Wb, device=dev)[None, None, :] < ws_t[:, None, None]
    )
    small, extremes_all = [], []
    for c in range(C):
        masks = (canvas[..., c] > 0.5) & extent
        props, raw, extremes, overflow = measure_largest_component(
            masks, fill_holes=bool(fill_channels[c]), num_segments=num_segments, n_bg_segments=n_bg_segments
        )
        small.append(torch.stack([raw.float(), props["area"], props["axis_major_length"], overflow.float()]))
        extremes_all.append(extremes)
    return torch.cat([torch.stack(small).reshape(-1), torch.stack(extremes_all).reshape(-1)])


def unpack_channel_stats(flat: np.ndarray, Bo: int, Hb: int, C: int):
    """Decode :func:`measure_channels_packed`'s buffer →
    (small (C, 4, Bo) float32, extremes (C, Bo, Hb, 3) float32)."""
    flat = np.asarray(flat)
    n_small = C * 4 * Bo
    small = flat[:n_small].reshape(C, 4, Bo)
    extremes = flat[n_small:].reshape(C, Bo, Hb, 3)
    return small, extremes


def cast_for_transfer(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Cast a probability canvas for the device→host transfer.

    ``uint8`` quantizes to 1/255 resolution, rounding half DOWN so the
    stored-value threshold ``>= 128`` keeps the strict ``p > 0.5`` at the
    exact boundary; any other dtype is a plain cast."""
    if dtype == torch.uint8:
        return torch.clamp(torch.ceil(x * 255.0 - 0.5), 0.0, 255.0).to(torch.uint8)
    return x.to(dtype)


def convex_area_from_extremes(extremes: np.ndarray, shape) -> float:
    """Pixel count of the filled convex hull from (H, 3) row extremes.

    A copy of the JAX package's ``convex_area_from_extremes`` (cv2
    ``fillPoly`` pixel count): the hull of the ≤2H per-row extreme points
    equals the hull of all mask pixels.
    """
    import cv2

    rows = np.nonzero(extremes[:, 2] > 0)[0]
    if rows.size == 0:
        return 0.0
    pts = np.concatenate(
        [
            np.stack([extremes[rows, 0], rows], axis=-1),
            np.stack([extremes[rows, 1], rows], axis=-1),
        ]
    ).astype(np.int32)
    if len(pts) < 3:
        return float(len(np.unique(pts, axis=0)))
    hull = cv2.convexHull(pts.reshape(-1, 1, 2))
    canvas = np.zeros(shape, np.uint8)
    cv2.fillPoly(canvas, [hull], 1)
    return float(canvas.sum())
