"""Batched per-region measurement: the general ``regionprops``, hole filling
and the marching-squares contour length.

Counterpart of ``maze_image_processing_pipeline_tpu/ops/regionprops.py``:

* :func:`regionprops` measures every region of a batch of label frames with
  segment reductions over the label image (``scatter_add`` /
  ``scatter_reduce``, as the JAX function's ``segment_sum`` / ``_min`` /
  ``_max``, which run outside any Pallas kernel): the same keys, the same
  background and empty-region sentinels, and the same centroid-shifted
  second pass on the same float32 terms, summed in float64 (so that the
  card's result does not depend on the order of its atomics). The histogram goes through :func:`.region_histogram.
  region_histogram`, K3 on the card (``csrc/region_measure.cu``).
* :func:`fill_holes` labels the background 4-connected with
  :func:`.label.label` (on the card the ``ccl_fixpoint`` launch of K1 + K4
  and K2's compaction) and fills every component that does not touch the
  frame's border.
* :func:`marching_squares_length`, shared with the fused measurement: each
  2×2 block of the padded mask contributes the calibrated length of its
  0.5-level isoline.

Labels outside [0, ``num_segments``) are not measured, as the JAX segment
reductions drop them.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch
import torch.nn.functional as F

from .label import label
from .region_histogram import region_histogram

__all__ = ["regionprops", "fill_holes", "bbox_from_props", "marching_squares_length"]

# Boundary-segment weights: corner cuts are down-weighted to 0.65 so the
# estimator tracks the length of digitised curved boundaries.
_W_STRAIGHT = 1.0
_W_CUT = 0.65
_W_DOUBLE = 2 * _W_CUT


def marching_squares_length(fg: torch.Tensor) -> torch.Tensor:
    """Per-2×2-block contour length, (..., H+1, W+1) float32."""
    m = F.pad(fg.to(torch.int32), (1, 1, 1, 1))
    a = m[..., :-1, :-1]
    b = m[..., :-1, 1:]
    c = m[..., 1:, :-1]
    d = m[..., 1:, 1:]
    count = a + b + c + d
    diag = (a == d) & (b == c) & (a != b)
    two = torch.where(diag, _W_DOUBLE, _W_STRAIGHT)
    length = torch.where(count == 2, two, 0.0)
    return torch.where((count == 1) | (count == 3), _W_CUT, length).to(torch.float32)


class _Segments:
    """Segment reductions of (B, P) values over (B, P) ids in [0, R); other
    ids go to a spare slot R that is cut off. Sums add the float32 terms in
    float64 and round once: the card's atomics add in no fixed order, and a
    float32 sum of a region's thousands of terms (the background's
    millions) would carry that order's rounding."""

    def __init__(self, ids: torch.Tensor, R: int) -> None:
        ids = ids.long()
        self.R = R
        self.ids = torch.where((ids >= 0) & (ids < R), ids, R)

    def _reduce(self, values: torch.Tensor, reduce: str, init: float) -> torch.Tensor:
        out = torch.full((values.shape[0], self.R + 1), init, dtype=values.dtype, device=values.device)
        if reduce == "sum":
            return out.scatter_add_(1, self.ids, values)
        return out.scatter_reduce_(1, self.ids, values, reduce=reduce, include_self=True)

    def sum(self, values: torch.Tensor) -> torch.Tensor:
        return self._reduce(values.double(), "sum", 0.0)[:, : self.R].to(values.dtype)

    def min(self, values: torch.Tensor) -> torch.Tensor:
        return self._reduce(values, "amin", math.inf)[:, : self.R]

    def max(self, values: torch.Tensor) -> torch.Tensor:
        return self._reduce(values, "amax", -math.inf)[:, : self.R]

    def spread(self, per_region: torch.Tensor) -> torch.Tensor:
        """(B, R) → the value of each pixel's region (0 where its id is not
        measured: those pixels are dropped from every reduction)."""
        return F.pad(per_region, (0, 1)).gather(1, self.ids)


def regionprops(
    labels: torch.Tensor,
    intensity: Optional[torch.Tensor] = None,
    *,
    num_segments: int,
    compute_histogram: bool = False,
    n_feret_angles: int = 16,
) -> Dict[str, torch.Tensor]:
    """Measure all regions of (a batch of) label images.

    Args:
        labels: integer (..., H, W) label image, 0 = background.
        intensity: optional (..., H, W) intensity image (any real dtype).
        num_segments: region-axis size (max label id + 1).
        compute_histogram: also return 256-bin intensity histograms
            (uint8-range intensity: clipped to 0..255 and truncated).
        n_feret_angles: projection count for the feret-diameter estimate
            (0 disables).

    Returns:
        dict of float32 tensors with trailing region axis ``num_segments``:
        area, bbox (min_row, min_col, max_row, max_col — max exclusive),
        centroid_row/col, mu20/mu02/mu11 (central moments),
        axis_major_length, axis_minor_length, orientation, eccentricity,
        perimeter, feret_diameter_max (if enabled), plus intensity stats
        (intensity_sum/mean/std/min/max, weighted centroid, skew, kurtosis)
        and the (..., num_segments, 256) histogram.
    """
    H, W = labels.shape[-2:]
    batch_shape = labels.shape[:-2]
    R = num_segments
    dev = labels.device
    flat = labels.reshape(-1, H * W)
    B = flat.shape[0]
    seg = _Segments(flat, R)
    inside = flat > 0

    yf = torch.arange(H, dtype=torch.float32, device=dev).repeat_interleave(W).expand(B, H * W)
    xf = torch.arange(W, dtype=torch.float32, device=dev).repeat(H).expand(B, H * W)

    area = seg.sum(torch.ones((B, H * W), dtype=torch.float32, device=dev))
    safe_area = torch.clamp(area, min=1.0)
    cy = seg.sum(yf) / safe_area
    cx = seg.sum(xf) / safe_area

    # Second pass: centroid-shifted second moments (cancellation-safe).
    dy = yf - seg.spread(cy)
    dx = xf - seg.spread(cx)
    mu20 = seg.sum(dy * dy)
    mu02 = seg.sum(dx * dx)
    mu11 = seg.sum(dy * dx)

    # Bounding boxes (background gets harmless sentinels).
    big = float(max(H, W) + 1)
    min_row = seg.min(torch.where(inside, yf, big))
    min_col = seg.min(torch.where(inside, xf, big))
    max_row = seg.max(torch.where(inside, yf, -1.0)) + 1
    max_col = seg.max(torch.where(inside, xf, -1.0)) + 1

    # Ellipse fit (skimage convention: 4·sqrt(eigenvalue of inertia tensor)).
    m20 = mu20 / safe_area
    m02 = mu02 / safe_area
    m11 = mu11 / safe_area
    common = torch.sqrt(torch.clamp((m20 - m02) ** 2 + 4 * m11 * m11, min=0.0))
    lam1 = (m20 + m02 + common) / 2
    lam2 = (m20 + m02 - common) / 2
    axis_major = 4.0 * torch.sqrt(torch.clamp(lam1, min=0.0))
    axis_minor = 4.0 * torch.sqrt(torch.clamp(lam2, min=0.0))
    # Angle of the major axis from the row axis, CCW, in (-pi/2, pi/2].
    orientation = 0.5 * torch.atan2(2.0 * m11, m20 - m02)
    ecc = torch.sqrt(torch.clamp(1.0 - lam2 / torch.clamp(lam1, min=1e-12), min=0.0))

    # Perimeter: each 2×2 block's contour length goes to its region (the
    # max label in the block: blocks never span two 8-connected regions).
    lab_pad = F.pad(flat.reshape(B, H, W), (1, 1, 1, 1))
    block_label = torch.maximum(
        torch.maximum(lab_pad[..., :-1, :-1], lab_pad[..., :-1, 1:]),
        torch.maximum(lab_pad[..., 1:, :-1], lab_pad[..., 1:, 1:]),
    )
    block_len = marching_squares_length(inside.reshape(B, H, W))
    perim = _Segments(block_label.reshape(B, -1), R).sum(block_len.reshape(B, -1))

    props: Dict[str, torch.Tensor] = {
        "area": area,
        "min_row": min_row,
        "min_col": min_col,
        "max_row": max_row,
        "max_col": max_col,
        "centroid_row": cy,
        "centroid_col": cx,
        "mu20": mu20,
        "mu02": mu02,
        "mu11": mu11,
        "axis_major_length": axis_major,
        "axis_minor_length": axis_minor,
        "orientation": orientation,
        "eccentricity": ecc,
        "perimeter": perim,
    }

    if n_feret_angles:
        # Max caliper diameter ≈ max over K projection angles of the extent.
        K = n_feret_angles
        angles = torch.arange(K, dtype=torch.float32, device=dev) * (math.pi / K)
        cos_a, sin_a = torch.cos(angles), torch.sin(angles)
        extents = []
        for k in range(K):
            proj = yf * cos_a[k] + xf * sin_a[k]
            extents.append(seg.max(torch.where(inside, proj, -1e9)) - seg.min(torch.where(inside, proj, 1e9)))
        props["feret_diameter_max"] = torch.amax(torch.stack(extents, dim=-1), dim=-1) + 1.0

    if intensity is not None:
        inten = intensity.reshape(B, H * W).to(torch.float32)
        s1 = seg.sum(inten)
        mean = s1 / safe_area
        # Central moments via a mean-shifted pass (cancellation-safe in f32).
        di = inten - seg.spread(mean)
        var = torch.clamp(seg.sum(di * di) / safe_area, min=0.0)
        std = torch.sqrt(var)
        m3 = seg.sum(di * di * di) / safe_area
        m4 = seg.sum(di * di * di * di) / safe_area
        std_safe = torch.clamp(std, min=1e-12)
        std_sq = std_safe * std_safe  # std³ and std⁴ as jax.lax.integer_pow forms them
        safe_s1 = torch.where(s1 != 0, s1, 1.0)
        props.update(
            intensity_sum=s1,
            weighted_centroid_row=seg.sum(inten * yf) / safe_s1,
            weighted_centroid_col=seg.sum(inten * xf) / safe_s1,
            intensity_mean=mean,
            intensity_std=std,
            intensity_min=seg.min(torch.where(inside, inten, 1e9)),
            intensity_max=seg.max(torch.where(inside, inten, -1e9)),
            intensity_skew=m3 / (std_safe * std_sq),
            intensity_kurtosis=m4 / (std_sq * std_sq) - 3.0,
        )

        if compute_histogram:
            lab32 = flat.reshape(B, H, W).to(torch.int32)
            props["histogram"] = region_histogram(lab32, intensity.reshape(B, H, W), R)

    return {k: v.reshape(batch_shape + v.shape[1:]) for k, v in props.items()}


def fill_holes(mask: torch.Tensor, max_iters: int = 64) -> torch.Tensor:
    """Fill holes: background components not connected to the image border.

    The background is labelled 4-connected (the complement connectivity of
    the 8-connected foreground). Parity: ``scipy.ndimage.binary_fill_holes``
    as used at ``predict/pipeline.py:87-96``.
    """
    fg = mask.bool()
    H, W = fg.shape[-2:]
    bg_labels, _ = label(~fg, connectivity=1, max_iters=max_iters)
    flat = bg_labels.reshape(-1, H * W)

    border = torch.zeros((H, W), dtype=torch.float32, device=fg.device)
    border[0, :] = border[-1, :] = 1
    border[:, 0] = border[:, -1] = 1

    # The component ids are compact raster ranks, at most ceil(H·W/2) (a
    # checkerboard): a cap of H·W//2 + 2 segments holds every one.
    cap = H * W // 2 + 2
    root_idx = torch.clamp(flat, 0, H * W)
    touches = _Segments(root_idx, cap).max(border.reshape(1, -1).expand_as(flat).contiguous()) > 0
    touch_px = touches.gather(1, torch.clamp(flat, 0, cap - 1).long())
    filled = fg.reshape(flat.shape) | ~touch_px
    return filled.reshape(fg.shape)


def bbox_from_props(props: Dict[str, torch.Tensor], index: int):
    """(min_row, min_col, max_row, max_col) ints for one region index."""
    return (
        int(props["min_row"][..., index]),
        int(props["min_col"][..., index]),
        int(props["max_row"][..., index]),
        int(props["max_col"][..., index]),
    )
