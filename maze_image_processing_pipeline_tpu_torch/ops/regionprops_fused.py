"""Fused region measurement of whole label frames (the hot-path regionprops).

Counterpart of ``maze_image_processing_pipeline_tpu/ops/regionprops_fused.py``
with the same keys and formulas. Per-region sums are scatter-adds over the
region axis; per-row and per-column presence counts give the bounding boxes
and the separable second moments; per-row x extremes (``scatter_reduce``
amin/amax) give the feret diameter; the 256-bin intensity histogram is one
``bincount`` of ``label * 256 + bin``. Labels at or above ``num_segments``
are not measured.

Integer results (counts, areas, bounding boxes, histograms) are exact. The
per-region sums and moments accumulate in float64 and are returned as
float32: on the card the scatter-adds run through atomics in no fixed order,
and a float32 sum over a region as large as the background (millions of
pixels, and ``Σ (x − cx)`` cancelling within every row) would differ from a
CPU run by ~1e-4 relative.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch

from .regionprops import marching_squares_length

__all__ = ["regionprops_fused", "feret_from_row_extremes"]


def feret_from_row_extremes(
    rowminx: torch.Tensor,
    rowmaxx: torch.Tensor,
    row_present: torch.Tensor,
    n_angles: int = 16,
) -> torch.Tensor:
    """Max-caliper (feret) diameter from per-row x extremes.

    For any direction the projection extreme of a region is attained at a
    per-row x-min or x-max, so the K-angle sweep over these points equals
    the sweep over all pixels.

    Args:
        rowminx / rowmaxx: (..., H, R) per-row min/max x per region.
        row_present: (..., H, R) bool, region occupies this row.
        n_angles: projection count.

    Returns:
        (..., R) max extent over the angles + 1.
    """
    H = rowminx.shape[-2]
    hh = torch.arange(H, dtype=torch.float32, device=rowminx.device)[:, None]
    extents = []
    for k in range(n_angles):
        a = k * math.pi / n_angles
        c, s = math.cos(a), math.sin(a)
        p1 = hh * c + rowminx * s
        p2 = hh * c + rowmaxx * s
        hi = torch.where(row_present, torch.maximum(p1, p2), -1e9).amax(dim=-2)
        lo = torch.where(row_present, torch.minimum(p1, p2), 1e9).amin(dim=-2)
        extents.append(hi - lo)
    return torch.stack(extents, dim=-1).amax(dim=-1) + 1.0


def _per_pixel_perimeter(fg: torch.Tensor) -> torch.Tensor:
    """Each 2×2 block's contour length, given to its raster-last fg corner."""
    block_len = marching_squares_length(fg)  # (B, H+1, W+1)
    m = torch.nn.functional.pad(fg.to(torch.int32), (1, 1, 1, 1)).bool()
    a = m[..., :-1, :-1]
    b = m[..., :-1, 1:]
    c = m[..., 1:, :-1]
    d = m[..., 1:, 1:]
    to_d = d
    to_c = c & ~d
    to_b = b & ~c & ~d
    to_a = a & ~b & ~c & ~d
    zero = torch.zeros((), dtype=torch.float32, device=fg.device)
    # Block (i, j) corners: a=(i-1, j-1) b=(i-1, j) c=(i, j-1) d=(i, j).
    out = torch.zeros(fg.shape, dtype=torch.float32, device=fg.device)
    out = out + torch.where(to_d, block_len, zero)[..., :-1, :-1]
    out = out + torch.where(to_c, block_len, zero)[..., :-1, 1:]
    out = out + torch.where(to_b, block_len, zero)[..., 1:, :-1]
    out = out + torch.where(to_a, block_len, zero)[..., 1:, 1:]
    return out


def regionprops_fused(
    labels: torch.Tensor,
    intensity: Optional[torch.Tensor] = None,
    *,
    num_segments: int,
    compute_histogram: bool = True,
    n_feret_angles: int = 16,
) -> Dict[str, torch.Tensor]:
    """Measure all regions of a batch of label images.

    Args:
        labels: int (..., H, W), ids in [0, R], 0 = background.
        intensity: optional (..., H, W) uint8-range intensity image.
        num_segments: region axis size R (ids < R are measured).
        compute_histogram: per-region 256-bin histograms.
        n_feret_angles: projection count of the feret diameter (0 = off).

    Returns:
        dict of (..., R) float32 tensors (``histogram``: (..., R, 256)).
    """
    batch_shape = labels.shape[:-2]
    H, W = labels.shape[-2:]
    R = num_segments
    dev = labels.device
    lab = labels.reshape(-1, H, W).long()
    B = lab.shape[0]
    # Region index with one spare slot R that collects unmeasured ids.
    seg = torch.where((lab >= 0) & (lab < R), lab, R)
    seg_flat = seg.reshape(B, H * W)
    f32, f64 = torch.float32, torch.float64

    def reduce_hw(values: torch.Tensor) -> torch.Tensor:  # Σ per region
        acc = torch.zeros(B, R + 1, dtype=f64, device=dev)
        acc.scatter_add_(1, seg_flat, values.reshape(B, H * W).to(f64))
        return acc[:, :R].to(f32)

    def gather_px(per_region: torch.Tensor) -> torch.Tensor:  # (B, R) → pixels
        padded = torch.cat([per_region, torch.zeros_like(per_region[:, :1])], dim=1)
        return torch.gather(padded, 1, seg_flat).reshape(B, H, W)

    ones_i = torch.ones(B, H, W, dtype=torch.int32, device=dev)
    rowcnt = torch.zeros(B, H, R + 1, dtype=torch.int32, device=dev)
    rowcnt.scatter_add_(2, seg, ones_i)
    rowcnt = rowcnt[..., :R].to(f32)  # (B, H, R)
    colcnt = torch.zeros(B, W, R + 1, dtype=torch.int32, device=dev)
    colcnt.scatter_add_(2, seg.transpose(1, 2).contiguous(), ones_i.transpose(1, 2))
    colcnt = colcnt[..., :R].to(f32)  # (B, W, R)
    area = rowcnt.sum(dim=1)
    safe_area = torch.clamp(area, min=1.0)

    perim = reduce_hw(_per_pixel_perimeter(lab > 0))

    # Moments in float64 (see the module docstring), returned as float32.
    hh = torch.arange(H, dtype=f64, device=dev)[None, :, None]
    ww = torch.arange(W, dtype=f64, device=dev)[None, :, None]
    rc, cc, sa = rowcnt.to(f64), colcnt.to(f64), safe_area.to(f64)
    cy = (rc * hh).sum(dim=1) / sa
    cx = (cc * ww).sum(dim=1) / sa
    mu20 = (rc * (hh - cy[:, None, :]) ** 2).sum(dim=1).to(f32)
    mu02 = (cc * (ww - cx[:, None, :]) ** 2).sum(dim=1).to(f32)

    # Σ (y−cy)(x−cx) = Σ_y (y−cy) · Σ_{x∈row} (x−cx): centre x per pixel,
    # sum per (row, region), then weight the rows.
    xc = torch.arange(W, dtype=f64, device=dev) - gather_px(cx)  # (B, H, W)
    rowxc = torch.zeros(B, H, R + 1, dtype=f64, device=dev)
    rowxc.scatter_add_(2, seg, xc)
    mu11 = ((hh - cy[:, None, :]) * rowxc[..., :R]).sum(dim=1).to(f32)
    cy, cx = cy.to(f32), cx.to(f32)
    hh, ww = hh.to(f32), ww.to(f32)
    xs = torch.arange(W, dtype=f32, device=dev)

    row_present = rowcnt > 0
    col_present = colcnt > 0
    min_row = torch.where(row_present, hh, float(H + 1)).amin(dim=1)
    max_row = torch.where(row_present, hh, -1.0).amax(dim=1) + 1
    min_col = torch.where(col_present, ww, float(W + 1)).amin(dim=1)
    max_col = torch.where(col_present, ww, -1.0).amax(dim=1) + 1

    feret = None
    if n_feret_angles:
        x_px = xs.expand(B, H, W).contiguous()
        rowminx = torch.full((B, H, R + 1), 1e9, dtype=f32, device=dev)
        rowminx = rowminx.scatter_reduce(2, seg, x_px, reduce="amin")[..., :R]
        rowmaxx = torch.full((B, H, R + 1), -1e9, dtype=f32, device=dev)
        rowmaxx = rowmaxx.scatter_reduce(2, seg, x_px, reduce="amax")[..., :R]
        feret = feret_from_row_extremes(rowminx, rowmaxx, row_present, n_angles=n_feret_angles)

    # Ellipse fit (skimage formulas: 4·sqrt of the inertia eigenvalues).
    m20 = mu20 / safe_area
    m02 = mu02 / safe_area
    m11 = mu11 / safe_area
    common = torch.sqrt(torch.clamp((m20 - m02) ** 2 + 4 * m11 * m11, min=0.0))
    lam1 = (m20 + m02 + common) / 2
    lam2 = (m20 + m02 - common) / 2

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
        "axis_major_length": 4.0 * torch.sqrt(torch.clamp(lam1, min=0.0)),
        "axis_minor_length": 4.0 * torch.sqrt(torch.clamp(lam2, min=0.0)),
        "orientation": 0.5 * torch.atan2(2.0 * m11, m20 - m02),
        "eccentricity": torch.sqrt(
            torch.clamp(1.0 - lam2 / torch.clamp(lam1, min=1e-12), min=0.0)
        ),
        "perimeter": perim,
    }
    if feret is not None:
        props["feret_diameter_max"] = feret

    if intensity is not None:
        inten = intensity.reshape(-1, H, W).to(f32)
        s1 = reduce_hw(inten)
        safe_s1 = torch.where(s1 != 0, s1, 1.0)
        mean = s1 / safe_area

        hist = None
        if compute_histogram:
            bins = torch.clamp(inten, 0, 255).to(torch.long)
            frame = torch.arange(B, device=dev)[:, None, None] * ((R + 1) * 256)
            joint = (frame + seg * 256 + bins).reshape(-1)
            counts = torch.bincount(joint, minlength=B * (R + 1) * 256)
            hist = counts.reshape(B, R + 1, 256)[:, :R].to(f32)
            props["histogram"] = hist

        if hist is not None and not intensity.dtype.is_floating_point:
            # Central moments from the integer-bin counts (float64 sums).
            c_bins = torch.arange(256, dtype=f32, device=dev)
            h64, sa = hist.to(f64), safe_area.to(f64)[..., None]
            d = c_bins.to(f64)[None, None, :] - mean.to(f64)[..., None]  # (B, R, 256)
            var = torch.clamp((h64 * d * d / sa).sum(-1), min=0.0).to(f32)
            m3 = (h64 * d**3 / sa).sum(-1).to(f32)
            m4 = (h64 * d**4 / sa).sum(-1).to(f32)
            present = hist > 0
            imin = torch.where(present, c_bins, 1e9).amin(-1)
            imax = torch.where(present, c_bins, -1e9).amax(-1)
        else:
            # Float intensities: mean-shifted passes per pixel.
            di = inten - gather_px(mean)
            var = torch.clamp(reduce_hw(di * di) / safe_area, min=0.0)
            m3 = reduce_hw(di * di * di) / safe_area
            m4 = reduce_hw(di * di * di * di) / safe_area
            flat = inten.reshape(B, H * W)
            imin = torch.full((B, R + 1), 1e9, dtype=f32, device=dev)
            imin = imin.scatter_reduce(1, seg_flat, flat, reduce="amin")[:, :R]
            imax = torch.full((B, R + 1), -1e9, dtype=f32, device=dev)
            imax = imax.scatter_reduce(1, seg_flat, flat, reduce="amax")[:, :R]

        std = torch.sqrt(var)
        # Guard: std**3 / std**4 underflow float32 for near-constant regions.
        ok = std > 1e-3
        std_safe = torch.where(ok, std, 1.0)
        yy = torch.arange(H, dtype=f32, device=dev)[:, None].expand(H, W)
        xx = xs[None, :].expand(H, W)
        props.update(
            intensity_sum=s1,
            intensity_mean=mean,
            intensity_std=std,
            intensity_skew=torch.where(ok, m3 / std_safe**3, 0.0),
            intensity_kurtosis=torch.where(ok, m4 / std_safe**4 - 3.0, 0.0),
            weighted_centroid_row=reduce_hw(inten * yy) / safe_s1,
            weighted_centroid_col=reduce_hw(inten * xx) / safe_s1,
            intensity_min=imin,
            intensity_max=imax,
        )

    return {k: v.reshape(batch_shape + v.shape[1:]) for k, v in props.items()}
