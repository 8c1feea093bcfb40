"""Fused region measurement of whole label frames (the hot-path regionprops).

Counterpart of ``maze_image_processing_pipeline_tpu/ops/regionprops_fused.py``
with the same keys and formulas. Every statistic derives from a few
partials: per-region sums (perimeter, intensity, intensity·y, intensity·x),
per-(row, region) count, x-sum and x-extremes, per-(column, region) count and
the 256-bin histogram. The row and column counts give the bounding boxes,
the centroids and the separable second moments; the row x-extremes give the
feret diameter; the histogram gives the intensity moments and extremes.
Labels at or above ``num_segments`` are not measured.

On a CUDA tensor :func:`regionprops_fused` computes the partials and the
histogram with one launch of the region-measurement kernel
(``csrc/region_measure.cu``: K7, replacing ``regionprops_fused_pallas`` of
``attic/pallas_props.py``, and K3, replacing ``region_histogram_pallas`` of
``attic/pallas_hist.py``, in one read of the labels and the intensity; its
accumulators in shared memory at every shape a path measures, in device
memory for larger R or wider frames, as
:func:`.region_histogram.region_measure_plan` chooses); it takes uint8
intensity only, and raises if the kernel does not launch. On the CPU it
runs :func:`regionprops_fused_plain`, which scatters per pixel; :func:`region_props_partials_plain` gives the
kernel's partials the same way (its oracle). ``regionprops_fused.launches``
counts the kernel's launches that write the partials.

Integer results (counts, areas, bounding boxes, histograms, intensity sums
and extremes) are exact on both routes, and so is the perimeter: each 2×2
block's length is a multiple of float32(0.65) or 1, summed in float64 (the
kernel counts the units) and rounded to float32 once. The other sums and
moments accumulate in float64 and are returned as float32: a float32 sum over
a region as large as the background (millions of pixels, ``Σ (x − cx)``
cancelling within every row) would differ between runs by ~1e-4 relative.
The routes differ only in ``mu11`` (the plain version centres x per pixel,
the kernel route per row: ``Σ_y (y − cy)·(Σx − cx·count)``) and in what
derives from it (axis lengths, orientation, eccentricity), by float64
rounding.
"""

from __future__ import annotations

import functools
import math
from typing import Dict, Optional

import torch

from .region_histogram import _MAX_W, region_histogram_plain, region_measure, region_measure_plan
from .regionprops import marching_squares_length
from .row_scan import _check_cuda, _raise_on, count_launch

__all__ = [
    "regionprops_fused",
    "regionprops_fused_plain",
    "region_props_partials",
    "region_props_partials_plain",
    "feret_from_row_extremes",
]

_F32, _F64 = torch.float32, torch.float64


@functools.lru_cache(maxsize=None)
def _directions(n_angles: int, dev: torch.device):
    """float32 cos and sin of the feret sweep's angles k·π/n on ``dev``,
    copied there once (a copy from the host synchronises with the card)."""
    angles = [k * math.pi / n_angles for k in range(n_angles)]
    return (torch.tensor([math.cos(a) for a in angles], dtype=torch.float32, device=dev),
            torch.tensor([math.sin(a) for a in angles], dtype=torch.float32, device=dev))


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
    dev = rowminx.device
    hh = torch.arange(H, dtype=torch.float32, device=dev)[:, None, None]
    # All angles at once on a trailing axis: a few large launches, not a
    # dozen small ones per angle.
    c, s = _directions(n_angles, dev)
    p1 = hh * c + rowminx[..., None] * s
    p2 = hh * c + rowmaxx[..., None] * s
    present = row_present[..., None]
    hi = torch.where(present, torch.maximum(p1, p2), -1e9).amax(dim=-3)
    lo = torch.where(present, torch.minimum(p1, p2), 1e9).amin(dim=-3)
    return (hi - lo).amax(dim=-1) + 1.0


def _to_last_corner(fg: torch.Tensor, block: torch.Tensor) -> torch.Tensor:
    """Each 2×2 block's value (``block``: (B, H+1, W+1), the blocks of the
    zero-padded (B, H, W) mask ``fg``) given to its raster-last foreground
    corner: (B, H, W)."""
    m = torch.nn.functional.pad(fg.to(torch.int32), (1, 1, 1, 1)).bool()
    a = m[..., :-1, :-1]
    b = m[..., :-1, 1:]
    c = m[..., 1:, :-1]
    d = m[..., 1:, 1:]
    to_d = d
    to_c = c & ~d
    to_b = b & ~c & ~d
    to_a = a & ~b & ~c & ~d
    zero = torch.zeros((), dtype=block.dtype, device=fg.device)
    # Block (i, j) corners: a=(i-1, j-1) b=(i-1, j) c=(i, j-1) d=(i, j).
    out = torch.zeros(fg.shape, dtype=block.dtype, device=fg.device)
    out = out + torch.where(to_d, block, zero)[..., :-1, :-1]
    out = out + torch.where(to_c, block, zero)[..., :-1, 1:]
    out = out + torch.where(to_b, block, zero)[..., 1:, :-1]
    out = out + torch.where(to_a, block, zero)[..., 1:, 1:]
    return out


def _per_pixel_perimeter(fg: torch.Tensor) -> torch.Tensor:
    """Each 2×2 block's contour length, given to its raster-last fg corner
    (float64: the sum of a pixel's blocks is exact)."""
    return _to_last_corner(fg, marching_squares_length(fg).to(_F64))


def _perimeter_units(fg: torch.Tensor):
    """The kernel's count of :func:`_per_pixel_perimeter`: per pixel, the
    int64 number of its blocks of length 1 (n1) and of 0.65-units (n065; a
    diagonal pair, 1.3, is two)."""
    m = torch.nn.functional.pad(fg.to(torch.int64), (1, 1, 1, 1))
    a, b, c, d = m[..., :-1, :-1], m[..., :-1, 1:], m[..., 1:, :-1], m[..., 1:, 1:]
    count = a + b + c + d
    diagonal = (count == 2) & (a == d)
    n1 = ((count == 2) & ~diagonal).long()
    n065 = ((count == 1) | (count == 3)).long() + 2 * diagonal.long()
    return _to_last_corner(fg, n1), _to_last_corner(fg, n065)


def _shape_props(rowcnt, colcnt, cy, cx, mu11, perim) -> Dict[str, torch.Tensor]:
    """Area, bounding box, centroid, central moments, ellipse and perimeter
    from the (B, H, R) row counts, the (B, W, R) column counts, the float64
    centroid and ``mu11``."""
    B, H, R = rowcnt.shape
    W = colcnt.shape[1]
    dev = rowcnt.device
    area = rowcnt.sum(dim=1)
    safe_area = torch.clamp(area, min=1.0)
    hh = torch.arange(H, dtype=_F64, device=dev)[None, :, None]
    ww = torch.arange(W, dtype=_F64, device=dev)[None, :, None]
    mu20 = (rowcnt.to(_F64) * (hh - cy[:, None, :]) ** 2).sum(dim=1).to(_F32)
    mu02 = (colcnt.to(_F64) * (ww - cx[:, None, :]) ** 2).sum(dim=1).to(_F32)
    hh, ww = hh.to(_F32), ww.to(_F32)
    row_present = rowcnt > 0
    col_present = colcnt > 0

    # Ellipse fit (skimage formulas: 4·sqrt of the inertia eigenvalues).
    m20 = mu20 / safe_area
    m02 = mu02 / safe_area
    m11 = mu11 / safe_area
    common = torch.sqrt(torch.clamp((m20 - m02) ** 2 + 4 * m11 * m11, min=0.0))
    lam1 = (m20 + m02 + common) / 2
    lam2 = (m20 + m02 - common) / 2
    return {
        "area": area,
        "min_row": torch.where(row_present, hh, float(H + 1)).amin(dim=1),
        "min_col": torch.where(col_present, ww, float(W + 1)).amin(dim=1),
        "max_row": torch.where(row_present, hh, -1.0).amax(dim=1) + 1,
        "max_col": torch.where(col_present, ww, -1.0).amax(dim=1) + 1,
        "centroid_row": cy.to(_F32),
        "centroid_col": cx.to(_F32),
        "mu20": mu20,
        "mu02": mu02,
        "mu11": mu11,
        "axis_major_length": 4.0 * torch.sqrt(torch.clamp(lam1, min=0.0)),
        "axis_minor_length": 4.0 * torch.sqrt(torch.clamp(lam2, min=0.0)),
        "orientation": 0.5 * torch.atan2(2.0 * m11, m20 - m02),
        "eccentricity": torch.sqrt(torch.clamp(1.0 - lam2 / torch.clamp(lam1, min=1e-12), min=0.0)),
        "perimeter": perim,
    }


def _centroid(rowcnt, colcnt):
    """float64 (cy, cx) from the row and column counts."""
    dev = rowcnt.device
    hh = torch.arange(rowcnt.shape[1], dtype=_F64, device=dev)[None, :, None]
    ww = torch.arange(colcnt.shape[1], dtype=_F64, device=dev)[None, :, None]
    rc, cc = rowcnt.to(_F64), colcnt.to(_F64)
    sa = torch.clamp(rc.sum(dim=1), min=1.0)
    return (rc * hh).sum(dim=1) / sa, (cc * ww).sum(dim=1) / sa


def _intensity_props(mean, std, m3, m4, s1, sy, sx, imin, imax) -> Dict[str, torch.Tensor]:
    """The intensity statistics from the moments and the sums (s1, Σ I·y,
    Σ I·x)."""
    # Guard: std**3 / std**4 underflow float32 for near-constant regions.
    ok = std > 1e-3
    std_safe = torch.where(ok, std, 1.0)
    safe_s1 = torch.where(s1 != 0, s1, 1.0)
    return dict(
        intensity_sum=s1,
        intensity_mean=mean,
        intensity_std=std,
        intensity_skew=torch.where(ok, m3 / std_safe**3, 0.0),
        intensity_kurtosis=torch.where(ok, m4 / std_safe**4 - 3.0, 0.0),
        weighted_centroid_row=sy / safe_s1,
        weighted_centroid_col=sx / safe_s1,
        intensity_min=imin,
        intensity_max=imax,
    )


def _hist_moments(hist, mean, safe_area):
    """Central moments and extremes of integer intensities from their
    histogram (float64 sums)."""
    c_bins = torch.arange(256, dtype=_F32, device=hist.device)
    h64, sa = hist.to(_F64), safe_area.to(_F64)[..., None]
    d = c_bins.to(_F64)[None, None, :] - mean.to(_F64)[..., None]  # (B, R, 256)
    var = torch.clamp((h64 * d * d / sa).sum(-1), min=0.0).to(_F32)
    m3 = (h64 * d**3 / sa).sum(-1).to(_F32)
    m4 = (h64 * d**4 / sa).sum(-1).to(_F32)
    present = hist > 0
    imin = torch.where(present, c_bins, 1e9).amin(-1)
    imax = torch.where(present, c_bins, -1e9).amax(-1)
    return torch.sqrt(var), m3, m4, imin, imax


def regionprops_fused_plain(
    labels: torch.Tensor,
    intensity: Optional[torch.Tensor] = None,
    *,
    num_segments: int,
    compute_histogram: bool = True,
    n_feret_angles: int = 16,
) -> Dict[str, torch.Tensor]:
    """Plain version of K7 (with K3's plain version for the histogram):
    per-pixel scatters over the region axis. Same arguments and results as
    :func:`regionprops_fused`; takes any intensity type."""
    batch_shape = labels.shape[:-2]
    H, W = labels.shape[-2:]
    R = num_segments
    dev = labels.device
    lab = labels.reshape(-1, H, W).long()
    B = lab.shape[0]
    # Region index with one spare slot R that collects unmeasured ids.
    seg = torch.where((lab >= 0) & (lab < R), lab, R)
    seg_flat = seg.reshape(B, H * W)

    def reduce_hw(values: torch.Tensor) -> torch.Tensor:  # Σ per region
        acc = torch.zeros(B, R + 1, dtype=_F64, device=dev)
        acc.scatter_add_(1, seg_flat, values.reshape(B, H * W).to(_F64))
        return acc[:, :R].to(_F32)

    def gather_px(per_region: torch.Tensor) -> torch.Tensor:  # (B, R) → pixels
        padded = torch.cat([per_region, torch.zeros_like(per_region[:, :1])], dim=1)
        return torch.gather(padded, 1, seg_flat).reshape(B, H, W)

    ones_i = torch.ones(B, H, W, dtype=torch.int32, device=dev)
    rowcnt = torch.zeros(B, H, R + 1, dtype=torch.int32, device=dev)
    rowcnt.scatter_add_(2, seg, ones_i)
    rowcnt = rowcnt[..., :R].to(_F32)  # (B, H, R)
    colcnt = torch.zeros(B, W, R + 1, dtype=torch.int32, device=dev)
    colcnt.scatter_add_(2, seg.transpose(1, 2).contiguous(), ones_i.transpose(1, 2))
    colcnt = colcnt[..., :R].to(_F32)  # (B, W, R)
    cy, cx = _centroid(rowcnt, colcnt)

    # Σ (y−cy)(x−cx) = Σ_y (y−cy) · Σ_{x∈row} (x−cx): centre x per pixel,
    # sum per (row, region), then weight the rows.
    hh = torch.arange(H, dtype=_F64, device=dev)[None, :, None]
    xc = torch.arange(W, dtype=_F64, device=dev) - gather_px(cx)  # (B, H, W)
    rowxc = torch.zeros(B, H, R + 1, dtype=_F64, device=dev)
    rowxc.scatter_add_(2, seg, xc)
    mu11 = ((hh - cy[:, None, :]) * rowxc[..., :R]).sum(dim=1).to(_F32)
    props = _shape_props(rowcnt, colcnt, cy, cx, mu11, reduce_hw(_per_pixel_perimeter(lab > 0)))

    if n_feret_angles:
        x_px = torch.arange(W, dtype=_F32, device=dev).expand(B, H, W).contiguous()
        rowminx = torch.full((B, H, R + 1), 1e9, dtype=_F32, device=dev)
        rowminx = rowminx.scatter_reduce(2, seg, x_px, reduce="amin")[..., :R]
        rowmaxx = torch.full((B, H, R + 1), -1e9, dtype=_F32, device=dev)
        rowmaxx = rowmaxx.scatter_reduce(2, seg, x_px, reduce="amax")[..., :R]
        props["feret_diameter_max"] = feret_from_row_extremes(rowminx, rowmaxx, rowcnt > 0, n_angles=n_feret_angles)

    if intensity is not None:
        inten = intensity.reshape(-1, H, W).to(_F32)
        s1 = reduce_hw(inten)
        safe_area = torch.clamp(props["area"], min=1.0)
        mean = s1 / safe_area
        if compute_histogram:
            props["histogram"] = region_histogram_plain(lab, inten, R)
        if compute_histogram and not intensity.dtype.is_floating_point:
            std, m3, m4, imin, imax = _hist_moments(props["histogram"], mean, safe_area)
        else:
            # Float intensities: mean-shifted passes per pixel.
            di = inten - gather_px(mean)
            std = torch.sqrt(torch.clamp(reduce_hw(di * di) / safe_area, min=0.0))
            m3 = reduce_hw(di * di * di) / safe_area
            m4 = reduce_hw(di * di * di * di) / safe_area
            flat = inten.reshape(B, H * W)
            imin = torch.full((B, R + 1), 1e9, dtype=_F32, device=dev)
            imin = imin.scatter_reduce(1, seg_flat, flat, reduce="amin")[:, :R]
            imax = torch.full((B, R + 1), -1e9, dtype=_F32, device=dev)
            imax = imax.scatter_reduce(1, seg_flat, flat, reduce="amax")[:, :R]
        yy = torch.arange(H, dtype=_F32, device=dev)[:, None].expand(H, W)
        xx = torch.arange(W, dtype=_F32, device=dev)[None, :].expand(H, W)
        props.update(
            _intensity_props(mean, std, m3, m4, s1, reduce_hw(inten * yy), reduce_hw(inten * xx), imin, imax)
        )

    return {k: v.reshape(batch_shape + v.shape[1:]) for k, v in props.items()}


# float32(0.65) in float64: a corner cut's length in the plain version.
_CUT = float(torch.tensor(0.65, dtype=_F32))


def _props_from_partials(sums, rowcnt, rowsumx, rowminx, rowmaxx, colcnt, hist, compute_histogram, n_feret_angles):
    """The props of the kernel route from K7's partials ((B, R, 5) int64
    sums, (B, H, R) int32 row partials, (B, W, R) int32 column counts) and
    K3's (B, R, 256) histogram (None without intensity)."""
    H = rowcnt.shape[1]
    cy, cx = _centroid(rowcnt, colcnt)
    hh = torch.arange(H, dtype=_F64, device=rowcnt.device)[None, :, None]
    # μ11 separably: Σ_y (y − cy)·(Σ_{x∈row} x − cx·count).
    mu11 = ((hh - cy[:, None, :]) * (rowsumx.to(_F64) - cx[:, None, :] * rowcnt.to(_F64))).sum(dim=1)
    s = sums.to(_F64)
    perim = (s[..., 0] + s[..., 1] * _CUT).to(_F32)
    props = _shape_props(rowcnt.to(_F32), colcnt.to(_F32), cy, cx, mu11.to(_F32), perim)
    if n_feret_angles:
        props["feret_diameter_max"] = feret_from_row_extremes(
            rowminx.to(_F32), rowmaxx.to(_F32), rowcnt > 0, n_angles=n_feret_angles
        )
    if hist is not None:
        s1 = s[..., 2].to(_F32)
        safe_area = torch.clamp(props["area"], min=1.0)
        mean = s1 / safe_area
        if compute_histogram:
            props["histogram"] = hist
        std, m3, m4, imin, imax = _hist_moments(hist, mean, safe_area)
        props.update(_intensity_props(mean, std, m3, m4, s1, s[..., 3].to(_F32), s[..., 4].to(_F32), imin, imax))
    return props


def regionprops_fused(
    labels: torch.Tensor,
    intensity: Optional[torch.Tensor] = None,
    *,
    num_segments: int,
    compute_histogram: bool = True,
    n_feret_angles: int = 16,
) -> Dict[str, torch.Tensor]:
    """Measure all regions of a batch of label frames (K7, with K3 for the
    histogram, on the card).

    Args:
        labels: int (..., H, W), ids in [0, R], 0 = background; on the card
            int32.
        intensity: optional (..., H, W) intensity; on the card uint8.
        num_segments: region axis size R (ids < R are measured).
        compute_histogram: return per-region 256-bin histograms.
        n_feret_angles: projection count of the feret diameter (0 = off).

    Returns:
        dict of (..., R) float32 tensors (``histogram``: (..., R, 256)).
    """
    if intensity is not None and intensity.shape != labels.shape:
        raise ValueError(f"regionprops_fused: shapes differ: {tuple(labels.shape)} vs {tuple(intensity.shape)}")
    if labels.dim() < 2:
        raise ValueError(f"regionprops_fused: need (..., H, W) labels, got {tuple(labels.shape)}")
    if num_segments < 1:
        raise ValueError(f"regionprops_fused: num_segments must be positive, got {num_segments}")
    if labels.device.type == "cpu":
        return regionprops_fused_plain(
            labels, intensity, num_segments=num_segments,
            compute_histogram=compute_histogram, n_feret_angles=n_feret_angles,
        )
    if intensity is not None and intensity.dtype != torch.uint8:
        raise TypeError(f"regionprops_fused: intensity on the card must be uint8, got {intensity.dtype}")
    if labels.dtype != torch.int32:
        raise TypeError(f"regionprops_fused: labels on the card must be int32, got {labels.dtype}")
    _check_cuda("regionprops_fused", labels, *(() if intensity is None else (intensity,)))
    batch_shape = labels.shape[:-2]
    H, W = labels.shape[-2:]
    B = math.prod(batch_shape)
    labels, intensity = labels.reshape(B, H, W), None if intensity is None else intensity.reshape(B, H, W)
    *partials, hist = region_props_partials(labels, intensity, num_segments)
    hist = None if hist is None else hist.to(_F32)
    props = _props_from_partials(*partials, hist, compute_histogram, n_feret_angles)
    return {k: v.reshape(batch_shape + v.shape[1:]) for k, v in props.items()}


def region_props_partials(labels: torch.Tensor, intensity: Optional[torch.Tensor], num_segments: int):
    """One launch of the region-measurement kernel on contiguous (B, H, W)
    int32 labels and uint8 intensity (or None) on the card: returns the
    partials of :func:`region_props_partials_plain` and the (B, R, 256)
    int32 histogram (None without intensity)."""
    partials, hist = region_measure(labels, intensity, num_segments, partials=True)
    plan = region_measure_plan(labels.shape[-1], num_segments, True, intensity is not None)
    count_launch(regionprops_fused, labels.device, plan.route)
    return (*partials, hist)


regionprops_fused.launches = 0


def region_props_partials_plain(labels: torch.Tensor, intensity: Optional[torch.Tensor], num_segments: int):
    """Plain version of the kernel's partials, by scatters, on (B, H, W)
    labels and intensity (or None): the (B, R, 5) int64 sums (perimeter
    units n1 and n065, Σ I, Σ I·y, Σ I·x; the last three 0 without
    intensity), the (B, H, R) int32 row count, x-sum (int64 where W >
    2^16: a row's x-sum may pass 2^31), x-min (W if absent) and x-max (-1
    if absent), and the (B, W, R) int32 column count."""
    B, H, W = labels.shape
    R = num_segments
    dev = labels.device
    lab = labels.long()
    seg = torch.where((lab >= 0) & (lab < R), lab, R)
    flat = seg.reshape(B, -1)
    yy = torch.arange(H, device=dev)[:, None].expand(B, H, W)
    xx = torch.arange(W, device=dev)[None, :].expand(B, H, W).contiguous()
    iv = torch.zeros_like(lab) if intensity is None else intensity.long()
    sums = torch.zeros(B, R + 1, 5, dtype=torch.int64, device=dev)
    for k, v in enumerate((*_perimeter_units(lab > 0), iv, iv * yy, iv * xx)):
        sums[..., k].scatter_add_(1, flat, v.reshape(B, -1))
    ones = torch.ones_like(seg)
    rowcnt = torch.zeros(B, H, R + 1, dtype=torch.int64, device=dev).scatter_add_(2, seg, ones)
    rowsumx = torch.zeros_like(rowcnt).scatter_add_(2, seg, xx)
    rowminx = torch.full_like(rowcnt, W).scatter_reduce(2, seg, xx, reduce="amin")
    rowmaxx = torch.full_like(rowcnt, -1).scatter_reduce(2, seg, xx, reduce="amax")
    colcnt = torch.zeros(B, W, R + 1, dtype=torch.int64, device=dev)
    colcnt.scatter_add_(2, seg.transpose(1, 2).contiguous(), ones.transpose(1, 2))
    rowsumx = rowsumx[..., :R] if W > _MAX_W else rowsumx[..., :R].int()
    rowcnt, rowminx, rowmaxx, colcnt = (t[..., :R].int() for t in (rowcnt, rowminx, rowmaxx, colcnt))
    return sums[:, :R], rowcnt, rowsumx, rowminx, rowmaxx, colcnt
