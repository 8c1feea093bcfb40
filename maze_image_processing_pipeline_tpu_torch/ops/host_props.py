"""Host (numpy) single-region measurement for small crops.

The TPU path measures whole frame batches in one fused dispatch
(:mod:`.regionprops_fused`); for *individual small crops* (vignettes,
threshold-segmentation inputs) a device dispatch would be dominated by
round-trip latency, so this numpy twin — same keys, same conventions —
serves the per-object nodes (`ImageProperties`, host fallbacks).
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import numpy as np

__all__ = ["host_region_props"]

_W_STRAIGHT = 1.0
_W_CUT = 0.65
_W_DOUBLE = 2 * _W_CUT


def _perimeter(mask: np.ndarray) -> float:
    m = np.pad(mask, 1).astype(np.int8)
    a = m[:-1, :-1]
    b = m[:-1, 1:]
    c = m[1:, :-1]
    d = m[1:, 1:]
    count = a + b + c + d
    diag = (a == d) & (b == c) & (a != b)
    cut = ((count == 1) | (count == 3)).sum()
    straight = ((count == 2) & ~diag).sum()
    double = ((count == 2) & diag).sum()
    return float(straight * _W_STRAIGHT + cut * _W_CUT + double * _W_DOUBLE)


def host_region_props(
    mask: np.ndarray,
    intensity: Optional[np.ndarray] = None,
    compute_histogram: bool = True,
    n_feret_angles: int = 16,
    compute_perimeter: bool = True,
) -> Dict[str, np.ndarray]:
    """Measure ONE region (boolean mask) with the device regionprops keys.

    Returns arrays of length 2 (index 1 = the region, index 0 = background
    placeholder) so downstream consumers can index identically to the
    device path.
    """
    mask = np.asarray(mask, bool)
    ys, xs = np.nonzero(mask)
    out: Dict[str, np.ndarray] = {}

    def put(key, value):
        out[key] = np.array([0.0, float(value)], dtype=np.float64)

    if ys.size == 0:
        for key in (
            "area min_row min_col max_row max_col centroid_row centroid_col "
            "mu20 mu02 mu11 axis_major_length axis_minor_length orientation "
            "eccentricity"
        ).split():
            put(key, 0.0)
        if compute_perimeter:
            put("perimeter", 0.0)
        if n_feret_angles:
            # Keep the key set identical to the non-empty branch, which
            # only emits feret when n_feret_angles is nonzero.
            put("feret_diameter_max", 0.0)
        if intensity is not None:
            for key in (
                "intensity_sum intensity_mean intensity_std intensity_min "
                "intensity_max intensity_skew intensity_kurtosis "
                "weighted_centroid_row weighted_centroid_col"
            ).split():
                put(key, 0.0)
            if compute_histogram:
                out["histogram"] = np.zeros((2, 256))
        return out

    area = float(ys.size)
    cy, cx = ys.mean(), xs.mean()
    dy = ys - cy
    dx = xs - cx
    mu20 = float((dy * dy).sum())
    mu02 = float((dx * dx).sum())
    mu11 = float((dy * dx).sum())
    m20, m02, m11 = mu20 / area, mu02 / area, mu11 / area
    common = math.sqrt(max((m20 - m02) ** 2 + 4 * m11 * m11, 0.0))
    lam1 = (m20 + m02 + common) / 2
    lam2 = (m20 + m02 - common) / 2

    put("area", area)
    put("min_row", ys.min())
    put("min_col", xs.min())
    put("max_row", ys.max() + 1)
    put("max_col", xs.max() + 1)
    put("centroid_row", cy)
    put("centroid_col", cx)
    put("mu20", mu20)
    put("mu02", mu02)
    put("mu11", mu11)
    put("axis_major_length", 4 * math.sqrt(max(lam1, 0)))
    put("axis_minor_length", 4 * math.sqrt(max(lam2, 0)))
    put("orientation", 0.5 * math.atan2(2 * m11, m20 - m02))
    put(
        "eccentricity",
        math.sqrt(max(1 - lam2 / lam1, 0.0)) if lam1 > 0 else 0.0,
    )
    if compute_perimeter:
        # A full extra pass over the mask; skippable by consumers that
        # never read it (e.g. semseg measure_segments — it was ~0.4 s of
        # a 332-object haul's steady stage).
        put("perimeter", _perimeter(mask))

    if n_feret_angles:
        angles = np.arange(n_feret_angles) * (math.pi / n_feret_angles)
        proj = ys[None, :] * np.cos(angles)[:, None] + xs[None, :] * np.sin(angles)[:, None]
        put("feret_diameter_max", float((proj.max(1) - proj.min(1)).max() + 1.0))

    if intensity is not None:
        vals = np.asarray(intensity)[mask].astype(np.float64)
        s1 = vals.sum()
        mean = vals.mean()
        std = vals.std()
        put("intensity_sum", s1)
        put("intensity_mean", mean)
        put("intensity_std", std)
        put("intensity_min", vals.min())
        put("intensity_max", vals.max())
        # Same guard threshold as the device twins (regionprops_fused,
        # pallas_props): near-constant regions must get identical 0.0
        # skew/kurtosis on whichever path measures them.
        if std > 1e-3:
            d = vals - mean
            put("intensity_skew", (d**3).mean() / std**3)
            put("intensity_kurtosis", (d**4).mean() / std**4 - 3.0)
        else:
            put("intensity_skew", 0.0)
            put("intensity_kurtosis", 0.0)
        if s1 > 0:
            put("weighted_centroid_row", (vals * ys).sum() / s1)
            put("weighted_centroid_col", (vals * xs).sum() / s1)
        else:
            put("weighted_centroid_row", cy)
            put("weighted_centroid_col", cx)
        if compute_histogram:
            hist = np.zeros((2, 256))
            hist[1] = np.bincount(
                np.clip(vals, 0, 255).astype(np.int64), minlength=256
            )[:256]
            out["histogram"] = hist

    return out
