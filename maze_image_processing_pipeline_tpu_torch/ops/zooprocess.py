"""ZooProcess-style morphometric feature vectors from device regionprops.

Capability parity with ``morphocut.contrib.zooprocess.CalculateZooProcessFeatures``
as used at ``loki/pipeline.py:625,654`` (SURVEY.md §2b): for each segmented
object, a dict of EcoTaxa-convention features (``object_*`` once prefixed by
the caller) describing geometry and grey-level statistics.

All statistics come from the fused device measurement pass
(:func:`..ops.regionprops.regionprops` with histograms); this module is pure
cheap host math over the per-region scalars.

Feature definitions (documented here because ZooProcess itself is informal):

==============  =============================================================
area            object area in pixels including holes (filled area)
area_exc        object area excluding holes (mask pixel count)
%area           share of the filled area consisting of holes, in percent
width/height    bounding-box extents; bx/by: bounding-box min col/row
x, y            centroid (col, row); xm, ym: intensity-weighted centroid
major/minor     ellipse axis lengths (4·sqrt of inertia eigenvalues)
angle           major-axis angle from the x axis, degrees in [0, 180)
circ            4π·area / perimeter²  (1 for a circle)
circex          4π·area_exc / perimeter²
elongation      major / minor
perim           calibrated marching-squares boundary length
feret           max caliper diameter (projection sweep)
perimareaexc    perim / sqrt(area_exc);  feretareaexc: feret / sqrt(area_exc)
perimferet      perim / feret;  perimmajor: perim / major
mean/stddev/…   grey stats over mask pixels: mean, stddev, min, max, median,
                mode, skew, kurt, range, intden (mean·area_exc),
                cv (100·stddev/mean), sr (100·stddev/range),
                meanpos ((max−mean)/range), histcum1/2/3 (intensity at
                25/50/75% of the cumulative histogram)
==============  =============================================================
"""

from __future__ import annotations

import math
from typing import Dict, Mapping, Optional

import numpy as np

__all__ = ["zooprocess_features", "N_FEATURES"]


def _hist_quantiles(hist: np.ndarray, area: float):
    """(median, mode, q25, q50, q75) from a 256-bin histogram."""
    if area <= 0:
        return 0.0, 0.0, 0.0, 0.0, 0.0
    cum = np.cumsum(hist)
    q25 = int(np.searchsorted(cum, 0.25 * area))
    q50 = int(np.searchsorted(cum, 0.50 * area))
    q75 = int(np.searchsorted(cum, 0.75 * area))
    mode = int(np.argmax(hist))
    return float(q50), float(mode), float(q25), float(q50), float(q75)


def zooprocess_features(
    props: Mapping[str, np.ndarray],
    index: int,
    *,
    area_filled: Optional[float] = None,
    prefix: str = "",
) -> Dict[str, float]:
    """Build the ZooProcess feature dict for region ``index``.

    Args:
        props: output of :func:`..ops.regionprops.regionprops` (with
            intensity and histogram), converted to numpy (or indexable
            jax arrays) — trailing axis is the region axis.
        index: region id (1-based; 0 is background).
        area_filled: filled area (area including holes). Defaults to
            ``area_exc`` (no hole information available).
        prefix: key prefix (the pipelines pass ``"object_"``).

    Returns:
        dict of float features.
    """

    def p(name):
        return float(np.asarray(props[name])[..., index])

    area_exc = p("area")
    area = float(area_filled) if area_filled is not None else area_exc
    holes = max(area - area_exc, 0.0)

    min_row, min_col = p("min_row"), p("min_col")
    max_row, max_col = p("max_row"), p("max_col")
    height = max_row - min_row
    width = max_col - min_col

    major = p("axis_major_length")
    minor = p("axis_minor_length")
    perim = p("perimeter")
    orientation = p("orientation")  # from row axis, CCW
    # Angle from the horizontal (x) axis in degrees, [0, 180).
    angle = (90.0 - math.degrees(orientation)) % 180.0

    has_intensity = "intensity_mean" in props
    if has_intensity:
        mean = p("intensity_mean")
        std = p("intensity_std")
        vmin = p("intensity_min")
        vmax = p("intensity_max")
        skew = p("intensity_skew")
        kurt = p("intensity_kurtosis")
    else:
        mean = std = vmin = vmax = skew = kurt = 0.0
    vrange = vmax - vmin

    if "histogram" in props:
        hist = np.asarray(props["histogram"])[..., index, :]
        median, mode, q25, q50, q75 = _hist_quantiles(hist, area_exc)
    else:
        median = mode = q25 = q50 = q75 = 0.0

    perim_safe = perim if perim > 0 else 1.0
    sqrt_area_exc = math.sqrt(area_exc) if area_exc > 0 else 1.0
    feret = p("feret_diameter_max") if "feret_diameter_max" in props else major

    features = {
        "area": area,
        "area_exc": area_exc,
        "%area": 100.0 * holes / area if area > 0 else 0.0,
        "width": width,
        "height": height,
        "bx": min_col,
        "by": min_row,
        "x": p("centroid_col"),
        "y": p("centroid_row"),
        "xm": p("weighted_centroid_col") if "weighted_centroid_col" in props else p("centroid_col"),
        "ym": p("weighted_centroid_row") if "weighted_centroid_row" in props else p("centroid_row"),
        "major": major,
        "minor": minor,
        "angle": angle,
        "eccentricity": p("eccentricity"),
        "circ.": 4.0 * math.pi * area / (perim_safe * perim_safe),
        "circex": 4.0 * math.pi * area_exc / (perim_safe * perim_safe),
        "elongation": major / minor if minor > 0 else 0.0,
        "perim.": perim,
        "feret": feret,
        "perimareaexc": perim / sqrt_area_exc,
        "feretareaexc": feret / sqrt_area_exc,
        "perimferet": perim / feret if feret > 0 else 0.0,
        "perimmajor": perim / major if major > 0 else 0.0,
        "mean": mean,
        "stddev": std,
        "min": vmin,
        "max": vmax,
        "median": median,
        "mode": mode,
        "range": vrange,
        "skew": skew,
        "kurt": kurt,
        "intden": mean * area_exc,
        "cv": 100.0 * std / mean if mean != 0 else 0.0,
        "sr": 100.0 * std / vrange if vrange != 0 else 0.0,
        "meanpos": (vmax - mean) / vrange if vrange != 0 else 0.0,
        "histcum1": q25,
        "histcum2": q50,
        "histcum3": q75,
    }

    if prefix:
        features = {prefix + k: v for k, v in features.items()}
    return features


# Number of features zooprocess_features returns (asserted by tests).
N_FEATURES = 40
