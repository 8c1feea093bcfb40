"""The plain reference of what the timed path produces.

NumPy, SciPy and plain PyTorch only; nothing of the program. Each stage
reads what the stage before it produced in the program, so each can be
held exactly where its arithmetic is exact:

* :func:`stitch`: a LOKI frame from its vignettes, pasted in order on black;
* :func:`tile_maps`: the U-Net over a frame's or a crop's tiles (tile
  starts over the true extent or the padded frame, the linear ramp blend,
  pixels of skipped empty tiles at 0), in the mode :class:`.unet_ref.
  PlainUNet` is asked for;
* :func:`frame_chain`: threshold at 0.5, closing by the Euclidean disk
  (outside the frame background for the dilation, foreground for the
  erosion), 8-connected labels in raster order, regions under ``min_area``
  dropped and the rest renumbered in order;
* :func:`region_rows`: each region's ZooProcess features and position, as
  the archive states them;
* :func:`measure_channel`: a semantic channel's raw area, then holes
  filled, the largest 8-connected component (the first in raster order
  among equals), its area, major axis and filled convex hull.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import numpy as np
import scipy.ndimage as ndi
import torch

from .unet_ref import PlainUNet

# The reference's precision: float32 with TF32 off, against the bfloat16 the
# configurations state.
REFERENCE = "float32"
_CUT = float(np.float32(0.65))
_S8 = np.ones((3, 3), bool)


def stitch(members: List[Tuple[np.ndarray, int, int]]) -> np.ndarray:
    H = max(y + b.shape[0] for b, y, _ in members)
    W = max(x + b.shape[1] for b, _, x in members)
    canvas = np.zeros((H, W), np.uint8)
    for b, y, x in members:
        canvas[y : y + b.shape[0], x : x + b.shape[1]] = b
    return canvas


def tile_starts(extent: int, tile: int, stride: int) -> List[int]:
    if extent <= tile:
        return [0]
    starts = list(range(0, extent - tile, stride)) + [extent - tile]
    return sorted(set(starts))


def ramp(ts: int) -> np.ndarray:
    r = np.minimum(np.arange(ts) + 1, np.arange(ts)[::-1] + 1).astype(np.float32)
    return r[:, None] * r[None, :]


def reference_net(model_cfg: dict, state, dev) -> PlainUNet:
    """The plain U-Net of a configuration with the given float32 state, on
    ``dev``, TF32 off."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    net = PlainUNet(model_cfg["out_channels"], model_cfg["base_features"], model_cfg["depth"]).to(dev).eval()
    net.load_state_dict(state)
    return net


def _forward(net: PlainUNet, tiles: np.ndarray, mode: str, dev, batch: int = 8) -> np.ndarray:
    """(N, ts, ts) uint8 tiles → (N, ts, ts, C) float32 probabilities."""
    out = []
    with torch.no_grad():
        for i in range(0, len(tiles), batch):
            x = torch.from_numpy(tiles[i : i + batch]).to(dev).float().div_(255.0)
            x = x[..., None].expand(*x.shape, 3)
            out.append(torch.sigmoid(net(x, mode)).float().cpu().numpy())
    return np.concatenate(out) if out else np.zeros((0,) + tiles.shape[1:] + (1,), np.float32)


def tile_maps(net: PlainUNet, image: np.ndarray, grid_shape: Tuple[int, int], ts: int, stride: int, mode: str,
              dev, skip_empty: bool) -> np.ndarray:
    """The blended (H, W, C) probabilities of ``image`` (H, W) uint8 over the
    tile grid of ``grid_shape`` (the padded frame, or the crop itself; tiles
    beyond the image are zero-padded). Pixels no tile covers are 0."""
    Hg, Wg = grid_shape
    padded = np.zeros((max(Hg, ts), max(Wg, ts)), np.uint8)
    padded[: image.shape[0], : image.shape[1]] = image
    jobs = [(y, x) for y in tile_starts(Hg, ts, stride) for x in tile_starts(Wg, ts, stride)]
    tiles = np.stack([padded[y : y + ts, x : x + ts] for y, x in jobs])
    if skip_empty:
        keep = tiles.reshape(len(tiles), -1).any(axis=1)
        jobs = [j for j, k in zip(jobs, keep) if k]
        tiles = tiles[keep]
    pred = _forward(net, tiles, mode, dev)
    C = pred.shape[-1]
    w = ramp(ts)[..., None]
    canvas = np.zeros(padded.shape + (C,), np.float32)
    wsum = np.zeros(padded.shape + (1,), np.float32)
    for (y, x), p in zip(jobs, pred):
        canvas[y : y + ts, x : x + ts] += p * w
        wsum[y : y + ts, x : x + ts] += w
    out = canvas / np.where(wsum > 0, wsum, 1.0)
    res = np.zeros(grid_shape + (C,), np.float32)
    h, w_ = image.shape
    res[:h, :w_] = out[:h, :w_]
    return res


def disk(r: int) -> np.ndarray:
    yy, xx = np.mgrid[-r : r + 1, -r : r + 1]
    return yy * yy + xx * xx <= r * r


def frame_chain(pred: np.ndarray, closing_radius: int, min_area: int) -> np.ndarray:
    """(H, W) float32 probabilities → int32 labels."""
    mask = pred > 0.5
    if closing_radius > 0:
        se = disk(closing_radius)
        mask = ndi.binary_dilation(mask, se, border_value=0)
        mask = ndi.binary_erosion(mask, se, border_value=1)
    labels, n = ndi.label(mask, _S8)
    if n and min_area > 0:
        areas = np.bincount(labels.ravel(), minlength=n + 1)
        keep = areas >= min_area
        keep[0] = False
        new = np.zeros(n + 1, np.int32)
        new[keep] = np.arange(1, int(keep.sum()) + 1)
        labels = new[labels]
    return labels.astype(np.int32)


def _perimeter(m: np.ndarray) -> float:
    p = np.pad(m.astype(np.int64), 1)
    a, b, c, d = p[:-1, :-1], p[:-1, 1:], p[1:, :-1], p[1:, 1:]
    count = a + b + c + d
    diagonal = (count == 2) & (a == d)
    n1 = int(((count == 2) & ~diagonal).sum())
    n065 = int(((count == 1) | (count == 3)).sum()) + 2 * int(diagonal.sum())
    return n1 + n065 * _CUT


def _quantiles(hist: np.ndarray, area: float):
    cum = np.cumsum(hist)
    q = [float(np.searchsorted(cum, f * area)) for f in (0.25, 0.5, 0.75)]
    return q[1], float(np.argmax(hist)), q[0], q[1], q[2]


def region_rows(labels: np.ndarray, frame: np.ndarray) -> Dict[int, Dict[str, float]]:
    """Per region id: the archive's ``object_*`` values that the region
    determines (position, size, sequence, invalid share, features)."""
    rows = {}
    for idx, sl in enumerate(ndi.find_objects(labels)):
        if sl is None:
            continue
        r = idx + 1
        m = labels[sl] == r
        ys, xs = np.nonzero(m)
        ys = ys.astype(np.float64) + sl[0].start
        xs = xs.astype(np.float64) + sl[1].start
        vals = frame[sl][m].astype(np.int64)
        area = float(m.sum())
        y0, x0, y1, x1 = sl[0].start, sl[1].start, sl[0].stop, sl[1].stop
        cy, cx = ys.mean(), xs.mean()
        m20, m02 = ((ys - cy) ** 2).mean(), ((xs - cx) ** 2).mean()
        m11 = ((ys - cy) * (xs - cx)).mean()
        common = math.sqrt(max((m20 - m02) ** 2 + 4 * m11 * m11, 0.0))
        lam1, lam2 = (m20 + m02 + common) / 2, (m20 + m02 - common) / 2
        major, minor = 4 * math.sqrt(max(lam1, 0.0)), 4 * math.sqrt(max(lam2, 0.0))
        orientation = 0.5 * math.atan2(2 * m11, m20 - m02)
        ecc = math.sqrt(max(1.0 - lam2 / max(lam1, 1e-12), 0.0))
        perim = _perimeter(m)
        feret = max(
            float(np.ptp(ys * math.cos(k * math.pi / 16) + xs * math.sin(k * math.pi / 16))) for k in range(16)
        ) + 1.0
        hist = np.bincount(vals, minlength=256).astype(np.float64)
        s1 = float(vals.sum())
        mean = s1 / area
        d = np.arange(256) - mean
        var = float((hist * d * d).sum() / area)
        std = math.sqrt(max(var, 0.0))
        m3, m4 = float((hist * d**3).sum() / area), float((hist * d**4).sum() / area)
        ok = std > 1e-3
        skew = m3 / std**3 if ok else 0.0
        kurt = m4 / std**4 - 3.0 if ok else 0.0
        vmin, vmax = float(vals.min()), float(vals.max())
        median, mode, q25, q50, q75 = _quantiles(hist, area)
        filled = float(ndi.binary_fill_holes(m).sum())
        holes = max(filled - area, 0.0)
        perim_safe = perim if perim > 0 else 1.0
        sq = math.sqrt(area)
        vrange = vmax - vmin
        f = {
            "posx": float(x0), "posy": float(y0), "width": float(x1 - x0), "height": float(y1 - y0),
            "sequence": float(r), "frac_invalid": float((vals == 0).mean()),
            "area": filled, "area_exc": area, "%area": 100.0 * holes / filled if filled > 0 else 0.0,
            "bx": float(x0), "by": float(y0), "x": cx, "y": cy,
            "xm": float((vals * xs).sum()) / s1 if s1 else 0.0,
            "ym": float((vals * ys).sum()) / s1 if s1 else 0.0,
            "major": major, "minor": minor, "angle": (90.0 - math.degrees(orientation)) % 180.0,
            "eccentricity": ecc,
            "circ.": 4.0 * math.pi * filled / (perim_safe * perim_safe),
            "circex": 4.0 * math.pi * area / (perim_safe * perim_safe),
            "elongation": major / minor if minor > 0 else 0.0,
            "perim.": perim, "feret": feret, "perimareaexc": perim / sq, "feretareaexc": feret / sq,
            "perimferet": perim / feret if feret > 0 else 0.0, "perimmajor": perim / major if major > 0 else 0.0,
            "mean": mean, "stddev": std, "min": vmin, "max": vmax, "median": median, "mode": mode,
            "range": vrange, "skew": skew, "kurt": kurt, "intden": mean * area,
            "cv": 100.0 * std / mean if mean != 0 else 0.0, "sr": 100.0 * std / vrange if vrange != 0 else 0.0,
            "meanpos": (vmax - mean) / vrange if vrange != 0 else 0.0,
            "histcum1": q25, "histcum2": q50, "histcum3": q75,
        }
        # An ellipse whose axes are equal has no direction to compare.
        f["_round"] = float(lam1 - lam2 <= 1e-3 * max(lam1 + lam2, 1e-12))
        rows[r] = f
    return rows


EXACT = {"posx", "posy", "width", "height", "sequence", "area", "area_exc", "bx", "by", "min", "max", "median",
         "mode", "range", "histcum1", "histcum2", "histcum3"}


def feature_gap(name: str, got: float, want: float) -> bool:
    """True where the program's value departs from the reference's beyond
    float32 rounding of the program's float64 sums."""
    if name in EXACT:
        return got != want
    if name == "angle":
        d = abs(got - want) % 180.0
        return min(d, 180.0 - d) > 1e-2
    if name == "eccentricity":
        return abs(got - want) > 2e-3
    return abs(got - want) > 1e-4 * max(abs(want), 1.0)


def convex_area(comp: np.ndarray) -> float:
    """Pixel count of the filled convex hull of the component's row
    extremes (cv2's ``convexHull`` and ``fillPoly``, on the crop's canvas)."""
    import cv2

    rows = np.nonzero(comp.any(axis=1))[0]
    if rows.size == 0:
        return 0.0
    minx = comp[rows].argmax(axis=1)
    maxx = comp.shape[1] - 1 - comp[rows, ::-1].argmax(axis=1)
    pts = np.concatenate([np.stack([minx, rows], -1), np.stack([maxx, rows], -1)]).astype(np.int32)
    if len(pts) < 3:
        return float(len(np.unique(pts, axis=0)))
    hull = cv2.convexHull(pts.reshape(-1, 1, 2))
    canvas = np.zeros(comp.shape, np.uint8)
    cv2.fillPoly(canvas, [hull], 1)
    return float(canvas.sum())


def measure_channel(prob: np.ndarray, fill: bool) -> Dict[str, float]:
    """The archive's values of one semantic channel of an (h, w) map, and
    the count of its 8-connected components after filling (``n``)."""
    mask = prob > 0.5
    raw = float(mask.sum())
    if fill:
        mask = ndi.binary_fill_holes(mask)
    labels, n = ndi.label(mask, _S8)
    out = {"raw_area": raw, "n": float(n)}
    if not n:
        return {**out, "area": 0.0, "axis_major_length": 0.0, "area_convex": 0.0, "area_convex_ratio": 0.0}
    counts = np.bincount(labels.ravel())[1:]
    comp = labels == int(np.argmax(counts)) + 1
    ys, xs = np.nonzero(comp)
    area = float(comp.sum())
    cy, cx = ys.mean(), xs.mean()
    m20, m02 = ((ys - cy) ** 2).mean(), ((xs - cx) ** 2).mean()
    m11 = ((ys - cy) * (xs - cx)).mean()
    lam1 = (m20 + m02 + math.sqrt(max((m20 - m02) ** 2 + 4 * m11 * m11, 0.0))) / 2
    convex = convex_area(comp)
    return {**out, "area": area, "axis_major_length": 4.0 * math.sqrt(max(lam1, 0.0)), "area_convex": convex,
            "area_convex_ratio": area / convex if convex else 0.0}


MEASURE_EXACT = {"raw_area", "area", "area_convex"}


def measure_gap(name: str, got: float, want: float) -> bool:
    if name in MEASURE_EXACT:
        return got != want
    return abs(got - want) > 1e-4 * max(abs(want), 1.0)


def map_gaps(got: np.ndarray, want: np.ndarray) -> Dict[str, float]:
    """Gaps between two probability maps: the widest, the sum (for a mean)
    and the pixels on opposite sides of 0.5."""
    d = np.abs(got.astype(np.float64) - want.astype(np.float64))
    return {"max": float(d.max()) if d.size else 0.0, "sum": float(d.sum()), "n": float(d.size),
            "flips": float(((got > 0.5) != (want > 0.5)).sum())}
