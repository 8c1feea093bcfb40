"""Image stream nodes of the LOKI workload: region fan-out, ROI crops,
whole-crop properties, ZooProcess features, scalebar, expression filter.

Host (numpy) code, the same as ``RegionInfo``, ``FindRegions``,
``ExtractROI``, ``ImageProperties``, ``CalculateZooProcessFeatures``,
``DrawScalebar`` and ``FilterEval`` in
``maze_image_processing_pipeline_tpu/engine/image.py``, with only the
imports changed. ``BatchedImageProperties`` (the threshold path's device
measurement) is not ported yet. Keep the two in step
(``tests/test_torch_host_copies.py`` holds them equal).
"""

from __future__ import annotations

from typing import Any, Mapping, Optional

import numpy as np
import scipy.ndimage as ndi

from ..ops.host_props import host_region_props
from ..ops.zooprocess import zooprocess_features
from .core import (
    Node,
    Output,
    RawOrVariable,
    ReturnOutputs,
    Stream,
    _annotate,
    closing_if_closable,
)
from .stream import StreamEstimator

__all__ = [
    "RegionInfo",
    "FindRegions",
    "ExtractROI",
    "ImageProperties",
    "CalculateZooProcessFeatures",
    "DrawScalebar",
    "FilterEval",
]


class RegionInfo:
    """One segmented region: label id, bboxes, crops, measurements."""

    __slots__ = (
        "label",
        "bbox",
        "bbox_padded",
        "image",
        "image_intensity",
        "props",
        "area_filled",
        "other_mask",
    )

    def __init__(
        self,
        label,
        bbox,
        bbox_padded,
        image,
        image_intensity,
        props,
        area_filled,
        other_mask=None,
    ):
        self.label = label
        self.bbox = bbox  # (min_row, min_col, max_row, max_col)
        self.bbox_padded = bbox_padded
        self.image = image  # boolean mask crop (padded bbox)
        self.image_intensity = image_intensity  # intensity crop (padded bbox)
        self.props = props  # dict of per-region scalars
        self.area_filled = area_filled
        # Pixels of *other* regions inside the padded bbox (device crop
        # extraction provides it so ExtractROI needs no label frame).
        self.other_mask = other_mask

    @property
    def area(self) -> float:
        return float(self.props["area"])


@ReturnOutputs
@Output("region")
class FindRegions(Node):
    """Emit one object per segmented region of a labeled frame.

    Args:
        labels: label image variable (int, 0 = background).
        image: intensity image variable.
        padding: grow each region's bbox by this many pixels (clipped).
        min_area / max_area: area gates.
        min_intensity: drop regions whose maximum intensity is below this.
        props: optional Variable with precomputed device measurements
            (dict of (R,) arrays from ``regionprops_fused``); when absent,
            regions are measured on host from their crops.
        regions: optional Variable carrying prebuilt :class:`RegionInfo`
            lists (device-side crop extraction); when its payload is
            present the node only applies the gates and fans out.
    """

    def __init__(
        self,
        labels: RawOrVariable[np.ndarray],
        image: RawOrVariable[np.ndarray],
        min_area: Optional[int] = None,
        max_area: Optional[int] = None,
        padding: int = 0,
        min_intensity: Optional[float] = None,
        props: Optional[RawOrVariable] = None,
        regions: Optional[RawOrVariable] = None,
    ) -> None:
        self.labels = labels
        self.image = image
        self.min_area = min_area
        self.max_area = max_area
        self.padding = padding
        self.min_intensity = min_intensity
        self.props = props
        self.regions = regions
        super().__init__()

    def _gate(self, region: "RegionInfo") -> bool:
        area = float(region.props["area"])
        if self.min_area is not None and area < self.min_area:
            return False
        if self.max_area is not None and area > self.max_area:
            return False
        if self.min_intensity is not None:
            imax = region.props.get("intensity_max")
            if imax is None:
                imax = np.max(
                    region.image_intensity[region.image], initial=0
                )
            if float(imax) < self.min_intensity:
                return False
        return True

    def transform_stream(self, stream: Stream) -> Stream:
        est = StreamEstimator()
        with closing_if_closable(stream):
            for obj in stream:
                prebuilt = (
                    self.prepare_input(obj, "regions")
                    if self.regions is not None
                    else None
                )
                if prebuilt is not None:
                    regions = [r for r in prebuilt if self._gate(r)]
                else:
                    labels = np.asarray(self.prepare_input(obj, "labels"))
                    image = np.asarray(self.prepare_input(obj, "image"))
                    device_props = (
                        self.prepare_input(obj, "props")
                        if self.props is not None
                        else None
                    )
                    regions = list(
                        self._iter_regions(labels, image, device_props)
                    )
                with est.consume(obj.n_remaining_hint) as incoming:
                    n = len(regions)
                    for i, region in enumerate(regions):
                        new_obj = obj.copy()
                        new_obj[self.output_vars[0]] = region
                        new_obj.n_remaining_hint = incoming.emit(n_to_come_local=n - i)
                        yield new_obj

    def _iter_regions(self, labels, image, device_props):
        H, W = labels.shape[:2]
        slices = ndi.find_objects(labels)
        for idx, sl in enumerate(slices):
            if sl is None:
                continue
            label = idx + 1
            bbox = (sl[0].start, sl[1].start, sl[0].stop, sl[1].stop)
            y0 = max(0, bbox[0] - self.padding)
            x0 = max(0, bbox[1] - self.padding)
            y1 = min(H, bbox[2] + self.padding)
            x1 = min(W, bbox[3] + self.padding)
            mask_crop = labels[y0:y1, x0:x1] == label
            inten_crop = image[y0:y1, x0:x1]

            if device_props is not None and label < np.shape(
                device_props["area"]
            )[-1]:
                props = {
                    k: np.asarray(v)[..., label]
                    if k != "histogram"
                    else np.asarray(v)[..., label, :]
                    for k, v in device_props.items()
                }
                # For crop-level stats absent from the fused device pass.
                area = float(props["area"])
            else:
                single = host_region_props(mask_crop, inten_crop)
                # host_region_props returns (2,)-shaped [background, region]
                # arrays for a single-region mask; keep the region row.
                props = {k: v[1] for k, v in single.items()}
                # Shift bbox/centroid keys from crop coords to frame coords.
                for key, off in (
                    ("min_row", y0),
                    ("max_row", y0),
                    ("centroid_row", y0),
                    ("weighted_centroid_row", y0),
                    ("min_col", x0),
                    ("max_col", x0),
                    ("centroid_col", x0),
                    ("weighted_centroid_col", x0),
                ):
                    if key in props:
                        props[key] = props[key] + off
                area = float(props["area"])

            if self.min_area is not None and area < self.min_area:
                continue
            if self.max_area is not None and area > self.max_area:
                continue
            if (
                self.min_intensity is not None
                and float(np.max(inten_crop[mask_crop], initial=0)) < self.min_intensity
            ):
                continue

            # Device chains provide the filled area from one frame-level
            # pass (ops/fill_holes.py); holes it could not attribute are
            # flagged and fall back to the reference's per-crop fill.
            ambiguous = props.get("area_filled_ambiguous", 1.0)
            if "area_filled" in props and not ambiguous > 0:
                area_filled = float(props["area_filled"])
            else:
                area_filled = float(ndi.binary_fill_holes(mask_crop).sum())
            yield RegionInfo(
                label,
                bbox,
                (y0, x0, y1, x1),
                mask_crop,
                inten_crop,
                props,
                area_filled,
            )


def _resolve_bg_color(bg_color, image, mask):
    if isinstance(bg_color, str) and bg_color.startswith("quantile:"):
        q = float(bg_color.split(":", 1)[1])
        return np.quantile(image, q)
    if isinstance(bg_color, str):
        named = {"black": 0, "white": 255}
        if bg_color in named:
            return named[bg_color]
        raise ValueError(f"Unknown background color: {bg_color!r}")
    return bg_color


@ReturnOutputs
@Output("roi")
class ExtractROI(Node):
    """Crop a region's (padded) bounding box, optionally masking foreign pixels.

    Parity with ``morphocut.image.ExtractROI`` (``loki/pipeline.py:596-602``):
    ``alpha=1`` hides everything not belonging to the region; with
    ``keep_background=True`` only *other objects* are hidden (pixels where a
    different label sits), the background stays.
    """

    def __init__(
        self,
        image: RawOrVariable[np.ndarray],
        region: RawOrVariable[RegionInfo],
        alpha: float = 0,
        bg_color: Any = 0,
        keep_background: bool = True,
        labels: Optional[RawOrVariable[np.ndarray]] = None,
    ) -> None:
        self.image = image
        self.region = region
        self.alpha = alpha
        self.bg_color = bg_color
        self.keep_background = keep_background
        self.labels = labels
        super().__init__()

    def transform_stream(self, stream: Stream) -> Stream:
        with closing_if_closable(stream):
            for obj in stream:
                region: RegionInfo = self.prepare_input(obj, "region")
                y0, x0, y1, x1 = region.bbox_padded
                crop = np.asarray(region.image_intensity).copy()

                if self.alpha:
                    labels_full = (
                        self.prepare_input(obj, "labels")
                        if self.labels is not None and region.other_mask is None
                        else None
                    )
                    if region.other_mask is not None:
                        # Device crop extraction already separated the
                        # masks; no label frame needed on host.
                        other = region.other_mask
                    elif labels_full is not None:
                        lab_crop = np.asarray(labels_full)[y0:y1, x0:x1]
                        other = (lab_crop > 0) & (lab_crop != region.label)
                    else:
                        # Fall back: anything outside this region's mask that
                        # is "object-like" cannot be identified without the
                        # label image; hide only non-mask pixels if the
                        # background is dropped.
                        other = np.zeros(crop.shape[:2], bool)
                    bg = _resolve_bg_color(self.bg_color, crop, region.image)
                    hide = other if self.keep_background else (other | ~region.image)
                    blended = crop.astype(np.float32)
                    blended[hide] = (
                        self.alpha * np.float32(bg)
                        + (1 - self.alpha) * blended[hide]
                    )
                    crop = blended.astype(region.image_intensity.dtype)

                obj[self.output_vars[0]] = crop
                yield obj


@ReturnOutputs
@Output("props")
class ImageProperties(Node):
    """Measure a whole boolean mask as one region (host, numpy).

    Parity with ``morphocut.image.ImageProperties`` (``loki/pipeline.py:653``).
    """

    def __init__(
        self, mask: RawOrVariable[np.ndarray], image: RawOrVariable[np.ndarray]
    ) -> None:
        self.mask = mask
        self.image = image
        super().__init__()

    def transform(self, mask, image):
        mask = np.asarray(mask, bool)
        props = {k: v[1] for k, v in host_region_props(mask, np.asarray(image)).items()}
        filled = ndi.binary_fill_holes(mask)
        return {"__props__": props, "__area_filled__": float(filled.sum())}

    def _input_names(self):
        return ("mask", "image")


@ReturnOutputs
@Output("meta")
class CalculateZooProcessFeatures(Node):
    """Merge the ZooProcess feature set into per-object metadata.

    Accepts a :class:`RegionInfo` (from FindRegions) or the dict produced by
    :class:`ImageProperties`. Parity with
    ``morphocut.contrib.zooprocess.CalculateZooProcessFeatures``.
    """

    def __init__(
        self,
        region: RawOrVariable,
        meta: RawOrVariable[Mapping],
        prefix: str = "",
    ) -> None:
        self.region = region
        self.meta = meta
        self.prefix = prefix
        super().__init__()

    def transform(self, region, meta):
        if isinstance(region, RegionInfo):
            props = {k: np.asarray([0.0, v]) if np.ndim(v) == 0 else np.stack([np.zeros_like(v), v]) for k, v in region.props.items()}
            area_filled = region.area_filled
        else:
            props = {k: np.asarray([0.0, v]) if np.ndim(v) == 0 else np.stack([np.zeros_like(v), v]) for k, v in region["__props__"].items()}
            area_filled = region["__area_filled__"]
        features = zooprocess_features(
            props, 1, area_filled=area_filled, prefix=self.prefix
        )
        return {**dict(meta), **features}

    def _input_names(self):
        return ("region", "meta")


@ReturnOutputs
@Output("image")
class DrawScalebar(Node):
    """Burn a physical scalebar into a vignette's bottom margin.

    Parity with ``morphocut.scalebar.DrawScalebar`` (``loki/pipeline.py:
    1183-1190``): appends a margin strip with a bar of
    ``length_in_unit * px_per_unit`` pixels and a label like "1 mm".
    """

    def __init__(
        self,
        image: RawOrVariable[np.ndarray],
        length_in_unit: float = 1,
        px_per_unit: float = 100,
        unit: str = "mm",
        fg_color: int = 255,
        bg_color: int = 0,
    ) -> None:
        self.image = image
        self.length_in_unit = length_in_unit
        self.px_per_unit = px_per_unit
        self.unit = unit
        self.fg_color = fg_color
        self.bg_color = bg_color
        super().__init__()

    def transform(self, image):
        import cv2

        image = np.asarray(image)
        H, W = image.shape[:2]
        bar_px = max(2, int(round(self.length_in_unit * self.px_per_unit)))
        margin = 24
        out_w = max(W, bar_px + 8)
        strip_shape = (margin, out_w) + image.shape[2:]
        strip = np.full(strip_shape, self.bg_color, dtype=image.dtype)

        y_bar = 6
        x0 = 4
        strip[y_bar : y_bar + 3, x0 : x0 + bar_px] = self.fg_color
        label = f"{self.length_in_unit:g} {self.unit}"
        cv2.putText(
            strip,
            label,
            (x0, margin - 4),
            cv2.FONT_HERSHEY_PLAIN,
            0.9,
            int(self.fg_color),
            1,
        )

        if out_w > W:
            pad = [(0, 0), (0, out_w - W)] + [(0, 0)] * (image.ndim - 2)
            image = np.pad(image, pad, constant_values=self.bg_color)
        return np.concatenate([image, strip], axis=0)

    def _input_names(self):
        return ("image",)


class FilterEval(Node):
    """Filter the stream with a compiled Python boolean expression over metadata.

    Parity with the reference's ``FilterEval`` (``loki/pipeline.py:82-108``).
    """

    def __init__(self, expression: str, data: RawOrVariable[Mapping]) -> None:
        self._compiled = compile(expression, "<filter_expr>", "eval")
        self.expression = expression
        self.data = data
        super().__init__()

    def transform_stream(self, stream: Stream) -> Stream:
        est = StreamEstimator()
        with closing_if_closable(stream):
            for obj in stream:
                with est.consume(obj.n_remaining_hint) as incoming:
                    data = self.prepare_input(obj, "data")
                    try:
                        keep = eval(self._compiled, {"__builtins__": {}}, dict(data))
                    except Exception as exc:
                        # add_note, not re-construction: many exception
                        # types cannot be rebuilt from (*args, msg).
                        _annotate(exc, f" [FilterEval({self.expression!r})]")
                        raise
                    if not keep:
                        continue
                    obj.n_remaining_hint = incoming.emit()
                    yield obj
