"""Prediction pipeline of the PyTorch port (``maze-ipp-torch predict``).

Counterpart of ``maze_image_processing_pipeline_tpu/predict/pipeline.py``:
EcoTaxa archives → model → semseg measurements / polytaxo annotations, with
the same stages and the same archives. Tiles and crops go through
:class:`..models.inference.DeviceTiledInference` (tiling with the blend on
the card, and the channel measurement fused behind it) or
:class:`..models.inference.TorchInference` (fixed-shape batches); the host
stages (archive reading, the polytaxo rule engine, archive writing) run
behind stream buffers. ``_convex_area``, :func:`measure_segments`,
``_prepare_translation`` and :func:`build_polytaxo_pipeline` are copies of
the originals (``tests/test_torch_host_copies.py`` holds them equal).

The raw HDF5 export (``save_raw_h5: true``) goes through the port's own
writer, :class:`..dataio.HDF5Writer`, which needs no h5py. With
``parallel:`` both inference nodes split their work over a mesh of cards
(:mod:`..parallel`).
"""

from __future__ import annotations

import logging
import os
import sys
import textwrap
from functools import partial
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import pandas as pd
import scipy.ndimage as ndi
import torch
import yaml

from .. import tracing
from ..common import (
    find_files_glob as _find_files_glob,
    natsorted,
    recursive_update,
)
from ..dataio import VALID_PREFIXES, EcotaxaReader, EcotaxaWriter, HDF5Writer
from ..engine import (
    BatchedPipeline,
    Call,
    Filter,
    Node,
    Output,
    Pipeline,
    Progress as LiveProgress,
    RawOrVariable,
    ReturnOutputs,
    Slice,
    StreamBuffer,
    StreamObject,
    TiledPipeline,
    Unpack,
    Variable,
)
from ..models.inference import resolve_device
from ..ops.host_props import host_region_props
from ..polytaxo import Description, NegatedRealNode, PolyTaxonomy, PrimaryNode, TagNode
from ..progress import LogProgress
from ..runner import PipelineRunner, apply_platform
from .config_schema import ModelMetaSchema, PredictionPipelineConfig

logging.captureWarnings(True)
logger = logging.getLogger(__name__)


# ---------------------------------------------------------------------------
# Segment measurement (semseg mode)


def _convex_area(mask: np.ndarray) -> float:
    """Pixel count of the filled convex hull (cv2)."""
    import cv2

    ys, xs = np.nonzero(mask)
    if ys.size < 3:
        return float(ys.size)
    # The hull of the per-row extreme pixels equals the hull of every
    # mask pixel (interior points are convex combinations), but hands
    # convexHull <= 2 rows points instead of `area` points (measured
    # 1.7 -> <0.1 ms per call on a 300^2 crop).
    rows, first = np.unique(ys, return_index=True)
    last = np.r_[first[1:], ys.size] - 1
    pts = np.stack(
        [np.r_[xs[first], xs[last]], np.r_[rows, rows]], axis=1
    ).astype(np.int32)[:, None, :]
    hull = cv2.convexHull(pts)
    # Rasterize in bbox-local coordinates: same pixel count, but the
    # canvas shrinks from the crop extent to the hull extent.
    x0, y0 = hull[:, 0, :].min(axis=0)
    x1, y1 = hull[:, 0, :].max(axis=0)
    canvas = np.zeros((int(y1 - y0) + 1, int(x1 - x0) + 1), np.uint8)
    cv2.fillPoly(canvas, [hull - np.array([[x0, y0]])], 1)
    return float(canvas.sum())


@ReturnOutputs
@Output("meta")
class BatchedSegmentMeasure(Node):
    """Device-batched :func:`measure_segments` (the ``draw: false`` path
    without the device blend).

    Collects up to ``chunk_size`` consecutive objects, groups their
    probability maps into power-of-two shape buckets (as the JAX package
    does, so that overflow flags agree), and measures every channel of a
    bucket on ``device``
    (:func:`..ops.segment_measure.measure_largest_component`); the exact
    filled convex hull is computed on the host from the largest component's
    per-row x extremes. Masks beyond the overflow bounds are re-measured on
    the host. Re-emits the chunk in arrival order; the meta equals the host
    path's.
    """

    def __init__(
        self,
        meta: RawOrVariable,
        predictions: RawOrVariable,
        channel_names: Sequence[str],
        fill_holes: Any = False,
        chunk_size: int = 128,
        device="cuda",
    ) -> None:
        self.meta = meta
        self.predictions = predictions
        self.channel_names = list(channel_names)
        self.fill_holes = fill_holes
        self.chunk_size = chunk_size
        super().__init__()
        self._device = resolve_device(device)

    def _input_names(self):
        return ("meta", "predictions")

    def transform_stream(self, stream):
        from ..engine.core import closing_if_closable

        with closing_if_closable(stream):
            pending = []
            for obj in stream:
                pending.append(obj)
                if len(pending) >= self.chunk_size:
                    yield from self._flush(pending)
                    pending = []
            if pending:
                yield from self._flush(pending)

    def _flush(self, objs):
        from ..ops.segment_measure import (
            convex_area_from_extremes,
            measure_largest_component,
        )

        probs = [
            np.asarray(self.prepare_input(obj, "predictions")) for obj in objs
        ]
        # uint8 transfer rung: restore probabilities (value/255) so the 0.5
        # thresholds below keep their meaning.
        probs = [
            p.astype(np.float32) / 255.0 if p.dtype == np.uint8 else p
            for p in probs
        ]
        metas = [
            {
                k: v
                for k, v in dict(self.prepare_input(obj, "meta")).items()
                if k.split("_", maxsplit=1)[0] in VALID_PREFIXES
            }
            for obj in objs
        ]

        buckets: Dict[tuple, list] = {}
        for i, p in enumerate(probs):
            hb = max(8, 1 << int(p.shape[0] - 1).bit_length())
            wb = max(128, 1 << int(p.shape[1] - 1).bit_length())
            buckets.setdefault((hb, wb), []).append(i)

        for (hb, wb), idxs in buckets.items():
            for c, channel_name in enumerate(self.channel_names):
                batch = np.zeros((len(idxs), hb, wb), bool)
                for j, i in enumerate(idxs):
                    h, w = probs[i].shape[:2]
                    batch[j, :h, :w] = probs[i][..., c] > 0.5
                fill = self.fill_holes is True or (
                    self.fill_holes and channel_name in self.fill_holes
                )
                with torch.inference_mode():
                    props, raw, extremes, overflow = measure_largest_component(
                        torch.from_numpy(batch).to(self._device), fill_holes=bool(fill)
                    )
                props = {k: v.cpu().numpy() for k, v in props.items()}
                raw = raw.cpu().numpy()
                extremes = extremes.cpu().numpy()
                overflow = overflow.cpu().numpy()
                for j, i in enumerate(idxs):
                    if overflow[j]:
                        # More components than the bounds measure: re-measure
                        # this crop's channel through the host path.
                        host_meta, _ = measure_segments(
                            {},
                            None,
                            probs[i][..., c : c + 1],
                            [channel_name],
                            False,
                            fill_holes=self.fill_holes,
                        )
                        metas[i].update(host_meta)
                        continue
                    m = metas[i]
                    m[f"object_{channel_name}_raw_area"] = int(raw[j])
                    area = float(props["area"][j])
                    if area > 0:
                        convex = convex_area_from_extremes(
                            extremes[j], (hb, wb)
                        )
                        m[f"object_{channel_name}_area"] = area
                        m[f"object_{channel_name}_axis_major_length"] = float(
                            props["axis_major_length"][j]
                        )
                        m[f"object_{channel_name}_area_convex"] = convex
                        m[f"object_{channel_name}_area_convex_ratio"] = (
                            area / convex if convex else 0
                        )
                    else:
                        m[f"object_{channel_name}_area"] = 0
                        m[f"object_{channel_name}_axis_major_length"] = 0
                        m[f"object_{channel_name}_area_convex"] = 0
                        m[f"object_{channel_name}_area_convex_ratio"] = 0

        out_var = self.output_vars[0]
        for obj, m in zip(objs, metas):
            obj[out_var] = m
            yield obj


def measure_segments(
    meta: Dict[str, Any],
    image: np.ndarray,
    probabilities: np.ndarray,
    channel_names: Sequence[str],
    draw: bool,
    fill_holes: Any = False,
) -> Tuple[Mapping[str, Any], List]:
    """Per-channel segment measurement (contract: predict/pipeline.py:59-180).

    Thresholds probabilities at 0.5, optionally fills holes, keeps only the
    largest connected component per channel, and measures
    area / axis_major_length / area_convex (+ convex ratio). With ``draw``,
    returns an overlay image with per-channel colors and major-axis lines.
    """
    meta = {
        k: v
        for k, v in meta.items()
        if k.split("_", maxsplit=1)[0] in VALID_PREFIXES
    }

    probabilities = np.asarray(probabilities)
    if probabilities.dtype == np.uint8:
        # raw_h5_dtype: uint8 rung — stored value = round(p * 255), so the
        # 0.5 probability threshold is 128 (127.5 rounds up).
        predictions = probabilities >= 128
    else:
        predictions = probabilities > 0.5
    assert predictions.ndim == 3, predictions.shape
    assert predictions.shape[-1] == len(channel_names), (
        predictions.shape,
        channel_names,
    )

    for c, channel_name in enumerate(channel_names):
        meta[f"object_{channel_name}_raw_area"] = int(predictions[..., c].sum())

    if fill_holes:
        for c, channel_name in enumerate(channel_names):
            if fill_holes is True or channel_name in fill_holes:
                for slices in ndi.find_objects(predictions[..., c].astype(np.int8), 1):
                    if slices is None:
                        continue
                    ndi.binary_fill_holes(
                        predictions[..., c][slices],
                        output=predictions[..., c][slices],
                    )

    # Keep only the largest connected component per channel.
    channel_props: Dict[str, Optional[Dict]] = {}
    s8 = np.ones((3, 3), bool)
    for c, channel_name in enumerate(channel_names):
        labels, n = ndi.label(predictions[..., c], structure=s8)
        if n:
            counts = np.bincount(labels.ravel())[1:]
            best = int(np.argmax(counts)) + 1
            largest = labels == best
            predictions[..., c] = largest
            # Only area / axis_major_length / centroid / orientation are
            # consumed below: skip the 16-angle feret sweep (measured
            # 3.3 -> 0.7 ms per call on a 300^2 crop; x2 channels x
            # objects it was ~1.7 s of the steady semseg stage) and the
            # perimeter pass (another ~0.4 s/haul).
            props = {
                k: v[1]
                for k, v in host_region_props(
                    largest, None, n_feret_angles=0, compute_perimeter=False
                ).items()
            }
            props["area_convex"] = _convex_area(largest)
            channel_props[channel_name] = props
        else:
            channel_props[channel_name] = None

    annotated = None
    colors = [(255, 60, 60), (60, 255, 60), (60, 120, 255), (255, 255, 60)]
    if draw:
        import cv2

        base = np.asarray(image)
        if base.ndim == 2:
            base = np.stack([base] * 3, axis=-1)
        base = base.astype(np.float32)
        annotated = base.copy()
        alpha = 0.3
        for c in range(predictions.shape[-1]):
            color = np.array(colors[c % len(colors)], np.float32)
            m = predictions[..., c]
            annotated[m] = (1 - alpha) * annotated[m] + alpha * color

    for c, channel_name in enumerate(channel_names):
        props = channel_props[channel_name]
        if props is None:
            meta[f"object_{channel_name}_area"] = 0
            meta[f"object_{channel_name}_axis_major_length"] = 0
            meta[f"object_{channel_name}_area_convex"] = 0
            meta[f"object_{channel_name}_area_convex_ratio"] = 0
            continue

        meta[f"object_{channel_name}_area"] = props["area"]
        meta[f"object_{channel_name}_axis_major_length"] = props["axis_major_length"]
        meta[f"object_{channel_name}_area_convex"] = props["area_convex"]
        meta[f"object_{channel_name}_area_convex_ratio"] = (
            props["area"] / props["area_convex"] if props["area_convex"] else 0
        )

        if annotated is not None:
            import cv2

            cy, cx = props["centroid_row"], props["centroid_col"]
            theta = props["orientation"]
            half = 0.5 * props["axis_major_length"]
            # orientation measured from the row axis, CCW
            vr, vc = np.cos(theta) * half, np.sin(theta) * half
            p0 = (int(round(cx - vc)), int(round(cy - vr)))
            p1 = (int(round(cx + vc)), int(round(cy + vr)))
            cv2.line(annotated, p0, p1, colors[c % len(colors)], 1, cv2.LINE_AA)

    images_out: List = []
    if annotated is not None:
        images_out.append(
            (
                str(meta.get("object_id", "object")) + "_overlay.jpg",
                np.clip(annotated, 0, 255).astype(np.uint8),
            )
        )
    return meta, images_out


# ---------------------------------------------------------------------------
# PolyTaxo prediction stage


def _prepare_translation(
    ecotaxa_taxonomy_fn: str, poly_taxonomy: PolyTaxonomy
) -> Tuple[pd.DataFrame, pd.DataFrame]:
    """Forward (display_name → description) and backward (description →
    shallowest display_name) translation tables from an EcoTaxa taxonomy CSV
    with ``display_name`` and ``lineage`` (">"-separated) columns."""
    taxonomy = pd.read_csv(ecotaxa_taxonomy_fn, index_col=False)

    def parse_lineage(lineage: str):
        parts = str(lineage).split(">")
        try:
            description = poly_taxonomy.get_description(
                parts, ignore_missing_intermediaries=True, with_alias=True
            )
        except (ValueError, KeyError) as exc:
            logger.warning("Could not parse lineage '%s': %s", lineage, exc)
            return pd.Series([None, len(parts)])
        return pd.Series([description, len(parts)])

    taxonomy[["polytaxo_description_obj", "lineage_depth"]] = taxonomy["lineage"].apply(
        parse_lineage
    )
    taxonomy = taxonomy[~pd.isna(taxonomy["polytaxo_description_obj"])]

    forward = taxonomy.set_index("display_name", drop=True)

    backward = taxonomy.copy()
    backward["polytaxo_description"] = backward["polytaxo_description_obj"].map(str)

    # Drop rows whose description was reached through wildcard aliases —
    # those display names are ambiguous targets.
    def has_wildcard(description: Description) -> bool:
        return any(
            isinstance(d, PrimaryNode) and any("*" in a for a in d.alias)
            for d in description.descriptors
        )

    backward = backward[~backward["polytaxo_description_obj"].map(has_wildcard)]
    backward = backward.sort_values(["polytaxo_description", "lineage_depth"])
    backward = backward.drop_duplicates("polytaxo_description", keep="first")
    backward = backward.set_index("polytaxo_description", drop=True)

    return forward, backward


def build_polytaxo_pipeline(
    config: PredictionPipelineConfig, et_obj: Variable, probabilities: Variable
) -> Variable:
    """Insert the polytaxo annotation stage; returns the updated meta variable."""
    assert config.polytaxo is not False
    ptc = config.polytaxo

    meta = Call(lambda o: o.meta, et_obj)

    logger.info("Predicting object properties using PolyTaxonomy %s.", ptc.poly_taxonomy_fn)
    with open(ptc.poly_taxonomy_fn) as f:
        poly_taxonomy_dict = yaml.safe_load(f)
    if not isinstance(poly_taxonomy_dict, dict):
        raise ValueError(
            f"Unexpected content in {ptc.poly_taxonomy_fn}: {poly_taxonomy_dict}"
        )

    poly_taxonomy = PolyTaxonomy.from_dict(poly_taxonomy_dict)
    logger.info(poly_taxonomy.format_tree())

    logger.info("Using EcoTaxa taxonomy %s", ptc.ecotaxa_taxonomy_fn)
    display_name_to_description, description_to_display_name = _prepare_translation(
        ptc.ecotaxa_taxonomy_fn, poly_taxonomy
    )

    def parse_rules(rules):
        if rules is None:
            return None
        return [
            (poly_taxonomy.parse_expression(q), poly_taxonomy.parse_expression(u))
            for q, u in rules.items()
        ]

    taxonomy_augmentation_rules = parse_rules(ptc.taxonomy_augmentation_rules)
    prediction_constraint_rules = parse_rules(ptc.prediction_constraint_rules)
    filter_validated = (
        poly_taxonomy.parse_expression(ptc.filter_validated)
        if ptc.filter_validated is not None
        else None
    )

    def _update_meta(meta: Dict, probabilities) -> Optional[Dict]:
        meta = dict(meta)
        meta.setdefault("object_annotation_category", "")

        description_prev: Optional[Description] = None
        if (
            ptc.compatible_predictions_only
            and meta.get("object_annotation_status", "") == "validated"
        ):
            description_prev = display_name_to_description.at[
                meta["object_annotation_category"], "polytaxo_description_obj"
            ]

            if filter_validated is not None and not filter_validated.match(
                description_prev
            ):
                return None

            if taxonomy_augmentation_rules is not None:
                for query, update in taxonomy_augmentation_rules:
                    if query.match(description_prev):
                        description_prev = update.apply(description_prev)

        description = poly_taxonomy.parse_probabilities(
            np.asarray(probabilities),
            baseline=description_prev,
            thr_pos_abs=ptc.threshold,
            thr_neg=1 - ptc.threshold,
            thr_pos_rel=ptc.threshold_relative,
        )

        # Exclude descriptors flagged predict=False (retreat to their parent).
        cleaned = []
        for d in description.descriptors:
            if isinstance(d, (TagNode, PrimaryNode)) and not d.meta.get("predict", True):
                if d.parent is not None:
                    cleaned.append(d.parent)
            else:
                cleaned.append(d)
        description = Description(poly_taxonomy.root).update(
            d for d in cleaned if d is not None and not (isinstance(d, PrimaryNode) and d.parent is None)
        )

        if prediction_constraint_rules is not None:
            for query, update in prediction_constraint_rules:
                if query.match(description):
                    description = update.apply(description)

        # Re-add the previous description in case a rule erased a
        # previously validated annotation.
        if description_prev is not None:
            description.add(description_prev)

        if ptc.save_raw_descriptions:
            meta["object_polytaxo_description"] = str(description)

        # Negated qualifiers are not representable on EcoTaxa.
        description.qualifiers = [
            q for q in description.qualifiers if not isinstance(q, NegatedRealNode)
        ]

        try:
            display_name = description_to_display_name.at[
                str(description), "display_name"
            ]
        except KeyError as exc:
            qualifier_description = Description(poly_taxonomy.root).update(
                description.qualifiers
            )
            matching_virtual = next(
                (
                    v
                    for v in description.anchor.get_applicable_virtuals()
                    if v.description == qualifier_description
                ),
                None,
            )
            if matching_virtual is not None:
                msg = (
                    f"Consider creating '{description.anchor.name}>"
                    f"{matching_virtual.name}' on EcoTaxa."
                )
            else:
                msg = (
                    "Consider creating an appropriate morpho-taxon on EcoTaxa "
                    "and adding it to the list of virtuals."
                )
            if meta.get("object_annotation_status", "") == "validated":
                msg += (
                    f"\nOriginal description was: {description_prev} "
                    f"({meta['object_annotation_category']})"
                )
            logger.error(
                "Could not find description in EcoTaxa taxonomy: %s\n%s",
                exc,
                textwrap.indent(msg, "  "),
            )
            display_name = meta["object_annotation_category"]

        if meta["object_annotation_category"] == display_name:
            if ptc.skip_unchanged_objects:
                return None
        else:
            meta.update(
                object_annotation_category=display_name,
                object_annotation_status="predicted",
            )

        if ptc.strip_metadata:
            keep = {
                "object_id",
                "object_annotation_category",
                "object_annotation_status",
                "object_polytaxo_description",
            }
            meta = {k: v for k, v in meta.items() if k in keep}
        else:
            meta = {
                k: v
                for k, v in meta.items()
                if not k.startswith("object_annotation_")
                or k in {"object_annotation_category", "object_annotation_status"}
            }

        return meta

    meta = Call(_update_meta, meta, probabilities)
    Filter(meta)
    return meta


# ---------------------------------------------------------------------------
# Runner


def _measure_on_device(flag, device: torch.device) -> bool:
    """``segmentation.device`` for the re-uploading measurement:
    ``auto`` measures on the card when the model runs there, on the host
    when it runs on the CPU."""
    if flag != "auto":
        return bool(flag)
    return device.type == "cuda"


class Runner(PipelineRunner):
    @staticmethod
    def _configure_and_run(config_dict):
        with tracing.unit("predict"):
            with tracing.span("unit.build"):
                built = Runner._build(config_dict)
            if built is not None:
                p, obj = built
                p.run(iter([obj]))

    @staticmethod
    def _build(config_dict):
        """Validate the task, set up the mesh, load the model and build the
        pipeline; returns (pipeline, its first stream object), or None where
        the task does not validate (the errors are logged)."""
        import pydantic

        try:
            config = PredictionPipelineConfig.model_validate(config_dict)
        except pydantic.ValidationError as exc:
            logger.error(str(exc))
            return None
        apply_platform(config)

        if sys.stdout.isatty():
            Progress = LiveProgress
        else:
            log_interval = config.log_interval
            if isinstance(log_interval, str):
                log_interval = pd.Timedelta(log_interval).total_seconds()
            Progress = partial(LogProgress, log_interval=log_interval)

        os.makedirs(config.target_dir, exist_ok=True)

        from ..models.inference import DeviceTiledInference, TorchInference
        from ..models.model_io import load_model

        device = resolve_device(config.model.device)

        from ..parallel import setup_parallel

        mesh = setup_parallel(config.parallel, device=device)

        with Pipeline() as p:
            process_meta_var = Variable("process_meta")
            process_meta: Dict = {}

            input_archive_fns = list(
                _find_files_glob(config.input.path, config.input.ignore_patterns)
            )
            logger.info(
                "Found %d input archives in %s", len(input_archive_fns), config.input.path
            )

            input_archive_fn = Unpack(natsorted(input_archive_fns))
            Progress(input_archive_fn)

            def out_fn(suffix):
                return Call(
                    lambda fn: os.path.join(
                        config.target_dir,
                        os.path.splitext(os.path.basename(fn))[0] + suffix,
                    ),
                    input_archive_fn,
                )

            predictions_fn = out_fn(".h5")
            measurements_fn = out_fn(".segmentation.zip")
            polytaxo_fn = out_fn(".polytaxo.zip")

            et_obj = EcotaxaReader(input_archive_fn)
            image = Call(lambda o: o.image, et_obj)
            object_id = Call(lambda o: o.meta["object_id"], et_obj)

            if config.input.max_n_objects is not None:
                Slice(config.input.max_n_objects)

            Progress(object_id)

            # Decouple archive reading and PNG decode from the device stage.
            StreamBuffer(16)

            # --- model loading + metadata contract
            model = load_model(config.model.model_fn, dtype=config.model.dtype)
            model_meta_dict = dict(model.meta)
            if config.model.meta is not None:
                model_meta_dict = recursive_update(
                    model_meta_dict, config.model.meta.model_dump()
                )
            try:
                model_meta = ModelMetaSchema.model_validate(model_meta_dict)
            except Exception:
                logger.error(
                    "Could not validate combined model metadata %r", model_meta_dict
                )
                raise

            if len(model_meta.outputs) != 1:
                raise ValueError(
                    "The model metadata must declare exactly one output, "
                    f"got {len(model_meta.outputs)}: "
                    f"{sorted(model_meta.outputs)}"
                )
            ((output_name, output_description),) = list(model_meta.outputs.items())
            logger.info(
                "Output channels '%s': %s", output_name, output_description.channel_names
            )

            input_size = config.model.input_size

            def pre_transform(img: np.ndarray) -> np.ndarray:
                """Host pre-transform: center-crop/pad when not tiling."""
                if config.model.tiling is not False:
                    return img
                img = np.asarray(img)
                if img.ndim == 3 and img.shape[-1] == 1:
                    img = img[..., 0]
                H, W = img.shape[:2]
                y0 = max(0, (H - input_size) // 2)
                x0 = max(0, (W - input_size) // 2)
                crop = img[y0 : y0 + input_size, x0 : x0 + input_size]
                if crop.shape[:2] != (input_size, input_size):
                    pad_y = input_size - crop.shape[0]
                    pad_x = input_size - crop.shape[1]
                    pad = [
                        (pad_y // 2, pad_y - pad_y // 2),
                        (pad_x // 2, pad_x - pad_x // 2),
                    ] + [(0, 0)] * (crop.ndim - 2)
                    crop = np.pad(crop, pad)
                return crop

            import contextlib

            # The transfer dtype of the JAX package: float16 (uint8 on the
            # opt-in rung with the device blend); float32 only for a float32
            # raw export.
            raw_f16 = config.raw_h5_dtype == "float16"
            raw_u8 = config.raw_h5_dtype == "uint8"
            if raw_u8 and (
                config.model.tiling is False
                or not config.model.tiling.device_blend
            ):
                logger.warning(
                    "raw_h5_dtype: uint8 only applies to device-blended "
                    "tiled prediction maps (the device quantizes after "
                    "blending); falling back to float16."
                )
                raw_u8, raw_f16 = False, True
            if raw_u8:
                transfer_dtype = np.uint8
            else:
                transfer_dtype = (
                    None if config.save_raw_h5 and not raw_f16 else np.float16
                )

            tiling = config.model.tiling
            seg_stats = None
            if tiling is not False and tiling.device_blend:
                # Each object's tile grid is inferred and linearly blended on
                # the device; only the blended prediction is fetched.
                if config.model.n_threads > 1:
                    logger.warning(
                        "model.n_threads=%d has no effect on the device-blend "
                        "path (host work there is tile cutting only); set "
                        "tiling.device_blend: false to use host thread "
                        "parallelism.",
                        config.model.n_threads,
                    )
                # Fused measurement: the blended canvases are already on the
                # device. segmentation.device: false forces the host path.
                fused_measure = (
                    config.segmentation is not False
                    and config.segmentation
                    and not config.segmentation.draw
                    and config.segmentation.device is not False
                    and output_description.channel_names is not None
                )
                predictions, seg_stats = DeviceTiledInference(
                    model,
                    image,
                    tile_size=tiling.size,
                    tile_stride=tiling.stride,
                    batch_size=config.model.batch_size or 8,
                    chunk_size=tiling.chunk_size,
                    in_flight=tiling.in_flight,
                    transfer_dtype=transfer_dtype,
                    measure_channels=(
                        list(output_description.channel_names)
                        if fused_measure
                        else None
                    ),
                    measure_fill_holes=(
                        config.segmentation.fill_holes if fused_measure else False
                    ),
                    device=device,
                    mesh=mesh,
                )
                if not fused_measure:
                    seg_stats = None
            else:
                with contextlib.ExitStack() as stack:
                    if tiling is not False:
                        stack.enter_context(
                            TiledPipeline(
                                (tiling.size, tiling.size),
                                image,
                                tile_stride=(tiling.stride, tiling.stride),
                                blend_strategy="linear",
                            )
                        )

                    is_batch = bool(config.model.batch_size)
                    if is_batch:
                        stack.enter_context(
                            BatchedPipeline(config.model.batch_size)
                        )

                    if config.model.n_threads > 1:
                        from ..engine import DataParallelPipeline

                        stack.enter_context(
                            DataParallelPipeline(executor=config.model.n_threads)
                        )

                    predictions = TorchInference(
                        model,
                        image,
                        is_batch=is_batch,
                        batch_size=None if is_batch else 8,
                        pre_transform=pre_transform,
                        transfer_dtype=transfer_dtype,
                        device=device,
                        mesh=mesh,
                    )

            # Decouple the device stage from the output taps; the capacity
            # holds a whole device chunk.
            StreamBuffer(64)

            if config.save_raw_h5:
                # As the JAX package: one dataset per object for tiled
                # models, appended columns otherwise; DEFLATE level 1 +
                # shuffle; the effective storage dtype as a root attribute.
                h5_mode_create = config.model.tiling is not False
                h5_pred = predictions
                if raw_f16:
                    h5_pred = Call(
                        lambda p: np.asarray(p, np.float16), predictions
                    )
                HDF5Writer(
                    predictions_fn,
                    (
                        [(object_id, h5_pred)]
                        if h5_mode_create
                        else [("object_id", object_id), ("predictions", h5_pred)]
                    ),
                    dataset_mode="create" if h5_mode_create else "append",
                    compression="gzip",
                    compression_opts=1,
                    file_attrs={
                        "raw_dtype": (
                            "uint8" if raw_u8
                            else ("float16" if raw_f16 else "float32")
                        ),
                        **({"raw_scale": 1.0 / 255.0} if raw_u8 else {}),
                    },
                )

            if config.segmentation:
                if config.model.tiling is False:
                    logger.warning("Segmentation is requested but tiling is not enabled.")
                if output_description.channel_names is None:
                    raise ValueError(f"Supply channel_names for output '{output_name}'")

                if seg_stats is not None:
                    # Measurement already ran fused into the device blend;
                    # assemble the meta (plus the exact convex hull from the
                    # fetched row extremes) on the host. Overflowing masks
                    # fall back to the host path per object and channel.
                    channel_names = list(output_description.channel_names)
                    fill_holes = config.segmentation.fill_holes

                    def _fused_meta(meta, stats, probs):
                        from ..ops.segment_measure import (
                            convex_area_from_extremes,
                        )

                        meta = {
                            k: v
                            for k, v in dict(meta).items()
                            if k.split("_", maxsplit=1)[0] in VALID_PREFIXES
                        }
                        for c, name in enumerate(channel_names):
                            if stats is None or stats["overflow"][c]:
                                host_meta, _ = measure_segments(
                                    {},
                                    None,
                                    probs[..., c : c + 1],
                                    [name],
                                    False,
                                    fill_holes=fill_holes,
                                )
                                meta.update(host_meta)
                                continue
                            meta[f"object_{name}_raw_area"] = int(
                                stats["raw_area"][c]
                            )
                            area = float(stats["area"][c])
                            if area > 0:
                                convex = convex_area_from_extremes(
                                    stats["extremes"][c], probs.shape[:2]
                                )
                                meta[f"object_{name}_area"] = area
                                meta[f"object_{name}_axis_major_length"] = float(
                                    stats["axis_major_length"][c]
                                )
                                meta[f"object_{name}_area_convex"] = convex
                                meta[f"object_{name}_area_convex_ratio"] = (
                                    area / convex if convex else 0
                                )
                            else:
                                meta[f"object_{name}_area"] = 0
                                meta[f"object_{name}_axis_major_length"] = 0
                                meta[f"object_{name}_area_convex"] = 0
                                meta[f"object_{name}_area_convex_ratio"] = 0
                        return meta

                    meta = Call(
                        _fused_meta,
                        Call(lambda o: o.meta, et_obj),
                        seg_stats,
                        predictions,
                    )
                    fnames_images = []
                elif config.segmentation.draw or not _measure_on_device(
                    config.segmentation.device, device
                ):
                    # Overlay drawing needs the masks on the host; the host
                    # path is also the default when the model runs on the CPU.
                    meta_images = Call(
                        measure_segments,
                        Call(lambda o: o.meta, et_obj),
                        image,
                        predictions,
                        list(output_description.channel_names),
                        config.segmentation.draw,
                        config.segmentation.fill_holes,
                    )
                    meta, fnames_images = meta_images.unpack(2)
                else:
                    meta = BatchedSegmentMeasure(
                        Call(lambda o: o.meta, et_obj),
                        predictions,
                        list(output_description.channel_names),
                        config.segmentation.fill_holes,
                        device=device,
                    )
                    fnames_images = []
                EcotaxaWriter(measurements_fn, fnames_images, meta=meta)

            if config.polytaxo is not False:
                meta = build_polytaxo_pipeline(config, et_obj, predictions)
                EcotaxaWriter(polytaxo_fn, [], meta=meta)

        obj = StreamObject(n_remaining_hint=1)
        obj[process_meta_var] = process_meta
        return p, obj
