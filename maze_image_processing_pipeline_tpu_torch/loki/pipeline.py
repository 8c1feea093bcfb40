"""LOKI re-segmentation pipeline (``maze-ipp-torch loki``) of the PyTorch port.

Counterpart of ``maze_image_processing_pipeline_tpu/loki/pipeline.py``,
with the same stages and the same archive: sample discovery → metadata and
telemetry → [stitch →] U-Net segmentation on the card
(:func:`.device_seg.build_torch_segmentation`: tile inference, blend, the
frame chain with its CUDA kernels, device crops) or threshold segmentation
of the crops (measured in batches on the card,
:class:`..engine.image.BatchedImageProperties`) → duplicate detection →
rescale / scalebar / annotation merge → EcoTaxa archive. Per-object host
work stays behind stream buffers so it overlaps with the card. With
``parallel:`` the U-Net path's frame groups go round-robin over a mesh of
cards (:mod:`..parallel`); ``input.num_shards`` / ``shard_index`` split the
samples over hosts.
"""

from __future__ import annotations

import logging
import os
import sys
from functools import partial
from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import pandas as pd

from .. import __version__ as _version
from .. import tracing
from ..common import find_files_glob as _find_files_glob, natsorted
from ..config import generate_yaml_example  # noqa: F401  (re-exported for docs)
from ..dataio import Archive, EcotaxaWriter, ImageReader, Telemetry, read_tsv
from ..dataio.loki import LOG_FIELDS_TO_ECOTAXA, find_data_roots, read_log, read_yaml
from ..engine import (
    AggregateErrorsPipeline,
    Call,
    Filter,
    MergeNodesPipeline,
    Node,
    Output,
    Pipeline,
    Progress as LiveProgress,
    RawOrVariable,
    ReturnOutputs,
    Slice,
    StreamBuffer,
    StreamObject,
    Unpack,
    Variable,
)
from ..engine.image import (
    BatchedImageProperties,
    CalculateZooProcessFeatures,
    DrawScalebar,
    FilterEval,
    ImageProperties,
)
from ..ops.image import rescale_max_intensity
from ..parallel.multihost import partition_work
from ..progress import LogProgress
from ..runner import PipelineRunner, apply_platform
from .config_schema import (
    DetectDuplicatesModelOrFalse,
    EcoTaxaOutputConfig,
    LokiInputConfig,
    SegmentationConfig,
    ThresholdSegmentationConfig,
)
from .device_seg import build_torch_segmentation
from .meta import (
    ensure_object_frame_id,
    format_object_id,
    parse_object_id,
    update_and_validate_sample_meta,
)
from .zoomie import DetectDuplicatesSimple

logging.captureWarnings(True)
logger = logging.getLogger(__name__)


# ---------------------------------------------------------------------------
# Overlap scoring (bbox IoU) for dedup + annotation merging


def calc_overlap(xy0, wh0, xy1, wh1) -> Tuple[float, float, float]:
    """(overlap_x, overlap_y, overlap_xy-IoU) of two boxes (pos, size)."""
    l0, t0 = xy0
    w0, h0 = wh0
    l1, t1 = xy1
    w1, h1 = wh1
    r0, b0 = l0 + w0, t0 + h0
    r1, b1 = l1 + w1, t1 + h1

    ix = max(0, min(r0, r1) - max(l0, l1))
    iy = max(0, min(b0, b1) - max(t0, t1))
    ux = max(1, max(r0, r1) - min(l0, l1))
    uy = max(1, max(b0, b1) - min(t0, t1))

    inter = ix * iy
    union = w0 * h0 + w1 * h1 - inter
    return ix / ux, iy / uy, inter / union if union else 0.0


def score_fn_simple(meta0: Mapping, meta1: Mapping) -> float:
    """Bounding-box IoU from object metadata (dedup scorer)."""
    xy0 = meta0["object_posx"], meta0["object_posy"]
    xy1 = meta1["object_posx"], meta1["object_posy"]
    wh0 = meta0["object_width"], meta0["object_height"]
    wh1 = meta1["object_width"], meta1["object_height"]
    return calc_overlap(xy0, wh0, xy1, wh1)[2]


# ---------------------------------------------------------------------------
# Input stage


def read_log_and_yaml_meta(data_root, meta: Mapping) -> Dict:
    """Merge LOKI device-log metadata and the meta.yaml sidecar."""
    log_dir = data_root / "Log"
    log_pat = "LOKI*.log"
    log_fns = log_dir.glob(log_pat)
    if len(log_fns) != 1:
        raise ValueError(f"Could not find exactly one '{log_pat}' in '{log_dir}'")
    return {
        **meta,
        **read_log(log_fns[0], remap_fields=LOG_FIELDS_TO_ECOTAXA),
        **read_yaml(data_root / "meta.yaml"),
    }


def build_object_frame_id_filter(valid_frames_fn: Optional[str], meta: Variable):
    if valid_frames_fn is None:
        return
    valid_frames = ensure_object_frame_id(read_tsv(valid_frames_fn))
    valid_frame_ids = set(valid_frames["object_frame_id"].unique())
    logger.info(
        "Filtering objects from %s (%d valid frame IDs).",
        valid_frames_fn,
        len(valid_frame_ids),
    )
    Filter(lambda obj: obj[meta]["object_frame_id"] in valid_frame_ids)


def build_input(
    input_config: LokiInputConfig,
    output_config: EcoTaxaOutputConfig,
    meta: Variable,
    process_meta: Dict,
    Progress,
):
    """Sample discovery → metadata → per-picture objects (SURVEY §3.1)."""
    default_meta = dict(input_config.default_meta)
    default_meta.setdefault("acq_instrument", "LOKI")
    meta = Call(lambda m: {**m, **default_meta}, meta)

    sample_roots = [
        Archive(fn)
        for fn in _find_files_glob(input_config.path, input_config.ignore_patterns)
    ]

    if input_config.discover:
        logger.info("Discovering LOKI samples in %s...", input_config.path)
        sample_roots = [
            root
            for sr in sample_roots
            for root in find_data_roots(sr, input_config.ignore_patterns)
        ]

    logger.info("Found %d input directories in %s", len(sample_roots), input_config.path)

    sample_roots = natsorted(sample_roots, key=str)
    if input_config.num_shards > 1:
        sample_roots = partition_work(
            sample_roots, input_config.num_shards, input_config.shard_index
        )

    sample_root = Unpack(sample_roots)
    Progress(sample_root)

    meta = Call(read_log_and_yaml_meta, sample_root, meta)

    with AggregateErrorsPipeline():
        meta = Call(update_and_validate_sample_meta, sample_root, meta)

        if input_config.merge_telemetry is not False:
            telemetry_config = input_config.merge_telemetry
            logger.info("Merging telemetry: %s", telemetry_config)
            telemetry = Call(
                Telemetry,
                sample_root,
                ignore_errors=True,
                **telemetry_config.model_dump(),
            )
        else:
            telemetry = None

    os.makedirs(output_config.target_dir, exist_ok=True)

    target_archive_fn = Call(
        lambda m: os.path.join(
            output_config.target_dir,
            "LOKI_{sample_station}_{sample_haul}.zip".format_map(m),
        ),
        meta,
    )

    if output_config.skip_existing:

        def check_not_exists(fn):
            if not os.path.exists(fn):
                return True
            logger.info("Skipping target '%s'.", fn)
            return False

        Filter(Call(check_not_exists, target_archive_fn))

    if input_config.save_meta:
        input_meta_archive_fn = Call(
            lambda m: os.path.join(
                output_config.target_dir,
                "LOKI_{sample_station}_{sample_haul}_input_meta.zip".format_map(m),
            ),
            meta,
        )

    # Overlap per-sample metadata/telemetry loading with downstream work.
    StreamBuffer(1)

    picture_fns = Call(
        lambda root: sorted(
            p
            for p in (root / "Pictures").glob("*/*.*")
            if p.suffix in (".jpg", ".bmp", ".png")
        ),
        sample_root,
    )
    Call(
        lambda fns, root: logger.info("%d input images in %s.", len(fns), root),
        picture_fns,
        sample_root,
    )

    picture_fn = Unpack(picture_fns)

    object_id = Call(lambda p: p.stem, picture_fn)
    meta = Call(parse_object_id, object_id, meta)

    build_object_frame_id_filter(input_config.valid_frames_fn, meta)

    if input_config.slice is not None:
        logger.warning("Only processing the first %d input objects.", input_config.slice)
        Slice(input_config.slice)

    def error_handler(exc, img_fn):
        logger.error("Could not read image: %s", img_fn, exc_info=True)

    with MergeNodesPipeline(on_error=error_handler, on_error_args=(picture_fn,)):
        image = ImageReader(picture_fn, "L")

    meta = Call(
        lambda img, m: {
            **m,
            "object_height": img.shape[0],
            "object_width": img.shape[1],
            "object_bounding_box_area": img.shape[0] * img.shape[1],
        },
        image,
        meta,
    )

    if input_config.filter_expr is not None:
        logger.info("Filtering input by expression %r", input_config.filter_expr)
        process_meta["process_input_filter"] = input_config.filter_expr
        FilterEval(input_config.filter_expr, meta)

    build_duplicate_detection(
        input_config.detect_duplicates, image, meta, "input", process_meta
    )

    if input_config.save_meta:
        EcotaxaWriter(input_meta_archive_fn, [], meta)

    if telemetry is not None:
        meta = Call(Telemetry.merge_telemetry, telemetry, meta)

    return image, meta, target_archive_fn


# ---------------------------------------------------------------------------
# Segmentation stages


def build_threshold_segmentation(config: ThresholdSegmentationConfig, image, meta):
    """Brightness-threshold segmentation of individual crops.

    Reference parity: ``loki/pipeline.py:648-656`` (mask → any() filter →
    ImageProperties → ZooProcess). ``device`` true, ``"auto"`` or
    ``"cuda"`` measures the crops in batches on the card
    (:class:`BatchedImageProperties`; without a card it raises), ``"cpu"``
    the same batches on the CPU, false the reference's per-crop host path.
    """
    mask = Call(
        lambda img: np.asarray(img) > config.threshold_brighter,
        image,
    )
    if config.device is not False:
        device = "cpu" if config.device == "cpu" else "cuda"
        props = BatchedImageProperties(
            image, config.threshold_brighter, chunk_size=config.device_chunk_size, device=device
        )
        Filter(Call(lambda p: p["__props__"]["area"] > 0, props))
    else:
        Filter(Call(lambda m: bool(m.any()), mask))
        props = ImageProperties(mask, image)
    meta = CalculateZooProcessFeatures(props, meta, prefix="object_")
    return image, meta, mask


def build_segmentation(
    config: SegmentationConfig,
    target_dir: str,
    image,
    meta,
    process_meta: Dict,
    mesh=None,
):
    mask = None
    if config.threshold is not None:
        image, meta, mask = build_threshold_segmentation(config.threshold, image, meta)
    elif config.pytorch is not None:
        image, meta, mask = build_torch_segmentation(
            config.pytorch,
            target_dir,
            image,
            meta,
            process_meta,
            device=config.pytorch.device,
            mesh=mesh,
        )
    else:  # pragma: no cover - validated by the schema
        raise ValueError(f"Unknown segmentation config: {config}")

    if config.filter_expr is not None:
        logger.info("Filtering segmentation results by expression %r", config.filter_expr)
        FilterEval(config.filter_expr, meta)

    return image, meta, mask


def build_duplicate_detection(
    detect_duplicates_config: DetectDuplicatesModelOrFalse,
    image,
    meta,
    where: str,
    process_meta: Dict,
):
    if not detect_duplicates_config:
        return

    logger.info("Duplicate detection (%s) is active (%s).", where, detect_duplicates_config)

    dupset_id = DetectDuplicatesSimple(
        Call(lambda m: m["object_frame_id"], meta),
        Call(lambda m: m["object_id"], meta),
        score_fn=score_fn_simple,
        score_arg=meta,
        min_similarity=detect_duplicates_config.min_similarity,
        max_age=detect_duplicates_config.max_age,
    )

    def keep_duplicate(dupset, m):
        if dupset == m["object_id"]:
            return True
        logger.info("Dropping duplicate (%s): %s of %s", where, m["object_id"], dupset)
        return False

    Filter(Call(keep_duplicate, dupset_id, meta))


# ---------------------------------------------------------------------------
# Annotation merging


@ReturnOutputs
@Output("meta")
class MergeAnnotations(Node):
    """Join prior EcoTaxa annotations onto re-segmented objects by bbox IoU.

    Contract from ``loki/pipeline.py:991-1073``: per frame, the
    best-overlapping prior annotation is attached when IoU exceeds
    ``min_overlap``; a previously validated status is downgraded to
    'predicted' below ``min_validated_overlap``; unmatched objects get
    blanked annotation columns.
    """

    def __init__(
        self,
        meta: RawOrVariable[Dict],
        annotations: pd.DataFrame,
        *,
        min_overlap: float = 0.5,
        min_validated_overlap: float = 0.8,
    ) -> None:
        self.meta = meta
        self.min_overlap = min_overlap
        self.min_validated_overlap = min_validated_overlap

        required = {
            "object_width",
            "object_height",
            "object_posx",
            "object_posy",
            "object_frame_id",
        }
        missing = required - set(annotations.columns)
        if missing:
            raise ValueError(f"The following columns are missing: {sorted(missing)}")

        self._by_frame = annotations.groupby("object_frame_id")
        self._annotation_columns = [
            c for c in annotations.columns if c.startswith("object_annotation")
        ]
        super().__init__()

    def transform(self, meta: Dict) -> Dict:
        meta = dict(meta)
        try:
            frame_annotations = self._by_frame.get_group(meta["object_frame_id"])
        except KeyError:
            return meta
        if not len(frame_annotations):
            return meta

        overlaps = frame_annotations.apply(
            lambda row: score_fn_simple(row.to_dict(), meta), axis=1
        )
        best_idx = overlaps.idxmax()
        best_overlap = float(overlaps.loc[best_idx])

        meta["object_annotation_merge_overlap"] = best_overlap

        if best_overlap > self.min_overlap:
            annotation_meta = frame_annotations.loc[
                best_idx, self._annotation_columns
            ].to_dict()
            if best_overlap < self.min_validated_overlap and annotation_meta.get(
                "object_annotation_status"
            ) in ("validated", "dubious"):
                annotation_meta["object_annotation_status"] = "predicted"
            annotation_meta["object_annotation_merge_src"] = frame_annotations.at[
                best_idx, "object_id"
            ]
        else:
            annotation_meta = {k: "" for k in self._annotation_columns}

        meta.update(annotation_meta)
        return meta

    def _input_names(self):
        return ("meta",)


def filename_suffix(fn: str, suffix: str) -> str:
    stem, ext = os.path.splitext(fn)
    return stem + suffix + ext


# ---------------------------------------------------------------------------
# Runner


def task_device(config: SegmentationConfig) -> str:
    """The device a loki task runs on: the U-Net's, or the threshold
    measurement's (the CPU for its host path, ``device: false``)."""
    if config.pytorch is not None:
        return config.pytorch.device
    return "cpu" if config.threshold.device in ("cpu", False) else "cuda"


class Runner(PipelineRunner):
    @staticmethod
    def _configure_and_run(config_dict):
        with tracing.unit("loki"):
            with tracing.span("unit.build"):
                built = Runner._build(config_dict)
            if built is not None:
                p, obj = built
                p.run(iter([obj]))

    @staticmethod
    def _build(config_dict):
        """Validate the task, set up the mesh and build the pipeline;
        returns (pipeline, its first stream object), or None where the task
        does not validate (the errors are logged)."""
        import pydantic

        from .config_schema import SegmentationPipelineConfig

        try:
            pipeline_config = SegmentationPipelineConfig.model_validate(config_dict)
        except pydantic.ValidationError as exc:
            logger.error(str(exc))
            return None
        apply_platform(pipeline_config)

        if sys.stdout.isatty():
            Progress = LiveProgress
        else:
            log_interval = pipeline_config.log_interval
            if isinstance(log_interval, str):
                log_interval = pd.Timedelta(log_interval).total_seconds()
            Progress = partial(LogProgress, log_interval=log_interval)

        from ..parallel import setup_parallel

        mesh = setup_parallel(pipeline_config.parallel, device=task_device(pipeline_config.segmentation))

        with Pipeline() as p:
            process_meta_var = Variable("process_meta")
            process_meta = {
                "process_pipeline_version": _version,
                "process_pipeline": "maze-ipp-torch",
            }

            image, meta, target_archive_fn = build_input(
                pipeline_config.input,
                pipeline_config.output,
                process_meta_var,
                process_meta,
                Progress,
            )

            Progress("Input objects")

            # Overlap host image decode (native codecs release the GIL)
            # with the device segmentation stage's compute wait.
            StreamBuffer(16)

            image, meta, mask = build_segmentation(
                pipeline_config.segmentation,
                pipeline_config.output.target_dir,
                image,
                meta,
                process_meta,
                mesh=mesh,
            )

            # Must hold a whole frame group's object burst (frame_batch
            # frames × ~20 regions arrive per stats fetch), so the consumer
            # thread (dedup, PNG encode, zip write) keeps working during the
            # producer's device waits.
            StreamBuffer(192)

            postprocess_config = pipeline_config.postprocess

            build_duplicate_detection(
                postprocess_config.detect_duplicates, image, meta, "output", process_meta
            )

            process_meta["process_rescale_max_intensity"] = (
                postprocess_config.rescale_max_intensity
            )
            if postprocess_config.rescale_max_intensity:
                logger.info("Rescaling intensity of output images: enabled")
                image = Call(rescale_max_intensity, image)

            if postprocess_config.scalebar is not None:
                scalebar_config = postprocess_config.scalebar
                process_meta["process_scalebar_px_per_mm"] = scalebar_config.px_per_mm
                logger.info("Scalebar: enabled")
                image = DrawScalebar(
                    image,
                    length_in_unit=1,
                    px_per_unit=scalebar_config.px_per_mm,
                    unit="mm",
                    fg_color=255,
                    bg_color=0,
                )

            if postprocess_config.merge_annotations is not None:
                logger.info("Merging annotations: %s", postprocess_config.merge_annotations)
                ma_config = postprocess_config.merge_annotations.model_dump()
                annotations = ensure_object_frame_id(
                    read_tsv(ma_config.pop("annotations_fn"))
                )
                meta = MergeAnnotations(meta, annotations, **ma_config)

            if postprocess_config.slice is not None:
                logger.warning(
                    "Only processing the first %d output objects.",
                    postprocess_config.slice,
                )
                Slice(postprocess_config.slice)

            if postprocess_config.filter_expr is not None:
                logger.info(
                    "Filtering output by expression %r", postprocess_config.filter_expr
                )
                FilterEval(postprocess_config.filter_expr, meta)

            output_config = pipeline_config.output

            target_image_fn = Call(lambda m: output_config.image_fn.format_map(m), meta)
            output_images = [(target_image_fn, image)]
            if output_config.store_mask:
                target_mask_fn = Call(filename_suffix, target_image_fn, "_mask")
                output_images.append((target_mask_fn, mask))

            # Merge process metadata into each object's row.
            meta = Call(lambda m, pm: {**pm, **m}, meta, process_meta_var)

            EcotaxaWriter(
                target_archive_fn,
                output_images,
                meta,
                store_types=output_config.type_header,
            )

        obj = StreamObject(n_remaining_hint=1)
        obj[process_meta_var] = process_meta
        return p, obj
