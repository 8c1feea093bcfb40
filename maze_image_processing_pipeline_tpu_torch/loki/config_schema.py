"""LOKI pipeline configuration schema of the PyTorch port.

A copy of ``maze_image_processing_pipeline_tpu/loki/config_schema.py`` so
that the JAX package's task files run unchanged, with these differences:

* model segmentation is ``pytorch:``; ``jax:`` is accepted as its alias;
* ``device`` defaults to ``"cuda"``, accepts ``"cpu"``, and reads ``"tpu"``
  (and ``"gpu"``) as the accelerator, i.e. the CUDA card;
* the threshold path's ``device`` also accepts ``"cuda"`` and ``"cpu"``;
  true and ``"auto"`` mean the card (there is no dispatch probe);
* ``postprocess.pallas_kernels`` is accepted and ignored (the port's
  kernels always run on the card);
* ``parallel`` builds a mesh of the cards (of CPU replicas for a ``device:
  cpu`` task), every card a data replica (:mod:`..parallel`).
"""

from __future__ import annotations

from typing import Any, Dict, List, Literal, Optional

from pydantic import BaseModel, ConfigDict, Field, field_validator, model_validator

from ..config import DefaultModel, TrueToDefaultsModel
from ..parallel.config import ParallelConfig


class SegmentationPostprocessingConfig(TrueToDefaultsModel):
    pallas_kernels: bool = Field(
        False,
        description=(
            "Accepted for task-file compatibility with the JAX package and "
            "ignored: the PyTorch port's CUDA kernels always run on the card."
        ),
        json_schema_extra={"debug": True},
    )
    closing_radius: int = Field(
        0, description="Apply morphological closing (close small gaps) using this radius."
    )
    opening_radius: int = Field(
        0, description="Apply morphological opening (remove small objects) using this radius."
    )
    merge_segments_distance: int = Field(
        0, description="Merge segments closer than the specified distance."
    )
    min_area: int = Field(
        0, description="Remove objects with an area below the specified threshold."
    )
    n_threads: int = Field(
        0, description="Use multiple threads for host-side post-processing stages."
    )
    clear_border: bool = Field(
        False, description="Clear objects touching the image border."
    )
    max_regions: int = Field(
        64,
        description="Static per-frame region capacity of the fused device "
        "measurement pass (regions beyond this are dropped with a warning).",
    )


class ThresholdSegmentationConfig(DefaultModel):
    __default_field__ = "threshold_brighter"

    threshold_brighter: float = Field(
        ..., description="Extract objects brighter than this threshold."
    )
    device: bool | Literal["auto", "cuda", "cpu"] = Field(
        "auto",
        description=(
            "Measure crops batched on the card (fused single-region props + "
            "exact filled area): true, 'auto' and 'cuda' mean the card and "
            "raise without one; 'cpu' runs the same batches on the CPU; "
            "false = per-crop host path."
        ),
    )
    device_chunk_size: int = Field(
        256,
        description="Consecutive crops measured per device batch.",
        json_schema_extra={"debug": True},
    )


class StitchConfig(TrueToDefaultsModel):
    skip_single: bool = Field(
        False,
        description="Remove stitched frames with only one object (debug).",
        json_schema_extra={"debug": True},
    )


class TorchSegmentationConfig(DefaultModel):
    __default_field__ = "model_fn"

    model_config = ConfigDict(protected_namespaces=())

    stitch: StitchConfig | Literal[False] = Field(
        default_factory=StitchConfig,
        description="Stitch objects to reconstruct frames. (Default: true)",
    )

    model_fn: str = Field(
        description="A model checkpoint directory (params.msgpack + meta.json) "
        "saved with save_model of either package."
    )

    device: str = Field(
        "cuda",
        description="Device to run the model and the frame chain on: 'cuda' "
        "(the card; 'tpu' and 'gpu' mean the same) or 'cpu'.",
    )
    n_threads: int = Field(
        0, description="Threads for host-side stages (decode, crops). Model "
        "execution is device-batched instead of thread-replicated."
    )
    batch_size: int = Field(0, description="Device batch size (tiles per dispatch).")
    autocast: bool = Field(
        False,
        description="Accepted for task-file compatibility; dtype governs precision.",
    )
    dtype: str = Field(
        "bfloat16",
        description="Compute dtype for inference ('bfloat16' or 'float32').",
    )

    postprocess: SegmentationPostprocessingConfig | Literal[False] = Field(
        False, description="Perform full-frame post-processing steps."
    )

    frame_batch: int = Field(
        8,
        description=(
            "Stitched frames postprocessed per device dispatch (the CCL "
            "stages are latency-bound, so a batch costs barely more than "
            "one frame and shares one device→host fetch)."
        ),
        json_schema_extra={"debug": True},
    )
    device_blend: bool = Field(
        True,
        description=(
            "Blend tile predictions on the accelerator (predictions never "
            "leave the device; only labels + measurements transfer). "
            "false = host-side tile blending."
        ),
    )
    skip_empty_tiles: bool = Field(
        True,
        description=(
            "Run the model only on tiles that contain any non-zero pixel "
            "(LOKI stitched frames are mostly background). Pixels covered "
            "only by skipped tiles score 0, matching the host path's "
            "empty-tile filter."
        ),
    )
    device_crops: bool = Field(
        True,
        description=(
            "Cut per-object crops (intensity + masks) on the accelerator, "
            "packed into the frame group's fetch, instead of slicing the "
            "label frame per object on the host. Automatically disabled "
            "when postprocess.merge_segments_distance > 0."
        ),
    )

    full_frame_archive_fn: Optional[str] = Field(
        None,
        description=(
            "Write segmented full-frames to this file in the target directory "
            "(debug). NOTE: the debug dump needs the blended prediction on "
            "the host, so setting this falls back to the host-blend tile "
            "path (as if device_blend were false) — expect a slower run."
        ),
        json_schema_extra={"debug": True},
    )

    padding: int = Field(
        75, description="Pad extracted regions with this number of pixels on each border."
    )
    min_intensity: Optional[int] = Field(
        None, description="Minimum intensity of extracted regions."
    )
    apply_mask: bool = Field(
        False, description="Hide everything in a vignette that is not part of current object."
    )
    background_color: Any = Field(
        0,
        description="Color for the background when hiding foreign object parts. "
        "Can be a scalar (`0`), a color name (`'black'`) or a quantile (`'quantile:0.25'`).",
    )
    keep_background: bool = Field(
        True, description="When hiding non-object image regions, keep background."
    )
    tile_size: int = Field(1024, description="Edge length of model input tiles.")
    tile_stride: int = Field(896, description="Stride of the tiling (overlap = size - stride).")

    @field_validator("device")
    @classmethod
    def accelerator_is_cuda(cls, value: str) -> str:
        # Task files written for the JAX package say 'tpu'.
        value = value.strip().lower()
        if value in ("tpu", "gpu"):
            return "cuda"
        if value == "cpu" or value == "cuda" or value.startswith("cuda:"):
            return value
        raise ValueError(f"device must be 'cuda', 'cpu', 'tpu' or 'gpu', got {value!r}")


class SegmentationConfig(BaseModel):
    threshold: Optional[ThresholdSegmentationConfig] = Field(
        None, description="Use thresholding for segmentation."
    )
    pytorch: Optional[TorchSegmentationConfig] = Field(
        None, description="Use a PyTorch model (U-Net) for segmentation on the card."
    )

    filter_expr: Optional[str] = Field(
        None, description="Filter objects by Python expression."
    )

    @model_validator(mode="before")
    @classmethod
    def accept_jax_alias(cls, data):
        # Task files written for the JAX package use `jax:`; route to `pytorch:`.
        if isinstance(data, dict) and "jax" in data and "pytorch" not in data:
            data = dict(data)
            data["pytorch"] = data.pop("jax")
        return data

    @model_validator(mode="after")
    def exactly_one(self):
        if (self.threshold is None) == (self.pytorch is None):
            raise ValueError("Exactly one of threshold and pytorch must be configured.")
        return self


class DetectDuplicatesConfig(BaseModel):
    min_similarity: float = Field(0.98, description="Minimum similarity of two objects.")
    max_age: int = Field(1, description="Maximum age of a previous object.")


DetectDuplicatesModelOrFalse = DetectDuplicatesConfig | Literal[False]


class MergeTelemetryConfig(BaseModel):
    tolerance: Optional[str] = Field(
        default=None,
        description="Maximum delta between object time and telemetry time.",
    )


class LokiInputConfig(BaseModel):
    path: str = Field(
        description="Path to a LOKI input directory. May contain wildcard characters ('?', '*')."
    )
    discover: bool = Field(
        True,
        description="Try to discover all LOKI samples inside the specified path "
        "by looking for directories that contain 'Pictures' and 'Telemetrie' folders.",
    )
    ignore_patterns: List[str] = Field(
        [], description="Ignore these directories. May contain wildcard characters ('?', '*')."
    )

    filter_expr: Optional[str] = Field(
        None, description="Filter input objects by Python expression."
    )

    slice: Optional[int] = Field(
        None,
        description="Process only this many objects (for debugging).",
        json_schema_extra={"debug": True},
    )

    default_meta: Dict = Field({}, description="Default metadata for all objects.")
    valid_frames_fn: Optional[str] = Field(
        None,
        description="EcoTaxa TSV file containing valid frame IDs.\n"
        "Input frames with no corresponding objects in this file will be skipped.\n"
        "If not present, object_frame_id is extracted from object_id.",
    )
    merge_telemetry: MergeTelemetryConfig | Literal[False] = Field(
        default_factory=MergeTelemetryConfig,
        description="Merge telemetry. (Default: true)",
    )
    save_meta: bool = Field(
        False,
        description="Save calculated input metadata in the target directory (for debugging).",
        json_schema_extra={"debug": True},
    )

    detect_duplicates: DetectDuplicatesModelOrFalse = Field(
        False, description="Detect duplicates. (Default: false)"
    )

    num_shards: int = Field(
        1,
        description="Partition the discovered samples across this many hosts "
        "(strided); each host processes its shard_index-th slice.",
    )
    shard_index: int = Field(
        0, description="This host's shard index in [0, num_shards)."
    )


class MergeAnnotationsConfig(DefaultModel):
    __default_field__ = "annotations_fn"

    annotations_fn: str = Field(
        description="EcoTaxa TSV file containing annotations for objects.\n"
        "Required columns: object_width, object_height, object_posx, object_posy "
        "and object_frame_id (derived from object_id if absent)."
    )
    min_overlap: float = Field(
        0.5, description="Minimum overlap of object and annotation bounding box in IoU."
    )
    min_validated_overlap: float = Field(
        0.8,
        description="Minimum overlap so that the resulting annotation_status remains 'validated'.",
    )


class ScalebarConfig(BaseModel):
    px_per_mm: float = Field(description="Pixels per millimeter.")


class PostprocessingConfig(BaseModel):
    scalebar: Optional[ScalebarConfig] = Field(
        None, description="Draw a scalebar on each object image."
    )

    slice: Optional[int] = Field(
        None,
        description="Process only this many objects (for debugging).",
        json_schema_extra={"debug": True},
    )

    filter_expr: Optional[str] = Field(
        None, description="Filter objects by Python expression."
    )

    detect_duplicates: DetectDuplicatesModelOrFalse = Field(
        False, description="Detect duplicates."
    )

    merge_annotations: Optional[MergeAnnotationsConfig] = Field(
        None, description="Merge annotations."
    )

    rescale_max_intensity: bool = Field(
        False,
        description="Rescale the image intensities so that the brightest value is white.",
    )


class EcoTaxaOutputConfig(BaseModel):
    target_dir: str = Field(description="Directory where the EcoTaxa archives are created.")
    skip_existing: bool = Field(False, description="Skip if archive already exists.")
    image_fn: str = Field(
        "{object_id}.jpg",
        description="Format string for the names of image files inside the archive. "
        "All fields in metadata can be used.",
    )
    store_mask: bool = Field(
        False, description="Store the mask of each object alongside its image."
    )
    type_header: bool = Field(
        True,
        description="Include a type header in the produced TSV file. "
        "(Required for successful import into EcoTaxa.)",
    )


class SegmentationPipelineConfig(BaseModel):
    input: LokiInputConfig = Field(description="Configuration of the input.")
    segmentation: SegmentationConfig = Field(description="Configuration of the segmentation.")
    postprocess: PostprocessingConfig = Field(description="Configuration of the post-processing.")
    output: EcoTaxaOutputConfig = Field(description="Configuration of the output.")
    parallel: ParallelConfig | Literal[False] = Field(
        False,
        description="Multi-chip execution: shard device batches over a mesh "
        "of all (or explicitly configured) accelerator devices.",
    )
    log_interval: str | float = Field(
        "60s", description="The interval at which progress is logged, e.g. 10s or 1m."
    )
