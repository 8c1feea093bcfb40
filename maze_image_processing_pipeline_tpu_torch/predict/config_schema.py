"""Prediction pipeline configuration schema of the PyTorch port.

Counterpart of ``maze_image_processing_pipeline_tpu/predict/config_schema.py``,
so that the JAX package's predict task files run unchanged, with these
differences:

* ``model.device`` defaults to ``"cuda"``, accepts ``"cpu"``, and reads
  ``"tpu"`` (and ``"gpu"``) as the accelerator, i.e. the CUDA card;
* ``parallel`` builds a mesh of the cards (of CPU replicas for a
  ``device: cpu`` model), every card a data replica (:mod:`..parallel`).

Every other field and default is the original's.
"""

from __future__ import annotations

from typing import Dict, List, Literal, Optional, Sequence, Tuple

from pydantic import BaseModel, ConfigDict, Field, field_validator

from ..config import TrueToDefaultsModel
from ..parallel.config import ParallelConfig


class EcoTaxaInputConfig(BaseModel):
    path: str = Field(
        description="Path to an input EcoTaxa archive. May contain wildcard characters ('?', '*')."
    )
    ignore_patterns: List[str] = Field(
        [], description="Ignore these archives. May contain wildcard characters ('?', '*')."
    )
    max_n_objects: Optional[int] = Field(
        None,
        description="Maximum number of objects. (For debugging.)",
        json_schema_extra={"debug": True},
    )


class DataDescriptorSchema(BaseModel):
    channel_names: Optional[Sequence[str]] = Field(
        None, description="List of channel names"
    )

    model_config = ConfigDict(extra="allow")


class ModelMetaSchema(BaseModel):
    outputs: Dict[str, DataDescriptorSchema] = Field(
        description="Ordered mapping of output names to output descriptions, "
        'e.g. {"pred": {"channel_names": ["Prosoma", "Oilsack"]}}. '
        "Only a single output is supported."
    )

    model_config = ConfigDict(extra="allow")


class TilingConfig(TrueToDefaultsModel):
    size: int = Field(1024, description="Edge length of one tile")
    stride: int = Field(
        896,
        description="Stride of the tiling. `size - stride` is the overlap of two consecutive tiles.",
    )
    device_blend: bool = Field(
        True,
        description=(
            "Blend tile predictions on the accelerator and fetch only the "
            "blended per-object prediction (packed across a chunk of "
            "objects into one transfer). false = host-side tile blending."
        ),
    )
    chunk_size: int = Field(
        32,
        description=(
            "Objects packed into one device blend+fetch on the "
            "device_blend path. Larger chunks amortize the fixed "
            "per-dispatch/per-fetch latency of remote accelerators over "
            "more objects at the cost of host memory."
        ),
    )
    in_flight: int = Field(
        2,
        description=(
            "Dispatched-but-unfetched chunks on the device_blend path "
            "(pipelining depth: the accelerator computes chunk k+1 while "
            "chunk k is being fetched)."
        ),
    )


class ModelConfig(BaseModel):
    model_config = ConfigDict(protected_namespaces=())

    model_fn: str = Field(
        description="A model checkpoint directory (params.msgpack + meta.json) "
        "saved with save_model of either package."
    )

    device: str = Field(
        "cuda",
        description="Device to run the model and the device measurement on: "
        "'cuda' (the card; 'tpu' and 'gpu' mean the same) or 'cpu'.",
    )
    n_threads: int = Field(
        0,
        description=(
            "Threads for host-side stages. Model execution is "
            "device-batched. Only effective with tiling.device_blend: "
            "false (the fused device-blend path has no per-object host "
            "stage to parallelize)."
        ),
    )
    batch_size: int = Field(0, description="Device batch size.")
    autocast: bool = Field(
        False, description="Accepted for task-file compatibility; dtype governs precision."
    )
    dtype: str = Field(
        "bfloat16", description="Compute dtype for inference ('bfloat16' or 'float32')."
    )

    meta: Optional[ModelMetaSchema] = Field(None, description="Model metadata.")

    tiling: TilingConfig | Literal[False] = Field(
        False,
        description="Apply the model to square tiles on each input image. "
        "Required for semantic segmentation.",
    )
    input_size: int = Field(
        1024,
        description="Center-crop/pad input images to this square size when tiling is disabled.",
    )

    @field_validator("device")
    @classmethod
    def accelerator_is_cuda(cls, value: str) -> str:
        # Task files written for the JAX package say 'tpu'.
        if value in ("tpu", "gpu"):
            return "cuda"
        if value == "cpu" or value == "cuda" or value.startswith("cuda:"):
            return value
        raise ValueError(f"device must be 'cuda', 'cpu', 'tpu' or 'gpu', got {value!r}")


class SegmentationConfig(TrueToDefaultsModel):
    draw: bool = Field(False, description="Draw segments.")
    fill_holes: bool | Tuple[str, ...] = Field(
        False,
        description="Fill holes in segments. Can be boolean or a list of channel names.",
    )
    device: bool | Literal["auto"] = Field(
        "auto",
        description=(
            "Measure channel segments on the model's device. With "
            "tiling.device_blend (the default) measurement is fused into "
            "the blend — the canvases are already on the device, so 'auto' "
            "and true both use it. Without device_blend, masks are "
            "re-uploaded (BatchedSegmentMeasure): 'auto' does so when the "
            "model runs on the card and measures on the host when it runs "
            "on the CPU. false always keeps the reference's host path. "
            "Ignored when draw is true."
        ),
    )


class PolyTaxoConfig(BaseModel):
    poly_taxonomy_fn: str = Field(description="PolyTaxonomy filename (YAML).")
    ecotaxa_taxonomy_fn: str = Field(description="EcoTaxa project taxonomy filename (CSV).")
    compatible_predictions_only: bool = Field(
        True,
        description="Update validated object_annotation_category with compatible predictions. "
        "Incompatible predictions will not be added, even if they obtain higher scores.\n"
        "If false, the prediction only depends on the model output.",
    )
    skip_unchanged_objects: bool = Field(
        True,
        description="Save only objects with updated annotations and skip unchanged objects.",
    )
    filter_validated: Optional[str] = Field(
        None,
        description="Filter expression to apply to validated objects.\n"
        "Objects not matching this filter are skipped.",
    )
    save_raw_descriptions: bool = Field(
        False, description="Save raw description as meta-data."
    )
    strip_metadata: bool = Field(
        True, description="Strip metadata unrelated to annotation."
    )
    threshold: float = Field(
        0.9,
        description="Absolute threshold to apply to prediction scores. "
        "Any accepted prediction must obtain a higher score than `threshold`. "
        "If a score is below 1-threshold, a negative descriptor will be added.",
    )
    threshold_relative: float = Field(
        0.0,
        description="Relative threshold: any accepted prediction must beat the "
        "next-best prediction's score by this margin.",
    )
    taxonomy_augmentation_rules: Optional[Dict[str, str]] = Field(
        None,
        description="Augmentation rules applied to previously validated annotations "
        "(`<query>: <update>` pairs).",
    )
    prediction_constraint_rules: Optional[Dict[str, str]] = Field(
        None,
        description="Constraint rules applied to predicted annotations "
        "(`<query>: <update>` pairs).",
    )


class PredictionPipelineConfig(BaseModel):
    model_config = ConfigDict(protected_namespaces=())

    input: EcoTaxaInputConfig = Field(description="Configuration of the input.")
    model: ModelConfig = Field(description="Configuration of the model.")

    save_raw_h5: bool = Field(
        False,
        description="Save raw predictions into an HDF5 file, e.g. for feature extraction.",
    )
    raw_h5_dtype: Literal["float32", "float16", "uint8"] = Field(
        "float16",
        description="Storage dtype for save_raw_h5. The float16 default "
        "halves the device fetch, the DEFLATE payload, and the file "
        "(prediction probabilities lose <1e-3 absolute precision); the "
        "chosen dtype is recorded as the `raw_dtype` root attribute of "
        "the HDF5 file. Set float32 to store the model output verbatim. "
        "uint8 (tiled models only) quantizes probabilities to 1/255 "
        "resolution on the device — stored value = round(p * 255), half "
        "rounded down so stored >= 128 means strictly p > 0.5 — for "
        "another 2x off the fetch and the file; for non-tiled feature "
        "export it falls back to float16 with a warning.",
    )
    segmentation: SegmentationConfig | Literal[False] = Field(
        False,
        description="Measure predicted segments and store into EcoTaxa archive. "
        "(Only applies for semantic segmentation.)",
    )
    polytaxo: PolyTaxoConfig | Literal[False] = Field(
        False,
        description="Predict object properties using a PolyTaxo classifier and "
        "store into an EcoTaxa archive.",
    )

    target_dir: str = Field(description="Directory where the output files are created.")

    parallel: ParallelConfig | Literal[False] = Field(
        False,
        description="Multi-chip execution: shard device batches over a mesh "
        "of all (or explicitly configured) accelerator devices.",
    )

    log_interval: str | float = Field(
        "60s", description="The interval at which progress is logged, e.g. 10s or 1m."
    )
