"""LOKI object/sample metadata: IDs, validation, frame-id recovery.

Capability parity with the reference's metadata plumbing
(``loki/pipeline.py:299-359,1081-1104``): the LOKI object-ID format
``{date} {time}  {ms}  {seq:06d} {posx:04d} {posy:04d}``, frame IDs, the
required-sample-fields validation, and derived sample/acq/process IDs.

Copy of ``maze_image_processing_pipeline_tpu/loki/meta.py`` for the PyTorch port,
which imports nothing of the JAX package; only imports differ.
``tests/test_torch_host_copies.py`` holds the two equal.
"""

from __future__ import annotations

import datetime
from typing import Dict

import pandas as pd

from ..common import FormatParser

__all__ = [
    "OBJECT_ID_FMT",
    "OBJECT_FRAME_ID_FMT",
    "REQUIRED_SAMPLE_META",
    "MissingMetaError",
    "parse_object_id",
    "format_object_id",
    "update_and_validate_sample_meta",
    "ensure_object_frame_id",
]

OBJECT_ID_FMT = (
    "{object_date} {object_time}  {object_milliseconds}"
    "  {object_sequence:06d} {object_posx:04d} {object_posy:04d}"
)
OBJECT_FRAME_ID_FMT = "{object_date} {object_time}  {object_milliseconds}"

_object_id_parser = FormatParser(OBJECT_ID_FMT)

REQUIRED_SAMPLE_META = [
    "sample_bottomdepth",
    "sample_region",
    "sample_detail_location",
    "sample_vessel",
    "sample_latitude",
    "sample_longitude",
    "sample_station",
    "sample_haul",
    "acq_instrument",
]


class MissingMetaError(Exception):
    pass


def parse_object_id(object_id: str, meta: Dict) -> Dict:
    """Parse a LOKI object ID into metadata fields (+ object_frame_id)."""
    result = _object_id_parser.parse(object_id)
    if result is None:
        raise ValueError(f"Can not parse object ID: {object_id}")

    object_frame_id = OBJECT_FRAME_ID_FMT.format_map(result.named)
    return {
        **meta,
        "object_id": object_id,
        "object_frame_id": object_frame_id,
        **result.named,
    }


def format_object_id(meta: Dict) -> str:
    return OBJECT_ID_FMT.format_map(meta)


def update_and_validate_sample_meta(data_root, meta: Dict) -> Dict:
    """Require the sample fields; derive sample_id / acq_id / process_id."""
    missing = set(REQUIRED_SAMPLE_META) - set(meta.keys())
    if missing:
        missing_str = ", ".join(sorted(missing))
        raise MissingMetaError(
            f"The following fields are missing: {missing_str}.\n"
            f"Supply them in {data_root}/meta.yaml"
        )

    meta = dict(meta)
    meta["sample_id"] = "{sample_station}_{sample_haul}".format_map(meta)
    meta["acq_id"] = "{acq_instrument}_{sample_id}".format_map(meta)
    meta["process_datetime"] = datetime.datetime.now().isoformat(timespec="seconds")
    meta["process_id"] = "{acq_id}_{process_datetime}".format_map(meta)
    return meta


def ensure_object_frame_id(data: "pd.DataFrame") -> "pd.DataFrame":
    """Add object_frame_id to a DataFrame, deriving it from object_id if needed."""
    if "object_frame_id" in data.columns:
        return data
    if "object_id" not in data.columns:
        raise ValueError("object_frame_id and object_id are both missing.")

    def extract(object_id: str) -> str:
        result = _object_id_parser.parse(str(object_id))
        if result is None:
            raise ValueError(
                f"object_id {object_id!r} does not match pattern {OBJECT_ID_FMT!r}"
            )
        return OBJECT_FRAME_ID_FMT.format_map(result.named)

    data = data.copy()
    data["object_frame_id"] = data["object_id"].map(extract)
    return data
