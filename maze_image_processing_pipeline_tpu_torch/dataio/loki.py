"""LOKI underwater-camera data readers and sample discovery.

Capability parity with the external ``lokidata`` package as exercised by the
reference (``loki/pipeline.py:111-198,802``): ``read_log`` / ``read_yaml`` /
``read_tmd`` / ``read_dat`` / ``find_data_roots`` plus the
``LOG_FIELDS_TO_ECOTAXA`` remap.

File formats (documented here, since they are only implicit in the
reference's external dependency):

* ``Log/LOKI*.log`` — text, one ``KEY: VALUE`` (or ``KEY=VALUE`` /
  ``KEY<TAB>VALUE``) pair per line. Keys are upper-case LOKI device fields.
* ``meta.yaml`` — free-form YAML mapping merged into the sample metadata.
* ``Telemetrie/YYYYMMDD HHMMSS.tmd`` — text telemetry snapshot, one
  ``KEY;VALUE`` (or ``KEY=VALUE``) pair per line; values parsed as float
  when possible. ``.dat`` files carry the same content in the older format
  (``KEY=VALUE`` pairs separated by ``;`` on one or more lines).
* A *sample root* (one LOKI haul dump, e.g. ``LOKI_00001.01``) is any
  directory containing both ``Pictures/`` and ``Telemetrie/`` folders
  (cf. ``docs/loki.rst:20-22`` of the reference).

Copy of ``maze_image_processing_pipeline_tpu/dataio/loki.py`` for the PyTorch port,
which imports nothing of the JAX package; only imports differ.
``tests/test_torch_host_copies.py`` holds the two equal.
"""

from __future__ import annotations

import logging
import re
from typing import Dict, Iterable, Iterator, List, Optional, Union

import yaml

from .archive import Archive, ArchivePath

logger = logging.getLogger(__name__)

__all__ = [
    "LOG_FIELDS_TO_ECOTAXA",
    "read_log",
    "read_yaml",
    "read_tmd",
    "read_dat",
    "find_data_roots",
]

#: LOKI log field → EcoTaxa metadata column. Covers the required sample
#: fields validated by the loki workload (REQUIRED_SAMPLE_META,
#: ``loki/pipeline.py:299-309``).
LOG_FIELDS_TO_ECOTAXA: Dict[str, str] = {
    "DEVICE": "acq_instrument",
    "INSTRUMENT": "acq_instrument",
    "LOKI": "acq_instrument_id",
    "CRUISE": "sample_cruise",
    "VESSEL": "sample_vessel",
    "SHIP": "sample_vessel",
    "STATION": "sample_station",
    "HAUL": "sample_haul",
    "CAST": "sample_haul",
    "REGION": "sample_region",
    "LOCATION": "sample_detail_location",
    "DETAIL_LOCATION": "sample_detail_location",
    "GPS_LAT": "sample_latitude",
    "LATITUDE": "sample_latitude",
    "GPS_LON": "sample_longitude",
    "LONGITUDE": "sample_longitude",
    "BOTTOM_DEPTH": "sample_bottomdepth",
    "WATER_DEPTH": "sample_bottomdepth",
    "OPERATOR": "sample_operator",
    "DATE": "sample_date",
    "TIME": "sample_time",
}

_KV_SPLIT = re.compile(r"\s*[:=;\t]\s*")


def _parse_value(raw: str):
    raw = raw.strip()
    try:
        f = float(raw)
        return int(f) if f.is_integer() and "." not in raw and "e" not in raw.lower() else f
    except ValueError:
        return raw


def _read_kv_text(text: str) -> Dict[str, object]:
    """Parse KEY:VALUE / KEY=VALUE / KEY;VALUE lines (and ;-joined pairs)."""
    out: Dict[str, object] = {}
    for line in text.splitlines():
        # Strip trailing pair separators first: a single ";"-terminated
        # pair ("TEMP=5.3;") must not keep the ";" in its value, which
        # would silently store the float as a string.
        line = line.strip().rstrip(";").strip()
        if not line or line.startswith("#"):
            continue
        # Multiple pairs on one line (old .dat style): A=1;B=2
        if "=" in line and ";" in line and line.count("=") > 1:
            for pair in line.split(";"):
                if "=" in pair:
                    k, v = pair.split("=", 1)
                    out[k.strip()] = _parse_value(v)
            continue
        parts = _KV_SPLIT.split(line, maxsplit=1)
        if len(parts) == 2:
            out[parts[0].strip()] = _parse_value(parts[1])
    return out


def _read_text(path: Union[str, ArchivePath]) -> str:
    if isinstance(path, ArchivePath):
        return path.read_text()
    with open(path, "r", errors="replace") as f:
        return f.read()


def read_log(
    path: Union[str, ArchivePath], remap_fields: Optional[Dict[str, str]] = None
) -> Dict[str, object]:
    """Read a LOKI device log; optionally remap fields to EcoTaxa names."""
    raw = _read_kv_text(_read_text(path))
    if remap_fields is None:
        return raw
    return {remap_fields[k]: v for k, v in raw.items() if k in remap_fields}


def read_yaml(path: Union[str, ArchivePath]) -> Dict[str, object]:
    """Read a ``meta.yaml`` sidecar; missing file → empty dict."""
    try:
        text = _read_text(path)
    except (FileNotFoundError, KeyError):
        return {}
    data = yaml.safe_load(text)
    if data is None:
        return {}
    if not isinstance(data, dict):
        raise ValueError(f"Expected a mapping in {path}, got {type(data).__name__}")
    return data


def read_tmd(path: Union[str, ArchivePath]) -> Dict[str, object]:
    """Read a ``.tmd`` telemetry snapshot into a field dict."""
    return _read_kv_text(_read_text(path))


def read_dat(path: Union[str, ArchivePath]) -> Dict[str, object]:
    """Read an old-style ``.dat`` telemetry snapshot into a field dict."""
    return _read_kv_text(_read_text(path))


def find_data_roots(
    root: Union[str, Archive, ArchivePath],
    ignore_patterns: Optional[Iterable[str]] = None,
    max_depth: int = 6,
) -> Iterator[ArchivePath]:
    """Discover LOKI sample roots: directories with Pictures + Telemetrie."""
    import fnmatch

    if isinstance(root, str):
        root = Archive(root)
    if isinstance(root, Archive):
        root = root.root

    ignore = list(ignore_patterns or [])

    def walk(path: ArchivePath, depth: int) -> Iterator[ArchivePath]:
        if ignore and any(fnmatch.fnmatch(str(path), pat) for pat in ignore):
            logger.info("Ignoring %s", path)
            return
        if (path / "Pictures").is_dir() and (path / "Telemetrie").is_dir():
            yield path
            return
        if depth >= max_depth:
            return
        try:
            children: List[ArchivePath] = [c for c in path.iterdir() if c.is_dir()]
        except (NotADirectoryError, FileNotFoundError):
            return
        for child in children:
            yield from walk(child, depth + 1)

    yield from walk(root, 0)
