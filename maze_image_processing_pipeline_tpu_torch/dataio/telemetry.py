"""Telemetry store with nearest-time join.

Capability parity with the reference's ``Telemetry`` class
(``loki/pipeline.py:201-296``): all ``.tmd`` (and, where no ``.tmd`` of the
same timestamp exists, ``.dat``) files under ``Telemetrie/`` are read into a
time-indexed DataFrame; per-object metadata is then joined to the nearest
telemetry timestamp within an optional tolerance, warning once per missing
timestamp.

Copy of ``maze_image_processing_pipeline_tpu/dataio/telemetry.py`` for the PyTorch port,
which imports nothing of the JAX package; only imports differ.
``tests/test_torch_host_copies.py`` holds the two equal.
"""

from __future__ import annotations

import datetime
import logging
import pathlib
from typing import Dict, Optional, Union

import pandas as pd

from ..common import FormatParser
from .archive import Archive, ArchivePath
from .loki import read_dat, read_tmd

logger = logging.getLogger(__name__)

__all__ = ["Telemetry", "parse_telemetry_fn", "TMD2META"]

#: Telemetry field → EcoTaxa metadata column (``loki/pipeline.py:130-159``).
TMD2META = {
    "object_lon": "GPS_LON",
    "object_lat": "GPS_LAT",
    "object_pressure": "PRESS",
    "object_temperature": "TEMP",
    "object_oxygen_concentration": "OXY_CON",
    "object_oxygen_saturation": "OXY_SAT",
    "object_temperature_oxsens": "OXY_TEMP",
    "object_conductivity": "COND_COND",
    "object_salinity": "COND_SALY",
}

_fn_parser = FormatParser("{:04d}{:02d}{:02d} {:02d}{:02d}{:02d}")


def parse_telemetry_fn(name: str) -> datetime.datetime:
    """Extract the timestamp from a telemetry filename (YYYYMMDD HHMMSS)."""
    r = _fn_parser.search(str(name))
    if r is None:
        raise ValueError(f"Could not parse telemetry filename: {name}")
    return datetime.datetime(*r.fixed)


class Telemetry:
    """All telemetry of one sample root, joinable by nearest timestamp."""

    def __init__(
        self,
        data_root: Union[str, Archive, ArchivePath],
        ignore_errors: bool = False,
        tolerance: Union[None, str, pd.Timedelta] = None,
    ) -> None:
        self.telemetry = self._read_all(data_root, ignore_errors)

        median_dt = pd.Series(self.telemetry.index).diff().median()
        logger.info(
            "Read telemetry for %s. Median time delta is %s.", data_root, median_dt
        )

        if isinstance(tolerance, str):
            tolerance = pd.Timedelta(tolerance)
        self.tolerance = tolerance
        self._not_found = set()
        # Nearest-join fast path: the sorted index as int64 ns + one dict
        # per row, computed once. A haul has ~20 objects per frame all
        # sharing the frame's timestamp, so joins are also memoized per
        # distinct timestamp (measured ~2 ms per pandas get_indexer +
        # .iloc[].to_dict() call -> ~0.9 s of a 6.5 s steady loki stage).
        if not self.telemetry.empty:
            self._times_ns = self.telemetry.index.values.astype(
                "datetime64[ns]"
            ).astype("int64")
            self._records = self.telemetry.to_dict("records")
        else:
            self._times_ns = None
            self._records = []
        self._join_cache: Dict[datetime.datetime, Optional[Dict]] = {}

    @staticmethod
    def _read_all(
        data_root: Union[str, Archive, ArchivePath], ignore_errors: bool
    ) -> pd.DataFrame:
        if isinstance(data_root, str):
            data_root = Archive(data_root)
        if isinstance(data_root, Archive):
            data_root = data_root.root

        telemetry_path = data_root / "Telemetrie"

        def read_one(fn: ArchivePath, reader):
            try:
                dt = parse_telemetry_fn(fn.name)
                raw = reader(fn)
            except Exception:
                logger.error("Error reading %s", fn, exc_info=True)
                if not ignore_errors:
                    raise
                return None
            return dt, {
                et: raw[loki] for et, loki in TMD2META.items() if loki in raw
            }

        tmd_fns = telemetry_path.glob("*.tmd") if telemetry_path.exists() else []
        rows: Dict[datetime.datetime, Dict] = {}
        tmd_stems = set()
        for fn in tmd_fns:
            item = read_one(fn, read_tmd)
            if item:
                rows[item[0]] = item[1]
                tmd_stems.add(fn.stem)
        logger.info("Found %d *.tmd files", len(tmd_stems))

        dat_fns = telemetry_path.glob("*.dat") if telemetry_path.exists() else []
        n_dat = 0
        for fn in dat_fns:
            if fn.stem in tmd_stems:
                continue
            item = read_one(fn, read_dat)
            if item and item[0] not in rows:
                rows[item[0]] = item[1]
                n_dat += 1
        logger.info("Used %d *.dat files", n_dat)

        if not rows:
            msg = f"{telemetry_path} contains no readable telemetry files"
            if ignore_errors:
                logger.error(msg)
            else:
                raise ValueError(msg)

        df = pd.DataFrame.from_dict(rows, orient="index")
        df.index = pd.DatetimeIndex(df.index)
        return df.sort_index()

    def merge_telemetry(self, meta: Dict) -> Dict:
        """Join nearest-in-time telemetry fields into an object's metadata."""
        if self.telemetry.empty:
            return meta

        fn = "{object_date} {object_time}.tmd".format_map(meta)
        dt = parse_telemetry_fn(pathlib.PurePosixPath(fn).name)

        try:
            row = self._join_cache[dt]
        except KeyError:
            row = self._join_cache[dt] = self._nearest_row(dt)

        if row is None:
            if dt not in self._not_found:
                logger.warning("No telemetry found for %s", dt)
                self._not_found.add(dt)
            return meta

        return {**meta, **row}

    def _nearest_row(self, dt: datetime.datetime) -> Optional[Dict]:
        """Nearest index row within tolerance (pandas ``method="nearest"``
        semantics: ties pick the earlier timestamp), or None."""
        import numpy as np

        times = self._times_ns
        t = np.datetime64(dt, "ns").astype("int64")
        pos = int(np.searchsorted(times, t))
        if pos == 0:
            idx = 0
        elif pos == len(times):
            idx = len(times) - 1
        else:
            left_dist = t - times[pos - 1]
            right_dist = times[pos] - t
            idx = pos - 1 if left_dist <= right_dist else pos
        if self.tolerance is not None and abs(
            int(times[idx]) - int(t)
        ) > self.tolerance.value:
            return None
        return self._records[idx]
