"""Host-side I/O: archives, EcoTaxa TSV, HDF5, images, LOKI data, telemetry.

This layer replaces the reference's external I/O dependencies
(``omni_archive``, ``pyecotaxa``, ``lokidata``, ``morphocut.contrib.ecotaxa``,
``morphocut.hdf5`` — SURVEY.md §2b) with in-repo implementations. Everything
here is host code backed by native-accelerated libraries (zipfile, pandas,
cv2/PIL); the engine overlaps it with device work via stream buffers.

The port's copy of ``maze_image_processing_pipeline_tpu/dataio/``: the
modules are copies of their originals (each names its file), apart from
``hdf5``, whose writer builds the file itself (h5py is not on the card's
machine).
"""

from .archive import Archive, ArchivePath
from .ecotaxa import (
    VALID_PREFIXES,
    EcotaxaObject,
    EcotaxaReader,
    EcotaxaWriter,
    read_tsv,
    write_tsv,
)
from .hdf5 import HDF5Writer
from .imageio import ImageReader, decode_image, encode_image
from .loki import LOG_FIELDS_TO_ECOTAXA, find_data_roots, read_dat, read_log, read_tmd, read_yaml
from .telemetry import Telemetry

__all__ = [
    "Archive",
    "ArchivePath",
    "read_tsv",
    "write_tsv",
    "VALID_PREFIXES",
    "EcotaxaObject",
    "EcotaxaReader",
    "EcotaxaWriter",
    "HDF5Writer",
    "ImageReader",
    "decode_image",
    "encode_image",
    "read_log",
    "read_yaml",
    "read_tmd",
    "read_dat",
    "find_data_roots",
    "LOG_FIELDS_TO_ECOTAXA",
    "Telemetry",
]
