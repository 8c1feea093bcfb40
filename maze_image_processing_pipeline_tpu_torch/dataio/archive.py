"""Uniform path access over directories and zip archives.

Capability parity with ``omni_archive.Archive`` / ``pathlib_abc`` as used by
the reference (``loki/pipeline.py:56-57,791-804,835-840``): an
:class:`Archive` wraps either a filesystem directory or a ``.zip`` file and
exposes :class:`ArchivePath` objects supporting ``/``, ``glob``, ``open``,
``iterdir``, ``exists`` — so sample discovery and readers are agnostic to
whether a LOKI dump arrives zipped.

Copy of ``maze_image_processing_pipeline_tpu/dataio/archive.py`` for the PyTorch port,
which imports nothing of the JAX package; only imports differ.
``tests/test_torch_host_copies.py`` holds the two equal.
"""

from __future__ import annotations

import fnmatch
import io
import os
import zipfile
from pathlib import PurePosixPath
from typing import IO, Iterator, List, Optional, Union

__all__ = ["Archive", "ArchivePath"]


class Archive:
    """A directory or zip file presenting a uniform path interface."""

    def __init__(self, path: Union[str, os.PathLike], mode: str = "r") -> None:
        self.path = os.fspath(path)
        self.mode = mode
        self._zip: Optional[zipfile.ZipFile] = None
        self._names: Optional[List[str]] = None

        if os.path.isdir(self.path) or (mode == "w" and not self.path.endswith(".zip")):
            self.is_zip = False
        elif self.path.endswith(".zip"):
            self.is_zip = True
        elif os.path.exists(self.path):
            self.is_zip = zipfile.is_zipfile(self.path)
        else:
            raise FileNotFoundError(self.path)

    # -- zip plumbing ------------------------------------------------------

    def _ensure_zip(self) -> zipfile.ZipFile:
        if self._zip is None:
            zmode = {"r": "r", "w": "w", "a": "a"}[self.mode]
            compression = zipfile.ZIP_STORED if zmode == "r" else zipfile.ZIP_DEFLATED
            self._zip = zipfile.ZipFile(self.path, zmode, compression=compression)
            self._names = None
        return self._zip

    def _namelist(self) -> List[str]:
        if self._names is None:
            self._names = self._ensure_zip().namelist()
        return self._names

    def close(self) -> None:
        if self._zip is not None:
            self._zip.close()
            self._zip = None
            self._names = None

    def __enter__(self) -> "Archive":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- path interface ----------------------------------------------------

    @property
    def root(self) -> "ArchivePath":
        return ArchivePath(self, "")

    def __truediv__(self, name: str) -> "ArchivePath":
        return self.root / name

    def glob(self, pattern: str) -> List["ArchivePath"]:
        return self.root.glob(pattern)

    def iterdir(self) -> Iterator["ArchivePath"]:
        return self.root.iterdir()

    @property
    def name(self) -> str:
        return os.path.basename(self.path.rstrip("/"))

    @property
    def stem(self) -> str:
        name = self.name
        return name[:-4] if name.endswith(".zip") else name

    def __repr__(self) -> str:
        return f"Archive({self.path!r})"

    def __str__(self) -> str:
        return self.path

    def __fspath__(self) -> str:
        return self.path


class ArchivePath:
    """A path inside an :class:`Archive` (file or directory member)."""

    def __init__(self, archive: Archive, rel: str) -> None:
        self.archive = archive
        self.rel = rel.strip("/")

    # -- pure path behavior ------------------------------------------------

    def __truediv__(self, name: str) -> "ArchivePath":
        rel = f"{self.rel}/{name}" if self.rel else str(name)
        return ArchivePath(self.archive, rel)

    @property
    def name(self) -> str:
        return PurePosixPath(self.rel or self.archive.name).name

    @property
    def stem(self) -> str:
        return PurePosixPath(self.rel or self.archive.name).stem

    @property
    def suffix(self) -> str:
        return PurePosixPath(self.rel).suffix

    @property
    def parent(self) -> "ArchivePath":
        parent_rel = str(PurePosixPath(self.rel).parent)
        return ArchivePath(self.archive, "" if parent_rel == "." else parent_rel)

    def __repr__(self) -> str:
        return f"ArchivePath({self.archive.path!r}, {self.rel!r})"

    def __str__(self) -> str:
        if self.archive.is_zip:
            return f"{self.archive.path}/{self.rel}"
        return os.path.join(self.archive.path, self.rel) if self.rel else self.archive.path

    def __lt__(self, other: "ArchivePath") -> bool:
        return str(self) < str(other)

    def __eq__(self, other) -> bool:
        return (
            isinstance(other, ArchivePath)
            and self.archive is other.archive
            and self.rel == other.rel
        )

    def __hash__(self) -> int:
        return hash((id(self.archive), self.rel))

    # -- filesystem-ish behavior -------------------------------------------

    @property
    def _fs_path(self) -> str:
        return os.path.join(self.archive.path, self.rel) if self.rel else self.archive.path

    def exists(self) -> bool:
        if not self.archive.is_zip:
            return os.path.exists(self._fs_path)
        prefix = self.rel + "/"
        for n in self.archive._namelist():
            if n == self.rel or n.startswith(prefix):
                return True
        return False

    def is_dir(self) -> bool:
        if not self.archive.is_zip:
            return os.path.isdir(self._fs_path)
        prefix = self.rel + "/" if self.rel else ""
        return any(n.startswith(prefix) and n != self.rel for n in self.archive._namelist())

    def iterdir(self) -> Iterator["ArchivePath"]:
        if not self.archive.is_zip:
            for entry in sorted(os.listdir(self._fs_path)):
                yield self / entry
            return
        prefix = self.rel + "/" if self.rel else ""
        seen = set()
        for n in self.archive._namelist():
            if not n.startswith(prefix):
                continue
            rest = n[len(prefix) :].strip("/")
            if not rest:
                continue
            first = rest.split("/", 1)[0]
            if first not in seen:
                seen.add(first)
                yield self / first

    def glob(self, pattern: str) -> List["ArchivePath"]:
        """Glob relative to this path; supports '*' within path segments."""
        parts = pattern.split("/")

        def expand(paths: List["ArchivePath"], part: str) -> List["ArchivePath"]:
            out: List[ArchivePath] = []
            for p in paths:
                if any(ch in part for ch in "*?["):
                    for child in p.iterdir():
                        if fnmatch.fnmatch(child.name, part):
                            out.append(child)
                else:
                    child = p / part
                    if child.exists():
                        out.append(child)
            return out

        result = [self]
        for part in parts:
            result = expand(result, part)
        return sorted(result)

    def open(self, mode: str = "rb") -> IO:
        if not self.archive.is_zip:
            if "w" in mode or "a" in mode:
                os.makedirs(os.path.dirname(self._fs_path), exist_ok=True)
            return open(self._fs_path, mode)
        zf = self.archive._ensure_zip()
        if "w" in mode:
            return zf.open(self.rel, "w")
        raw = zf.open(self.rel, "r")
        if "b" in mode:
            return raw
        return io.TextIOWrapper(raw)

    def read_bytes(self) -> bytes:
        with self.open("rb") as f:
            return f.read()

    def read_text(self, encoding: str = "utf-8") -> str:
        return self.read_bytes().decode(encoding)

    # Members that are already compressed: deflating them again wastes the
    # (single) host core for ~0 size win.
    _STORED_SUFFIXES = (".png", ".jpg", ".jpeg", ".zip", ".gz")

    def write_bytes(self, data: bytes) -> None:
        if self.archive.is_zip and self.rel.lower().endswith(
            self._STORED_SUFFIXES
        ):
            zf = self.archive._ensure_zip()
            zf.writestr(self.rel, data, compress_type=zipfile.ZIP_STORED)
            return
        with self.open("wb") as f:
            f.write(data)
