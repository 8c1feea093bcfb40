"""Build and load the package's hand-written CUDA kernels.

Every ``*.cu`` file under ``csrc/`` is compiled by ``nvcc`` for Hopper
(``sm_90a``) into ONE shared library with a plain C interface, loaded with
:mod:`ctypes`. The library goes into ``build/`` beside this file, named by a
hash of the sources and flags, so an edited source is rebuilt and an
unchanged one is loaded as it is. Nothing is compiled at import time: the
first :func:`kernels` call builds. A failed build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

__all__ = ["kernels", "build", "NVCC_FLAGS"]

_PKG = Path(__file__).resolve().parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "build"

NVCC_FLAGS = [
    "-gencode",
    "arch=compute_90a,code=sm_90a",
    "-std=c++17",
    "-O3",
    "-shared",
    "-Xcompiler",
    "-fPIC",
]

_lock = threading.Lock()
_lib = None


def _nvcc() -> str:
    """nvcc from $CUDA_HOME, else PATH, else the toolkit's default prefix."""
    home = os.environ.get("CUDA_HOME")
    for cand in (home and Path(home) / "bin" / "nvcc", shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and Path(cand).exists():
            return str(cand)
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def build(verbose: bool = False) -> Path:
    """Compile ``csrc/*.cu`` into the cached library; returns its path.
    ``verbose`` prints ptxas' register and shared-memory report."""
    srcs = sorted(CSRC.glob("*.cu"))
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    out = BUILD_DIR / f"libmaze_kernels_{h.hexdigest()[:16]}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    flags = NVCC_FLAGS + (["-Xptxas", "-v"] if verbose else [])
    cmd = [_nvcc(), *flags, "-o", tmp, *map(str, srcs)]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(
            f"nvcc failed ({res.returncode}):\n{' '.join(cmd)}\n{res.stderr}"
        )
    if verbose:
        print(res.stderr, end="")
    os.replace(tmp, out)  # atomic: a concurrent loader never sees half a file
    return out


def kernels() -> ctypes.CDLL:
    """The loaded kernel library (built at first use)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            vp, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
            lib.hpass_launch.argtypes = [vp, vp, vp, ll, i, vp]
            lib.hpass_launch.restype = i
            lib.cumsum_rows_launch.argtypes = [vp, vp, ll, i, vp]
            lib.cumsum_rows_launch.restype = i
            _lib = lib
        return _lib
