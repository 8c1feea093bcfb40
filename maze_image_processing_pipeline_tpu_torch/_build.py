"""Build and load the package's hand-written CUDA kernels.

Every ``*.cu`` file under ``csrc/`` is compiled by ``nvcc`` for Hopper
(``sm_90a``) into a shared library of its own with a plain C interface,
loaded with :mod:`ctypes`. The ``nvcc`` processes of all sources start
together, so the build takes as long as the slowest source. Each library
goes into ``build/`` beside this file, named by the source's stem and a
hash of the source, the headers and the flags, so an edited source is
rebuilt and an unchanged one is loaded as it is. Nothing is compiled at
import time: the first :func:`kernels` call builds. A failed build raises.
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
from types import SimpleNamespace
from typing import List

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

_vp, _ll, _i, _u, _f = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_uint, ctypes.c_float
# The C entry points: argument types (every pointer and the stream as
# c_void_p, or ctypes would cut them to 32 bits); each returns a CUDA error
# code as int.
SIGNATURES = {
    "hpass_launch": [_vp, _vp, _vp, _ll, _i, _vp],
    "hpass_wide_launch": [_vp, _vp, _vp, _vp, _ll, _i, _vp],
    "cumsum_rows_launch": [_vp, _vp, _ll, _i, _vp],
    "vertical_pass_launch": [_vp, _vp, _vp, _i, _i, _i, _i, _i, _vp],
    "vertical_pass_banded_launch": [_vp, _vp, _vp, _vp, _i, _i, _i, _i, _i, _u, _vp],
    "ccl_fixpoint_launch": [_vp, _vp, _vp, _i, _i, _i, _i, _i, _vp],
    "ccl_fixpoint_banded_launch": [_vp, _vp, _vp, _vp, _i, _i, _i, _i, _i, _i, _u, _vp],
    "ccl_grid_launch": [_vp] * 5 + [_i] * 7 + [_vp],
    "remove_small_objects_launch": [_vp, _vp, _vp, _i, _ll, _i, _i, _i, _ll, _ll, _vp],
    "remove_small_objects_global_launch": [_vp, _vp, _vp, _vp, _i, _ll, _i, _i, _vp],
    "relabel_capacity": [_vp],
    "group_norm_capacity": [_i, _i, _i, _i, _vp],
    "group_norm_launch": [_vp] * 7 + [_i, _i, _i, _ll, _i, _i, _i, _i, _i, _i, _i, _f, _vp],
    "group_norm_bwd_launch": [_vp] * 9 + [_i, _i, _i, _ll, _i, _i, _i, _i, _i, _i, _i, _i, _vp],
    "group_norm_shard_capacity": [_i, _i, _i, _i, _i, _vp],
    "group_norm_partials_launch": [_vp] * 4 + [_i, _i, _i, _ll] + [_i] * 6 + [_vp],
    "group_norm_apply_launch": [_vp] * 5 + [_i, _i, _i, _ll] + [_i] * 6 + [_vp],
    "group_norm_bwd_partials_launch": [_vp] * 6 + [_i, _i, _i, _ll] + [_i] * 7 + [_vp],
    "group_norm_bwd_apply_launch": [_vp] * 6 + [_i, _i, _i, _ll] + [_i] * 7 + [_vp],
    "region_measure_launch": [_vp] * 8 + [_ll, _i, _i, _i, _i, _i, _vp],
    "anchor_launch": [_vp, _vp, _ll, _ll, _ll, _ll, _ll, _ll, _i, _i, _vp],
}

_lock = threading.Lock()
_lib = None


def _nvcc() -> str:
    """nvcc from $CUDA_HOME, else PATH, else the toolkit's default prefix."""
    home = os.environ.get("CUDA_HOME")
    for cand in (home and Path(home) / "bin" / "nvcc", shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and Path(cand).exists():
            return str(cand)
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _library(src: Path) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in [src, *sorted(CSRC.glob("*.cuh"))]:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_DIR / f"lib{src.stem}_{h.hexdigest()[:16]}.so"


def build(verbose: bool = False) -> List[Path]:
    """Compile each ``csrc/*.cu`` into its cached library, all sources in
    parallel; returns the libraries' paths. ``verbose`` prints ptxas'
    register and shared-memory report."""
    srcs = sorted(CSRC.glob("*.cu"))
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = []
    for src in srcs:
        out = _library(src)
        if out.exists():
            continue
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        flags = NVCC_FLAGS + (["-Xptxas", "-v"] if verbose else [])
        cmd = [_nvcc(), *flags, "-o", tmp, str(src)]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        jobs.append((out, tmp, cmd, proc))
    failures = []
    for out, tmp, cmd, proc in jobs:
        _, stderr = proc.communicate()
        if proc.returncode != 0:
            os.unlink(tmp)
            failures.append(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{stderr}")
            continue
        if verbose:
            print(stderr, end="")
        os.replace(tmp, out)  # atomic: a concurrent loader never sees half a file
    if failures:
        raise RuntimeError("\n".join(failures))
    return [_library(src) for src in srcs]


def kernels() -> SimpleNamespace:
    """The C entry points of all kernel libraries (built at first use), by
    name, with their argument types set."""
    global _lib
    with _lock:
        if _lib is None:
            fns = {}
            for path in build():
                lib = ctypes.CDLL(str(path))
                for name, argtypes in SIGNATURES.items():
                    fn = getattr(lib, name, None)
                    if fn is not None:
                        fn.argtypes = argtypes
                        fn.restype = ctypes.c_int
                        fns[name] = fn
            missing = sorted(set(SIGNATURES) - set(fns))
            if missing:
                raise RuntimeError(f"kernel entry points missing from the built libraries: {missing}")
            _lib = SimpleNamespace(**fns)
        return _lib
