"""Version resolution (versioneer-style capability, minimal implementation).

Resolves the package version from ``git describe`` when running from a
checkout (so outputs record the exact commit, cf. the reference recording
``process_loki_pipeline_version`` into every row), falling back to the
static release version.

Copy of ``maze_image_processing_pipeline_tpu/_version.py`` for the PyTorch port,
which imports nothing of the JAX package; only imports differ.
``tests/test_torch_host_copies.py`` holds the two equal.
"""

from __future__ import annotations

import os
import subprocess

_STATIC_VERSION = "0.1.0"


def get_version() -> str:
    here = os.path.dirname(os.path.abspath(__file__))
    try:
        out = subprocess.run(
            ["git", "describe", "--tags", "--always", "--dirty"],
            cwd=here,
            capture_output=True,
            text=True,
            timeout=5,
        )
        if out.returncode == 0 and out.stdout.strip():
            described = out.stdout.strip()
            return f"{_STATIC_VERSION}+{described}"
    except (OSError, subprocess.SubprocessError):
        pass
    return _STATIC_VERSION
