"""Host image utilities of the LOKI workload.

:func:`rescale_max_intensity` is a copy of the numpy function of the same
name in ``maze_image_processing_pipeline_tpu/ops/image.py``, whose module
imports jax; ``tests/test_torch_host_copies.py`` holds the two equal.
"""

from __future__ import annotations

import numpy as np

__all__ = ["rescale_max_intensity"]


def rescale_max_intensity(image) -> np.ndarray:
    """Stretch intensities so the max maps to the dtype maximum (host/NumPy).

    Parity: ``rescale_max_intensity`` at ``loki/pipeline.py:382-383`` (which
    stretches ``(0, image.max())`` to the full dtype range).
    """
    image = np.asarray(image)
    maxval = image.max()
    if image.dtype.kind == "u":
        out_max = np.iinfo(image.dtype).max
        if maxval == 0:
            return image.copy()
        scaled = image.astype(np.float32) * (out_max / float(maxval))
        return np.clip(scaled, 0, out_max).astype(image.dtype)
    if maxval == 0:
        return image.copy()
    return (image / maxval).astype(image.dtype)
