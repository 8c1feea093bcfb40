"""Device-side pre- and post-processing around the model forward.

Counterpart of ``default_device_pre`` / ``sigmoid_post`` in
``maze_image_processing_pipeline_tpu/models/inference.py``.
"""

from __future__ import annotations

import torch

__all__ = ["default_device_pre", "sigmoid_post"]

_UNSIGNED = (torch.uint8, torch.uint16, torch.uint32, torch.uint64)


def default_device_pre(x: torch.Tensor) -> torch.Tensor:
    """(B, H, W[, C]) → (B, H, W, 3); unsigned integers scale by 1/max
    into [0, 1] float32, floats pass through."""
    if x.dim() == 3:
        x = x[..., None]
    if x.shape[-1] == 1:
        x = x.expand(*x.shape[:-1], 3)
    if x.dtype in _UNSIGNED:
        x = x.to(torch.float32) / float(torch.iinfo(x.dtype).max)
    return x


def sigmoid_post(y: torch.Tensor) -> torch.Tensor:
    """Logits → probabilities."""
    return torch.sigmoid(y)
