"""Marching-squares contour length, shared by the fused region measurement.

Counterpart of ``_marching_squares_length`` in
``maze_image_processing_pipeline_tpu/ops/regionprops.py``: each 2×2 block of
the padded mask contributes the calibrated length of its 0.5-level isoline.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["marching_squares_length"]

# Boundary-segment weights: corner cuts are down-weighted to 0.65 so the
# estimator tracks the length of digitised curved boundaries.
_W_STRAIGHT = 1.0
_W_CUT = 0.65
_W_DOUBLE = 2 * _W_CUT


def marching_squares_length(fg: torch.Tensor) -> torch.Tensor:
    """Per-2×2-block contour length, (..., H+1, W+1) float32."""
    m = F.pad(fg.to(torch.int32), (1, 1, 1, 1))
    a = m[..., :-1, :-1]
    b = m[..., :-1, 1:]
    c = m[..., 1:, :-1]
    d = m[..., 1:, 1:]
    count = a + b + c + d
    diag = (a == d) & (b == c) & (a != b)
    two = torch.where(diag, _W_DOUBLE, _W_STRAIGHT)
    length = torch.where(count == 2, two, 0.0)
    return torch.where((count == 1) | (count == 3), _W_CUT, length).to(torch.float32)
