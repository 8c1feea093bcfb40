"""Batched binary morphology by the exact Euclidean disk, from the EDT.

Counterpart of ``maze_image_processing_pipeline_tpu/ops/morphology.py``
(binary erosion, dilation, opening and closing). The footprint is
``{(dy, dx): dy² + dx² <= r²}``. Pixels outside the image count as
foreground for erosion and as background for dilation.
"""

from __future__ import annotations

import torch

from .edt import squared_edt

__all__ = ["binary_erosion", "binary_dilation", "binary_opening", "binary_closing"]


def binary_erosion(mask: torch.Tensor, radius: int) -> torch.Tensor:
    """Erosion by the Euclidean disk of integer radius ``radius``."""
    if radius <= 0:
        return mask.bool()
    return squared_edt(~mask.bool(), radius) > radius * radius


def binary_dilation(mask: torch.Tensor, radius: int) -> torch.Tensor:
    """Dilation by the Euclidean disk of integer radius ``radius``."""
    if radius <= 0:
        return mask.bool()
    return squared_edt(mask.bool(), radius) <= radius * radius


def binary_opening(mask: torch.Tensor, radius: int) -> torch.Tensor:
    """Erosion then dilation: removes details smaller than the disk."""
    return binary_dilation(binary_erosion(mask, radius), radius)


def binary_closing(mask: torch.Tensor, radius: int) -> torch.Tensor:
    """Dilation then erosion: closes gaps smaller than the disk."""
    return binary_erosion(binary_dilation(mask, radius), radius)
