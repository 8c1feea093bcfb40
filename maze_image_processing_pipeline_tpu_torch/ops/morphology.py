"""Batched binary morphology by the exact Euclidean disk, from the EDT.

Counterpart of ``maze_image_processing_pipeline_tpu/ops/morphology.py``:

* ``binary_*`` (erosion, dilation, opening, closing): the footprint is
  ``{(dy, dx): dy² + dx² <= r²}``. Pixels outside the image count as
  foreground for erosion and as background for dilation.
* ``isotropic_*``: the strict thresholds of ``maze_ipp/isotropic.py``
  (erosion keeps ``dist > r``, dilation adds ``dist < r``) on the squared
  EDT bounded at ``ceil(r)``, so fractional radii such as 1.5 and 2.5 work.
"""

from __future__ import annotations

import math

import torch

from .edt import squared_edt

__all__ = [
    "binary_erosion",
    "binary_dilation",
    "binary_opening",
    "binary_closing",
    "isotropic_erosion",
    "isotropic_dilation",
    "isotropic_opening",
    "isotropic_closing",
]


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


def isotropic_erosion(mask: torch.Tensor, radius: float) -> torch.Tensor:
    """EDT-based erosion with strict threshold (``dist > radius``)."""
    sq = squared_edt(~mask.bool(), math.ceil(radius))
    return sq.to(torch.float32) > radius * radius


def isotropic_dilation(mask: torch.Tensor, radius: float) -> torch.Tensor:
    """EDT-based dilation with strict threshold (``dist < radius``)."""
    sq = squared_edt(mask.bool(), math.ceil(radius))
    return sq.to(torch.float32) < radius * radius


def isotropic_opening(mask: torch.Tensor, radius: float) -> torch.Tensor:
    return isotropic_dilation(isotropic_erosion(mask, radius), radius)


def isotropic_closing(mask: torch.Tensor, radius: float) -> torch.Tensor:
    return isotropic_erosion(isotropic_dilation(mask, radius), radius)
