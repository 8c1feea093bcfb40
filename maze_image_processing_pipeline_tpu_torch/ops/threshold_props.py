"""Measurement of threshold-segmented object crops, batched on the device.

Counterpart of ``maze_image_processing_pipeline_tpu/ops/threshold_props.py``.
A padded batch of crops is measured in a few device calls:

* the mask ``image > threshold`` of each crop is one region (label 1),
  measured by :func:`.regionprops_fused.regionprops_fused` with
  ``num_segments=2`` (K7, with K3 for the histogram, on the card);
* the filled area (``binary_fill_holes`` on the host path) is exact without
  a flood fill: the 4-connected CCL of the background (:func:`.label.label`,
  K1, K2 and K4 on the card), then ``filled = H·W − Σ size(background
  components that touch the border)``. The right and bottom zero padding is
  itself border-connected background, so a padded crop measures as its true
  extent, in crop-local coordinates.

``n_bg`` is returned so that callers can find crops with more background
components than ``n_bg_segments`` and measure those on the host.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from .label import label, region_areas
from .regionprops_fused import regionprops_fused

__all__ = ["threshold_measure"]


def threshold_measure(
    imgs: torch.Tensor,
    threshold: float,
    *,
    n_bg_segments: int = 64,
    n_feret_angles: int = 16,
) -> Tuple[Dict[str, torch.Tensor], torch.Tensor, torch.Tensor]:
    """Measure ``imgs > threshold`` of each crop as one region.

    Args:
        imgs: (N, H, W) uint8 intensity crops (zero padded).
        threshold: brightness threshold (strict ``>``, as the host path).
        n_bg_segments: background components counted for the filled area.
        n_feret_angles: caliper sweep resolution.

    Returns:
        (props, area_filled, n_bg): ``props`` maps the regionprops keys to
        (N,) tensors (histogram: (N, 256)); ``area_filled`` is (N,) float32;
        ``n_bg`` is (N,) int32 background-component counts (crops with
        ``n_bg >= n_bg_segments`` are overflowed).
    """
    mask = imgs.to(torch.float32) > threshold
    props = regionprops_fused(
        mask.to(torch.int32), imgs, num_segments=2, compute_histogram=True, n_feret_angles=n_feret_angles
    )
    props = {k: v[:, 1] for k, v in props.items()}

    # Filled area: all pixels minus the border-connected background.
    bg_lab, n_bg = label(~mask, connectivity=1)
    N, H, W = mask.shape
    bg_size = region_areas(bg_lab, n_bg_segments).to(torch.float32)  # (N, C)
    border = torch.cat([bg_lab[:, 0, :], bg_lab[:, -1, :], bg_lab[:, :, 0], bg_lab[:, :, -1]], dim=-1)
    touches = region_areas(border[:, None, :], n_bg_segments) > 0
    outer = torch.where(touches, bg_size, 0.0)[:, 1:].sum(dim=-1)
    area_filled = float(H * W) - outer
    return props, area_filled, n_bg
