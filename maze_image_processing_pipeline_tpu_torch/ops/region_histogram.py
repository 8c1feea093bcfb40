"""Per-region 256-bin intensity histograms: the K3 kernel and its plain version.

:func:`region_histogram` counts, for every frame and region id in
[0, ``num_segments``), the pixels of each intensity value 0..255 (K3,
``csrc/region_histogram.cu``, which replaces ``region_histogram_pallas`` of
``attic/pallas_hist.py``). Labels outside [0, ``num_segments``) are not
counted; intensity is clipped to [0, 255] and truncated, as the Pallas kernel
does. The region measurement (:mod:`.regionprops_fused`) takes its histograms
from here.

A tensor on the CPU goes through :func:`region_histogram_plain` (one
``bincount`` of the joint index ``frame·(R+1)·256 + region·256 + bin``); a
CUDA tensor always launches the kernel, and the wrapper raises if the kernel
does not take it or does not launch. ``region_histogram.launches`` counts the
launches.
"""

from __future__ import annotations

import math

import torch

from .row_scan import _check_cuda, _raise_on

__all__ = ["region_histogram", "region_histogram_plain"]


def region_histogram_plain(labels: torch.Tensor, intensity: torch.Tensor, num_segments: int) -> torch.Tensor:
    """Plain version of K3."""
    H, W = labels.shape[-2:]
    batch_shape = labels.shape[:-2]
    R = num_segments
    lab = labels.reshape(-1, H, W).long()
    B = lab.shape[0]
    seg = torch.where((lab >= 0) & (lab < R), lab, R)
    bins = torch.clamp(intensity.reshape(-1, H, W).to(torch.float32), 0, 255).to(torch.long)
    frame = torch.arange(B, device=lab.device)[:, None, None] * ((R + 1) * 256)
    joint = (frame + seg * 256 + bins).reshape(-1)
    counts = torch.bincount(joint, minlength=B * (R + 1) * 256)
    hist = counts.reshape(B, R + 1, 256)[:, :R].to(torch.float32)
    return hist.reshape(batch_shape + (R, 256))


def region_histogram(labels: torch.Tensor, intensity: torch.Tensor, num_segments: int) -> torch.Tensor:
    """Per-region intensity histograms of (..., H, W) label frames (K3).

    Args:
        labels: integer labels (..., H, W); on the card int32.
        intensity: (..., H, W) intensity of the same shape.
        num_segments: R, the region ids counted ([0, R)).

    Returns:
        float32 (..., R, 256) pixel counts.
    """
    if labels.shape != intensity.shape or labels.dim() < 2:
        raise ValueError(
            f"region_histogram: need equal (..., H, W) shapes, got {tuple(labels.shape)} and {tuple(intensity.shape)}"
        )
    if labels.dtype.is_floating_point or labels.dtype == torch.bool:
        raise TypeError(f"region_histogram: labels must be integers, got {labels.dtype}")
    if num_segments < 1:
        raise ValueError(f"region_histogram: num_segments must be positive, got {num_segments}")
    if labels.device.type == "cpu":
        return region_histogram_plain(labels, intensity, num_segments)
    if labels.dtype != torch.int32:
        raise TypeError(f"region_histogram: labels on the card must be int32, got {labels.dtype}")
    if intensity.dtype != torch.uint8:
        intensity = torch.clamp(intensity.to(torch.float32), 0, 255).to(torch.uint8)
    _check_cuda("region_histogram", labels, intensity)
    H, W = labels.shape[-2:]
    batch_shape = labels.shape[:-2]
    B = math.prod(batch_shape)
    counts = torch.zeros(batch_shape + (num_segments, 256), dtype=torch.int32, device=labels.device)
    from .._build import kernels

    with torch.cuda.device(labels.device):
        stream = torch.cuda.current_stream(labels.device).cuda_stream
        err = kernels().region_histogram_launch(
            labels.data_ptr(), intensity.data_ptr(), counts.data_ptr(), B, H * W, num_segments, stream
        )
    _raise_on("region_histogram", err)
    region_histogram.launches += 1
    return counts.to(torch.float32)


region_histogram.launches = 0
