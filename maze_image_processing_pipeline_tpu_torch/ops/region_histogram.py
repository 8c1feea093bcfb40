"""Per-region 256-bin intensity histograms: the K3 kernel and its plain version.

:func:`region_histogram` counts, for every frame and region id in
[0, ``num_segments``), the pixels of each intensity value 0..255. Labels
outside [0, ``num_segments``) are not counted; intensity is clipped to
[0, 255] and truncated, as the Pallas kernel ``region_histogram_pallas`` of
``attic/pallas_hist.py`` does.

On the card the histogram is written by the region-measurement kernel
(``csrc/region_measure.cu``, K7 and K3 in one pass), which
:func:`region_measure` launches: here with the histogram alone, from
:mod:`.regionprops_fused` with the region partials too, in one read of the
labels and the intensity. A tensor on the CPU goes through
:func:`region_histogram_plain` (one ``bincount`` of the joint index
``frame·(R+1)·256 + region·256 + bin``); a CUDA tensor always launches the
kernel, and the wrapper raises if the kernel does not take it or does not
launch. ``region_histogram.launches`` counts the kernel's launches that
write a histogram, this function's and the measurement's.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from .row_scan import _check_cuda, _raise_on, count_launch

__all__ = ["region_histogram", "region_histogram_plain", "region_measure"]


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
    _, hist = region_measure(labels.reshape(B, H, W), intensity.reshape(B, H, W), num_segments, partials=False)
    return hist.to(torch.float32).reshape(batch_shape + (num_segments, 256))


region_histogram.launches = 0


def region_measure(labels: torch.Tensor, intensity: Optional[torch.Tensor], num_segments: int, partials: bool):
    """Launch the region-measurement kernel once on contiguous (B, H, W)
    int32 labels and uint8 intensity (or None) on the card.

    Returns ``(partials, hist)``: with ``partials`` the (B, R, 5) int64 sums
    (perimeter units n1 and n065, Σ I, Σ I·y, Σ I·x), the (B, H, R) int32
    row count, x-sum, x-min (W if absent) and x-max (-1 if absent) and the
    (B, W, R) int32 column count, else None; the (B, R, 256) int32
    histogram with intensity, else None. Counts the launch on
    ``region_histogram.launches`` when it writes a histogram; the caller
    counts the partials.
    """
    B, H, W = labels.shape
    R = num_segments
    dev = labels.device
    n_sums = 2 * B * R * 5 if partials else 0  # int64 as int32 pairs, first (8-B aligned)
    n_col = B * W * R if partials else 0
    n_hist = B * R * 256 if intensity is not None else 0
    # The outputs that blocks add to lie in one buffer, with the kernel's B
    # strip counters last, zeroed by its launcher (one memset) or by the
    # blocks themselves.
    zero = torch.empty(n_sums + n_col + n_hist + B, dtype=torch.int32, device=dev)
    hist = zero[n_sums + n_col : n_sums + n_col + n_hist].view(B, R, 256) if n_hist else None
    sums = rows = colcnt = None
    if partials:
        sums = zero[:n_sums].view(torch.int64).view(B, R, 5)
        rows = torch.empty((4, B, H, R), dtype=torch.int32, device=dev)
        colcnt = zero[n_sums : n_sums + n_col].view(B, W, R)
    from .._build import kernels

    def ptr(t):
        return 0 if t is None else t.data_ptr()

    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = kernels().region_measure_launch(
            labels.data_ptr(), ptr(intensity), ptr(sums), ptr(rows), ptr(colcnt), ptr(hist),
            zero.data_ptr(), 4 * zero.numel(), B, H, W, R, stream,
        )
    _raise_on("region_measure", err)
    if hist is not None:
        count_launch(region_histogram, dev)
    return ((sums, *rows, colcnt) if partials else None), hist
