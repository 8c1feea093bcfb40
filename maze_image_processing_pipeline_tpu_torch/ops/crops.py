"""Per-region crop windows (intensity + masks) cut on the device.

Counterpart of ``maze_image_processing_pipeline_tpu/ops/crops.py``: N
fixed-size windows are cut from a batch of frames with one gather each for
the labels and the intensity, and come back to the host as one flat uint8
buffer.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["extract_region_crops", "UNPACK_LUT"]

_PACK_WEIGHTS = (1, 4, 16, 64)


def extract_region_crops(
    frames: torch.Tensor,
    labels: torch.Tensor,
    ids: torch.Tensor,
    bidx: torch.Tensor,
    y0: torch.Tensor,
    x0: torch.Tensor,
    *,
    size_h: int,
    size_w: int,
    include_intensity: bool = True,
    pack_bits: bool = False,
) -> torch.Tensor:
    """Cut N windows of (size_h, size_w) out of a batch of frames.

    Args:
        frames: (B, H, W) uint8 intensity frames.
        labels: (B, H, W) int32 label frames (0 = background).
        ids: (N,) region id per window.
        bidx / y0 / x0: (N,) frame index and non-negative window start
            per window; a start past ``H - size_h`` (``W - size_w``) is
            clamped back into the frame.
        size_h / size_w: window extent.
        include_intensity: also return the intensity windows.
        pack_bits: pack the 2-bit mask fields 4 per byte along x (requires
            ``size_w % 4 == 0``); :data:`UNPACK_LUT` inverts on the host.

    Returns:
        flat uint8: with ``include_intensity`` the N intensity windows then
        the N mask windows, otherwise the mask windows only. A mask field
        holds bit 0 = pixel of this region, bit 1 = pixel of another region.
    """
    if pack_bits and size_w % 4:
        raise ValueError(f"pack_bits requires size_w % 4 == 0, got {size_w}")
    H, W = labels.shape[-2:]
    dev = labels.device
    ids, bidx, y0, x0 = (torch.as_tensor(t, device=dev).long() for t in (ids, bidx, y0, x0))
    y = y0.clamp(0, H - size_h)
    x = x0.clamp(0, W - size_w)
    rows = (y[:, None] + torch.arange(size_h, device=dev))[:, :, None]
    cols = (x[:, None] + torch.arange(size_w, device=dev))[:, None, :]
    b = bidx[:, None, None]
    lab = labels[b, rows, cols]  # (N, size_h, size_w)
    this = lab == ids[:, None, None]
    other = (lab > 0) & ~this
    bits = this.to(torch.uint8) | (other.to(torch.uint8) << 1)
    if pack_bits:
        g = bits.reshape(-1, size_h, size_w // 4, 4).to(torch.int32)
        w = torch.tensor(_PACK_WEIGHTS, dtype=torch.int32, device=dev)
        bits = (g * w).sum(-1).to(torch.uint8)
    if not include_intensity:
        return bits.reshape(-1)
    img = frames[b, rows, cols]
    return torch.cat([img.reshape(-1), bits.reshape(-1)])


# Host-side inverse of pack_bits: UNPACK_LUT[byte] -> the 4 two-bit fields.
UNPACK_LUT = np.asarray(
    [[(b >> (2 * k)) & 3 for k in range(4)] for b in range(256)], np.uint8
)
