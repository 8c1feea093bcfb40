"""Bounded squared Euclidean distance transform (EDT).

Counterpart of ``maze_image_processing_pipeline_tpu/ops/edt.py``:

1. **Column pass** — per column, the row distance to the nearest site from
   two ``cummax`` sweeps (down, and up on the flipped image).
2. **Row pass** — ``F[x] = min over |dx| <= r of G[x+dx]² + dx²`` as a loop of
   2r+1 shifted minima.

Within the bound ``r`` the result is the exact squared EDT; beyond it values
clamp to ``(r+1)²``. Pixels outside the image are never sites. Int32
throughout; :func:`edt` is the square root of :func:`squared_edt` in
float32.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["squared_edt", "edt"]


def _row_distance_to_site(sites: torch.Tensor) -> torch.Tensor:
    """Per-column distance (in rows) to the nearest site, along axis -2;
    columns without a site get a large value."""
    H = sites.shape[-2]
    none = -1 - (2 * H + 2)
    iota = torch.arange(H, dtype=torch.int32, device=sites.device)[:, None]
    none_t = torch.tensor(none, dtype=torch.int32, device=sites.device)
    nearest_above = torch.cummax(torch.where(sites, iota, none_t), dim=-2).values
    dist_above = iota - nearest_above
    marked_dn = torch.where(sites, -iota, none_t).flip(-2)
    nearest_below = torch.cummax(marked_dn, dim=-2).values.flip(-2)
    dist_below = -(iota + nearest_below)
    return torch.minimum(dist_above, dist_below)


def squared_edt(sites: torch.Tensor, max_distance: int) -> torch.Tensor:
    """Squared Euclidean distance to the nearest True pixel of ``sites``.

    Args:
        sites: bool (..., H, W); True marks distance-zero pixels.
        max_distance: bound ``r``; exact up to ``r``, ``(r+1)²`` beyond.

    Returns:
        int32 (..., H, W) squared distances.
    """
    r = int(max_distance)
    if r < 0:
        raise ValueError("max_distance must be >= 0")
    cap = (r + 1) * (r + 1)
    sites = sites.bool()
    W = sites.shape[-1]

    rowdist = torch.clamp(_row_distance_to_site(sites), max=r + 1)
    g2 = rowdist * rowdist
    g2_padded = F.pad(g2, (r, r), value=cap)
    result = torch.clamp(g2, max=cap)
    for dx in range(1, r + 1):
        left = g2_padded[..., r - dx : r - dx + W]
        right = g2_padded[..., r + dx : r + dx + W]
        result = torch.minimum(result, torch.minimum(left, right) + dx * dx)
    return torch.clamp(result, max=cap)


def edt(sites: torch.Tensor, max_distance: int) -> torch.Tensor:
    """Euclidean distance to the nearest True pixel (float32), bounded."""
    return torch.sqrt(squared_edt(sites, max_distance).to(torch.float32))
