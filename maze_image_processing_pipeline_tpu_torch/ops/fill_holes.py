"""Per-region filled area from one frame-level pass.

Counterpart of ``maze_image_processing_pipeline_tpu/ops/fill_holes.py``:

* label the background 4-connected (the CCL of :mod:`.label`, whose row
  scans are CUDA kernels on the card);
* a background component is a hole iff it does not touch the frame border;
* a hole belongs to the region that encloses it: all its foreground
  4-neighbours carry that region's label, so their min and max agree.
  ``area_filled[r] = area[r] + Σ holes owned by r``.

A hole whose foreground neighbours belong to different regions cannot be
attributed; the regions in the [min, max] range of its neighbour labels are
flagged ``ambiguous``, as is every region of a frame whose background
components overflow ``bg_segments``. Callers fill those on the host.
"""

from __future__ import annotations

from typing import Tuple

import torch

from .label import label

__all__ = ["region_filled_extra"]

_BIG = 1 << 30


def _shift(x: torch.Tensor, dy: int, dx: int) -> torch.Tensor:
    """x moved by (dy, dx) along the last two axes, zero-filled."""
    out = torch.zeros_like(x)
    H, W = x.shape[-2:]
    ys, yd = (slice(0, H - dy), slice(dy, H)) if dy >= 0 else (slice(-dy, H), slice(0, H + dy))
    xs, xd = (slice(0, W - dx), slice(dx, W)) if dx >= 0 else (slice(-dx, W), slice(0, W + dx))
    out[..., yd, xd] = x[..., ys, xs]
    return out


def region_filled_extra(
    labels: torch.Tensor,
    *,
    num_segments: int,
    bg_segments: int = 256,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-region enclosed-hole area and attribution-ambiguity flags.

    Args:
        labels: (..., H, W) int label images, 0 = background.
        num_segments: region axis size R (ids < R are measured).
        bg_segments: bound on background components per frame; on overflow
            every region of that frame is flagged ambiguous.

    Returns:
        (extra, ambiguous): (..., R) float32 hole area per region, and
        (..., R) bool, True where the caller must fill on the host.
    """
    batch_shape = labels.shape[:-2]
    H, W = labels.shape[-2:]
    lab = labels.reshape(-1, H, W).to(torch.int32)
    B = lab.shape[0]
    R = num_segments
    C = bg_segments
    dev = lab.device

    bg_lab, n_bg = label(lab == 0, connectivity=1)
    comp = torch.where(bg_lab < C, bg_lab, C).long().reshape(B, H * W)

    def per_comp(values, init, reduce):
        acc = torch.full((B, C + 1), init, dtype=values.dtype, device=dev)
        return acc.scatter_reduce(1, comp, values.reshape(B, H * W), reduce=reduce)[:, :C]

    comp_area = per_comp(torch.ones(B, H, W, device=dev), 0.0, "sum")  # (B, C)
    on_border = torch.zeros(H, W, dtype=torch.int32, device=dev)
    on_border[0, :] = on_border[-1, :] = 1
    on_border[:, 0] = on_border[:, -1] = 1
    touches_border = per_comp(on_border.expand(B, H, W).contiguous(), 0, "amax") > 0

    # Foreground labels of each pixel's 4-neighbourhood (0 = background or
    # outside the frame).
    nb_max = torch.zeros_like(lab)
    nb_min = torch.full_like(lab, _BIG)
    for dy, dx in ((1, 0), (-1, 0), (0, 1), (0, -1)):
        nb = _shift(lab, dy, dx)
        nb_max = torch.maximum(nb_max, nb)
        nb_min = torch.minimum(nb_min, torch.where(nb > 0, nb, _BIG))
    comp_nb_max = per_comp(nb_max, 0, "amax")
    comp_nb_min = per_comp(nb_min, _BIG, "amin")

    c_ids = torch.arange(C, device=dev)
    is_hole = ~touches_border & (c_ids[None] > 0) & (c_ids[None] <= n_bg[:, None])
    unanimous = comp_nb_max == comp_nb_min
    has_nb = comp_nb_max > 0
    owner = torch.where(is_hole & unanimous & has_nb, comp_nb_max, 0).long()

    extra = torch.zeros(B, R + 1, dtype=torch.float32, device=dev)
    extra.scatter_add_(1, torch.where(owner < R, owner, R), comp_area)
    extra = extra[:, :R]
    extra[:, 0] = 0.0

    r_ids = torch.arange(R, device=dev)
    amb_comp = is_hole & has_nb & ~unanimous
    lo = torch.where(amb_comp, comp_nb_min, _BIG)[..., None]  # (B, C, 1)
    hi = torch.where(amb_comp, comp_nb_max, -1)[..., None]
    ambiguous = ((r_ids >= lo) & (r_ids <= hi)).any(dim=1)  # (B, R)
    overflow = (n_bg >= C)[:, None]
    ambiguous = (ambiguous | overflow) & (r_ids > 0)
    return extra.reshape(batch_shape + (R,)), ambiguous.reshape(batch_shape + (R,))
