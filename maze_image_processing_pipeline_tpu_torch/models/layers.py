"""Group normalisation with the JAX package's numerics.

Counterpart of ``GroupNorm`` / ``_group_norm_ref`` in
``maze_image_processing_pipeline_tpu/models/layers.py``: statistics in
float32 as ``E[x²] − E[x]²`` clamped at 0, ``eps = 1e-6``, the result cast
back to the input's dtype. ``torch.nn.functional.group_norm`` computes the
variance another way (and defaults to ``eps = 1e-5``); against it the
outputs agree to about 1e-5, not bit for bit.
"""

from __future__ import annotations

import torch
from torch import nn

__all__ = ["GroupNorm", "group_norm"]


def group_norm(
    x: torch.Tensor,
    weight: torch.Tensor,
    bias: torch.Tensor,
    num_groups: int,
    eps: float = 1e-6,
) -> torch.Tensor:
    """GroupNorm of channels-first ``x`` (B, C, ...)."""
    B, C = x.shape[:2]
    G = num_groups
    if C % G:
        raise ValueError(f"channels {C} not divisible by groups {G}")
    red = tuple(range(2, x.dim()))
    n = C // G
    for a in red:
        n *= x.shape[a]
    xf = x.float()
    s1 = xf.sum(red)  # (B, C)
    s2 = (xf * xf).sum(red)
    mean_g = s1.view(B, G, C // G).sum(-1) / n
    var_g = torch.clamp(s2.view(B, G, C // G).sum(-1) / n - mean_g * mean_g, min=0.0)
    rstd_g = torch.rsqrt(var_g + eps)
    shape = (B, C) + (1,) * len(red)
    mean_c = mean_g.repeat_interleave(C // G, dim=1).view(shape)
    rstd_c = rstd_g.repeat_interleave(C // G, dim=1)
    cshape = (1, C) + (1,) * len(red)
    y = (xf - mean_c) * (rstd_c * weight).view(shape) + bias.view(cshape)
    return y.to(x.dtype)


class GroupNorm(nn.Module):
    """``num_groups`` consecutive channel blocks, statistics over all
    non-batch axes of each block; parameters ``weight`` (the flax ``scale``)
    and ``bias`` of shape (C,), kept in float32."""

    def __init__(self, num_groups: int, num_channels: int, eps: float = 1e-6) -> None:
        super().__init__()
        self.num_groups = num_groups
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(num_channels))
        self.bias = nn.Parameter(torch.zeros(num_channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return group_norm(x, self.weight, self.bias, self.num_groups, self.eps)
