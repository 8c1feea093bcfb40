"""Group normalisation with the JAX package's numerics (K5).

Counterpart of ``GroupNorm`` / ``_group_norm_ref`` in
``maze_image_processing_pipeline_tpu/models/layers.py``: statistics in
float32 as ``E[x²] − E[x]²`` clamped at 0, ``eps = 1e-6``, the result cast
back to the input's dtype. ``torch.nn.functional.group_norm`` computes the
variance another way (and defaults to ``eps = 1e-5``); against it the
outputs agree to about 1e-5, not bit for bit.

:func:`group_norm` takes the plain PyTorch version (:func:`group_norm_plain`)
for a tensor on the CPU; a CUDA tensor always launches the hand-written
kernel K5 (``csrc/group_norm.cu``, the counterpart of the Pallas
``group_norm_pallas`` of ``attic/pallas_norm.py``), in NCHW-contiguous or
channels_last layout, and the wrapper raises on any other layout or a
failed launch. ``group_norm.launches`` counts the launches.
"""

from __future__ import annotations

import math

import torch
from torch import nn

__all__ = ["GroupNorm", "group_norm", "group_norm_plain"]

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_BLOCK_ELEMENTS = 16384  # elements a statistics block reduces


def group_norm_plain(
    x: torch.Tensor,
    weight: torch.Tensor,
    bias: torch.Tensor,
    num_groups: int,
    eps: float = 1e-6,
) -> torch.Tensor:
    """Plain version of K5: GroupNorm of channels-first ``x`` (B, C, ...)."""
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


def _vector_width(n: int, itemsize: int, *tensors: torch.Tensor) -> int:
    """Elements per load: the widest of 16, 8, 4, 2 bytes (or 1 element)
    that divides ``n`` elements and aligns every tensor's address."""
    for nbytes in (16, 8, 4, 2):
        v = nbytes // itemsize
        if v >= 1 and n % v == 0 and all(t.data_ptr() % nbytes == 0 for t in tensors):
            return v
    return 1


def group_norm(
    x: torch.Tensor,
    weight: torch.Tensor,
    bias: torch.Tensor,
    num_groups: int,
    eps: float = 1e-6,
) -> torch.Tensor:
    """GroupNorm of channels-first ``x`` (B, C, ...) (K5 on the card).

    Args:
        x: float32, bfloat16 or float16 activations, (B, C, *spatial);
            on the card NCHW-contiguous or, 4-D, channels_last.
        weight, bias: (C,) affine parameters (used in float32).
        num_groups: G, dividing C; groups are consecutive channel blocks.
        eps: added to the variance.

    Returns:
        y in x's dtype and layout.
    """
    if x.device.type == "cpu":
        return group_norm_plain(x, weight, bias, num_groups, eps)
    if x.device.type != "cuda":
        raise ValueError(f"group_norm: tensors must lie on the CPU or a CUDA device, got {x.device}")
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"group_norm: activations must be float32, bfloat16 or float16, got {x.dtype}")
    if x.dim() < 3:
        raise ValueError(f"group_norm: need (B, C, *spatial) activations, got {tuple(x.shape)}")
    B, C = x.shape[:2]
    G = num_groups
    if G < 1 or C % G:
        raise ValueError(f"group_norm: channels {C} not divisible by groups {G}")
    if x.is_contiguous():
        channels_last = False
    elif x.dim() == 4 and x.is_contiguous(memory_format=torch.channels_last):
        channels_last = True
    else:
        raise ValueError(
            f"group_norm: activations must be NCHW-contiguous or channels_last, got strides {x.stride()}"
        )
    w = weight.detach().to(device=x.device, dtype=torch.float32).contiguous()
    b = bias.detach().to(device=x.device, dtype=torch.float32).contiguous()
    if w.shape != (C,) or b.shape != (C,):
        raise ValueError(f"group_norm: weight and bias must be ({C},), got {tuple(w.shape)}, {tuple(b.shape)}")
    y = torch.empty_like(x)  # same layout as x
    HW = math.prod(x.shape[2:])
    if y.numel() == 0:
        return y
    Cg = C // G
    vec = _vector_width(Cg if channels_last else HW, x.element_size(), x, y)
    n_units = HW if channels_last else Cg * HW // vec
    unit_elems = Cg if channels_last else vec
    per_split = max(1, _BLOCK_ELEMENTS // unit_elems, -(-n_units // 65535))
    splits = -(-n_units // per_split)
    part = torch.empty((2, B * G, splits), dtype=torch.float32, device=x.device)
    stats = torch.empty((2, B * G), dtype=torch.float32, device=x.device)
    counters = torch.zeros((B * G,), dtype=torch.int32, device=x.device)  # the kernel leaves them dirty
    from .._build import kernels

    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = kernels().group_norm_launch(
            x.data_ptr(), w.data_ptr(), b.data_ptr(), y.data_ptr(), part.data_ptr(), stats.data_ptr(),
            counters.data_ptr(), B, C, G, HW, int(channels_last), _DTYPE_CODES[x.dtype], vec,
            per_split, splits, float(eps), stream,
        )
    if err != 0:
        raise RuntimeError(f"group_norm: kernel launch failed with CUDA error {err}")
    group_norm.launches += 1
    return y


group_norm.launches = 0


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
