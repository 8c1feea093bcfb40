"""Group normalisation with the JAX package's numerics, forward (K5) and
backward (K6).

Counterpart of ``GroupNorm`` / ``_group_norm_ref`` in
``maze_image_processing_pipeline_tpu/models/layers.py``: statistics in
float32 as ``E[x²] − E[x]²`` clamped at 0, ``eps = 1e-6``, the result cast
back to the input's dtype. ``torch.nn.functional.group_norm`` computes the
variance another way (and defaults to ``eps = 1e-5``); against it the
outputs agree to about 1e-5, not bit for bit.

:func:`group_norm` is a ``torch.autograd.Function`` on both devices. For a
tensor on the CPU it takes the plain PyTorch versions
(:func:`group_norm_plain`, :func:`group_norm_bwd_plain`); a CUDA tensor
always launches the hand-written kernels of ``csrc/group_norm.cu``: K5 in
the forward (the counterpart of the Pallas ``group_norm_pallas`` of
``attic/pallas_norm.py``), K6 in the backward (``group_norm_bwd_pallas``),
in NCHW-contiguous or channels_last layout. The forward keeps K5's
per-group mean and rstd for the backward. The wrappers raise on any other
layout of ``x`` or a failed launch. ``group_norm.launches`` and
``group_norm_bwd.launches`` count the launches.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch
from torch import nn
from torch.autograd.function import once_differentiable

__all__ = [
    "GroupNorm",
    "group_norm",
    "group_norm_bwd",
    "group_norm_bwd_plain",
    "group_norm_plain",
    "group_stats_plain",
]

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_BLOCK_ELEMENTS = 16384  # elements a statistics block reduces


def _check_groups(C: int, G: int) -> None:
    if G < 1 or C % G:
        raise ValueError(f"group_norm: channels {C} not divisible by groups {G}")


def group_stats_plain(x: torch.Tensor, num_groups: int, eps: float = 1e-6) -> torch.Tensor:
    """Plain version of K5's statistics: (2, B*G) float32, the mean and
    rstd of each (batch, group) of channels-first ``x`` (B, C, ...)."""
    B, C = x.shape[:2]
    G = num_groups
    _check_groups(C, G)
    red = tuple(range(2, x.dim()))
    n = C // G
    for a in red:
        n *= x.shape[a]
    xf = x.float()
    s1 = xf.sum(red)  # (B, C)
    s2 = (xf * xf).sum(red)
    mean_g = s1.view(B, G, C // G).sum(-1) / n
    var_g = torch.clamp(s2.view(B, G, C // G).sum(-1) / n - mean_g * mean_g, min=0.0)
    return torch.stack([mean_g.reshape(-1), torch.rsqrt(var_g + eps).reshape(-1)])


def _per_channel(stats_row: torch.Tensor, B: int, C: int, G: int) -> torch.Tensor:
    """A (B*G,) row of per-group values → (B, C)."""
    return stats_row.view(B, G).repeat_interleave(C // G, dim=1)


def _normalize_plain(x, weight, bias, stats, G) -> torch.Tensor:
    B, C = x.shape[:2]
    shape = (B, C) + (1,) * (x.dim() - 2)
    cshape = (1, C) + (1,) * (x.dim() - 2)
    mean_c = _per_channel(stats[0], B, C, G).view(shape)
    rstd_c = _per_channel(stats[1], B, C, G)
    y = (x.float() - mean_c) * (rstd_c * weight).view(shape) + bias.view(cshape)
    return y.to(x.dtype)


def group_norm_plain(
    x: torch.Tensor,
    weight: torch.Tensor,
    bias: torch.Tensor,
    num_groups: int,
    eps: float = 1e-6,
) -> torch.Tensor:
    """Plain version of K5: GroupNorm of channels-first ``x`` (B, C, ...)."""
    return _normalize_plain(x, weight, bias, group_stats_plain(x, num_groups, eps), num_groups)


def group_norm_bwd_plain(
    x: torch.Tensor,
    ct: torch.Tensor,
    weight: torch.Tensor,
    stats: torch.Tensor,
    num_groups: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of K6: the GroupNorm VJP in float32.

    Args:
        x: the forward's input (B, C, ...).
        ct: the cotangent of the output, x's shape.
        weight: (C,) scale.
        stats: the forward's (2, B*G) mean and rstd (:func:`group_stats_plain`).
        num_groups: G.

    Returns:
        (dx in x's dtype, dweight (C,) float32, dbias (C,) float32). With
        Sc = Σct and Scx = Σct·(x − mean) per (b, c), S1 = Σ_g weight·Sc and
        S2 = Σ_g weight·rstd·Scx per (b, g), and n the elements of a group:
        ``dx = rstd·weight·ct − rstd²·S2/n·(x − mean) − rstd·S1/n``.
    """
    B, C = x.shape[:2]
    G = num_groups
    _check_groups(C, G)
    red = tuple(range(2, x.dim()))
    n = math.prod(x.shape[1:]) // G
    shape = (B, C) + (1,) * len(red)
    xc = x.float() - _per_channel(stats[0], B, C, G).view(shape)
    cf = ct.float()
    rstd_g = stats[1].view(B, G)
    rstd_c = _per_channel(stats[1], B, C, G)
    gamma = weight.float()
    sc = cf.sum(red)  # (B, C)
    dw_rows = rstd_c * (cf * xc).sum(red)
    s1 = (gamma * sc).view(B, G, C // G).sum(-1)  # (B, G)
    s2 = (gamma * dw_rows).view(B, G, C // G).sum(-1)
    coef_x = (-rstd_g * rstd_g * s2 / n).repeat_interleave(C // G, dim=1).view(shape)
    coef_d = (-rstd_g * s1 / n).repeat_interleave(C // G, dim=1).view(shape)
    dx = (rstd_c * gamma).view(shape) * cf + coef_x * xc + coef_d
    return dx.to(x.dtype), dw_rows.sum(0), sc.sum(0)


def _vector_width(n: int, itemsize: int, *tensors: torch.Tensor) -> int:
    """Elements per load: the widest of 16, 8, 4, 2 bytes (or 1 element)
    that divides ``n`` elements and aligns every tensor's address."""
    for nbytes in (16, 8, 4, 2):
        v = nbytes // itemsize
        if v >= 1 and n % v == 0 and all(t.data_ptr() % nbytes == 0 for t in tensors):
            return v
    return 1


def _cuda_layout(x: torch.Tensor, num_groups: int, name: str) -> bool:
    """Checks what K5 and K6 take of ``x``; returns whether it is
    channels_last (else NCHW-contiguous)."""
    if x.device.type != "cuda":
        raise ValueError(f"{name}: tensors must lie on the CPU or a CUDA device, got {x.device}")
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"{name}: activations must be float32, bfloat16 or float16, got {x.dtype}")
    if x.dim() < 3:
        raise ValueError(f"{name}: need (B, C, *spatial) activations, got {tuple(x.shape)}")
    _check_groups(x.shape[1], num_groups)
    if x.is_contiguous():
        return False
    if x.dim() == 4 and x.is_contiguous(memory_format=torch.channels_last):
        return True
    raise ValueError(f"{name}: activations must be NCHW-contiguous or channels_last, got strides {x.stride()}")


def _param(t: torch.Tensor, x: torch.Tensor, name: str) -> torch.Tensor:
    C = x.shape[1]
    out = t.detach().to(device=x.device, dtype=torch.float32).contiguous()
    if out.shape != (C,):
        raise ValueError(f"{name}: weight and bias must be ({C},), got {tuple(out.shape)}")
    return out


def _splits(n_units: int, unit_elems: int) -> Tuple[int, int]:
    """(units a block reduces, blocks) for ``n_units`` units of
    ``unit_elems`` elements: about ``_BLOCK_ELEMENTS`` elements a block, at
    most 65535 blocks."""
    per_split = max(1, _BLOCK_ELEMENTS // unit_elems, -(-n_units // 65535))
    return per_split, -(-n_units // per_split)


def _group_norm_forward(x, weight, bias, G, eps) -> Tuple[torch.Tensor, torch.Tensor]:
    """(y, stats): K5 on the card, the plain version on the CPU."""
    if x.device.type == "cpu":
        stats = group_stats_plain(x, G, eps)
        return _normalize_plain(x, weight, bias, stats, G), stats
    channels_last = _cuda_layout(x, G, "group_norm")
    w, b = _param(weight, x, "group_norm"), _param(bias, x, "group_norm")
    B, C = x.shape[:2]
    y = torch.empty_like(x)  # same layout as x
    stats = torch.empty((2, B * G), dtype=torch.float32, device=x.device)
    HW = math.prod(x.shape[2:])
    if y.numel() == 0:
        return y, stats.zero_()
    Cg = C // G
    vec = _vector_width(Cg if channels_last else HW, x.element_size(), x, y)
    per_split, splits = _splits(HW if channels_last else Cg * HW // vec, Cg if channels_last else vec)
    part = torch.empty((2, B * G, splits), dtype=torch.float32, device=x.device)
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
    return y, stats


def group_norm_bwd(
    x: torch.Tensor,
    ct: torch.Tensor,
    weight: torch.Tensor,
    stats: torch.Tensor,
    num_groups: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The GroupNorm VJP (K6 on the card): (dx, dweight, dbias).

    Arguments and results as :func:`group_norm_bwd_plain`'s, which a tensor
    on the CPU takes. On the card ``x`` is NCHW-contiguous or channels_last
    and ``ct`` any layout: it is copied into x's first. dx has x's layout.
    """
    if x.device.type == "cpu":
        return group_norm_bwd_plain(x, ct, weight, stats, num_groups)
    G = num_groups
    channels_last = _cuda_layout(x, G, "group_norm_bwd")
    if ct.shape != x.shape:
        raise ValueError(f"group_norm_bwd: cotangent {tuple(ct.shape)} for activations {tuple(x.shape)}")
    B, C = x.shape[:2]
    if stats.shape != (2, B * G) or stats.dtype != torch.float32 or stats.device != x.device:
        raise ValueError(f"group_norm_bwd: stats must be (2, {B * G}) float32 on {x.device}")
    fmt = torch.channels_last if channels_last else torch.contiguous_format
    ct = ct.to(x.dtype).contiguous(memory_format=fmt)
    w = _param(weight, x, "group_norm_bwd")
    stats = stats.contiguous()
    dx = torch.empty_like(x)
    dwb = torch.empty((2, C), dtype=torch.float32, device=x.device)  # the apply kernel's block 0 fills it
    HW = math.prod(x.shape[2:])
    if dx.numel() == 0:
        dwb.zero_()
        return dx, dwb[0], dwb[1]
    Cg = C // G
    vec = _vector_width(Cg if channels_last else HW, x.element_size(), x, ct, dx)
    # Units: channels_last, a group's HW pixels; NCHW, one plane's vectors.
    per_split, splits = _splits(HW if channels_last else HW // vec, Cg if channels_last else vec)
    part = torch.empty((2, B * C, splits), dtype=torch.float32, device=x.device)
    rows = torch.empty((2, B * C), dtype=torch.float32, device=x.device)
    coef = torch.empty((2, B * G), dtype=torch.float32, device=x.device)
    counters = torch.zeros((B * G,), dtype=torch.int32, device=x.device)
    from .._build import kernels

    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = kernels().group_norm_bwd_launch(
            x.data_ptr(), ct.data_ptr(), w.data_ptr(), stats.data_ptr(), dx.data_ptr(), dwb.data_ptr(),
            part.data_ptr(), rows.data_ptr(), coef.data_ptr(), counters.data_ptr(), B, C, G, HW,
            int(channels_last), _DTYPE_CODES[x.dtype], vec, per_split, splits, stream,
        )
    if err != 0:
        raise RuntimeError(f"group_norm_bwd: kernel launch failed with CUDA error {err}")
    group_norm_bwd.launches += 1
    return dx, dwb[0], dwb[1]


group_norm_bwd.launches = 0


class _GroupNormFunction(torch.autograd.Function):
    """K5 forward, K6 backward on the card; the plain versions on the CPU."""

    @staticmethod
    def forward(ctx, x, weight, bias, num_groups, eps):
        y, stats = _group_norm_forward(x, weight, bias, num_groups, eps)
        ctx.save_for_backward(x, weight, stats)
        ctx.num_groups = num_groups
        ctx.bias_meta = (bias.device, bias.dtype)
        return y

    @staticmethod
    @once_differentiable
    def backward(ctx, dy):
        x, weight, stats = ctx.saved_tensors
        dx, dw, db = group_norm_bwd(x, dy, weight, stats, ctx.num_groups)
        return dx, dw.to(weight.device, weight.dtype), db.to(*ctx.bias_meta), None, None


def group_norm(
    x: torch.Tensor,
    weight: torch.Tensor,
    bias: torch.Tensor,
    num_groups: int,
    eps: float = 1e-6,
) -> torch.Tensor:
    """GroupNorm of channels-first ``x`` (B, C, ...) (K5 on the card),
    differentiable in x, weight and bias (K6 on the card).

    Args:
        x: float32, bfloat16 or float16 activations, (B, C, *spatial);
            on the card NCHW-contiguous or, 4-D, channels_last.
        weight, bias: (C,) affine parameters (used in float32).
        num_groups: G, dividing C; groups are consecutive channel blocks.
        eps: added to the variance.

    Returns:
        y in x's dtype and layout.
    """
    return _GroupNormFunction.apply(x, weight, bias, num_groups, eps)


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
