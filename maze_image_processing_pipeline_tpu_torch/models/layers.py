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
in NCHW-contiguous or channels_last layout. Each call on the card is one
device operation: one cooperative launch (no memset, no host
synchronisation), cut into blocks by :func:`norm_plan`, which reads each
input once wherever a normalisation unit fits in the card's shared memory.
The forward keeps K5's per-group mean and rstd for the backward. The
wrappers raise on any other layout of ``x`` or a failed launch.
``group_norm.launches`` and ``group_norm_bwd.launches`` count the launches.
"""

from __future__ import annotations

import ctypes
import functools
import math
from dataclasses import dataclass
from typing import Dict, Tuple

import torch
from torch import nn
from torch.autograd.function import once_differentiable

from ..ops.row_scan import count_launch

__all__ = [
    "GroupNorm",
    "NormPlan",
    "group_norm",
    "group_norm_bwd",
    "group_norm_bwd_plain",
    "group_norm_plain",
    "group_norm_plan",
    "group_stats_plain",
    "norm_plan",
]

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


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


# Constants of csrc/group_norm.cu that the plan must respect.
_THREADS = 256  # kThreads: a block's threads
_TABLE = 2048  # kTable: floats of the shared table, at least
_MAX_BLOCK_CHANNELS = 64  # kMaxBlockChannels: K6 NCHW, channel planes a share may touch
_MAX_PIECES = 128  # kMaxPieces: K6 NCHW, pieces a share is cut into
_PIECE = 64  # K6 NCHW: vectors a warp reduces at a time, at least
_MIN_SHARE_BYTES = 16384  # staged bytes a share has at least, where the unit has them


@dataclass(frozen=True)
class NormPlan:
    """How K5 or K6 cuts a call into blocks (:func:`norm_plan`).

    A unit (one statistic's elements: a (b, g) group in NCHW, an image in
    channels_last) of ``unit_vectors`` vectors is cut into ``splits`` shares
    of ``vectors_per_split`` vectors (the last may be shorter), one block a
    share; a block stages the first ``stage_vectors`` vectors of its share
    (of x, and of ct for K6: ``staged_bytes`` in all). ``units_per_wave``
    units run at a time on ``grid`` co-resident blocks.
    """

    units: int
    unit_vectors: int
    splits: int
    vectors_per_split: int
    stage_vectors: int
    units_per_wave: int
    piece: int
    staged_bytes: int

    @property
    def grid(self) -> int:
        return self.units_per_wave * self.splits

    @property
    def waves(self) -> int:
        return -(-self.units // self.units_per_wave)

    @property
    def one_read(self) -> bool:
        """Every share fits its block's shared memory: each input is read
        once; else the unstaged rest of a share is read twice."""
        return self.stage_vectors == self.vectors_per_split

    @property
    def mode(self) -> str:
        return "one read" if self.one_read else "two passes"


@functools.lru_cache(maxsize=4096)
def norm_plan(
    shape: Tuple[int, ...],
    num_groups: int,
    channels_last: bool,
    itemsize: int,
    vec: int,
    backward: bool,
    capacity: int,
    stage_bytes: int,
) -> NormPlan:
    """The one place K5 (``backward`` False) and K6 choose their mode, blocks
    per unit and staged bytes, for activations of ``shape`` (B, C, *spatial)
    loaded ``vec`` elements of ``itemsize`` bytes at a time, on a card that
    holds ``capacity`` co-resident blocks of ``stage_bytes`` stageable bytes
    each (``group_norm_capacity`` of csrc/group_norm.cu).

    A unit whose inputs fit ``capacity`` blocks' shared memory is read once:
    it gets the fewest blocks that hold it, raised (while the shares stay at
    least ``_MIN_SHARE_BYTES``) until the units of a wave, spread evenly over
    the waves, fill the card. A larger unit takes the whole grid and each
    block stages what it can; the rest of its share is read twice (two
    passes).
    """
    B, C = shape[0], shape[1]
    HW = math.prod(shape[2:])
    G = num_groups
    inputs = 2 if backward else 1
    vb = vec * itemsize
    units = B if channels_last else B * G
    unit_vectors = (C * HW if channels_last else C // G * HW) // vec
    max_stage = (stage_bytes // inputs) // 16 * 16 // vb
    if max_stage < 1 or capacity < 1:
        raise ValueError(f"norm_plan: a block must stage a vector ({stage_bytes} bytes, {capacity} blocks)")
    max_vps = unit_vectors
    if backward and not channels_last:  # a share touches few enough channel planes
        max_vps = min(max_vps, (_MAX_BLOCK_CHANNELS - 1) * (HW // vec))
    need = -(-unit_vectors // min(max_stage, max_vps))
    want = -(-unit_vectors // max(1, _MIN_SHARE_BYTES // (inputs * vb)))
    if need <= capacity:
        per_wave = min(units, capacity // need)
        per_wave = -(-units // -(-units // per_wave))  # the same number of waves, evenly filled
        splits = max(need, min(capacity // per_wave, want))
    else:
        per_wave = 1
        splits = max(min(capacity, want), -(-unit_vectors // max_vps))
        if splits > capacity:
            raise ValueError(f"norm_plan: {shape} needs {splits} blocks a unit, the card holds {capacity}")
    vps = -(-unit_vectors // splits)
    splits = -(-unit_vectors // vps)
    stage = min(vps, max_stage)
    piece = max(_PIECE, -(-vps // (_MAX_PIECES - _MAX_BLOCK_CHANNELS))) if backward and not channels_last else 1
    return NormPlan(
        units=units,
        unit_vectors=unit_vectors,
        splits=splits,
        vectors_per_split=vps,
        stage_vectors=stage,
        units_per_wave=per_wave,
        piece=piece,
        staged_bytes=inputs * -(-stage * vb // 16) * 16,
    )


_CAPACITY: Dict[tuple, Tuple[int, int]] = {}
_COUNTERS: Dict[tuple, torch.Tensor] = {}


def _capacity(x: torch.Tensor, backward: bool, vec: int, channels_last: bool) -> Tuple[int, int]:
    """(co-resident blocks, stageable bytes a block) of the kernel that takes
    ``x``: asked of ``x``'s card once per kernel and device (the query also
    sets the kernel's shared-memory size on that card)."""
    key = (x.device.index, backward, x.dtype, vec, channels_last)
    cap = _CAPACITY.get(key)
    if cap is None:
        from .._build import kernels

        out = (ctypes.c_int * 3)()
        with torch.cuda.device(x.device):
            err = kernels().group_norm_capacity(int(backward), _DTYPE_CODES[x.dtype], vec, int(channels_last),
                                                ctypes.addressof(out))
        if err != 0:
            raise RuntimeError(f"group_norm: the kernel's occupancy query failed with CUDA error {err}")
        cap = _CAPACITY[key] = (out[0] * out[1], out[2])
    return cap


def _counters(x: torch.Tensor, stream: int, n: int) -> torch.Tensor:
    """The kernels' barrier counters for ``x``'s device and ``stream``, at
    least ``n``: zeroed once when made, left zeroed by every launch."""
    key = (x.device.index, stream)
    buf = _COUNTERS.get(key)
    if buf is None or buf.numel() < n:
        buf = _COUNTERS[key] = torch.zeros(max(n, 1024), dtype=torch.int32, device=x.device)
    return buf


def _table_floats(C: int, G: int, channels_last: bool, vec: int) -> int:
    """Floats of the kernels' shared table (``table_floats`` of
    csrc/group_norm.cu): more than ``_TABLE`` where a channels_last pixel
    has more than ``_THREADS`` vectors (two sums of each channel) or the
    image has more than ``_TABLE / 2`` groups; the staging loses the rest."""
    t = max(_TABLE, (2 * C if C // vec > _THREADS else 0), 2 * G) if channels_last else _TABLE
    return -(-t // 4) * 4


def _card_plan(x: torch.Tensor, num_groups: int, backward: bool, *others: torch.Tensor) -> Tuple[bool, int, NormPlan]:
    """(channels_last, vec, plan) of K5 / K6 for ``x`` on the card."""
    name = "group_norm_bwd" if backward else "group_norm"
    channels_last = _cuda_layout(x, num_groups, name)
    C = x.shape[1]
    vec = _vector_width(C if channels_last else math.prod(x.shape[2:]), x.element_size(), x, *others)
    capacity, stage_bytes = _capacity(x, backward, vec, channels_last)
    stage_bytes -= 4 * (_table_floats(C, num_groups, channels_last, vec) - _TABLE)
    plan = norm_plan(tuple(x.shape), num_groups, channels_last, x.element_size(), vec, backward, capacity,
                     stage_bytes)
    return channels_last, vec, plan


def group_norm_plan(x: torch.Tensor, num_groups: int, backward: bool = False) -> NormPlan:
    """The plan K5 (or, ``backward``, K6) runs for activations ``x`` on the
    card."""
    return _card_plan(x, num_groups, backward)[2]


def _group_norm_forward(x, weight, bias, G, eps) -> Tuple[torch.Tensor, torch.Tensor]:
    """(y, stats): K5 on the card, the plain version on the CPU."""
    if x.device.type == "cpu":
        stats = group_stats_plain(x, G, eps)
        return _normalize_plain(x, weight, bias, stats, G), stats
    y = torch.empty_like(x)  # same layout as x
    w, b = _param(weight, x, "group_norm"), _param(bias, x, "group_norm")
    B, C = x.shape[:2]
    stats = torch.empty((2, B * G), dtype=torch.float32, device=x.device)
    if y.numel() == 0:
        _cuda_layout(x, G, "group_norm")
        return y, stats.zero_()
    channels_last, vec, plan = _card_plan(x, G, False, y)
    part = torch.empty((plan.units * plan.splits * (2 * G if channels_last else 2),), dtype=torch.float32,
                       device=x.device)
    from .._build import kernels

    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        counters = _counters(x, stream, plan.units + 1)
        err = kernels().group_norm_launch(
            x.data_ptr(), w.data_ptr(), b.data_ptr(), y.data_ptr(), stats.data_ptr(), part.data_ptr(),
            counters.data_ptr(), B, C, G, math.prod(x.shape[2:]), int(channels_last), _DTYPE_CODES[x.dtype], vec,
            plan.splits, plan.vectors_per_split, plan.stage_vectors, plan.units_per_wave, float(eps), stream,
        )
    if err != 0:
        raise RuntimeError(f"group_norm: kernel launch failed with CUDA error {err}")
    count_launch(group_norm, x.device)
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
    dwb = torch.empty((2, C), dtype=torch.float32, device=x.device)  # the last unit's block fills it
    if dx.numel() == 0:
        dwb.zero_()
        return dx, dwb[0], dwb[1]
    channels_last, vec, plan = _card_plan(x, G, True, ct, dx)
    # A share's partials: two per group of the unit, then two per channel.
    slots = (2 * G + 2 * C) if channels_last else (2 + 2 * _MAX_BLOCK_CHANNELS)
    n_part = plan.units * plan.splits * slots
    scratch = torch.empty((n_part + 2 * B * C,), dtype=torch.float32, device=x.device)
    rows = scratch[n_part:]
    from .._build import kernels

    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        counters = _counters(x, stream, plan.units + 1)
        err = kernels().group_norm_bwd_launch(
            x.data_ptr(), ct.data_ptr(), w.data_ptr(), stats.data_ptr(), dx.data_ptr(), dwb.data_ptr(),
            scratch.data_ptr(), rows.data_ptr(), counters.data_ptr(), B, C, G,
            math.prod(x.shape[2:]), int(channels_last), _DTYPE_CODES[x.dtype], vec, plan.splits,
            plan.vectors_per_split, plan.stage_vectors, plan.units_per_wave, plan.piece, stream,
        )
    if err != 0:
        raise RuntimeError(f"group_norm_bwd: kernel launch failed with CUDA error {err}")
    count_launch(group_norm_bwd, x.device)
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
