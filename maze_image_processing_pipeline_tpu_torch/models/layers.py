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
from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.autograd.function import once_differentiable

from .. import tracing
from ..ops.row_scan import count_launch
from ..parallel.multihost import exchange

__all__ = [
    "GroupNorm",
    "NormPlan",
    "group_norm",
    "group_norm_apply",
    "group_norm_apply_plain",
    "group_norm_bwd",
    "group_norm_bwd_apply",
    "group_norm_bwd_apply_plain",
    "group_norm_bwd_partials",
    "group_norm_bwd_partials_plain",
    "group_norm_bwd_plain",
    "group_norm_partials",
    "group_norm_plain",
    "group_norm_plan",
    "group_partials_plain",
    "group_stats_plain",
    "norm_plan",
    "shard_norm_plan",
    "sharded_group_norm",
]

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def _check_groups(C: int, G: int) -> None:
    if G < 1 or C % G:
        raise ValueError(f"group_norm: channels {C} not divisible by groups {G}")


def group_partials_plain(x: torch.Tensor, num_groups: int) -> torch.Tensor:
    """Plain version of K5's partials launch: (2, B*G) float32, the sum of
    x and of x*x over each (batch, group) of channels-first ``x`` (B, C,
    ...)."""
    B, C = x.shape[:2]
    G = num_groups
    _check_groups(C, G)
    red = tuple(range(2, x.dim()))
    xf = x.float()
    s1 = xf.sum(red)  # (B, C)
    s2 = (xf * xf).sum(red)
    return torch.stack([s1.view(B, G, C // G).sum(-1).reshape(-1), s2.view(B, G, C // G).sum(-1).reshape(-1)])


def _stats_from_sums(sums: torch.Tensor, n, eps: float) -> torch.Tensor:
    """K5's mean and rstd from a statistic's two sums over ``n`` elements."""
    mean = sums[0] / n
    var = torch.clamp(sums[1] / n - mean * mean, min=0.0)
    return torch.stack([mean, torch.rsqrt(var + eps)])


def group_stats_plain(x: torch.Tensor, num_groups: int, eps: float = 1e-6) -> torch.Tensor:
    """Plain version of K5's statistics: (2, B*G) float32, the mean and
    rstd of each (batch, group) of channels-first ``x`` (B, C, ...)."""
    n = math.prod(x.shape[1:]) // num_groups
    return _stats_from_sums(group_partials_plain(x, num_groups), n, eps)


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
    rows = group_norm_bwd_partials_plain(x, ct, stats, num_groups)
    s = (weight.float() * rows.view(2, B, C)).view(2, B, num_groups, C // num_groups).sum(-1).view(2, -1)
    coef = _bwd_coefficients(s, stats[1], math.prod(x.shape[1:]) // num_groups)
    dx = group_norm_bwd_apply_plain(x, ct, weight, stats, coef, num_groups)
    return dx, rows[0].view(B, C).sum(0), rows[1].view(B, C).sum(0)


def _bwd_coefficients(s: torch.Tensor, rstd: torch.Tensor, n) -> torch.Tensor:
    """K6's dx coefficients of each group from its S2 and S1 (``s``) over
    ``n`` elements: the factor of x - mean, then the term added."""
    return torch.stack([(-rstd * rstd) * s[0] / n, (-rstd) * s[1] / n])


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
    tracing.count("group_norm.bytes", 2 * x.numel() * x.element_size())  # x read once, y written once
    with tracing.span("group_norm"):
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


# -- the sharded norm: a norm's activations cut over several cards ----------
#
# Each kernel has two more launches (the Mode of csrc/group_norm.cu): a
# partials launch, which writes a shard's share of the sums a statistic
# needs, and an apply launch, which writes the shard's y or dx from
# statistics or coefficients it is given. Nothing is staged in either: each
# reads its inputs once.

_PARTIALS, _APPLY = 1, 2  # the kernels' Mode


def group_norm_apply_plain(x, weight, bias, stats, num_groups) -> torch.Tensor:
    """Plain version of K5's apply launch: y of channels-first ``x`` from the
    (2, B*G) mean and rstd ``stats``."""
    _check_groups(x.shape[1], num_groups)
    return _normalize_plain(x, weight, bias, stats, num_groups)


def group_norm_bwd_partials_plain(x, ct, stats, num_groups) -> torch.Tensor:
    """Plain version of K6's partials launch: (2, B*C) float32, the dw row
    ``rstd * sum(ct * (x - mean))`` and the dbias row ``sum(ct)`` of each
    (batch, channel), about the (2, B*G) mean and rstd ``stats``."""
    B, C = x.shape[:2]
    G = num_groups
    _check_groups(C, G)
    red = tuple(range(2, x.dim()))
    shape = (B, C) + (1,) * len(red)
    xc = x.float() - _per_channel(stats[0], B, C, G).view(shape)
    cf = ct.float()
    dw_rows = _per_channel(stats[1], B, C, G) * (cf * xc).sum(red)
    return torch.stack([dw_rows.reshape(-1), cf.sum(red).reshape(-1)])


def group_norm_bwd_apply_plain(x, ct, weight, stats, coef, num_groups) -> torch.Tensor:
    """Plain version of K6's apply launch: ``dx = rstd * w * ct + coef[0] *
    (x - mean) + coef[1]``, with the (2, B*G) mean and rstd ``stats`` and
    per-group coefficients ``coef`` (2, B*G), in x's dtype."""
    B, C = x.shape[:2]
    G = num_groups
    _check_groups(C, G)
    shape = (B, C) + (1,) * (x.dim() - 2)
    xc = x.float() - _per_channel(stats[0], B, C, G).view(shape)
    a = (_per_channel(stats[1], B, C, G) * weight.float()).view(shape)
    cx = _per_channel(coef[0], B, C, G).view(shape)
    cd = _per_channel(coef[1], B, C, G).view(shape)
    return (a * ct.float() + cx * xc + cd).to(x.dtype)


@functools.lru_cache(maxsize=4096)
def shard_norm_plan(
    shape: Tuple[int, ...],
    num_groups: int,
    channels_last: bool,
    itemsize: int,
    vec: int,
    backward: bool,
    capacity: int,
) -> NormPlan:
    """How a partials or apply launch of K5 (``backward`` False) or K6 cuts
    activations of ``shape`` into blocks, on a card that holds ``capacity``
    co-resident blocks: nothing staged; each unit cut into shares of at
    least ``_MIN_SHARE_BYTES`` of input (K6 NCHW: touching few enough
    channel planes), as many as fill the card with the units of a wave."""
    B, C = shape[0], shape[1]
    HW = math.prod(shape[2:])
    G = num_groups
    vb = vec * itemsize
    units = B if channels_last else B * G
    unit_vectors = (C * HW if channels_last else C // G * HW) // vec
    max_vps = unit_vectors
    if backward and not channels_last:
        max_vps = min(max_vps, (_MAX_BLOCK_CHANNELS - 1) * (HW // vec))
    least = -(-unit_vectors // max_vps)
    if least > capacity:
        raise ValueError(f"shard_norm_plan: {shape} needs {least} blocks a unit, the card holds {capacity}")
    want = -(-unit_vectors // max(1, _MIN_SHARE_BYTES // ((2 if backward else 1) * vb)))
    per_wave = min(units, max(1, capacity // least))
    per_wave = -(-units // -(-units // per_wave))  # the same number of waves, evenly filled
    splits = max(least, min(capacity // per_wave, want))
    vps = -(-unit_vectors // splits)
    splits = -(-unit_vectors // vps)
    piece = max(_PIECE, -(-vps // (_MAX_PIECES - _MAX_BLOCK_CHANNELS))) if backward and not channels_last else 1
    return NormPlan(units=units, unit_vectors=unit_vectors, splits=splits, vectors_per_split=vps, stage_vectors=0,
                    units_per_wave=per_wave, piece=piece, staged_bytes=0)


def _shard_card_plan(x: torch.Tensor, num_groups: int, backward: bool, mode: int,
                     *others: torch.Tensor) -> Tuple[bool, int, NormPlan]:
    """(channels_last, vec, plan) of a partials or apply launch for ``x``."""
    name = "group_norm_bwd" if backward else "group_norm"
    channels_last = _cuda_layout(x, num_groups, name)
    vec = _vector_width(x.shape[1] if channels_last else math.prod(x.shape[2:]), x.element_size(), x, *others)
    key = (x.device.index, backward, mode, x.dtype, vec, channels_last)
    cap = _CAPACITY.get(key)
    if cap is None:
        from .._build import kernels

        out = (ctypes.c_int * 3)()
        with torch.cuda.device(x.device):
            err = kernels().group_norm_shard_capacity(int(backward), mode, _DTYPE_CODES[x.dtype], vec,
                                                      int(channels_last), ctypes.addressof(out))
        if err != 0:
            raise RuntimeError(f"{name}: the sharded kernel's occupancy query failed with CUDA error {err}")
        cap = _CAPACITY[key] = (out[0] * out[1], out[2])
    plan = shard_norm_plan(tuple(x.shape), num_groups, channels_last, x.element_size(), vec, backward, cap[0])
    return channels_last, vec, plan


def _launched(err: int, fn, x: torch.Tensor) -> None:
    if err != 0:
        raise RuntimeError(f"{fn.__name__}: kernel launch failed with CUDA error {err}")
    count_launch(fn, x.device)


def group_norm_partials(x: torch.Tensor, num_groups: int) -> torch.Tensor:
    """K5's partials launch on the card (:func:`group_partials_plain` on the
    CPU): (2, B*G) float32, the sum of x and of x*x of each (batch, group)."""
    if x.device.type == "cpu" or x.numel() == 0:
        return group_partials_plain(x, num_groups)
    channels_last, vec, plan = _shard_card_plan(x, num_groups, False, _PARTIALS)
    B, C = x.shape[:2]
    sums = torch.empty((2, B * num_groups), dtype=torch.float32, device=x.device)
    part = torch.empty((plan.units * plan.splits * (2 * num_groups if channels_last else 2),), dtype=torch.float32,
                       device=x.device)
    from .._build import kernels

    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        counters = _counters(x, stream, plan.units + 1)
        err = kernels().group_norm_partials_launch(
            x.data_ptr(), sums.data_ptr(), part.data_ptr(), counters.data_ptr(), B, C, num_groups,
            math.prod(x.shape[2:]), int(channels_last), _DTYPE_CODES[x.dtype], vec, plan.splits,
            plan.vectors_per_split, plan.units_per_wave, stream)
    _launched(err, group_norm_partials, x)
    return sums


def group_norm_apply(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, stats: torch.Tensor,
                     num_groups: int) -> torch.Tensor:
    """K5's apply launch on the card (:func:`group_norm_apply_plain` on the
    CPU): y in x's dtype and layout from the (2, B*G) mean and rstd."""
    if x.device.type == "cpu" or x.numel() == 0:
        return group_norm_apply_plain(x, weight, bias, stats, num_groups)
    y = torch.empty_like(x)
    channels_last, vec, plan = _shard_card_plan(x, num_groups, False, _APPLY, y)
    w, b = _param(weight, x, "group_norm_apply"), _param(bias, x, "group_norm_apply")
    stats = stats.to(device=x.device, dtype=torch.float32).contiguous()
    B, C = x.shape[:2]
    from .._build import kernels

    with torch.cuda.device(x.device):
        err = kernels().group_norm_apply_launch(
            x.data_ptr(), w.data_ptr(), b.data_ptr(), stats.data_ptr(), y.data_ptr(), B, C, num_groups,
            math.prod(x.shape[2:]), int(channels_last), _DTYPE_CODES[x.dtype], vec, plan.splits,
            plan.vectors_per_split, plan.units_per_wave, torch.cuda.current_stream(x.device).cuda_stream)
    _launched(err, group_norm_apply, x)
    return y


def _ct_like(x: torch.Tensor, ct: torch.Tensor, channels_last: bool) -> torch.Tensor:
    if ct.shape != x.shape:
        raise ValueError(f"group_norm_bwd: cotangent {tuple(ct.shape)} for activations {tuple(x.shape)}")
    return ct.to(x.dtype).contiguous(memory_format=torch.channels_last if channels_last else torch.contiguous_format)


def group_norm_bwd_partials(x: torch.Tensor, ct: torch.Tensor, stats: torch.Tensor, num_groups: int) -> torch.Tensor:
    """K6's partials launch on the card (:func:`group_norm_bwd_partials_plain`
    on the CPU): (2, B*C) float32 dw and dbias rows about the (2, B*G) mean
    and rstd. ``ct`` of any layout is copied into x's first."""
    if x.device.type == "cpu" or x.numel() == 0:
        return group_norm_bwd_partials_plain(x, ct, stats, num_groups)
    ct = _ct_like(x, ct, _cuda_layout(x, num_groups, "group_norm_bwd"))
    channels_last, vec, plan = _shard_card_plan(x, num_groups, True, _PARTIALS, ct)
    B, C = x.shape[:2]
    stats = stats.to(device=x.device, dtype=torch.float32).contiguous()
    rows = torch.empty((2, B * C), dtype=torch.float32, device=x.device)
    slots = (2 * num_groups + 2 * C) if channels_last else (2 + 2 * _MAX_BLOCK_CHANNELS)
    part = torch.empty((plan.units * plan.splits * slots,), dtype=torch.float32, device=x.device)
    from .._build import kernels

    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        counters = _counters(x, stream, plan.units + 1)
        err = kernels().group_norm_bwd_partials_launch(
            x.data_ptr(), ct.data_ptr(), stats.data_ptr(), rows.data_ptr(), part.data_ptr(), counters.data_ptr(),
            B, C, num_groups, math.prod(x.shape[2:]), int(channels_last), _DTYPE_CODES[x.dtype], vec, plan.splits,
            plan.vectors_per_split, plan.units_per_wave, plan.piece, stream)
    _launched(err, group_norm_bwd_partials, x)
    return rows


def group_norm_bwd_apply(x: torch.Tensor, ct: torch.Tensor, weight: torch.Tensor, stats: torch.Tensor,
                         coef: torch.Tensor, num_groups: int) -> torch.Tensor:
    """K6's apply launch on the card (:func:`group_norm_bwd_apply_plain` on
    the CPU): dx in x's dtype and layout."""
    if x.device.type == "cpu" or x.numel() == 0:
        return group_norm_bwd_apply_plain(x, ct, weight, stats, coef, num_groups)
    ct = _ct_like(x, ct, _cuda_layout(x, num_groups, "group_norm_bwd"))
    dx = torch.empty_like(x)
    channels_last, vec, plan = _shard_card_plan(x, num_groups, True, _APPLY, ct, dx)
    B, C = x.shape[:2]
    w = _param(weight, x, "group_norm_bwd_apply")
    stats = stats.to(device=x.device, dtype=torch.float32).contiguous()
    coef = coef.to(device=x.device, dtype=torch.float32).contiguous()
    from .._build import kernels

    with torch.cuda.device(x.device):
        err = kernels().group_norm_bwd_apply_launch(
            x.data_ptr(), ct.data_ptr(), w.data_ptr(), stats.data_ptr(), coef.data_ptr(), dx.data_ptr(), B, C,
            num_groups, math.prod(x.shape[2:]), int(channels_last), _DTYPE_CODES[x.dtype], vec, plan.splits,
            plan.vectors_per_split, plan.units_per_wave, plan.piece, torch.cuda.current_stream(x.device).cuda_stream)
    _launched(err, group_norm_bwd_apply, x)
    return dx


for _fn in (group_norm_partials, group_norm_apply, group_norm_bwd_partials, group_norm_bwd_apply):
    _fn.launches = 0


@dataclass(frozen=True)
class _Units:
    """A shard's channels [offset, offset + channels) of a norm whose groups
    have ``group_channels`` each, cut into ``count`` units of ``width``
    channels that each lie within one group: the shard's tensor is normed
    as one of ``count`` groups, and ``lead`` units of its first group lie
    before it (on another shard)."""

    offset: int
    channels: int
    group_channels: int

    @property
    def width(self) -> int:
        return math.gcd(math.gcd(self.offset, self.channels), self.group_channels)

    @property
    def count(self) -> int:
        return self.channels // self.width

    @property
    def per_group(self) -> int:
        return self.group_channels // self.width

    @property
    def lead(self) -> int:
        return self.offset % self.group_channels // self.width

    @property
    def first(self) -> int:
        return self.offset // self.group_channels

    @property
    def groups(self) -> int:
        return -(-(self.lead + self.count) // self.per_group)

    def fold(self, v: torch.Tensor, G: int) -> torch.Tensor:
        """(k, B*count) per-unit values → (k, B, G): summed over each group's
        units in order, zero in the groups the shard does not touch."""
        k = v.shape[0]
        v = v.view(k, -1, self.count)
        v = F.pad(v, (self.lead, self.groups * self.per_group - self.lead - self.count))
        v = v.view(k, v.shape[1], self.groups, self.per_group).sum(-1)
        return F.pad(v, (self.first, G - self.first - self.groups))

    def unfold(self, v: torch.Tensor) -> torch.Tensor:
        """(k, B, G) per-group values → (k, B*count) per unit."""
        idx = (self.offset + torch.arange(self.count, device=v.device) * self.width) // self.group_channels
        return v.index_select(2, idx).reshape(v.shape[0], -1)


def _ordered_sum(parts, device) -> torch.Tensor:
    """The parts summed on ``device`` in the order given."""
    total = parts[0].to(device)
    for p in parts[1:]:
        total = total + p.to(device)
    return total


def _sum_shards(parts, ranks, link, device) -> torch.Tensor:
    """The shards' parts (this process's; None for the others') summed on
    ``device`` in shard order. Where other processes hold shards
    (``ranks``), each process sends its parts to the others first, so that
    every process of the norm sums the same parts in the same order."""
    if link is not None:
        me = link.rank
        mine = [p for p, r in zip(parts, ranks) if r == me]
        peers = sorted(set(ranks) - {me})
        shape = mine[0].shape
        got = exchange({q: mine for q in peers},
                       {q: [(shape, torch.float32, device) for r in ranks if r == q] for q in peers}, link.stage)
        seen = dict.fromkeys(peers, 0)
        parts = list(parts)
        for i, r in enumerate(ranks):
            if r != me:
                parts[i] = got[r][seen[r]]
                seen[r] += 1
    return _ordered_sum(parts, device)


class _ShardedGroupNorm(torch.autograd.Function):
    """The sharded norm's forward (K5's partials and apply launches) and
    backward (K6's), over shards on any devices. With a ``link`` some
    shards lie in other processes (``ranks``; here they are ``meta``
    tensors of their shapes): each process launches on its own shards, the
    per-group sums cross processes (:func:`_sum_shards`), and a token
    orders the crossing among the others of the forward
    (``parallel.multihost.Link``): the outputs are then (token, *ys)."""

    @staticmethod
    def forward(ctx, units, num_groups, eps, ranks, link, token, *tensors):
        k = len(units)
        xs, ws, bs = tensors[:k], tensors[k:2 * k], tensors[2 * k:]
        G = num_groups
        mine = [not x.is_meta for x in xs]
        root = next(x.device for x, m in zip(xs, mine) if m)
        n = torch.zeros(G, dtype=torch.float64)
        for x, u in zip(xs, units):
            spatial = math.prod(x.shape[2:])
            for c0 in range(u.offset, u.offset + u.channels, u.width):
                n[c0 // u.group_channels] += u.width * spatial
        n = n.clamp(min=1).float().to(root)
        parts = [u.fold(group_norm_partials(x, u.count), G) if m else None for x, u, m in zip(xs, units, mine)]
        sums = _sum_shards(parts, ranks, link, root)
        stats = _stats_from_sums(sums, n.view(1, G), eps)  # (2, B, G)
        local = [u.unfold(stats.to(x.device)) if m else None for x, u, m in zip(xs, units, mine)]
        ys = [group_norm_apply(x, w, b, st, u.count) if m else torch.empty_like(x)
              for x, w, b, st, u, m in zip(xs, ws, bs, local, units, mine)]
        ctx.save_for_backward(*xs, *ws, *local, stats, n)
        ctx.units, ctx.num_groups, ctx.ranks, ctx.link = units, G, ranks, link
        ctx.meta = [(w.device, w.dtype, b.device, b.dtype) for w, b in zip(ws, bs)]
        return tuple(ys) if link is None else (token.new_zeros(()), *ys)

    @staticmethod
    @once_differentiable
    def backward(ctx, *grads):
        units, G, link = ctx.units, ctx.num_groups, ctx.link
        dys = grads if link is None else grads[1:]
        k = len(units)
        saved = ctx.saved_tensors
        xs, ws, local, (stats, n) = saved[:k], saved[k:2 * k], saved[2 * k:3 * k], saved[3 * k:]
        mine = [not x.is_meta for x in xs]
        B = xs[0].shape[0]
        dys = [dy if dy is not None or not m else torch.zeros_like(x) for dy, x, m in zip(dys, xs, mine)]
        rows = [group_norm_bwd_partials(x, dy, st, u.count) if m else None
                for x, dy, st, u, m in zip(xs, dys, local, units, mine)]
        # S2 and S1 of each group: w times the dw and dbias rows, summed over
        # each unit's channels, then over the units of a group and the shards.
        parts = []
        for r, w, u in zip(rows, ws, units):
            if r is None:
                parts.append(None)
                continue
            t = r.view(2, B, u.channels) * w.detach().to(r.device, torch.float32)
            parts.append(u.fold(t.view(2, B, u.count, u.width).sum(-1).view(2, -1), G))
        coef = _bwd_coefficients(_sum_shards(parts, ctx.ranks, link, stats.device), stats[1], n)
        dxs = [group_norm_bwd_apply(x, dy, w, st, u.unfold(coef.to(x.device)), u.count) if m else None
               for x, dy, w, st, u, m in zip(xs, dys, ws, local, units, mine)]
        dws, dbs = [], []
        for r, u, (wd, wt, bd, bt) in zip(rows, units, ctx.meta):
            if r is None:
                dws.append(None)
                dbs.append(None)
                continue
            r = r.view(2, B, u.channels).sum(1)
            dws.append(r[0].to(wd, wt))
            dbs.append(r[1].to(bd, bt))
        dtoken = None if link is None else torch.zeros((), device=link.token_device)
        return (None, None, None, None, None, dtoken, *dxs, *dws, *dbs)


def sharded_group_norm(xs, weights, biases, offsets, num_channels: int, num_groups: int,
                       eps: float = 1e-6, ranks=None, link=None) -> List[torch.Tensor]:
    """GroupNorm of activations cut into shards, one tensor a card:
    differentiable in every shard, weight and bias.

    Shard i holds channels ``offsets[i] .. offsets[i] + xs[i].shape[1]`` of
    a ``num_channels``-channel activation and some of its spatial elements
    (rows of a ``space`` shard); together the shards hold each element of
    the groups they touch once. Each group's statistics span every shard
    that holds its channels: a group may straddle shards of channels. Each
    shard's K5 partials launch writes its share of each group's two sums,
    the shards' shares are summed on the first shard's device in shard
    order into K5's mean and rstd, and each shard's K5 apply launch writes
    its y. The backward likewise: K6's partials launch writes each shard's
    dw and dbias rows, their sums give S1 and S2 of each group, and K6's
    apply launch writes dx. On the CPU the launches' plain versions run.

    Args:
        xs: (B, C_i, *spatial_i) activations; on the card NCHW-contiguous
            or channels_last.
        weights, biases: the (C_i,) affine parameters of each shard's
            channels.
        offsets: the first channel of each shard.
        num_channels, num_groups: C and G of the whole norm.
        ranks, link: where shards lie in other processes, the rank of each
            shard's process and the forward's ``parallel.multihost.Link``;
            another process's shard is a ``meta`` tensor of its shape (and
            so are its weight and bias). Each process launches on its own
            shards, every process of the norm sums every shard's partials
            in shard order, and the sums cross processes through ``link``
            in the forward and again in the backward.

    Returns:
        y of each shard, in its dtype and layout (``meta`` for another
        process's shard).
    """
    _check_groups(num_channels, num_groups)
    Cg = num_channels // num_groups
    units = []
    for x, o in zip(xs, offsets):
        if o < 0 or o + x.shape[1] > num_channels:
            raise ValueError(f"sharded_group_norm: channels {o}..{o + x.shape[1]} of {num_channels}")
        units.append(_Units(o, x.shape[1], Cg))
    if ranks is None or link is None or all(r == link.rank for r in ranks):
        return list(_ShardedGroupNorm.apply(tuple(units), num_groups, eps, None, None, None, *xs, *weights, *biases))
    if link.rank not in ranks:  # no shard here
        return [torch.empty_like(x) for x in xs]
    out = _ShardedGroupNorm.apply(tuple(units), num_groups, eps, tuple(ranks), link, link.token, *xs, *weights,
                                  *biases)
    link.sync(out[0])
    return list(out[1:])
