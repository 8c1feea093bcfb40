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
kernel, and the wrapper raises if it does not launch. The kernel has two
routes (:func:`region_measure_plan` chooses before the launch): its
accumulators in shared memory wherever R < 2^15, W <= 2^16 and a strip of
rows fits a block (every shape a path of the port measures), else in device
memory (any R and W). ``region_histogram.launches`` counts the kernel's
launches that write a histogram, this function's and the measurement's;
``launches_by_route`` counts them by route.
"""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass
from typing import Optional

import torch

from .row_scan import _check_cuda, _raise_on, count_launch

__all__ = [
    "region_histogram",
    "region_histogram_plain",
    "region_measure",
    "region_measure_plan",
    "measure_layout",
    "MeasurePlan",
]


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


# csrc/region_measure.cu's limits and shared-memory budgets, mirrored by
# region_measure_plan (tests/test_torch_region_plan.py holds them to the
# source).
_TWO_BLOCKS = 112 * 1024  # kTwoBlocks: a block's bytes that leave two an SM
_ONE_BLOCK = 232448  # kOneBlock: the 227 KB a block may use
_HIST_SHARED = 48 * 1024  # kHistShared: the packed histogram's budget
_PACKED = 65535  # kPacked: a 16-bit count's largest value
_ROW_IX_MAX_W = 5803  # kRowIxMaxW: a row's Σ I·x in 32 bits
_MAX_R = 1 << 15  # the shared route's ids: R < 2^15
_MAX_W = 1 << 16  # the shared route's widths, and a row x-sum's in int32


def _r16(n: int) -> int:
    return -(-n // 16) * 16


@dataclass(frozen=True)
class MeasurePlan:
    """How the region-measurement kernel runs a call: ``strip`` rows a strip
    of ``smem`` shared bytes a block (the packed histogram in shared memory
    where ``hist_shared``) on the shared-memory route; all 0 on the
    device-memory route."""

    strip: int
    smem: int
    hist_shared: bool

    @property
    def route(self) -> str:
        return "shared memory" if self.strip else "device memory"


def measure_layout(W: int, R: int, strip: int, partials: bool, intensity: bool, hist_shared: bool) -> int:
    """Shared bytes a block of the shared-memory route takes for strips of
    ``strip`` rows (``layout`` of csrc/region_measure.cu): the staged label
    rows with a halo row each side and intensity rows; the per-region sums
    of I, I·y, I·x; the packed histogram; the per-(row, region)
    accumulators; the columns' runs; the perimeter units."""
    P, I = partials, intensity
    off = (strip + 2) * _r16(4 * W + 32) + (strip * _r16(W + 32) if I else 0)
    if P and I:
        off += _r16(3 * R * 8)
    if hist_shared:
        off += R * 128 * 4
    if P:
        words = 5 + (W <= _ROW_IX_MAX_W) if I else 4
        off += _r16(words * strip * R * 4) + _r16(W * 4) + _r16(2 * R * 4)
    return off


@functools.lru_cache(maxsize=1024)
def region_measure_plan(W: int, R: int, partials: bool, intensity: bool) -> MeasurePlan:
    """The route of the region-measurement kernel for frames of W columns
    and R ids, with the partials and / or the histogram (intensity): the
    launcher's ``choose_strip`` replayed. The tallest strip of 16, 8, 4 rows
    whose layout (:func:`measure_layout`) leaves two blocks an SM, else the
    tallest of 16 ... 1 that fits one; the packed histogram (R ≤ 96) needs a
    strip of at most 65535 pixels and is given up before no strip fits.
    Where R ≥ 2^15, W > 2^16 or no strip fits: the device-memory route."""
    if R < _MAX_R and W <= _MAX_W:
        hist_options = (True, False) if intensity and R * 128 * 4 <= _HIST_SHARED else (False,)
        for hist_shared in hist_options:
            for budget, heights in ((_TWO_BLOCKS, (16, 8, 4)), (_ONE_BLOCK, (16, 8, 4, 2, 1))):
                for th in heights:
                    smem = measure_layout(W, R, th, partials, intensity, hist_shared)
                    if smem <= budget and not (hist_shared and th * W > _PACKED):
                        return MeasurePlan(th, smem, hist_shared)
    return MeasurePlan(0, 0, False)


def region_measure(labels: torch.Tensor, intensity: Optional[torch.Tensor], num_segments: int, partials: bool):
    """Launch the region-measurement kernel once on contiguous (B, H, W)
    int32 labels and uint8 intensity (or None) on the card, on the route of
    :func:`region_measure_plan`.

    Returns ``(partials, hist)``: with ``partials`` the (B, R, 5) int64 sums
    (perimeter units n1 and n065, Σ I, Σ I·y, Σ I·x), the (B, H, R) int32
    row count, x-sum (int64 where W > 2^16), x-min (W if absent) and x-max
    (-1 if absent) and the (B, W, R) int32 column count, else None; the
    (B, R, 256) int32 histogram with intensity, else None. Counts the launch
    on ``region_histogram.launches`` when it writes a histogram; the caller
    counts the partials.
    """
    B, H, W = labels.shape
    R = num_segments
    dev = labels.device
    plan = region_measure_plan(W, R, partials, intensity is not None)
    wide = partials and plan.route == "device memory" and W > _MAX_W
    n_sums = 2 * B * R * 5 if partials else 0  # int64 as int32 pairs, first (8-B aligned)
    n_sumx = 2 * B * H * R if wide else 0  # int64 row x-sums, next
    n_col = B * W * R if partials else 0
    n_hist = B * R * 256 if intensity is not None else 0
    # The outputs that blocks add to lie in one buffer, with the kernel's B
    # strip counters last, zeroed by its launcher (one memset) or by the
    # blocks themselves.
    zero = torch.empty(n_sums + n_sumx + n_col + n_hist + B, dtype=torch.int32, device=dev)
    o_col = n_sums + n_sumx
    hist = zero[o_col + n_col : o_col + n_col + n_hist].view(B, R, 256) if n_hist else None
    sums = rows = colcnt = sumx64 = None
    if partials:
        sums = zero[:n_sums].view(torch.int64).view(B, R, 5)
        rows = torch.empty((4, B, H, R), dtype=torch.int32, device=dev)
        colcnt = zero[o_col : o_col + n_col].view(B, W, R)
    if wide:
        sumx64 = zero[n_sums:o_col].view(torch.int64).view(B, H, R)
    from .._build import kernels

    def ptr(t):
        return 0 if t is None else t.data_ptr()

    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = kernels().region_measure_launch(
            labels.data_ptr(), ptr(intensity), ptr(sums), ptr(rows), ptr(colcnt), ptr(hist), ptr(sumx64),
            zero.data_ptr(), 4 * zero.numel(), B, H, W, R, plan.strip, stream,
        )
    _raise_on("region_measure", err)
    if hist is not None:
        count_launch(region_histogram, dev, plan.route)
    if not partials:
        return None, hist
    return (sums, rows[0], rows[1] if sumx64 is None else sumx64, rows[2], rows[3], colcnt), hist
