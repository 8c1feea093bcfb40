"""Connected-component labelling (CCL) and label utilities.

Counterpart of ``maze_image_processing_pipeline_tpu/ops/label.py``, with the
same results:

1. **Init** — every foreground pixel takes its linear index + 1 as label.
2. **Propagate** — sweeps of horizontal pass, vertical pass down, vertical
   pass up, horizontal pass, to a fixpoint capped at ``max_iters`` sweeps
   (:func:`_fixpoint`). On the card the whole fixpoint is one CUDA launch
   (``csrc/ccl.cu``: one block per frame loops the sweeps itself and stops
   when a sweep changes nothing, with no host synchronisation; rows wider
   than 8192 take the banded route, ``csrc/ccl_banded.cu``: bands of a frame
   in co-resident blocks that exchange their edges through device memory,
   :func:`ccl_route`; a frame whose bands the card cannot hold at once takes
   the grid route, ``csrc/ccl_grid.cu``: every block of the card on each row
   of the vertical pass in turn, the grid synchronised once a row); its plain
   version :func:`fixpoint_plain` runs the sweeps of the horizontal pass
   (:func:`.row_scan.hpass_plain`, K1) and :func:`vertical_pass_plain` (K4).
   Both passes also stand alone on the card (:func:`.row_scan.hpass`,
   :func:`vertical_pass`), over the same device code.
3. **Compact** — each component's final label is the linear index of its
   raster-first pixel, so the raster rank of the roots (a per-row prefix
   sum, :func:`.row_scan.cumsum_rows`, plus a prefix sum of row totals) gives
   consecutive ids in scipy/skimage order; the rank spreads through each
   component with the same sweep.

On the card :func:`label` makes no host synchronisation: ``n_regions``
stays a device tensor.

Region tables (areas, border contact, the id remap) count with
:func:`_per_frame_bincount` and ``gather`` over the region axis instead of
one-hot compares; on the card the count reads nothing back to the host.
:func:`remove_small_objects` is one CUDA launch on the card (K8,
``csrc/relabel.cu``: one thread-block cluster a frame, each label read once
wherever the frame fits the cluster's shared memory; :func:`relabel_plan`
chooses the cluster size and the staged pixels), or three where R's bins
and table do not fit a block's shared memory (the device-memory route).

Each kernel's wrapper takes the plain PyTorch version (``*_plain``, in this
module or :mod:`.row_scan`) for a tensor on the CPU; a CUDA tensor always
launches the kernel, and the wrapper raises if the kernel does not take it
or does not launch. ``_fixpoint.launches``, ``vertical_pass.launches`` and
``remove_small_objects.launches`` count the launches.
"""

from __future__ import annotations

import ctypes
import functools
import math
import threading
from dataclasses import dataclass
from typing import Dict, Tuple

import torch

from .. import tracing
from .row_scan import INF, _check_cuda, _raise_on, count_launch, cumsum_rows, hpass_plain

__all__ = [
    "label",
    "vertical_pass",
    "vertical_pass_plain",
    "fixpoint_plain",
    "remove_small_objects",
    "remove_small_objects_plain",
    "remove_small_objects_plan",
    "relabel_plan",
    "RelabelPlan",
    "ccl_route",
    "ccl_route_of",
    "CclRoute",
    "clear_border",
    "region_areas",
    "per_frame_bincount_plain",
]

# Widest band one block of the fixpoint or of the 8-connected pass walks
# (csrc/ccl_rows.cuh: `plan`, 512 walker threads of 16 columns), a multiple
# of 32; wider rows take the banded route.
CCL_BAND = 8192
# The banded route's narrowest band: a band's rows cost more a column the
# wider it is (16 columns a walker thread and fewer ring stages past 4096),
# so wide rows take bands of 512 columns while the card holds them all.
CCL_BAND_MIN = 512
# Columns a warp of the grid route's K1 stages at once (csrc/ccl_grid.cu:
# kGridChunk) and the bytes of its chunk summary (ChunkSum).
CCL_GRID_CHUNK = 1024
_GRID_CHUNK_SUM_BYTES = 32
# cudaErrorCooperativeLaunchTooLarge: the card cannot hold a frame's bands.
_TOO_MANY_BANDS = 720


@dataclass(frozen=True)
class CclRoute:
    """How the CCL fixpoint (and the 8-connected pass alone) runs on the
    card: ``"one_block"``, a block a frame; ``"banded"``, ``bands`` bands
    of ``band`` columns a frame (the last one narrower), a block each, which
    exchange through a workspace of ``slots`` 16-byte slots; or ``"grid"``,
    every block of the card on each row in turn (K1 in ``bands`` chunks of
    ``band`` columns a row), with ``slots`` 16-byte slots of scratch."""

    route: str
    band: int
    bands: int
    slots: int


def ccl_route(B: int, H: int, W: int, connectivity: int, sms: int) -> CclRoute:
    """The one place the fixpoint's route is chosen, for B frames of H × W,
    ``connectivity`` (1 or 2) and a card of ``sms`` multiprocessors (one
    block of the walk each). Rows of at most ``CCL_BAND`` columns take one
    block a frame. Wider rows take bands of ``CCL_BAND_MIN`` columns, or as
    many more as keep a frame's bands within ``sms`` blocks, at most
    ``CCL_BAND``; then bands of equal width rounded up to a multiple of 32.
    The workspace holds, for each frame and band, K1's row summaries of both
    passes and two stop flags, and 8-connected K4's edge carries of both
    passes and both sides (``unit_slots`` of csrc/ccl_banded.cu). Where a
    frame would need more than ``sms`` bands (the banded route holds a band
    a block and every band of a frame resident at once), the grid route
    takes it; its scratch is a sweep counter a frame and K1's summary of
    each chunk of ``CCL_GRID_CHUNK`` columns (csrc/ccl_grid.cu)."""
    if W <= CCL_BAND:
        return CclRoute("one_block", W, 1, 0)
    band = min(CCL_BAND, max(CCL_BAND_MIN, -(-W // sms)))
    even = -(-W // -(-W // band))
    band = -(-even // 32) * 32
    bands = -(-W // band)
    if bands > sms:
        chunks = -(-W // CCL_GRID_CHUNK)
        nbytes = 32 * -(-B // 8) + _GRID_CHUNK_SUM_BYTES * B * H * chunks
        return CclRoute("grid", CCL_GRID_CHUNK, chunks, nbytes // 16)
    unit = 2 * H + 2 + (4 * H if connectivity == 2 else 0)
    return CclRoute("banded", band, bands, B * bands * unit)


@functools.lru_cache(maxsize=None)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def ccl_route_of(t: torch.Tensor, connectivity: int) -> CclRoute:
    """:func:`ccl_route` for the (..., H, W) tensor ``t`` on its card."""
    H, W = t.shape[-2:]
    return ccl_route(math.prod(t.shape[:-2]), H, W, connectivity, _sms(t.device.index))


# The banded route's workspace for each (device, stream): [int64 tensor of
# 16-byte slots, zeroed when made; the epoch of the last call]. Host threads
# that launch on the same stream share it, so the lock hands each call an
# epoch of its own: two calls with one epoch would read each other's slots.
_EXCHANGE: Dict[Tuple[int, int], list] = {}
_EXCHANGE_LOCK = threading.Lock()


def _exchange(device: torch.device, stream: int, slots: int) -> Tuple[torch.Tensor, int]:
    """The workspace of the banded route for ``device`` and ``stream``, of at
    least ``slots`` slots, and this call's epoch (1, 2, ...), distinct from
    every other call's on that stream since the workspace was last zeroed.
    Every slot carries the epoch of the call that wrote it, so nothing is
    zeroed between calls: only when the workspace is made, grown, or its
    epochs would pass 32 bits (on ``stream``, behind the calls before)."""
    key = (device.index, stream)
    with _EXCHANGE_LOCK:
        entry = _EXCHANGE.get(key)
        if entry is None or entry[0].numel() < 2 * slots:
            entry = _EXCHANGE[key] = [torch.zeros(max(2 * slots, 1 << 16), dtype=torch.int64, device=device), 0]
        epoch = entry[1] + 1
        if epoch >= 2**32:
            entry[0].zero_()
            epoch = 1
        entry[1] = epoch
        return entry[0], epoch


def _raise_on_banded(name: str, err: int, W: int, route: CclRoute) -> None:
    if err == _TOO_MANY_BANDS and route.route == "banded":
        raise ValueError(f"{name}: rows of {W} need {route.bands} bands of {route.band} columns resident at once; "
                         "the card holds fewer")
    _raise_on(name, err)


def vertical_pass_plain(lab: torch.Tensor, fg: torch.Tensor, connectivity: int, reverse: bool):
    """Plain version of K4: row-sequential min propagation through
    foreground (with diagonal links for 8-connectivity), top to bottom or
    bottom to top."""
    H = lab.shape[-2]
    fg = fg.bool()
    out = torch.empty_like(lab)
    carry = torch.full_like(lab[..., 0, :], INF)
    order = range(H - 1, -1, -1) if reverse else range(H)
    for r in order:
        neigh = carry
        if connectivity == 2:
            neigh = carry.clone()
            neigh[..., 1:] = torch.minimum(neigh[..., 1:], carry[..., :-1])
            neigh[..., :-1] = torch.minimum(neigh[..., :-1], carry[..., 1:])
        carry = torch.where(fg[..., r, :], torch.minimum(lab[..., r, :], neigh), INF)
        out[..., r, :] = carry
    return out


def vertical_pass(lab: torch.Tensor, fg: torch.Tensor, connectivity: int, reverse: bool) -> torch.Tensor:
    """CCL vertical pass over (..., H, W) frames (K4).

    Args:
        lab: int32 labels (..., H, W).
        fg: bool or uint8 foreground mask of the same shape.
        connectivity: 2 = 8-connected (diagonal links), 1 = 4-connected.
        reverse: walk the rows bottom to top.

    Returns:
        int32 (..., H, W): after each row, the running minimum carried
        through foreground from the previous row; ``2**30`` on background.
    """
    if lab.dtype != torch.int32:
        raise TypeError(f"vertical_pass: labels must be int32, got {lab.dtype}")
    if fg.dtype not in (torch.bool, torch.uint8):
        raise TypeError(f"vertical_pass: mask must be bool or uint8, got {fg.dtype}")
    if lab.shape != fg.shape or lab.dim() < 2:
        raise ValueError(f"vertical_pass: need equal (..., H, W) shapes, got {tuple(lab.shape)} and {tuple(fg.shape)}")
    if connectivity not in (1, 2):
        raise ValueError("vertical_pass: connectivity must be 1 or 2")
    if lab.device.type == "cpu":
        return vertical_pass_plain(lab, fg, connectivity, reverse)
    _check_cuda("vertical_pass", lab, fg)
    H, W = lab.shape[-2:]
    B = math.prod(lab.shape[:-2])
    out = torch.empty_like(lab)
    if out.numel() == 0:
        return out
    from .._build import kernels

    # 4-connected columns are independent (bands of 256 columns); 8-connected
    # rows wider than a block walks take the banded or the grid route.
    route = ccl_route_of(lab, 2) if connectivity == 2 else CclRoute("one_block", W, 1, 0)
    with torch.cuda.device(lab.device):
        stream = torch.cuda.current_stream(lab.device).cuda_stream
        if route.route == "one_block":
            err = kernels().vertical_pass_launch(
                lab.data_ptr(), fg.data_ptr(), out.data_ptr(), B, H, W, connectivity, int(reverse), stream,
            )
        elif route.route == "grid":
            err = kernels().ccl_grid_launch(
                lab.data_ptr(), fg.data_ptr(), out.data_ptr(), None, None, B, H, W, 2, 0, int(reverse), 0, stream,
            )
        else:
            ws, epoch = _exchange(lab.device, stream, route.slots)
            err = kernels().vertical_pass_banded_launch(
                lab.data_ptr(), fg.data_ptr(), out.data_ptr(), ws.data_ptr(), B, H, W, route.band, int(reverse),
                epoch, stream,
            )
    _raise_on_banded("vertical_pass", err, W, route)
    count_launch(vertical_pass, lab.device)
    return out


vertical_pass.launches = 0


def _sweep_plain(lab: torch.Tensor, fg: torch.Tensor, connectivity: int) -> torch.Tensor:
    lab = hpass_plain(lab, fg)
    lab = vertical_pass_plain(lab, fg, connectivity, reverse=False)
    lab = vertical_pass_plain(lab, fg, connectivity, reverse=True)
    return hpass_plain(lab, fg)


def fixpoint_plain(lab0: torch.Tensor, fg: torch.Tensor, connectivity: int, max_iters: int):
    """Plain version of the fixpoint kernel: sweeps of the whole batch until
    no pixel changes or ``max_iters`` sweeps have run (at least one). The
    sweeps of a frame are counted as the same loop run on that frame alone
    would count them: a frame that stopped changing is a fixed point of the
    sweep, so the batch's further sweeps leave it as it is."""
    lab = _sweep_plain(lab0, fg, connectivity)
    sweeps = torch.ones(lab.shape[0], dtype=torch.int32, device=lab.device)
    active = (lab != lab0).flatten(1).any(1)
    i = 1
    while i < max_iters and bool(active.any()):
        nxt = _sweep_plain(lab, fg, connectivity)
        sweeps += active.to(torch.int32)
        active &= (nxt != lab).flatten(1).any(1)
        lab = nxt
        i += 1
    return lab, sweeps


def _fixpoint(lab0: torch.Tensor, fg: torch.Tensor, connectivity: int, max_iters: int):
    """The CCL fixpoint over (B, H, W) frames: sweeps of horizontal pass,
    vertical pass down, vertical pass up, horizontal pass, until no pixel of
    a frame changes or ``max_iters`` sweeps have run (at least one).

    Args:
        lab0: int32 (B, H, W) seed labels.
        fg: bool or uint8 foreground mask of the same shape.
        connectivity: 2 = 8-connected, 1 = 4-connected.
        max_iters: cap on the sweeps of each frame.

    Returns:
        (labels, sweeps): int32 (B, H, W), and int32 (B,) the sweeps each
        frame ran. On the card one launch (``csrc/ccl.cu``, or
        ``csrc/ccl_banded.cu`` on the banded route, ``csrc/ccl_grid.cu`` on
        the grid route; :func:`ccl_route` picks),
        updating a copy of ``lab0`` in place; nothing is read back.
    """
    if lab0.dtype != torch.int32:
        raise TypeError(f"_fixpoint: labels must be int32, got {lab0.dtype}")
    if fg.dtype not in (torch.bool, torch.uint8):
        raise TypeError(f"_fixpoint: mask must be bool or uint8, got {fg.dtype}")
    if lab0.shape != fg.shape or lab0.dim() != 3:
        raise ValueError(f"_fixpoint: need equal (B, H, W) shapes, got {tuple(lab0.shape)} and {tuple(fg.shape)}")
    if connectivity not in (1, 2):
        raise ValueError("_fixpoint: connectivity must be 1 or 2")
    if lab0.device.type == "cpu":
        return fixpoint_plain(lab0, fg, connectivity, max_iters)
    _check_cuda("_fixpoint", lab0, fg)
    B, H, W = lab0.shape
    lab = lab0.clone()
    if lab.numel() == 0:
        return lab, torch.ones((B,), dtype=torch.int32, device=lab.device)
    sweeps = torch.empty((B,), dtype=torch.int32, device=lab.device)
    route = ccl_route_of(lab, connectivity)
    from .._build import kernels

    with torch.cuda.device(lab.device):
        stream = torch.cuda.current_stream(lab.device).cuda_stream
        if route.route == "one_block":
            err = kernels().ccl_fixpoint_launch(
                lab.data_ptr(), fg.data_ptr(), sweeps.data_ptr(), B, H, W, connectivity, int(max_iters), stream
            )
        elif route.route == "grid":
            ws = torch.empty((2 * route.slots,), dtype=torch.int64, device=lab.device)
            err = kernels().ccl_grid_launch(
                lab.data_ptr(), fg.data_ptr(), None, sweeps.data_ptr(), ws.data_ptr(), B, H, W, connectivity, 1, 0,
                int(max_iters), stream,
            )
        else:
            ws, epoch = _exchange(lab.device, stream, route.slots)
            err = kernels().ccl_fixpoint_banded_launch(
                lab.data_ptr(), fg.data_ptr(), sweeps.data_ptr(), ws.data_ptr(), B, H, W, route.band, connectivity,
                int(max_iters), epoch, stream,
            )
    _raise_on_banded("_fixpoint", err, W, route)
    count_launch(_fixpoint, lab.device)
    return lab, sweeps


_fixpoint.launches = 0


@tracing.span("label")
def label(
    mask: torch.Tensor, connectivity: int = 2, max_iters: int = 256
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Label connected components of a boolean mask.

    Args:
        mask: (..., H, W) foreground mask.
        connectivity: 2 = 8-connected, 1 = 4-connected.
        max_iters: cap on the fixpoint sweeps (blob-like masks converge in
            1-2; a serpentine needs about one per switchback).

    Returns:
        (labels, n_regions): int32 labels in [0, R], 0 = background, in
        raster order; int32 (...,) component counts.
    """
    if connectivity not in (1, 2):
        raise ValueError("connectivity must be 1 or 2")
    H, W = mask.shape[-2:]
    batch_shape = mask.shape[:-2]
    # The mask read once, the int32 labels and counts written once.
    tracing.count("label.bytes", mask.numel() * (mask.element_size() + 4) + 4 * math.prod(batch_shape))
    fg = mask.bool().reshape(-1, H, W).contiguous()
    dev = fg.device

    lin = torch.arange(H * W, dtype=torch.int32, device=dev).reshape(1, H, W)
    lab0 = torch.where(fg, lin + 1, INF)
    lab, _ = _fixpoint(lab0, fg, connectivity, max_iters)

    # Compaction: rank the roots in raster order, then spread the rank.
    is_root = fg & (lab == lin + 1)
    within_row = cumsum_rows(is_root.to(torch.int32))
    row_counts = within_row[..., -1]  # (B, H)
    row_prefix_incl = torch.cumsum(row_counts, dim=1, dtype=torch.int32)
    ranks = within_row + (row_prefix_incl - row_counts)[..., None]
    n_regions = row_prefix_incl[..., -1]  # (B,)

    rank_seed = torch.where(is_root, ranks, INF)
    rank_img, _ = _fixpoint(rank_seed, fg, connectivity, max_iters)
    compact = torch.where(fg, rank_img, 0)
    return compact.reshape(batch_shape + (H, W)), n_regions.reshape(batch_shape)


def per_frame_bincount_plain(values: torch.Tensor, num_segments: int) -> torch.Tensor:
    """Plain version of :func:`_per_frame_bincount`: one ``bincount`` over
    the frames' ids offset into a bin range each, ids outside
    [0, num_segments) into a dump bin."""
    B = values.shape[0]
    v = values.reshape(B, -1).long()
    ok = (v >= 0) & (v < num_segments)
    offs = torch.arange(B, device=v.device)[:, None] * (num_segments + 1)
    idx = torch.where(ok, v, num_segments) + offs
    counts = torch.bincount(idx.reshape(-1), minlength=B * (num_segments + 1))
    return counts.reshape(B, num_segments + 1)[:, :num_segments].to(torch.int32)


def _per_frame_bincount(values: torch.Tensor, num_segments: int) -> torch.Tensor:
    """(B, N) int ids → (B, num_segments) int32 counts; ids outside
    [0, num_segments) are not counted.

    On the card one ``torch.histc`` over the ids offset into a bin range a
    frame (ids out of range below its range), whose bounds are given, so
    nothing is read back to the host (``torch.bincount`` reads its input's
    minimum and maximum to size its output). On the CPU, where ``histc``
    takes no integers, :func:`per_frame_bincount_plain`."""
    B = values.shape[0]
    v = values.reshape(B, -1)
    if v.device.type == "cpu":
        return per_frame_bincount_plain(v, num_segments)
    bins = B * num_segments
    if bins == 0:
        return torch.zeros((B, num_segments), dtype=torch.int32, device=v.device)
    if v.dtype not in (torch.int32, torch.int64):
        v = v.long()  # as the plain version reads them
    ok = (v >= 0) & (v < num_segments)
    kt = torch.int32 if bins < 2**31 else torch.int64
    offs = torch.arange(B, device=v.device, dtype=kt)[:, None] * num_segments
    keys = torch.where(ok, v.to(kt) + offs, -1)
    return torch.histc(keys.reshape(-1), bins=bins, min=0, max=bins).reshape(B, num_segments).to(torch.int32)


def region_areas(labels: torch.Tensor, num_segments: int) -> torch.Tensor:
    """Pixel counts per label id (index 0 = background), batched."""
    H, W = labels.shape[-2:]
    batch_shape = labels.shape[:-2]
    out = _per_frame_bincount(labels.reshape(-1, H * W), num_segments)
    return out.reshape(batch_shape + (num_segments,))


def _relabel_keep(labels: torch.Tensor, keep: torch.Tensor) -> torch.Tensor:
    """Relabel so kept ids become consecutive (raster order kept); ids at or
    beyond ``keep.shape[-1]`` map to 0."""
    R = keep.shape[-1]
    H, W = labels.shape[-2:]
    lab = labels.reshape(-1, H * W).long()
    keep = keep.reshape(-1, R)
    new_ids = torch.cumsum(keep.to(torch.int32), dim=-1, dtype=torch.int32) * keep
    table = torch.cat([new_ids, torch.zeros_like(new_ids[:, :1])], dim=1)  # (B, R+1)
    idx = torch.where((lab >= 0) & (lab < R), lab, R)
    out = torch.gather(table, 1, idx)
    return out.reshape(labels.shape).to(torch.int32)


def remove_small_objects_plain(
    labels: torch.Tensor, min_area: int, num_segments: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K8: drop regions below ``min_area`` pixels;
    re-compact ids. The areas come from :func:`per_frame_bincount_plain`
    (``torch.bincount``) on every device."""
    H, W = labels.shape[-2:]
    areas = per_frame_bincount_plain(labels.reshape(-1, H * W), num_segments)
    keep = areas.reshape(labels.shape[:-2] + (num_segments,)) >= min_area
    keep[..., 0] = False
    return _relabel_keep(labels, keep), keep.sum(-1).to(torch.int32)


# K8's cluster sizes (blocks a frame) and a block's shared scratch beyond
# its R int32 bins and R uint16 new ids (csrc/relabel.cu: `layout`).
CLUSTER_SIZES = (1, 2, 4, 8, 16)
_RELABEL_SCRATCH = 160
# What a wave of clusters costs beyond its bytes (the launch, the barrier's
# wait for the slowest block of a cluster, the table), counted as the bytes
# a block moves meanwhile: about 4 us at about 30 GB/s an SM, the K8 block's
# rate on an H100.
_RELABEL_WAVE_BYTES = 131072


def _r16(n: int) -> int:
    return -(-n // 16) * 16


def relabel_fixed_bytes(R: int) -> int:
    """Shared bytes a K8 block needs beside its staged labels: R int32
    bins, R uint16 new ids and the scan's scratch."""
    return _r16(4 * R) + _r16(2 * R) + _RELABEL_SCRATCH


def relabel_stage_bytes(R: int) -> int:
    """Bytes of a staged label: uint8 where the ids fit (R <= 256), else
    uint16."""
    return 1 if R <= 256 else 2


def relabel_max_segments(smem_block: int) -> int:
    """The largest R whose bins and table fit a block of ``smem_block``
    bytes of shared memory."""
    R = (smem_block - _RELABEL_SCRATCH) // 6
    while relabel_fixed_bytes(R + 1) <= smem_block:
        R += 1
    while R > 0 and relabel_fixed_bytes(R) > smem_block:
        R -= 1
    return R


# The largest R of K8's cluster route: its new ids and staged labels are
# uint16.
RELABEL_MAX_CLUSTER_R = 65536


@dataclass(frozen=True)
class RelabelPlan:
    """How K8 runs a call: ``cluster`` blocks a frame, ``share`` pixels a
    block, the first ``stage`` of them staged in its ``smem`` bytes of shared
    memory; all 0 on the device-memory route (bins and table in device
    memory, three launches)."""

    cluster: int
    share: int
    stage: int
    smem: int

    @property
    def one_read(self) -> bool:
        """Every share is staged: each label is read once from device
        memory; else the unstaged rest of a share (or, on the device-memory
        route, every label) is read twice."""
        return self.cluster > 0 and self.stage == self.share

    @property
    def route(self) -> str:
        if self.cluster == 0:
            return "device memory"
        return "one read" if self.one_read else "two reads"


@functools.lru_cache(maxsize=1024)
def relabel_plan(B: int, HW: int, R: int, smem_block: int, active: Tuple[int, ...]) -> RelabelPlan:
    """The one place K8 chooses its cluster size, staged pixels and shared
    bytes, for B frames of HW pixels and R ids on a card whose blocks take
    ``smem_block`` bytes of shared memory and that holds ``active[k]``
    clusters of ``CLUSTER_SIZES[k]`` such blocks at once (``relabel_capacity``
    of csrc/relabel.cu).

    Each size's cost is the bytes a block moves (8 a pixel, 4 more for each
    pixel read twice), the cluster's bins it sums (4 B an id a block) and a
    wave's overhead (``_RELABEL_WAVE_BYTES``), times the waves of clusters
    the frames need; the cheapest size wins, the smaller on a tie. A share
    fits its block where it is at most what the block stages (uint8 labels
    where R <= 256, else uint16): then each label is read once. Where R's
    bins and table do not fit a block, or R > ``RELABEL_MAX_CLUSTER_R``:
    the device-memory route.
    """
    fixed = relabel_fixed_bytes(R)
    if fixed > smem_block or R > RELABEL_MAX_CLUSTER_R:
        return RelabelPlan(0, 0, 0, 0)
    per_px = relabel_stage_bytes(R)
    cap = (smem_block - fixed) // per_px // 8 * 8  # pixels a block can stage
    best = None
    for cs, clusters in zip(CLUSTER_SIZES, active):
        if clusters < 1:
            continue
        share = -(-HW // (8 * cs)) * 8  # pixels a block, a multiple of 8
        stage = min(share, cap)
        waves = -(-B // clusters)
        cost = waves * (8 * share + 4 * (share - stage) + 4 * cs * R + _RELABEL_WAVE_BYTES)
        if best is None or cost < best[0]:
            best = (cost, RelabelPlan(cs, share, stage, fixed + _r16(per_px * stage)))
    if best is None:
        raise ValueError(f"remove_small_objects: the card runs no cluster of {CLUSTER_SIZES} blocks")
    return best[1]


_RELABEL_CAPACITY: Dict[int, Tuple[int, Tuple[int, ...]]] = {}


def _relabel_capacity(device: torch.device) -> Tuple[int, Tuple[int, ...]]:
    """(shared bytes a block, co-resident clusters of each size) of K8 on
    ``device``: asked of the card once."""
    cap = _RELABEL_CAPACITY.get(device.index)
    if cap is None:
        from .._build import kernels

        out = (ctypes.c_int * (2 + len(CLUSTER_SIZES)))()
        with torch.cuda.device(device):
            err = kernels().relabel_capacity(ctypes.addressof(out))
        if err != 0:
            raise RuntimeError(f"remove_small_objects: the kernel's occupancy query failed with CUDA error {err}")
        cap = _RELABEL_CAPACITY[device.index] = (out[0], tuple(out[2:]))
    return cap


def remove_small_objects_plan(labels: torch.Tensor, num_segments: int) -> RelabelPlan:
    """The plan K8 runs for ``labels`` (..., H, W) on the card."""
    if labels.device.type != "cuda":
        raise ValueError(f"remove_small_objects_plan: labels must lie on a CUDA device, got {labels.device}")
    H, W = labels.shape[-2:]
    smem_block, active = _relabel_capacity(labels.device)
    return relabel_plan(math.prod(labels.shape[:-2]), H * W, num_segments, smem_block, active)


def remove_small_objects(
    labels: torch.Tensor, min_area: int, num_segments: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Drop regions below ``min_area`` pixels and re-compact ids (K8).

    Args:
        labels: int32 label frames (..., H, W).
        min_area: smallest area kept; id 0 is never kept (with ``min_area``
            <= 0 every other id is kept, present or not).
        num_segments: R, the id range measured; ids outside [0, R) map to 0.

    Returns:
        (labels, n): int32 (..., H, W) with kept ids renumbered 1..n in id
        order, and int32 (...,) the number kept. On the card one launch
        (:func:`remove_small_objects_plan` shows its plan), or, where R's
        bins and table do not fit a block's shared memory, three launches
        of the device-memory route.
    """
    if labels.dtype != torch.int32:
        raise TypeError(f"remove_small_objects: labels must be int32, got {labels.dtype}")
    if labels.dim() < 2:
        raise ValueError(f"remove_small_objects: need (..., H, W) labels, got {tuple(labels.shape)}")
    if num_segments < 1:
        raise ValueError(f"remove_small_objects: num_segments must be positive, got {num_segments}")
    if labels.device.type == "cpu":
        return remove_small_objects_plain(labels, min_area, num_segments)
    _check_cuda("remove_small_objects", labels)
    H, W = labels.shape[-2:]
    batch_shape = labels.shape[:-2]
    B = math.prod(batch_shape)
    out = torch.empty_like(labels)
    n = torch.empty((B,), dtype=torch.int32, device=labels.device)
    if B == 0:
        return out, n.reshape(batch_shape)
    plan = remove_small_objects_plan(labels, num_segments)
    from .._build import kernels

    with torch.cuda.device(labels.device):
        stream = torch.cuda.current_stream(labels.device).cuda_stream
        if plan.route == "device memory":
            bins = torch.empty((B, num_segments), dtype=torch.int32, device=labels.device)
            err = kernels().remove_small_objects_global_launch(
                labels.data_ptr(), out.data_ptr(), n.data_ptr(), bins.data_ptr(), B, H * W, num_segments,
                int(min_area), stream,
            )
        else:
            err = kernels().remove_small_objects_launch(
                labels.data_ptr(), out.data_ptr(), n.data_ptr(), B, H * W, num_segments, int(min_area),
                plan.cluster, plan.share, plan.stage, stream,
            )
    _raise_on("remove_small_objects", err)
    count_launch(remove_small_objects, labels.device, plan.route)
    return out, n.reshape(batch_shape)


remove_small_objects.launches = 0


def clear_border(
    labels: torch.Tensor, num_segments: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Drop regions touching the image border; re-compact ids."""
    border_vals = torch.cat(
        [labels[..., 0, :], labels[..., -1, :], labels[..., :, 0], labels[..., :, -1]],
        dim=-1,
    )
    batch_shape = labels.shape[:-2]
    touches = _per_frame_bincount(border_vals.reshape(-1, border_vals.shape[-1]), num_segments) > 0
    keep = ~touches.reshape(batch_shape + (num_segments,))
    keep[..., 0] = False
    return _relabel_keep(labels, keep), keep.sum(-1).to(torch.int32)
