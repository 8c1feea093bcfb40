"""The CCL row scans: hand-written CUDA kernels and their plain versions.

* :func:`hpass` — the horizontal pass of the connected-component labelling:
  every foreground pixel receives the minimum label of its horizontal run,
  background receives ``2**30`` (K1, ``csrc/ccl.cu:hpass_kernel``, over
  the row function that :func:`.label._fixpoint`'s kernel runs too; rows
  wider than 46000 take ``csrc/ccl_banded.cu:hpass_wide_kernel``, a block a
  row in chunks whose edge runs are chained afterwards).
* :func:`cumsum_rows` — the inclusive int32 prefix sum along each row, which
  ranks component roots in raster order (K2,
  ``csrc/row_scan.cu:cumsum_rows_kernel``).

A tensor on the CPU goes through the plain PyTorch version; a CUDA tensor
always launches the kernel, and the wrapper raises if the kernel does not
take it or does not launch. Each wrapper counts its kernel launches in a
plain integer attribute (``hpass.launches``, ``cumsum_rows.launches``; by
card in ``launches_by_device``, :func:`count_launch`; ``launches.<kernel>``
among the program counters of :mod:`..tracing`) so a run can show that its
main path went through the kernels, on each card of a mesh.
"""

from __future__ import annotations

from typing import Optional

import torch

from .. import tracing

__all__ = ["hpass", "hpass_plain", "cumsum_rows", "cumsum_rows_plain", "count_launch", "INF"]

INF = 2**30  # background label of the CCL
_MAX_W1 = 46000  # widest row K1 stages in one block's shared memory; wider rows take the wide route
WIDE_CHUNK = 4096  # csrc/ccl_banded.cu: kWideChunk
_CHUNK_SUM_INTS = 8  # csrc/ccl_banded.cu: ChunkSum


def count_launch(fn, device: torch.device, route: Optional[str] = None) -> None:
    """One launch of ``fn``'s kernel on ``device``: ``fn.launches`` counts
    every launch, ``fn.launches_by_device`` those of each card (by index)
    and, for a kernel of several routes, ``fn.launches_by_route`` those of
    each route (by name). While tracing is on, the program counter
    ``launches.<fn's name>`` counts it too."""
    fn.launches += 1
    tracing.count("launches." + fn.__name__)
    by_device = fn.__dict__.setdefault("launches_by_device", {})
    by_device[device.index] = by_device.get(device.index, 0) + 1
    if route is not None:
        by_route = fn.__dict__.setdefault("launches_by_route", {})
        by_route[route] = by_route.get(route, 0) + 1


def _shift(v: torch.Tensor, d: int, fill, reverse: bool) -> torch.Tensor:
    """Shift along the last axis by ``d``, filling the vacated places."""
    pad = torch.full(v.shape[:-1] + (d,), fill, dtype=v.dtype, device=v.device)
    if reverse:
        return torch.cat([v[..., d:], pad], dim=-1)
    return torch.cat([pad, v[..., :-d]], dim=-1)


def _segmented_min_doubling(v, r, reverse: bool):
    """Log-depth inclusive min-scan along the last axis that restarts where
    ``r`` is set; out-of-row neighbours act as restarts."""
    W = v.shape[-1]
    d = 1
    while d < W:
        v_sh = _shift(v, d, INF, reverse)
        r_sh = _shift(r, d, True, reverse)
        v = torch.where(r, v, torch.minimum(v, v_sh))
        r = r | r_sh
        d *= 2
    return v


def hpass_plain(lab: torch.Tensor, fg: torch.Tensor) -> torch.Tensor:
    """Plain version of K1: forward then reverse segmented min-scan."""
    fg = fg.bool()
    v = torch.where(fg, lab, INF)
    resets = ~fg
    v = _segmented_min_doubling(v, resets, reverse=False)
    v = _segmented_min_doubling(v, resets, reverse=True)
    return torch.where(fg, v, INF)


def cumsum_rows_plain(x: torch.Tensor) -> torch.Tensor:
    """Plain version of K2."""
    return torch.cumsum(x, dim=-1, dtype=torch.int32)


def _rows(x: torch.Tensor):
    W = x.shape[-1]
    return x.numel() // W, W


def _check_cuda(name: str, *tensors: torch.Tensor) -> None:
    dev = tensors[0].device
    if dev.type != "cuda":
        raise ValueError(f"{name}: tensors must lie on the CPU or a CUDA device, got {dev}")
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"{name}: all tensors must be on {dev}, got {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous")
        if t.dim() < 1 or t.shape[-1] < 1:
            raise ValueError(f"{name}: rows must hold at least one element, got {tuple(t.shape)}")


def _raise_on(name: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error {err}")


def hpass(lab: torch.Tensor, fg: torch.Tensor) -> torch.Tensor:
    """CCL horizontal pass over (..., W) rows.

    Args:
        lab: int32 labels, any shape (..., W).
        fg: bool or uint8 foreground mask of the same shape.

    Returns:
        int32 (..., W): the run minimum on foreground, ``2**30`` elsewhere.
    """
    if lab.dtype != torch.int32:
        raise TypeError(f"hpass: labels must be int32, got {lab.dtype}")
    if fg.dtype not in (torch.bool, torch.uint8):
        raise TypeError(f"hpass: mask must be bool or uint8, got {fg.dtype}")
    if lab.shape != fg.shape:
        raise ValueError(f"hpass: shapes differ: {tuple(lab.shape)} vs {tuple(fg.shape)}")
    if lab.device.type == "cpu":
        return hpass_plain(lab, fg)
    _check_cuda("hpass", lab, fg)
    out = torch.empty_like(lab)
    rows, W = _rows(lab)
    if rows == 0:
        return out
    from .._build import kernels

    with torch.cuda.device(lab.device):
        stream = torch.cuda.current_stream(lab.device).cuda_stream
        if W <= _MAX_W1:
            err = kernels().hpass_launch(lab.data_ptr(), fg.data_ptr(), out.data_ptr(), rows, W, stream)
        else:
            sums = torch.empty((rows * -(-W // WIDE_CHUNK), _CHUNK_SUM_INTS), dtype=torch.int32, device=lab.device)
            err = kernels().hpass_wide_launch(
                lab.data_ptr(), fg.data_ptr(), out.data_ptr(), sums.data_ptr(), rows, W, stream
            )
    _raise_on("hpass", err)
    count_launch(hpass, lab.device)
    return out


hpass.launches = 0


def cumsum_rows(x: torch.Tensor) -> torch.Tensor:
    """Inclusive int32 prefix sum along the last axis of (..., W)."""
    if x.dtype != torch.int32:
        raise TypeError(f"cumsum_rows: input must be int32, got {x.dtype}")
    if x.device.type == "cpu":
        return cumsum_rows_plain(x)
    _check_cuda("cumsum_rows", x)
    out = torch.empty_like(x)
    rows, W = _rows(x)
    if rows == 0:
        return out
    from .._build import kernels

    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = kernels().cumsum_rows_launch(
            x.data_ptr(), out.data_ptr(), rows, W, stream
        )
    _raise_on("cumsum_rows", err)
    count_launch(cumsum_rows, x.device)
    return out


cumsum_rows.launches = 0
