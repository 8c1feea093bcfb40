"""The layout anchor of the frame-chain perf lab: a hand-written CUDA kernel
and its plain version.

:func:`anchor` copies a (B, H, W) tensor of any strides into a new tensor in
the standard (contiguous, row-major) layout, with the same values (K9,
``csrc/anchor.cu``). It is the counterpart of the identity Pallas copy
``anchor`` of ``tools/perf_lab.py``, which pins a layout between the
morphology chain and ``label``; its only caller is
:mod:`..tools.perf_lab` (experiments ``morph_anchor_label`` and
``chain_anchor``).

A tensor on the CPU goes through :func:`anchor_plain`; a CUDA tensor always
launches the kernel, and the wrapper raises if the kernel does not take it
or does not launch. ``anchor.launches`` counts the kernel's launches.
"""

from __future__ import annotations

import torch

from .row_scan import _raise_on

__all__ = ["anchor", "anchor_plain"]


def anchor_plain(mask: torch.Tensor) -> torch.Tensor:
    """Plain version of K9: a contiguous copy."""
    return mask.contiguous().clone()


def anchor(mask: torch.Tensor) -> torch.Tensor:
    """A contiguous copy of the (B, H, W) ``mask``, whose elements may be of
    any dtype of 1, 2, 4 or 8 bytes and whose strides may be any."""
    if mask.dim() != 3:
        raise ValueError(f"anchor: expected a (B, H, W) tensor, got {tuple(mask.shape)}")
    if mask.device.type == "cpu":
        return anchor_plain(mask)
    if mask.device.type != "cuda":
        raise ValueError(f"anchor: tensors must lie on the CPU or a CUDA device, got {mask.device}")
    elem = mask.element_size()
    if elem not in (1, 2, 4, 8):
        raise TypeError(f"anchor: elements must be of 1, 2, 4 or 8 bytes, got {mask.dtype}")
    out = torch.empty(mask.shape, dtype=mask.dtype, device=mask.device)
    if out.numel() == 0:
        return out
    vec = mask.is_contiguous() and mask.data_ptr() % 16 == 0 and out.data_ptr() % 16 == 0
    from .._build import kernels

    with torch.cuda.device(mask.device):
        stream = torch.cuda.current_stream(mask.device).cuda_stream
        err = kernels().anchor_launch(
            mask.data_ptr(), out.data_ptr(), *mask.shape, *mask.stride(), elem, int(vec), stream
        )
    _raise_on("anchor", err)
    anchor.launches += 1
    return out


anchor.launches = 0
