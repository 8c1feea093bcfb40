"""Elementwise image ops and shape utilities.

Counterpart of ``maze_image_processing_pipeline_tpu/ops/image.py``: the
device forms on tensors (:func:`convert_img_dtype`, :func:`gray2rgb`,
:func:`center_crop_or_pad`, :func:`rescale_max_intensity_batch`,
:func:`threshold_mask`) run on whatever device their input lies on, with the
JAX functions' results. :func:`rescale_max_intensity` is a copy of the numpy
function of the same name in the original module, which imports jax;
``tests/test_torch_host_copies.py`` holds the two equal.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = [
    "convert_img_dtype",
    "gray2rgb",
    "center_crop_or_pad",
    "rescale_max_intensity",
    "rescale_max_intensity_batch",
    "threshold_mask",
]

_UNSIGNED = (torch.uint8, torch.uint16, torch.uint32, torch.uint64)


def _torch_dtype(dtype) -> torch.dtype:
    """A torch dtype, its name (``"bfloat16"``) or a numpy dtype."""
    if isinstance(dtype, torch.dtype):
        return dtype
    if isinstance(dtype, str):
        return getattr(torch, dtype)
    return getattr(torch, np.dtype(dtype).name)


def convert_img_dtype(image: torch.Tensor, dtype) -> torch.Tensor:
    """Dtype conversion: unsigned ints scale to [0, 1] floats. As in the JAX
    function, the target is a numpy floating kind: float16, float32 or
    float64 (bfloat16 is refused there too)."""
    dtype = _torch_dtype(dtype)
    if dtype not in (torch.float16, torch.float32, torch.float64):
        raise ValueError(f"Target dtype must be floating, got {dtype}")
    if image.dtype in _UNSIGNED:
        factor = 1.0 / float(torch.iinfo(image.dtype).max)
        return image.to(dtype) * torch.tensor(factor, dtype=dtype, device=image.device)
    if image.dtype.is_floating_point:
        return image.to(dtype)
    raise ValueError(
        f"Unsupported image dtype {image.dtype} (target {dtype}): expected "
        "unsigned-integer or floating input"
    )


def gray2rgb(image: torch.Tensor) -> torch.Tensor:
    """(..., H, W) → (..., H, W, 3) by channel replication (a view)."""
    return image[..., None].expand(*image.shape, 3)


def center_crop_or_pad(image: torch.Tensor, size: int, *, channels_last: bool = True) -> torch.Tensor:
    """Extract the center ``size``×``size`` window, zero-padding as needed.

    ``channels_last=True`` treats a ≥3-D input as (..., H, W, C); ``False``
    as (..., H, W). 2-D inputs are always (H, W).
    """
    if image.dim() >= 3 and channels_last:
        h_ax, w_ax = image.dim() - 3, image.dim() - 2
    else:
        h_ax, w_ax = image.dim() - 2, image.dim() - 1
    H, W = image.shape[h_ax], image.shape[w_ax]

    before = [0] * image.dim()
    shape = list(image.shape)
    for ax, extent in ((h_ax, H), (w_ax, W)):
        if extent < size:
            before[ax] = (size - extent) // 2
            shape[ax] = size
    if shape != list(image.shape):
        padded = image.new_zeros(shape)
        padded[tuple(slice(b, b + n) for b, n in zip(before, image.shape))] = image
        image = padded
    H2, W2 = image.shape[h_ax], image.shape[w_ax]

    idx = [slice(None)] * image.dim()
    y0 = (H2 - size) // 2
    x0 = (W2 - size) // 2
    idx[h_ax] = slice(y0, y0 + size)
    idx[w_ax] = slice(x0, x0 + size)
    return image[tuple(idx)]


def rescale_max_intensity(image) -> np.ndarray:
    """Stretch intensities so the max maps to the dtype maximum (host/NumPy).

    Parity: ``rescale_max_intensity`` at ``loki/pipeline.py:382-383`` (which
    stretches ``(0, image.max())`` to the full dtype range).
    """
    image = np.asarray(image)
    maxval = image.max()
    if image.dtype.kind == "u":
        out_max = np.iinfo(image.dtype).max
        if maxval == 0:
            return image.copy()
        scaled = image.astype(np.float32) * (out_max / float(maxval))
        return np.clip(scaled, 0, out_max).astype(image.dtype)
    if maxval == 0:
        return image.copy()
    return (image / maxval).astype(image.dtype)


def rescale_max_intensity_batch(images: torch.Tensor) -> torch.Tensor:
    """Batched contrast stretch for uint8 images (..., H, W)."""
    maxval = torch.amax(images, dim=(-2, -1), keepdim=True).to(torch.float32)
    # A true division: ``255.0 / maxval`` in torch is 255 · (1 / maxval).
    scale = torch.where(maxval > 0, torch.full_like(maxval, 255.0) / maxval, 1.0)
    return torch.clamp(images.to(torch.float32) * scale, 0, 255).to(torch.uint8)


def threshold_mask(image: torch.Tensor, threshold_brighter: float) -> torch.Tensor:
    """Foreground mask of pixels strictly brighter than the threshold."""
    return image > threshold_brighter
