"""U-Net semantic segmentation model.

Counterpart of ``UNet`` in ``maze_image_processing_pipeline_tpu/models/unet.py``
on its canonical path (no phase packing): per level a ConvBlock of two
(3×3 conv → GroupNorm → ReLU), 2×2 max pooling down, nearest 2× upsampling
and a 2×2 "same" conv up, the skip concatenated first, and a 1×1 head in
float32.

``forward`` takes and returns NHWC, like the JAX model; inside, tensors are
NCHW. Convolutions and norms run in the compute ``dtype`` (bfloat16 or
float32); parameters stay float32. Submodules carry the flax module names
(``ConvBlock_0.Conv_0`` ...), so a flax checkpoint maps onto the state dict
by name (:func:`.model_io.params_from_jax`).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .layers import GroupNorm

__all__ = ["UNet", "ConvBlock"]

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32, "float16": torch.float16}


def _dtype(dtype) -> torch.dtype:
    return _DTYPES[dtype] if isinstance(dtype, str) else dtype


def _conv(conv: nn.Conv2d, x: torch.Tensor, dtype: torch.dtype, padding, stride: int = 1) -> torch.Tensor:
    """``conv`` evaluated in ``dtype`` (weights cast, parameters untouched)."""
    x = x.to(dtype)
    return F.conv2d(x, conv.weight.to(dtype), conv.bias.to(dtype), stride=stride, padding=padding)


class ConvBlock(nn.Module):
    """Two (3×3 conv → GroupNorm(min(8, features)) → ReLU)."""

    def __init__(self, in_features: int, features: int, norm: bool = True) -> None:
        super().__init__()
        self.norm = norm
        groups = min(8, features)
        for k in range(2):
            setattr(self, f"Conv_{k}", nn.Conv2d(in_features if k == 0 else features, features, 3))
            if norm:
                setattr(self, f"GroupNorm_{k}", GroupNorm(groups, features))

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        for k in range(2):
            x = _conv(getattr(self, f"Conv_{k}"), x, dtype, padding=1)
            if self.norm:
                x = getattr(self, f"GroupNorm_{k}")(x)
            x = F.relu(x)
        return x


class UNet(nn.Module):
    """Encoder-decoder with skip connections.

    Args:
        out_channels: output mask channels.
        base_features: width of the first level; doubles per level.
        depth: number of down/up-sampling levels.
        dtype: compute dtype (``torch.bfloat16``/``torch.float32`` or their
            names); parameters stay float32.
        norm: GroupNorm after every conv.
        in_channels: input channels (3: gray frames are broadcast to RGB).
    """

    # The meta.json config a checkpoint records; the flax U-Net takes the
    # same fields (it has no in_channels: it reads them off its input).
    config_fields = ("out_channels", "base_features", "depth", "dtype", "norm")

    def __init__(
        self,
        out_channels: int = 2,
        base_features: int = 32,
        depth: int = 4,
        dtype=torch.bfloat16,
        norm: bool = True,
        in_channels: int = 3,
    ) -> None:
        super().__init__()
        self.out_channels = out_channels
        self.base_features = base_features
        self.depth = depth
        self.dtype = _dtype(dtype)
        self.norm = norm
        # Registered in the flax module's call order (= its parameter order).
        cin = in_channels
        for i in range(depth):
            setattr(self, f"ConvBlock_{i}", ConvBlock(cin, base_features * 2**i, norm))
            cin = base_features * 2**i
        setattr(self, f"ConvBlock_{depth}", ConvBlock(cin, base_features * 2**depth, norm))
        for i in reversed(range(depth)):
            feats = base_features * 2**i
            setattr(self, f"Conv_{depth - 1 - i}", nn.Conv2d(2 * feats, feats, 2))
            setattr(self, f"ConvBlock_{2 * depth - i}", ConvBlock(2 * feats, feats, norm))
        setattr(self, f"Conv_{depth}", nn.Conv2d(base_features, out_channels, 1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(B, H, W, C) → (B, H, W, out_channels) float32 logits."""
        dt = self.dtype
        x = x.to(dt).permute(0, 3, 1, 2)
        skips = []
        for i in range(self.depth):
            x = getattr(self, f"ConvBlock_{i}")(x, dt)
            skips.append(x)
            x = F.max_pool2d(x, 2)
        x = getattr(self, f"ConvBlock_{self.depth}")(x, dt)
        for i in reversed(range(self.depth)):
            x = x.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)
            # "SAME" for a 2×2 kernel pads (0, 1) on each axis, as in flax.
            x = F.pad(x, (0, 1, 0, 1))
            x = _conv(getattr(self, f"Conv_{self.depth - 1 - i}"), x, dt, padding=0)
            x = torch.cat([skips[i], x], dim=1)
            x = getattr(self, f"ConvBlock_{2 * self.depth - i}")(x, dt)
        head = getattr(self, f"Conv_{self.depth}")
        logits = F.conv2d(x.float(), head.weight, head.bias)
        return logits.permute(0, 2, 3, 1)
