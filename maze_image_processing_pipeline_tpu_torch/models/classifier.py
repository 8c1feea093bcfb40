"""Multi-label CNN classifier for polytaxo predictions.

Counterpart of ``ConvClassifier`` in
``maze_image_processing_pipeline_tpu/models/classifier.py``: per stage a
stride-2 3×3 conv, GroupNorm(min(8, f)), ReLU, a stride-1 3×3 conv,
GroupNorm, ReLU; then a global mean, ``Dense(features[-1])`` with ReLU in
the compute dtype and ``Dense(n_outputs)`` in float32.

``forward`` takes NHWC and returns (B, n_outputs) float32 logits. Inside,
tensors are NCHW. Submodules carry the flax names (``Conv_k``,
``GroupNorm_k``, ``Dense_k``), so a flax checkpoint maps onto the state
dict by name (:func:`.model_io.params_from_jax`).
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from .layers import GroupNorm
from .unet import _conv, _dtype

__all__ = ["ConvClassifier"]


def _same_pad(extent: int, stride: int, k: int = 3):
    """flax ``padding="SAME"``: (low, high) padding of one axis. With stride
    2 and a 3×3 kernel that is (0, 1) at even extents and (1, 1) at odd."""
    out = -(-extent // stride)
    total = max((out - 1) * stride + k - extent, 0)
    return total // 2, total - total // 2


class ConvClassifier(nn.Module):
    """Strided conv backbone + global average pool + dense multi-label head.

    Args:
        n_outputs: number of taxonomy-node scores.
        features: channel widths per stage (each stage halves the extent).
        dtype: compute dtype (``torch.bfloat16``/``torch.float32`` or their
            names); parameters stay float32.
        norm: GroupNorm after every conv.
        in_channels: input channels (3: gray crops are broadcast to RGB).
    """

    config_fields = ("n_outputs", "features", "dtype", "norm")

    def __init__(
        self,
        n_outputs: int = 32,
        features: Sequence[int] = (32, 64, 128, 256),
        dtype=torch.bfloat16,
        norm: bool = True,
        in_channels: int = 3,
    ) -> None:
        super().__init__()
        self.n_outputs = n_outputs
        self.features = tuple(features)
        self.dtype = _dtype(dtype)
        self.norm = norm
        cin = in_channels
        for s, f in enumerate(self.features):
            for k in (2 * s, 2 * s + 1):
                setattr(self, f"Conv_{k}", nn.Conv2d(cin, f, 3))
                if norm:
                    setattr(self, f"GroupNorm_{k}", GroupNorm(min(8, f), f))
                cin = f
        self.Dense_0 = nn.Linear(cin, self.features[-1])
        self.Dense_1 = nn.Linear(self.features[-1], n_outputs)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(B, H, W, C) → (B, n_outputs) float32 logits."""
        dt = self.dtype
        x = x.to(dt).permute(0, 3, 1, 2)
        for k in range(2 * len(self.features)):
            if k % 2 == 0:
                (t, b), (l, r) = _same_pad(x.shape[2], 2), _same_pad(x.shape[3], 2)
                x = _conv(getattr(self, f"Conv_{k}"), F.pad(x, (l, r, t, b)), dt, padding=0, stride=2)
            else:
                x = _conv(getattr(self, f"Conv_{k}"), x, dt, padding=1)
            if self.norm:
                x = getattr(self, f"GroupNorm_{k}")(x)
            x = F.relu(x)
        # jnp.mean of bf16 sums in float32 and casts the mean back.
        x = x.float().mean(dim=(2, 3)).to(dt)
        x = F.relu(F.linear(x, self.Dense_0.weight.to(dt), self.Dense_0.bias.to(dt)))
        return F.linear(x.float(), self.Dense_1.weight, self.Dense_1.bias)
