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

:class:`ShardedClassifier` runs the same classifier over a mesh's ``space``
and ``model`` cards (one group of them a ``data`` index), with its weights
placed as ``parallel.mesh.shard_params`` places them (the convs and dense
layers of at least 64 outputs that divide by ``model`` split), on the
placement, halo, gather and norm helpers of ``unet.ShardedNet``.
"""

from __future__ import annotations

import functools
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..parallel.mesh import space_rows
from .layers import GroupNorm
from .unet import ShardedNet, _Act, _conv, _dtype

__all__ = ["ConvClassifier", "ShardedClassifier"]


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


class ShardedClassifier(ShardedNet):
    """A :class:`ConvClassifier` over a mesh (``unet.ShardedNet``).

    * ``space``: image rows cut into shares of whole multiples of
      ``2**len(features)`` rows (``parallel.mesh.space_rows`` over the rows
      rounded up to such a multiple; the last share takes the rest), so each
      stride-2 conv halves every share and its cuts stay on even rows.
      flax's SAME padding of a stride-2 3×3 conv is (0, 1) at an even extent
      and (1, 1) at an odd one (:func:`_same_pad`): a shard then takes the
      row below it (or the row above it) from its neighbour, a zero row at
      the image's edge. A stride-1 3×3 conv takes one row from each side.
    * The global mean: each shard's sums over its rows and columns, summed
      over the shards in order and divided by the last level's H·W, on the
      group's first card.
    * ``Dense_0``, and ``Dense_1`` where ``n_outputs`` meets the rule, split
      over ``model``: card (0, m) computes its slice of the outputs from the
      whole input, and the slices are gathered on the first card.

    Built as ``ShardedClassifier(classifier, mesh, space=True)``
    (``unet.ShardedNet``'s arguments).
    """

    def forward(self, x: torch.Tensor, group: int = 0) -> torch.Tensor:
        """(B, H, W, C) images → (B, n_outputs) float32 logits on
        :meth:`root`, through group ``group``'s cards."""
        c = self.module
        dt = c.dtype
        H, W = x.shape[1:3]
        n = len(c.features)
        padded = -(-H // 2**n) * 2**n
        rows = [slice(r.start, min(r.stop, H)) for r in space_rows(padded, self.grid.shape[1], n) if r.start < H]
        act = self._start(x, group, rows)
        extent = H
        for k in range(2 * n):
            if k % 2 == 0:
                act = self._conv(act, f"Conv_{k}", functools.partial(self._conv_down, top=_same_pad(extent, 2)[0]))
                extent = -(-extent // 2)
            else:
                act = self._conv(act, f"Conv_{k}", self._conv3x3)
            if c.norm:
                act = self._norm(act, f"GroupNorm_{k}")
            act = self._each(act, F.relu)
        root = self._cards[0, 0]
        total = None
        for s in range(len(rows)):
            ts = act.t[s] if act.split else [act.t[s]]
            part = torch.cat([t.float().sum(dim=(2, 3)).to(root) for t in ts], dim=1)
            total = part if total is None else total + part
        width = (act.t[0][0] if act.split else act.t[0]).shape[3]
        pooled = (total / (extent * width)).to(dt)  # jnp.mean sums bf16 in float32
        hidden = F.relu(self._dense(pooled, "Dense_0", dt))
        return self._dense(hidden.float(), "Dense_1", torch.float32)

    def _dense(self, v: torch.Tensor, name: str, dt: torch.dtype) -> torch.Tensor:
        """Dense layer ``name`` of the whole input ``v`` (on the group's
        first card) in ``dt``: on each card (0, m) of its ``model`` slices
        where it is split, the slices gathered on the first card."""
        split = f"{name}.weight" in self.split
        outs = []
        for m in range(self._cards.shape[1] if split else 1):
            held, dev = self._held[0][m], self._cards[0, m]
            y = F.linear(v.to(dev), held[f"{name}.weight"].to(dt), held[f"{name}.bias"].to(dt))
            outs.append(y.to(self._cards[0, 0]))
        return torch.cat(outs, dim=1) if split else outs[0]

    def _conv_down(self, act: _Act, s: int, x: torch.Tensor, dev, w, b, top: int) -> torch.Tensor:
        """A stride-2 3×3 SAME conv of shard ``s``: ``top`` (flax's top pad
        at this level's extent) rows above it from the shard above (a zero
        row at the image's top), the row below it from the shard below (a
        zero row at the bottom) where an output needs it, and the columns
        padded as flax pads them."""
        last = s == len(self._cards) - 1
        parts = [self._halo(act, s - 1, slice(-1, None), x, dev)] if top else []
        parts.append(x)
        if not top or last:
            parts.append(self._halo(act, s + 1, slice(0, 1), x, dev))
        left, right = _same_pad(x.shape[3], 2)
        return F.conv2d(F.pad(torch.cat(parts, dim=2), (left, right)), w, b, stride=2)

