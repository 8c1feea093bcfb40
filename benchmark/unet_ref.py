"""The plain U-Net: the reference forward pass and the distillation's model.

Per level two (3×3 conv → GroupNorm(min(8, features), eps 1e-6) → ReLU),
2×2 max pooling down; up, nearest 2× upsampling, a 2×2 conv padded
(0, 1) on each axis ("SAME" for an even kernel), the skip concatenated
first, then the level's block; a 1×1 head. Parameters keep the names and
shapes of the published checkpoint layout (``ConvBlock_0.Conv_0.weight``
...), so one state dict serves this module and the program's loader.

``forward(x, mode)`` evaluates the same parameters in one of three ways:

* ``"float32"``: float32 throughout, TF32 off (the caller sets the flags);
  the reference.
* ``"bfloat16"``: convolutions and norms on bfloat16 activations, the head
  in float32: the precision the configurations state.
* ``"fp8"``: every convolution's input and weight rounded to float8 e4m3
  with one scale a tensor (its largest magnitude at 448), then computed in
  float32: the control, one precision below bfloat16.

Plain ``torch`` only: ``F.conv2d``, ``F.group_norm``, ``F.max_pool2d``.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F
from torch import nn

_FP8_MAX = 448.0


def _fp8(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to float8 e4m3 at one scale for the whole tensor."""
    scale = _FP8_MAX / torch.clamp(t.detach().abs().amax().float(), min=1e-12)
    return ((t.float() * scale).to(torch.float8_e4m3fn).float() / scale)


def _cast(x: torch.Tensor, mode: str) -> torch.Tensor:
    return x.to(torch.bfloat16) if mode == "bfloat16" else x.float()


class _Norm(nn.Module):
    def __init__(self, groups: int, channels: int) -> None:
        super().__init__()
        self.groups = groups
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor, mode: str) -> torch.Tensor:
        if mode == "bfloat16":
            y = F.group_norm(x.float(), self.groups, self.weight, self.bias, eps=1e-6)
            return y.to(torch.bfloat16)
        return F.group_norm(x.float(), self.groups, self.weight, self.bias, eps=1e-6)


def _conv(conv: nn.Conv2d, x: torch.Tensor, mode: str, padding) -> torch.Tensor:
    if mode == "fp8":
        return F.conv2d(_fp8(x), _fp8(conv.weight), conv.bias.float(), padding=padding)
    dt = torch.bfloat16 if mode == "bfloat16" else torch.float32
    return F.conv2d(x.to(dt), conv.weight.to(dt), conv.bias.to(dt), padding=padding)


class _Block(nn.Module):
    def __init__(self, cin: int, features: int) -> None:
        super().__init__()
        for k in range(2):
            setattr(self, f"Conv_{k}", nn.Conv2d(cin if k == 0 else features, features, 3))
            setattr(self, f"GroupNorm_{k}", _Norm(min(8, features), features))

    def forward(self, x: torch.Tensor, mode: str) -> torch.Tensor:
        for k in range(2):
            x = _conv(getattr(self, f"Conv_{k}"), x, mode, 1)
            x = F.relu(getattr(self, f"GroupNorm_{k}")(x, mode))
        return x


class PlainUNet(nn.Module):
    """``PlainUNet(out_channels, base_features, depth)``: 3 input channels."""

    def __init__(self, out_channels: int, base_features: int, depth: int, in_channels: int = 3) -> None:
        super().__init__()
        self.depth = depth
        cin = in_channels
        for i in range(depth):
            setattr(self, f"ConvBlock_{i}", _Block(cin, base_features * 2**i))
            cin = base_features * 2**i
        setattr(self, f"ConvBlock_{depth}", _Block(cin, base_features * 2**depth))
        for i in reversed(range(depth)):
            feats = base_features * 2**i
            setattr(self, f"Conv_{depth - 1 - i}", nn.Conv2d(2 * feats, feats, 2))
            setattr(self, f"ConvBlock_{2 * depth - i}", _Block(2 * feats, feats))
        setattr(self, f"Conv_{depth}", nn.Conv2d(base_features, out_channels, 1))

    def forward(self, x: torch.Tensor, mode: str = "float32") -> torch.Tensor:
        """(B, H, W, 3) in [0, 1] → (B, H, W, out) float32 logits."""
        d = self.depth
        x = _cast(x.permute(0, 3, 1, 2), mode)
        skips: List[torch.Tensor] = []
        for i in range(d):
            x = getattr(self, f"ConvBlock_{i}")(x, mode)
            skips.append(x)
            x = F.max_pool2d(x, 2)
        x = getattr(self, f"ConvBlock_{d}")(x, mode)
        for i in reversed(range(d)):
            B, C, h, w = x.shape
            x = x[:, :, :, None, :, None].expand(B, C, h, 2, w, 2).reshape(B, C, 2 * h, 2 * w)
            x = _conv(getattr(self, f"Conv_{d - 1 - i}"), F.pad(x, (0, 1, 0, 1)), mode, 0)
            x = getattr(self, f"ConvBlock_{2 * d - i}")(torch.cat([skips[i], _cast(x, mode)], dim=1), mode)
        head = getattr(self, f"Conv_{d}")
        if mode == "fp8":
            logits = F.conv2d(_fp8(x), _fp8(head.weight), head.bias.float())
        else:
            logits = F.conv2d(x.float(), head.weight, head.bias)
        return logits.permute(0, 2, 3, 1)


def conv_layers(out_channels: int, base_features: int, depth: int, in_channels: int = 3
                ) -> List[Tuple[int, int, int, int]]:
    """Every convolution of the U-Net as ``(cin, cout, k, level)``: its
    input channels, output channels, kernel side and the level whose
    resolution it runs at (0 = the tile's, each level halves both sides)."""
    layers = []
    cin = in_channels
    for i in range(depth + 1):
        f = base_features * 2**i
        layers += [(cin, f, 3, i), (f, f, 3, i)]
        cin = f
    for i in reversed(range(depth)):
        f = base_features * 2**i
        layers += [(2 * f, f, 2, i), (2 * f, f, 3, i), (f, f, 3, i)]
    layers.append((base_features, out_channels, 1, 0))
    return layers


def forward_flops(h: int, w: int, out_channels: int, base_features: int, depth: int) -> float:
    """Multiply-add FLOPs (2 a multiply-add) of the convolutions of one
    forward over one (h, w) tile: the work that bounds the U-Net. Norms,
    activations, pooling and upsampling are left out (a few operations an
    element, under 1 % of the total at these widths)."""
    total = 0.0
    for cin, cout, k, level in conv_layers(out_channels, base_features, depth):
        total += 2.0 * cin * cout * k * k * (h >> level) * (w >> level)
    return total


def state_dict_of(module: nn.Module) -> Dict[str, torch.Tensor]:
    """The parameters as float32 CPU tensors."""
    return {k: v.detach().float().cpu().clone() for k, v in module.state_dict().items()}
