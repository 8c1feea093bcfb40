"""The U-Net configurations' architecture (``model.arch: "UNet"``): weights
distilled toward the threshold teacher by a plain trainer, the program's
checkpoint, the forward's FLOPs.

An architecture module, found by the configuration's ``model.arch`` as
``archs/<arch>.py``, provides

* ``make_state(config, device) -> (state_dict, loss or None)``: float32
  parameters, distilled or drawn from a seed (the reference's copy);
* ``write_checkpoint(path, config, state)``: the same parameters as a
  checkpoint directory, written by the program's own writer;
* ``forward_flops(model_cfg, h, w) -> float``: the FLOPs of one forward over
  one input of h × w.

The trainer is plain PyTorch (:class:`benchmark.unet_ref.PlainUNet`:
``F.conv2d``, ``F.group_norm``), float32 with TF32 off and deterministic
algorithms: AdamW (lr 1e-3, betas 0.9 / 0.999, weight decay 1e-4), sigmoid
BCE + soft Dice, on :mod:`benchmark.synth`'s batches. The initial weights
are drawn on the card with one ``torch.Generator`` in one call (LeCun-normal
convolutions, zero biases, unit norm scales).
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from benchmark import unet_ref
from benchmark.synth import batch_stream
from benchmark.unet_ref import PlainUNet, state_dict_of


def init_plain_unet(model_cfg: dict, seed: int, device) -> PlainUNet:
    """A :class:`PlainUNet` with weights drawn on ``device`` from ``seed``."""
    net = PlainUNet(model_cfg["out_channels"], model_cfg["base_features"], model_cfg["depth"]).to(device)
    convs = [(n, p) for n, p in net.named_parameters() if p.dim() == 4]
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    draw = torch.randn(sum(p.numel() for _, p in convs), generator=gen, device=device)
    o = 0
    with torch.no_grad():
        for _, p in convs:
            fan_in = p.shape[1] * p.shape[2] * p.shape[3]
            p.copy_(draw[o : o + p.numel()].view_as(p) / fan_in**0.5)
            o += p.numel()
        for n, p in net.named_parameters():
            if p.dim() == 1:
                p.fill_(1.0 if "GroupNorm" in n and n.endswith("weight") else 0.0)
    return net


def bce_dice(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Sigmoid BCE + soft Dice ``(2·inter + 1) / (union + 1)`` of NHWC logits."""
    bce = -(targets * F.logsigmoid(logits) + (1.0 - targets) * F.logsigmoid(-logits)).mean()
    probs = torch.sigmoid(logits)
    inter = (probs * targets).sum((1, 2))
    union = probs.sum((1, 2)) + targets.sum((1, 2))
    return bce + (1.0 - (2 * inter + 1.0) / (union + 1.0)).mean()


def distil(model_cfg: dict, distill_cfg: dict, device) -> Tuple[Dict[str, torch.Tensor], float]:
    """Train the plain U-Net; returns its float32 state dict and the last
    loss."""
    flags = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.use_deterministic_algorithms(True)
    try:
        net = init_plain_unet(model_cfg, distill_cfg["init_seed"], device)
        opt = torch.optim.AdamW(net.parameters(), lr=1e-3, betas=(0.9, 0.999), eps=1e-8, weight_decay=1e-4)
        batches = batch_stream(distill_cfg["batches"], model_cfg["out_channels"], distill_cfg["data_seed"])
        loss = torch.zeros(())
        for _ in range(int(distill_cfg["steps"])):
            x, y = next(batches)
            x = torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(device)
            y = torch.from_numpy(np.ascontiguousarray(y, np.float32)).to(device)
            opt.zero_grad(set_to_none=True)
            loss = bce_dice(net(x, "float32"), y)
            loss.backward()
            opt.step()
        return state_dict_of(net), float(loss.detach())
    finally:
        torch.use_deterministic_algorithms(False)
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags


def write_program_checkpoint(path: str, model_cfg: dict, state: Dict[str, torch.Tensor], channel_names) -> None:
    """The parameters as a checkpoint directory the Runners load, written by
    the program's own writer (its module takes the same state dict)."""
    from maze_image_processing_pipeline_tpu_torch.models.model_io import save_model
    from maze_image_processing_pipeline_tpu_torch.models.unet import UNet

    module = UNet(model_cfg["out_channels"], model_cfg["base_features"], model_cfg["depth"], dtype=model_cfg["dtype"])
    module.load_state_dict(state)
    save_model(path, module, outputs={"pred": {"channel_names": list(channel_names)}})


def make_state(config: dict, device) -> Tuple[Dict[str, torch.Tensor], float]:
    return distil(config["model"], config["distill"], device)


def write_checkpoint(path: str, config: dict, state: Dict[str, torch.Tensor]) -> None:
    write_program_checkpoint(path, config["model"], state, config["model"]["channel_names"])


def forward_flops(model_cfg: dict, h: int, w: int) -> float:
    return unet_ref.forward_flops(h, w, model_cfg["out_channels"], model_cfg["base_features"], model_cfg["depth"])
