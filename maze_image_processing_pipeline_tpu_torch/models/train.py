"""Training of the port's U-Net and classifier on one card.

Counterpart of ``maze_image_processing_pipeline_tpu/models/train.py``:

* segmentation: sigmoid BCE + soft-Dice loss over mask channels
  (:func:`bce_dice_loss`), classification: sigmoid BCE over taxonomy-node
  targets (:func:`bce_loss`);
* :func:`create_train_state` initialises the parameters from a numpy seed
  (``model_io.init_unet_params`` / ``init_classifier_params``: flax's
  initialiser scales, not its random bits) and builds ``torch.optim.AdamW``
  set to optax's ``adamw`` defaults;
* :func:`make_train_step` returns the step ``(state, images, targets) →
  (state, {"loss": ...})``. It updates the module's parameters and the
  optimizer in place and returns the same state with its step count
  advanced (the JAX step returns a new state).

Every GroupNorm of the forward runs K5 on the card and its backward K6
(``models/layers.py``). The data-parallel (``mesh``) step of the JAX package
is not ported (ROADMAP A6): passing a mesh raises.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .classifier import ConvClassifier
from .inference import resolve_device
from .model_io import init_classifier_params, init_unet_params, params_from_jax
from .unet import UNet

__all__ = [
    "bce_dice_loss",
    "bce_loss",
    "create_train_state",
    "make_adamw",
    "make_train_step",
    "TrainState",
]


@dataclass
class TrainState:
    """The module (its parameters), the optimizer (its moments) and the
    number of steps taken."""

    module: nn.Module
    optimizer: torch.optim.Optimizer
    step: int = 0


def _sigmoid_bce(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """optax's ``sigmoid_binary_cross_entropy``, element by element."""
    return -(targets * F.logsigmoid(logits) + (1.0 - targets) * F.logsigmoid(-logits))


def bce_dice_loss(logits: torch.Tensor, masks: torch.Tensor) -> torch.Tensor:
    """Sigmoid BCE + soft Dice of NHWC logits, averaged over batch and
    channels; Dice ``(2·inter + 1) / (union + 1)`` over the spatial axes."""
    masks = masks.float()
    bce = _sigmoid_bce(logits, masks).mean()
    probs = torch.sigmoid(logits)
    axes = tuple(range(1, logits.dim() - 1))
    inter = (probs * masks).sum(axes)
    union = probs.sum(axes) + masks.sum(axes)
    dice = 1.0 - (2 * inter + 1.0) / (union + 1.0)
    return bce + dice.mean()


def bce_loss(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    return _sigmoid_bce(logits, targets.float()).mean()


def _no_mesh(mesh) -> None:
    if mesh is not None:
        raise NotImplementedError("data-parallel training over a mesh is not ported to PyTorch yet (ROADMAP A6)")


def make_adamw(params, learning_rate: float = 1e-3) -> torch.optim.AdamW:
    """``torch.optim.AdamW`` as ``optax.adamw(learning_rate)``: betas (0.9,
    0.999), eps 1e-8 outside the square root, weight decay 1e-4 (torch's
    default is 1e-2) on every parameter."""
    return torch.optim.AdamW(params, lr=learning_rate, betas=(0.9, 0.999), eps=1e-8, weight_decay=1e-4)


def _init_params(module: nn.Module, in_channels: int, seed: int) -> Dict:
    if isinstance(module, UNet):
        cfg = dict(out_channels=module.out_channels, base_features=module.base_features, depth=module.depth,
                   norm=module.norm, in_channels=in_channels)
        return init_unet_params(cfg, seed=seed)
    if isinstance(module, ConvClassifier):
        cfg = dict(n_outputs=module.n_outputs, features=module.features, norm=module.norm, in_channels=in_channels)
        return init_classifier_params(cfg, seed=seed)
    raise TypeError(f"create_train_state: no initialiser for {type(module).__name__}")


def create_train_state(
    module: nn.Module,
    input_shape: Tuple[int, ...],
    learning_rate: float = 1e-3,
    optimizer: Optional[Callable[..., torch.optim.Optimizer]] = None,
    seed: int = 0,
    device="cuda",
    mesh=None,
) -> Tuple[TrainState, torch.optim.Optimizer]:
    """Initialise ``module``'s parameters from ``seed``, move it to
    ``device`` and build its optimizer.

    Args:
        module: a :class:`UNet` or :class:`ConvClassifier`.
        input_shape: (B, H, W, C) of the images; C must be the module's
            input channels.
        learning_rate: AdamW's, when ``optimizer`` is None.
        optimizer: a factory ``optimizer(params)``; default
            :func:`make_adamw` at ``learning_rate``.
        seed: numpy seed of the parameters.
        device: the card by default; raises without one unless ``"cpu"``.
        mesh: not ported (ROADMAP A6); anything but None raises.

    Returns:
        (state, state.optimizer), as the JAX package returns (state,
        optimizer).
    """
    _no_mesh(mesh)
    dev = resolve_device(device)
    first = next(m for m in module.modules() if isinstance(m, nn.Conv2d))
    if input_shape[-1] != first.in_channels:
        raise ValueError(f"create_train_state: input_shape {tuple(input_shape)} has {input_shape[-1]} channels, "
                         f"the module takes {first.in_channels}")
    module.load_state_dict(params_from_jax(_init_params(module, first.in_channels, seed)))
    module.to(dev).train()
    params = module.parameters()
    opt = make_adamw(params, learning_rate) if optimizer is None else optimizer(params)
    return TrainState(module, opt, 0), opt


def make_train_step(
    module: nn.Module,
    optimizer: torch.optim.Optimizer,
    loss_fn: Callable = bce_dice_loss,
    mesh=None,
) -> Callable:
    """The train step: (state, images, targets) → (state, {"loss": loss}).

    The step updates ``module`` and ``optimizer`` (those of the state
    :func:`create_train_state` returned) in place and counts the step in
    ``state``. ``images`` (B, H, W, C) and ``targets`` (numpy arrays or
    tensors) go to the module's device as float32. The loss comes back as a
    0-d tensor on that device (reading it waits for the step)."""
    _no_mesh(mesh)
    dev = next(module.parameters()).device

    def step(state: TrainState, images, targets):
        x = torch.as_tensor(images).to(dev, torch.float32, non_blocking=True)
        y = torch.as_tensor(targets).to(dev, torch.float32, non_blocking=True)
        optimizer.zero_grad(set_to_none=True)
        loss = loss_fn(module(x), y)
        loss.backward()
        optimizer.step()
        state.step += 1
        return state, {"loss": loss.detach()}

    return step
