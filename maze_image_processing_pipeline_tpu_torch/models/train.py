"""Training of the port's U-Net and classifier on one card or several.

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
(``models/layers.py``).

With a ``mesh`` (:func:`..parallel.make_mesh`) the step runs over the
mesh's cards, as the JAX package's ``mesh`` step, in one of two ways:

* A :class:`.unet.UNet` or :class:`.classifier.ConvClassifier` on a mesh
  with ``space`` cards, or with ``model`` cards and a layer
  ``parallel.mesh.shard_params`` splits, is sharded (dp × sp × tp):
  :func:`create_train_state` places its weights as ``shard_params`` does
  (:class:`.unet.ShardedUNet` / :class:`.classifier.ShardedClassifier`;
  ``state.module`` is that), the batch is split over the ``data`` groups,
  each group runs its share through its ``space`` × ``model`` cards (image
  rows over ``space``, wide output channels over ``model``), each share's
  loss is weighted by its share of the batch, every gradient is summed over
  the cards that hold the same slice onto its owner, AdamW updates each
  slice on the card that holds it, and the new values are copied to the
  other holders.
* Otherwise (any module on a ``data`` mesh, a module the ``model`` axis
  splits nothing of) every card is a data replica: the module lies on the
  mesh's first device and a replica on each other card; the batch is split
  over the mesh's devices; each replica's loss is weighted by its share of
  the batch and its gradients are summed onto the first card, where AdamW
  steps; the parameters are copied to the replicas before the next step's
  forward.

The batch must divide by the ``data`` axis, as ``shard_batch_spec`` needs.
Both losses are means of per-sample terms over whole images (GroupNorm
normalises each sample alone; a sharded group's logits are gathered onto its
first card for the loss), so either step equals the one-device step on the
whole batch up to summation order.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..parallel.mesh import mesh_grid, replicate, sharded_names, split_batch
from .classifier import ConvClassifier
from .inference import SHARDED, resolve_device
from .model_io import init_classifier_params, init_unet_params, params_from_jax
from .unet import ShardedNet, UNet

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


def shards(module, mesh) -> bool:
    """Whether the train step shards ``module`` over ``mesh`` (module
    docstring): a U-Net or a classifier, on a mesh with ``space`` cards or
    with ``model`` cards that split one of its layers."""
    if isinstance(module, ShardedNet):
        return True
    if mesh is None or type(module) not in SHARDED:
        return False
    _, S, M = mesh_grid(mesh).shape
    return S > 1 or bool(sharded_names(module, M))


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
        mesh: with a mesh that :func:`shards` the module, its weights are
            placed on the mesh's cards and ``state.module`` is the
            :class:`.unet.ShardedUNet` or
            :class:`.classifier.ShardedClassifier`; with any other mesh the module goes
            to the mesh's first device, where :func:`make_train_step` keeps
            the state. ``device`` is not read.

    Returns:
        (state, state.optimizer), as the JAX package returns (state,
        optimizer).
    """
    dev = resolve_device(mesh.devices.flat[0] if mesh is not None else device)
    first = next(m for m in module.modules() if isinstance(m, nn.Conv2d))
    if input_shape[-1] != first.in_channels:
        raise ValueError(f"create_train_state: input_shape {tuple(input_shape)} has {input_shape[-1]} channels, "
                         f"the module takes {first.in_channels}")
    module.load_state_dict(params_from_jax(_init_params(module, first.in_channels, seed)))
    if shards(module, mesh):
        for d in mesh.devices.flat:
            resolve_device(d)
        module = SHARDED[type(module)](module.train(), mesh)
    else:
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
    0-d tensor on that device (reading it waits for the step). With a
    ``mesh`` the step is sharded where :func:`shards` says so (it runs
    ``state.module``, the sharded network), else data-parallel
    over the mesh's devices with the module on the mesh's first device
    (module docstring)."""
    if shards(module, mesh):
        return _sharded_step(optimizer, loss_fn)
    dev = next(module.parameters()).device
    if mesh is not None:
        return _mesh_step(module, optimizer, loss_fn, mesh, dev)

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


def _mesh_step(module: nn.Module, optimizer: torch.optim.Optimizer, loss_fn: Callable, mesh, dev: torch.device):
    devices = list(mesh.devices.flat)
    if devices[0] != dev:
        raise ValueError(f"make_train_step: the module lies on {dev}, the mesh's first device is {devices[0]} "
                         "(create_train_state(..., mesh=mesh) places it)")
    data = mesh.shape.get("data", 1)
    replicas = replicate(module, devices)
    params = list(module.parameters())
    others = [m for m in replicas.values() if m is not module]
    for m in others:
        m.train(module.training)

    def step(state: TrainState, images, targets):
        x = torch.as_tensor(images)
        y = torch.as_tensor(targets)
        B = x.shape[0]
        if B % data:
            raise ValueError(f"make_train_step: a batch of {B} does not split over the mesh's data axis of {data}")
        with torch.no_grad():
            for m in others:
                for p, q in zip(m.parameters(), params):
                    p.copy_(q, non_blocking=True)
                m.zero_grad(set_to_none=True)
        optimizer.zero_grad(set_to_none=True)
        loss = None
        for share, d in zip(split_batch(B, len(devices)), devices):
            if share.start == share.stop:
                continue
            xs = x[share].to(d, torch.float32, non_blocking=True)
            ys = y[share].to(d, torch.float32, non_blocking=True)
            part = loss_fn(replicas[d](xs), ys) * ((share.stop - share.start) / B)
            part.backward()
            part = part.detach().to(dev, non_blocking=True)
            loss = part if loss is None else loss + part
        with torch.no_grad():
            for m in others:
                for p, q in zip(params, m.parameters()):
                    if q.grad is None:
                        continue
                    g = q.grad.to(dev, non_blocking=True)
                    if p.grad is None:
                        p.grad = g
                    else:
                        p.grad.add_(g)
        optimizer.step()
        state.step += 1
        return state, {"loss": loss}

    return step


def _sharded_step(optimizer: torch.optim.Optimizer, loss_fn: Callable):
    def step(state: TrainState, images, targets):
        model = state.module
        if not isinstance(model, ShardedNet):
            raise TypeError("make_train_step: a sharded step needs the state of create_train_state(..., mesh=mesh)")
        x = torch.as_tensor(images)
        y = torch.as_tensor(targets)
        B, D = x.shape[0], model.groups
        if B % D:
            raise ValueError(f"make_train_step: a batch of {B} does not split over the mesh's data axis of {D}")
        model.zero_grad()  # every copy's gradient, the owners' (the optimizer's) among them
        loss = None
        for g, share in enumerate(split_batch(B, D)):
            if share.start == share.stop:
                continue
            logits = model(x[share].to(torch.float32), g)  # each row share goes to its cards
            part = loss_fn(logits, y[share].to(model.root(g), torch.float32, non_blocking=True))
            part = part * ((share.stop - share.start) / B)
            part.backward()
            part = part.detach().to(model.root(0), non_blocking=True)
            loss = part if loss is None else loss + part
        model.reduce_grads()
        optimizer.step()
        model.sync()
        state.step += 1
        return state, {"loss": loss}

    return step
