"""U-Net, polytaxo classifier, GroupNorm, checkpoints, the inference nodes
and training of the port.

* :class:`UNet`, :class:`ConvClassifier` — the JAX package's models in
  PyTorch (NHWC at the boundary, NCHW inside), every GroupNorm through K5
  forward and K6 backward on the card (:mod:`.layers`);
* :func:`load_model`, :func:`save_model` — the JAX package's checkpoint
  directories (``meta.json`` + ``params.msgpack``), read and written;
* :class:`TorchInference`, :class:`DeviceTiledInference` — the batched
  inference stream nodes;
* :mod:`.train`, :mod:`.train_loop` — training on one card with
  step-granular checkpoint and resume (:func:`fit`).
"""

from .unet import UNet
from .classifier import ConvClassifier
from .model_io import LoadedModel, load_model, save_model
from .inference import DeviceTiledInference, TorchInference
from .train import TrainState, bce_dice_loss, bce_loss, create_train_state, make_train_step
from .train_loop import fit, restore_checkpoint, save_checkpoint

__all__ = [
    "UNet",
    "ConvClassifier",
    "LoadedModel",
    "load_model",
    "save_model",
    "DeviceTiledInference",
    "TorchInference",
    "TrainState",
    "bce_dice_loss",
    "bce_loss",
    "create_train_state",
    "make_train_step",
    "fit",
    "restore_checkpoint",
    "save_checkpoint",
]
