"""Training loop with step-granular checkpoint and resume.

Counterpart of ``fit``, ``save_checkpoint`` and ``restore_checkpoint`` of
``maze_image_processing_pipeline_tpu/models/train_loop.py``, with the same
arguments and a ``device`` (the card unless ``"cpu"``); with a ``mesh``
(:func:`..parallel.make_mesh`) each step runs over the mesh's cards, a
U-Net sharded where the mesh's axes shard it (:func:`.train.make_train_step`).
The loop restores the newest
checkpoint on start and saves every ``checkpoint_every`` steps and at the
end, so a stopped job continues where it stopped.

Checkpoints are ``torch.save`` files, not orbax directories: one
``<checkpoint_dir>/<step>/state.pt`` per saved step holding the model's and
the optimizer's state dicts and the step, written under a temporary name and
renamed into place; the newest three are kept (orbax's ``max_to_keep=3``).
On a mesh that spans processes every process gathers the whole parameters
and the owners' AdamW state (``unet.ShardedNet.optimizer_state_dict``; a
data-parallel state is the same on every process), process 0 writes the
file while the others wait at a barrier, and every process restores its own
share of it: the file is the one a single process on a mesh of the same
shape writes.
orbax and flax are not on the card's machine, so the JAX package's orbax
checkpoints are not read here: carry a JAX train state over with
``model_io.params_from_jax`` and ``model_io.adam_state_from_optax``, and
trained weights out with ``model_io.save_model``, which both packages'
``load_model`` read.
"""

from __future__ import annotations

import logging
import os
import shutil
import tempfile
from typing import Callable, Iterator, List, Optional, Tuple

import numpy as np
import torch

from ..parallel.multihost import barrier, host_id
from ..progress import ProgressLogger
from .train import TrainState, bce_dice_loss, create_train_state, make_train_step
from .unet import ShardedNet

logger = logging.getLogger(__name__)

__all__ = ["fit", "save_checkpoint", "restore_checkpoint"]

MAX_TO_KEEP = 3
_FILE = "state.pt"


def _saved_steps(checkpoint_dir: str) -> List[int]:
    if not os.path.isdir(checkpoint_dir):
        return []
    return sorted(
        int(d) for d in os.listdir(checkpoint_dir)
        if d.isdigit() and os.path.isfile(os.path.join(checkpoint_dir, d, _FILE))
    )


def _spans(state: TrainState) -> bool:
    return state.mesh is not None and state.mesh.spans_processes


def save_checkpoint(checkpoint_dir: str, state: TrainState, step: int) -> None:
    """Write ``state`` as step ``step`` (replacing a checkpoint of the same
    step) and delete all but the newest ``MAX_TO_KEEP``. On a mesh that
    spans processes every process calls it; process 0 writes."""
    model = state.module.state_dict()
    if isinstance(state.module, ShardedNet):
        opt = state.module.optimizer_state_dict(state.optimizer)
    else:
        opt = state.optimizer.state_dict()
    if _spans(state):
        if host_id() == 0:
            _write(checkpoint_dir, model, opt, step)
        barrier(state.mesh.local_devices()[0])
    else:
        _write(checkpoint_dir, model, opt, step)


def _write(checkpoint_dir: str, model: dict, opt: dict, step: int) -> None:
    os.makedirs(checkpoint_dir, exist_ok=True)
    tmp = tempfile.mkdtemp(prefix=f".{step}-", dir=checkpoint_dir)
    try:
        torch.save({"model": model, "optimizer": opt, "step": int(step)}, os.path.join(tmp, _FILE))
        final = os.path.join(checkpoint_dir, str(int(step)))
        if os.path.isdir(final):
            shutil.rmtree(final)
        os.replace(tmp, final)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    for old in _saved_steps(checkpoint_dir)[:-MAX_TO_KEEP]:
        shutil.rmtree(os.path.join(checkpoint_dir, str(old)))


def restore_checkpoint(checkpoint_dir: str, state: TrainState) -> Tuple[TrainState, int]:
    """Load the newest checkpoint into ``state`` (its module and optimizer,
    in place; on a mesh that spans processes this process's share);
    returns (state, step), step 0 if there is none."""
    steps = _saved_steps(checkpoint_dir)
    if not steps:
        return state, 0
    # Loaded to the CPU: load_state_dict places the module's tensors and
    # AdamW's moments where the parameters live and leaves each ``step`` on
    # the CPU, as a fresh run has it (a ``step`` on the card costs a host
    # sync per parameter in every update).
    saved = torch.load(os.path.join(checkpoint_dir, str(steps[-1]), _FILE), map_location="cpu", weights_only=True)
    state.module.load_state_dict(saved["model"])
    if isinstance(state.module, ShardedNet):
        state.module.load_optimizer_state_dict(state.optimizer, saved["optimizer"])
    else:
        state.optimizer.load_state_dict(saved["optimizer"])
    state.step = int(saved["step"])
    logger.info("Restored checkpoint step %d from %s", state.step, checkpoint_dir)
    return state, state.step


def fit(
    module,
    data_iter: Iterator[Tuple[np.ndarray, np.ndarray]],
    n_steps: int,
    *,
    learning_rate: float = 1e-3,
    input_shape: Tuple[int, ...],
    loss_fn: Callable = bce_dice_loss,
    mesh=None,
    checkpoint_dir: Optional[str] = None,
    checkpoint_every: int = 100,
    log_interval: float = 30,
    seed: int = 0,
    device="cuda",
) -> TrainState:
    """Train ``module`` on (images, targets) batches with checkpoint/resume.

    ``device`` is the card unless ``"cpu"`` (no card raises); with a
    ``mesh`` each step runs over its cards (:func:`.train.make_train_step`;
    a sharded state's trained weights are copied back into ``module`` at
    the end). On a mesh that spans processes every process calls ``fit``
    with the same batches (module docstring for the checkpoints)."""
    state, optimizer = create_train_state(
        module, input_shape, learning_rate=learning_rate, seed=seed, device=device, mesh=mesh
    )
    start_step = 0
    if checkpoint_dir is not None:
        state, start_step = restore_checkpoint(checkpoint_dir, state)

    step_fn = make_train_step(module, optimizer, loss_fn=loss_fn, mesh=mesh)
    progress = ProgressLogger(description="train", n_total=n_steps, log_interval=log_interval, unit="step")

    metrics = None
    saved = start_step
    for step in range(start_step, n_steps):
        images, targets = next(data_iter)
        state, metrics = step_fn(state, images, targets)
        progress.update()
        if checkpoint_dir is not None and checkpoint_every and (step + 1) % checkpoint_every == 0:
            save_checkpoint(checkpoint_dir, state, step + 1)
            saved = step + 1

    if checkpoint_dir is not None and saved != state.step:
        save_checkpoint(checkpoint_dir, state, state.step)
    if metrics is not None:
        logger.info("Training finished at step %d (loss %.4f)", state.step, float(metrics["loss"]))
    if state.module is not module:  # sharded over the mesh: the whole weights, for save_model
        module.load_state_dict(state.module.state_dict())
    return state
