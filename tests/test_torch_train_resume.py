"""A resumed ``fit`` keeps AdamW's step counters where a fresh run has them.

``restore_checkpoint`` loads a checkpoint to the CPU and lets
``load_state_dict`` place the tensors: the module's parameters and AdamW's
moments where the parameters live, each ``step`` counter on the CPU. A
``step`` on the card would cost Adam's bias correction a host sync per
parameter in every update. This file imports no JAX, so its ``cuda`` test
collects on the card's machine.
"""

import numpy as np
import pytest
import torch

from maze_image_processing_pipeline_tpu_torch.models import UNet
from maze_image_processing_pipeline_tpu_torch.models.train_loop import fit


def _batches(seed=0):
    rng = np.random.default_rng(seed)
    while True:
        x = rng.random((2, 32, 32, 3), dtype=np.float32)
        yield x, (x[..., :1] > 0.5).astype(np.float32)


def _resume(device, ckpt):
    """Two steps with a checkpoint after each, then a resume to four."""
    kw = dict(input_shape=(2, 32, 32, 3), checkpoint_dir=ckpt, checkpoint_every=1, log_interval=1e9, device=device)
    fit(UNet(1, 4, 1, dtype="float32"), _batches(), 2, **kw)
    return fit(UNet(1, 4, 1, dtype="float32"), _batches(seed=1), 4, **kw)


def _places(state):
    opt = state.optimizer
    return [(opt.state[p]["step"].device.type, opt.state[p]["exp_avg"].device, p.device)
            for g in opt.param_groups for p in g["params"]]


def test_resumed_fit_keeps_step_counters_on_the_cpu(tmp_path):
    state = _resume("cpu", str(tmp_path / "ckpt"))
    assert state.step == 4
    places = _places(state)
    assert places and all(step == "cpu" and moment == param for step, moment, param in places)


@pytest.mark.cuda
def test_cuda_resumed_fit_keeps_step_counters_on_the_cpu(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    state = _resume("cuda", str(tmp_path / "ckpt"))
    assert state.step == 4
    places = _places(state)
    assert len(places) == len(list(state.module.parameters()))
    assert all(step == "cpu" for step, _, _ in places), places
    assert all(moment.type == "cuda" and moment == param for _, moment, param in places), places
