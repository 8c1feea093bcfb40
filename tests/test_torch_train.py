"""Training of the PyTorch port against the JAX package's, on the CPU.

* The losses (``bce_dice_loss``, ``bce_loss``) on the same logits: rtol
  1e-6.
* The first train step of ``UNet(1, 4, 1)``, ``UNet(2, 8, 2)`` (float32,
  32×32) and ``ConvClassifier(4, (4, 8))`` from the JAX package's
  ``create_train_state`` parameters (carried over with ``params_from_jax``):
  the loss within rtol 1e-5 and every gradient within 1e-4 of its tensor's
  norm plus 1e-6 of the whole gradient's norm (convolutions and sums in other
  orders; the conv biases that feed a GroupNorm have an analytically zero
  gradient, float noise of ~1e-8 on both sides).
* The optimizer alone: the same gradients into ``optax.adamw(1e-3)`` and the
  port's AdamW for three steps, parameters within 1e-6; and a JAX state of
  two steps carried over with ``adam_state_from_optax`` gives JAX's third
  step. (Parameters after several whole steps are not compared: Adam turns
  the float noise of the zero-gradient biases into ±lr steps.)
* The loss falls on a fixed batch; ``fit`` checkpoints and resumes at step
  granularity (resumed training equals uninterrupted training) and keeps
  the newest three checkpoints; a trained checkpoint loads in the JAX
  package's ``load_model`` and gives the port's forward within atol 1e-4.
* Without a card, ``create_train_state`` and ``fit`` raise unless
  ``device="cpu"``; a mesh raises (data parallel is not ported).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from maze_image_processing_pipeline_tpu.models import ConvClassifier as JClassifier
from maze_image_processing_pipeline_tpu.models import UNet as JUNet
from maze_image_processing_pipeline_tpu.models import load_model as j_load_model
from maze_image_processing_pipeline_tpu.models import train as j_train
from maze_image_processing_pipeline_tpu_torch.models import ConvClassifier, UNet, layers, save_model
from maze_image_processing_pipeline_tpu_torch.models import train as t_train
from maze_image_processing_pipeline_tpu_torch.models.model_io import (
    adam_state_from_optax,
    init_classifier_params,
    params_from_jax,
    params_to_jax,
)
from maze_image_processing_pipeline_tpu_torch.models.train_loop import fit, restore_checkpoint
from maze_image_processing_pipeline_tpu_torch.parallel import make_mesh


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the parallel test workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_losses_match_jax():
    rng = np.random.default_rng(0)
    logits = (rng.standard_normal((2, 8, 8, 2)) * 3).astype(np.float32)
    masks = (rng.random((2, 8, 8, 2)) > 0.5).astype(np.float32)
    ref = float(j_train.bce_dice_loss(jnp.asarray(logits), jnp.asarray(masks)))
    ours = float(t_train.bce_dice_loss(torch.from_numpy(logits), torch.from_numpy(masks)))
    np.testing.assert_allclose(ours, ref, rtol=1e-6)
    logits, targets = logits.reshape(8, 32), masks.reshape(8, 32)
    ref = float(j_train.bce_loss(jnp.asarray(logits), jnp.asarray(targets)))
    np.testing.assert_allclose(float(t_train.bce_loss(torch.from_numpy(logits), torch.from_numpy(targets))), ref,
                               rtol=1e-6)


MODELS = {
    "unet-1-4-1": (lambda: JUNet(1, 4, 1, dtype=jnp.float32), lambda: UNet(1, 4, 1, dtype="float32"),
                   (2, 32, 32, 3), (2, 32, 32, 1), "bce_dice_loss"),
    "unet-2-8-2": (lambda: JUNet(2, 8, 2, dtype=jnp.float32), lambda: UNet(2, 8, 2, dtype="float32"),
                   (2, 32, 32, 3), (2, 32, 32, 2), "bce_dice_loss"),
    "classifier": (lambda: JClassifier(4, (4, 8), dtype=jnp.float32),
                   lambda: ConvClassifier(4, (4, 8), dtype="float32"), (4, 32, 32, 3), (4, 4), "bce_loss"),
}


def _as_numpy(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.mark.parametrize("name", sorted(MODELS))
def test_first_step_loss_and_gradients_match_jax(name):
    j_make, t_make, shape, target_shape, loss_name = MODELS[name]
    j_module = j_make()
    j_state, _ = j_train.create_train_state(j_module, jax.random.key(0), shape)
    rng = np.random.default_rng(1)
    x = rng.random(shape).astype(np.float32)
    y = (rng.random(target_shape) > 0.5).astype(np.float32)
    j_loss_fn = getattr(j_train, loss_name)
    ref_loss, ref_grads = jax.value_and_grad(lambda p: j_loss_fn(j_module.apply(p, x), y))(j_state.params)
    ref_grads = params_from_jax(_as_numpy(ref_grads))

    module = t_make()
    state, opt = t_train.create_train_state(module, shape, device="cpu")
    module.load_state_dict(params_from_jax(_as_numpy(j_state.params)))
    step = t_train.make_train_step(module, opt, loss_fn=getattr(t_train, loss_name))
    n6 = layers.group_norm_bwd.launches
    state, metrics = step(state, x, y)
    assert state.step == 1 and layers.group_norm_bwd.launches == n6
    np.testing.assert_allclose(float(metrics["loss"]), float(ref_loss), rtol=1e-5)
    total = np.sqrt(sum(float((g.double() ** 2).sum()) for g in ref_grads.values()))
    names = [k for k, _ in module.named_parameters()]
    assert sorted(names) == sorted(ref_grads)
    for k, p in module.named_parameters():  # the step leaves the gradients in .grad
        ref = ref_grads[k].numpy()
        err = float(np.abs(p.grad.numpy() - ref).max())
        assert err <= 1e-4 * float(np.linalg.norm(ref)) + 1e-6 * total, (k, err, float(np.linalg.norm(ref)))


def _grad_trees(params, n, seed):
    rng = np.random.default_rng(seed)
    return [jax.tree.map(lambda a: rng.standard_normal(a.shape).astype(np.float32), params) for _ in range(n)]


def _port_adamw_steps(module, opt, grads):
    for g in grads:
        for k, t in params_from_jax(g).items():
            module.get_parameter(k).grad = t
        opt.step()


def _max_diff(module, params):
    ours = jax.tree_util.tree_leaves(params_to_jax(module.state_dict()))
    return max(float(np.abs(a - b).max()) for a, b in zip(ours, jax.tree_util.tree_leaves(params)))


def test_adamw_matches_optax():
    cfg = dict(n_outputs=4, features=(4, 8))
    params = init_classifier_params(cfg, seed=3)
    grads = _grad_trees(params, 3, seed=4)
    opt = optax.adamw(1e-3)
    j_params, s = params, opt.init(params)
    module = ConvClassifier(**cfg, dtype="float32")
    _, t_opt = t_train.create_train_state(module, (2, 16, 16, 3), device="cpu")
    module.load_state_dict(params_from_jax(params))
    for g in grads:
        updates, s = opt.update(g, s, j_params)
        j_params = optax.apply_updates(j_params, updates)
        _port_adamw_steps(module, t_opt, [g])
        assert _max_diff(module, j_params) <= 1e-6


def test_optax_state_continues_in_the_port():
    cfg = dict(n_outputs=4, features=(4, 8))
    params = init_classifier_params(cfg, seed=5)
    grads = _grad_trees(params, 3, seed=6)
    opt = optax.adamw(1e-3)
    s = opt.init(params)
    for g in grads[:2]:
        updates, s = opt.update(g, s, params)
        params = optax.apply_updates(params, updates)
    module = ConvClassifier(**cfg, dtype="float32")
    _, t_opt = t_train.create_train_state(module, (2, 16, 16, 3), device="cpu")
    module.load_state_dict(params_from_jax(_as_numpy(params)))
    sd = t_opt.state_dict()
    sd["state"] = adam_state_from_optax(s, module)
    t_opt.load_state_dict(sd)
    updates, s = opt.update(grads[2], s, params)
    params = optax.apply_updates(params, updates)
    _port_adamw_steps(module, t_opt, grads[2:])
    assert _max_diff(module, _as_numpy(params)) <= 1e-6
    with pytest.raises(ValueError, match="ScaleByAdamState"):
        adam_state_from_optax(optax.sgd(1e-3).init(params), module)


def test_training_reduces_loss():
    module = UNet(out_channels=1, base_features=4, depth=1, dtype="float32")
    state, opt = t_train.create_train_state(module, (2, 32, 32, 3), device="cpu")
    step = t_train.make_train_step(module, opt)
    rng = np.random.default_rng(0)
    x = rng.random((2, 32, 32, 3)).astype(np.float32)
    y = (rng.random((2, 32, 32, 1)) > 0.5).astype(np.float32)
    losses = []
    for _ in range(5):
        state, metrics = step(state, x, y)
        losses.append(float(metrics["loss"]))
    assert losses[-1] < losses[0] and state.step == 5


def _batches(start=0, seed=0):
    """Batch i of a fixed stream, from batch ``start`` on."""
    i = start
    while True:
        rng = np.random.default_rng([seed, i])
        x = rng.random((2, 32, 32, 3)).astype(np.float32)
        yield x, (x.mean(axis=-1, keepdims=True) > 0.5).astype(np.float32)
        i += 1


def _fit(n_steps, data, ckpt, every):
    module = UNet(out_channels=1, base_features=4, depth=1, dtype="float32")
    return fit(module, data, n_steps, input_shape=(2, 32, 32, 3), checkpoint_dir=ckpt, checkpoint_every=every,
               log_interval=1e9, device="cpu")


def test_fit_checkpoints_and_resumes(tmp_path):
    ckpt = str(tmp_path / "ckpt")
    state = _fit(4, _batches(), ckpt, every=2)
    assert state.step == 4 and sorted(os.listdir(ckpt), key=int) == ["2", "4"]
    # Resuming continues from the saved step; the result equals an
    # uninterrupted run over the same batches (optimizer moments restored).
    resumed = _fit(6, _batches(start=4), ckpt, every=100)
    whole = _fit(6, _batches(), None, every=100)
    assert resumed.step == 6 and sorted(os.listdir(ckpt), key=int) == ["2", "4", "6"]
    for (k, a), b in zip(resumed.module.state_dict().items(), whole.module.state_dict().values()):
        torch.testing.assert_close(a, b, rtol=0, atol=0, msg=k)

    fresh, _ = t_train.create_train_state(UNet(1, 4, 1, dtype="float32"), (2, 32, 32, 3), device="cpu")
    first = fresh.module.ConvBlock_0.Conv_0.weight.detach().clone()
    restored, step = restore_checkpoint(ckpt, fresh)
    assert step == 6 and restored.step == 6
    assert not torch.equal(first, restored.module.ConvBlock_0.Conv_0.weight)
    _fit(9, _batches(start=6), ckpt, every=1)
    assert sorted(os.listdir(ckpt), key=int) == ["7", "8", "9"]  # the newest three


def test_trained_checkpoint_loads_in_the_jax_package(tmp_path):
    module = UNet(out_channels=2, base_features=8, depth=2, dtype="float32")
    data = ((x, np.concatenate([y, 1 - y], axis=-1)) for x, y in _batches(seed=1))
    fit(module, data, 3, input_shape=(2, 32, 32, 3), log_interval=1e9, device="cpu")
    save_model(str(tmp_path / "unet"), module, outputs={"pred": {"channel_names": ["a", "b"]}})
    j_loaded = j_load_model(str(tmp_path / "unet"))
    x = np.random.default_rng(2).random((2, 32, 32, 3), dtype=np.float32)
    with torch.no_grad():
        ours = module.eval()(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(np.asarray(j_loaded(jnp.asarray(x))), ours, rtol=0, atol=1e-4)


def test_training_needs_a_card_unless_asked_for_the_cpu(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        t_train.create_train_state(UNet(1, 4, 1), (2, 32, 32, 3))
    with pytest.raises(RuntimeError, match="no CUDA card"):
        fit(UNet(1, 4, 1), _batches(), 1, input_shape=(2, 32, 32, 3), checkpoint_dir=str(tmp_path))
    assert not os.path.exists(tmp_path / "1")
    # A mesh of a card needs the card; a mesh of CPU replicas is asked for by name.
    with pytest.raises(RuntimeError, match="no CUDA card"):
        t_train.create_train_state(UNet(1, 4, 1), (2, 32, 32, 3), device="cpu",
                                   mesh=make_mesh({"data": 1}, devices=["cuda"]))
    module = UNet(1, 4, 1)
    t_train.create_train_state(module, (2, 32, 32, 3), mesh=make_mesh({"data": 2}, devices=["cpu"] * 2))
    assert next(module.parameters()).device.type == "cpu"
    with pytest.raises(ValueError, match="channels"):
        t_train.create_train_state(UNet(1, 4, 1), (2, 32, 32, 1), device="cpu")
