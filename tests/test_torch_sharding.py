"""One U-Net sharded over a mesh's ``space`` and ``model`` axes in the PyTorch
port (``models.unet.ShardedUNet``, ``models.layers.sharded_group_norm``,
``parallel.mesh``), against the JAX package and the port's unsharded paths.

On the CPU a port mesh is made of replicas of the CPU device; the JAX
package runs on the 8 virtual CPU devices of ``tests/conftest.py``. At
``tests/test_models.py``'s size (``UNet(1, 64, 1)``, a batch of 4 of 32² × 3,
the same weights through ``params_from_jax``):

* the ``{data: 2, space: 2, model: 2}`` train step equals the JAX step on
  the same mesh and the port's one-device step over two steps;
* uneven ``space`` shares (16/12/12 rows) and shares with no rows give the
  unsharded step;
* ``{model: 2}`` inference in both nodes equals the unsharded node and the
  JAX node;
* the sharded norm's plain partials and apply equal ``group_norm_plain`` /
  ``group_norm_bwd_plain`` on shards of rows, of channels and of channels
  that cut a group;
* the placement: the conv weights split are exactly those the JAX rule
  splits, each card holds its slice, and each ``space`` card's activations
  its share of rows.

The ``ConvClassifier`` sharded the same way (``models.classifier.
ShardedClassifier``), at ``features (16, 64)``, ``n_outputs 64`` on 32²
inputs: its train step on ``{data: 1, space: 2, model: 2}``, ``{model:
4}`` and ``{model: 3}`` (a slice that cuts a GroupNorm group) against the
JAX step on the same mesh and the one-device step; odd and uneven rows;
``TorchInference`` on ``{model: 2}`` against one device; the JAX rule's
split of its convs and dense layers.

The ``cuda`` tests hold the split K5/K6 launches to their plain versions on
the card; they skip here. The JAX package is imported inside the tests that
run it, so that the ``cuda`` tests collect where flax is absent.
"""

import math

import numpy as np
import pytest
import torch

from maze_image_processing_pipeline_tpu_torch import parallel as tp
from maze_image_processing_pipeline_tpu_torch.models import layers
from maze_image_processing_pipeline_tpu_torch.models import model_io as t_model_io
from maze_image_processing_pipeline_tpu_torch.models import train as t_train
from maze_image_processing_pipeline_tpu_torch.models import unet as t_unet
from maze_image_processing_pipeline_tpu_torch.models.classifier import ConvClassifier, ShardedClassifier
from maze_image_processing_pipeline_tpu_torch.models.unet import ShardedNet, ShardedUNet
from maze_image_processing_pipeline_tpu_torch.models.unet import UNet as TorchUNet
from maze_image_processing_pipeline_tpu_torch.parallel import mesh as t_mesh

CPU = torch.device("cpu")
LR = 1e-3
cuda = pytest.mark.skipif(not torch.cuda.is_available(), reason="needs a CUDA card")


def _cpu_mesh(axes):
    return tp.make_mesh(axes, devices=[CPU] * math.prod(axes.values()))


def _batch(rng, B, H, W, out=1):
    x = rng.random((B, H, W, 3)).astype(np.float32)
    y = (rng.random((B, H, W, out)) > 0.5).astype(np.float32)
    return x, y


def _port_steps(cfg, init, mesh, x, y, steps, make=TorchUNet, loss_fn=t_train.bce_dice_loss, every_step=False):
    """The port's train step of ``make(**cfg)`` from the parameters
    ``init`` (a state dict): the losses, the gradients of the last step and
    the parameters after it (with ``every_step``, lists of each step's)."""
    module = make(**cfg, dtype="float32")
    state, opt = t_train.create_train_state(module, x.shape, device="cpu", mesh=mesh)
    state.module.load_state_dict(init)
    step = t_train.make_train_step(module, opt, loss_fn=loss_fn, mesh=mesh)
    losses, grads, params = [], [], []
    for _ in range(steps):
        state, m = step(state, x, y)
        losses.append(float(m["loss"]))
        if isinstance(state.module, ShardedNet):
            grads.append(state.module.grads())
            params.append(state.module.state_dict())
        else:
            grads.append({k: p.grad.clone() for k, p in module.named_parameters()})
            params.append({k: v.detach().clone() for k, v in module.state_dict().items()})
    assert state.step == steps
    return (losses, grads, params) if every_step else (losses, grads[-1], params[-1])


def _unet_norm_bias(k: str) -> bool:
    """The U-Net's conv biases that feed a GroupNorm."""
    return k.startswith("ConvBlock_") and k.endswith(".bias")


def _hold_params(params, ref_params, sure_grads, total, steps, noise_bias=_unet_norm_bias):
    """Parameters within rtol 1e-5 wherever every step's reference gradient
    exceeds 1e-2 of its tensor's norm plus 1e-6 of the whole gradient's and
    keeps its sign, plus 1e-2 lr for each step after the first; the others
    within 2 lr a step. AdamW's first step moves every element by lr times
    the sign of its gradient: an element of a smaller gradient may move the
    other way on float noise (``test_torch_parallel.py``'s rule). A later
    step moves it by lr times a ratio of its gradients' moments, so their
    float noise (about 1e-3 of a gradient near the threshold) moves it by up
    to about 1e-2 lr, and more where the gradient changes sign and the first
    moment is a difference (the JAX package's step and the port's unsharded
    one differ by up to 2e-5 there after two steps). The biases of the
    convs that feed a GroupNorm have an analytically zero gradient (the norm
    removes a shift of a channel): their gradients are float noise, and
    every element of them is held within 2 lr a step."""
    assert sorted(params) == sorted(ref_params)
    for k, p in params.items():
        noise = noise_bias(k)
        sure = torch.full_like(p, not noise, dtype=torch.bool)
        for grads in sure_grads:
            sure &= grads[k].abs() > 1e-2 * float(grads[k].norm()) + 1e-6 * total
            sure &= torch.sign(grads[k]) == torch.sign(sure_grads[0][k])
        np.testing.assert_allclose(p[sure].numpy(), ref_params[k][sure].numpy(), rtol=1e-5,
                                   atol=max(1e-6, 1e-2 * LR * (steps - 1)), err_msg=k)
        if bool((~sure).any()):
            assert float((p - ref_params[k]).abs()[~sure].max()) <= 2 * steps * LR * (1 + 1e-5), k


def test_dp_sp_tp_train_step_matches_jax_and_one_device():
    """``UNet(1, 64, 1)`` float32 on ``{data: 2, space: 2, model: 2}``: the
    JAX step on the same mesh of 8 virtual devices, the port's sharded step
    on 8 CPU replicas and its one-device step, two steps from the JAX
    initial parameters: the losses within rtol 1e-5, the parameters after
    two steps within rtol 1e-5 (:func:`_hold_params`)."""
    import jax
    import jax.numpy as jnp

    from maze_image_processing_pipeline_tpu.models import train as j_train
    from maze_image_processing_pipeline_tpu.models.unet import UNet as JaxUNet
    from maze_image_processing_pipeline_tpu.parallel import make_mesh as j_make_mesh

    cfg = dict(out_channels=1, base_features=64, depth=1)
    axes = {"data": 2, "space": 2, "model": 2}
    x, y = _batch(np.random.default_rng(0), 4, 32, 32)

    j_mesh = j_make_mesh(axes)
    j_module = JaxUNet(**cfg, dtype=jnp.float32)
    j_state, j_opt = j_train.create_train_state(j_module, jax.random.key(0), (2, 32, 32, 3), mesh=j_mesh)
    j_step = j_train.make_train_step(j_module, j_opt, mesh=j_mesh)
    init = t_model_io.params_from_jax(jax.tree.map(np.asarray, j_state.params))
    grad_of = jax.jit(jax.grad(lambda p: j_train.bce_dice_loss(j_module.apply(p, x), y)))
    j_losses, j_grads = [], []
    for _ in range(2):
        j_grads.append(t_model_io.params_from_jax(jax.tree.map(np.asarray, grad_of(j_state.params))))
        j_state, m = j_step(j_state, x, y)
        j_losses.append(float(m["loss"]))
    j_params = t_model_io.params_from_jax(jax.tree.map(np.asarray, j_state.params))
    total = np.sqrt(sum(float((g.double() ** 2).sum()) for g in j_grads[0].values()))

    losses, grads, params = _port_steps(cfg, init, _cpu_mesh(axes), x, y, 2)
    one_losses, one_grads, one_params = _port_steps(cfg, init, None, x, y, 2)
    for ref in (j_losses, one_losses):
        np.testing.assert_allclose(losses, ref, rtol=1e-5)
    # The second step's gradients: within test_torch_train.py's tolerance of
    # the one-device step's (1e-4 of the tensor's norm plus 1e-6 of the whole).
    for k, g in one_grads.items():
        assert float((grads[k] - g).abs().max()) <= 1e-4 * float(g.norm()) + 1e-6 * total, k
    _hold_params(params, j_params, j_grads, total, 2)
    _hold_params(params, one_params, j_grads, total, 2)


def _classifier_norm_bias(k: str) -> bool:
    """The classifier's conv biases (each feeds a GroupNorm)."""
    return k.startswith("Conv_") and k.endswith(".bias")


@pytest.mark.parametrize("features, axes", [
    ((16, 64), {"data": 1, "space": 2, "model": 2}),
    ((16, 64), {"model": 4}),
    # 72 channels over 3 slices of 24: each slice cuts a group of 9.
    ((16, 72), {"model": 3}),
])
def test_classifier_train_step_matches_jax_and_one_device(features, axes):
    """``ConvClassifier(64, features)`` float32, a batch of 4 of 32² × 3,
    ``bce_loss``, from the JAX initial parameters: the port's sharded step
    on CPU replicas against the JAX step on the same mesh of virtual
    devices (one step: the loss within rtol 1e-5, the gradients within 1e-4
    of their tensor's norm plus 1e-6 of the whole, the parameters by
    :func:`_hold_params`) and against the port's one-device step (two
    steps: the losses within rtol 1e-5, the first step's gradients within
    the same bound, the parameters after two steps by
    :func:`_hold_params`).

    The JAX mesh step is held to its first step: on ``{data: 1, space: 2,
    model: 2}`` its second step reports a loss 1.9e-5 (relative) from the
    loss of the parameters it steps from, and its parameters after it miss
    JAX's one-device step's by 3e-5 where the port's pass. The second
    step's gradients are not held to the gradient bound either: from JAX's
    initial parameters the first AdamW step moves elements whose gradients
    are float noise by up to 1e-4 differently on each path
    (``_hold_params``' rule), and the second step's first-layer gradients
    then differ by up to 2.4 times the bound between the port's own sharded
    and one-device steps."""
    import jax
    import jax.numpy as jnp

    from maze_image_processing_pipeline_tpu.models import train as j_train
    from maze_image_processing_pipeline_tpu.models.classifier import ConvClassifier as JaxClassifier
    from maze_image_processing_pipeline_tpu.parallel import make_mesh as j_make_mesh

    cfg = dict(n_outputs=64, features=features)
    rng = np.random.default_rng(7)
    x = rng.random((4, 32, 32, 3)).astype(np.float32)
    y = (rng.random((4, 64)) > 0.5).astype(np.float32)

    j_mesh = j_make_mesh(axes, devices=jax.devices()[: math.prod(axes.values())])
    j_module = JaxClassifier(**cfg, dtype=jnp.float32)
    j_state, j_opt = j_train.create_train_state(j_module, jax.random.key(0), (2, 32, 32, 3), mesh=j_mesh)
    init = t_model_io.params_from_jax(jax.tree.map(np.asarray, j_state.params))
    grad_of = jax.jit(jax.grad(lambda p: j_train.bce_loss(j_module.apply(p, x), y)))
    j_grads = t_model_io.params_from_jax(jax.tree.map(np.asarray, grad_of(j_state.params)))
    j_state, m = j_train.make_train_step(j_module, j_opt, loss_fn=j_train.bce_loss, mesh=j_mesh)(j_state, x, y)
    j_params = t_model_io.params_from_jax(jax.tree.map(np.asarray, j_state.params))
    total = np.sqrt(sum(float((g.double() ** 2).sum()) for g in j_grads.values()))

    mesh = _cpu_mesh(axes)
    assert t_train.shards(ConvClassifier(**cfg), mesh)
    kw = dict(make=ConvClassifier, loss_fn=t_train.bce_loss, every_step=True)
    losses, grads, params = _port_steps(cfg, init, mesh, x, y, 2, **kw)
    one_losses, one_grads, one_params = _port_steps(cfg, init, None, x, y, 2, **kw)
    np.testing.assert_allclose(losses[0], float(m["loss"]), rtol=1e-5)
    np.testing.assert_allclose(losses, one_losses, rtol=1e-5)
    for ref in (j_grads, one_grads[0]):
        for k, g in ref.items():
            assert float((grads[0][k] - g).abs().max()) <= 1e-4 * float(g.norm()) + 1e-6 * total, k
    _hold_params(params[0], j_params, [j_grads], total, 1, _classifier_norm_bias)
    _hold_params(params[1], one_params[1], one_grads, total, 2, _classifier_norm_bias)


@pytest.mark.parametrize("H, W, axes", [
    (37, 29, {"space": 2}),  # odd extents: SAME pads (1, 1), the shard below takes a row from above
    (64, 24, {"space": 4}),
    (20, 20, {"space": 3, "model": 2}),  # the rows round up to 24: the last share is cut short, one is empty
])
def test_sharded_classifier_on_uneven_rows_gives_the_unsharded_step(H, W, axes):
    """``ConvClassifier(5, (8, 64))`` float32, one step on rows that are not
    a multiple of ``2**len(features)`` or that leave a share empty: the
    one-device step's loss (rtol 1e-5) and gradients (1e-4 of the tensor's
    norm plus 1e-6 of the whole)."""
    cfg = dict(n_outputs=5, features=(8, 64))
    rng = np.random.default_rng(H)
    x = rng.random((2, H, W, 3)).astype(np.float32)
    y = (rng.random((2, 5)) > 0.5).astype(np.float32)
    init = t_model_io.params_from_jax(t_model_io.init_classifier_params(dict(cfg, in_channels=3), seed=5))
    kw = dict(make=ConvClassifier, loss_fn=t_train.bce_loss)
    (loss,), grads, _ = _port_steps(cfg, init, _cpu_mesh(axes), x, y, 1, **kw)
    (ref,), ref_grads, _ = _port_steps(cfg, init, None, x, y, 1, **kw)
    np.testing.assert_allclose(loss, ref, rtol=1e-5)
    total = math.sqrt(sum(float((g.double() ** 2).sum()) for g in ref_grads.values()))
    for k, g in ref_grads.items():
        assert float((grads[k] - g).abs().max()) <= 1e-4 * float(g.norm()) + 1e-6 * total, k


@pytest.mark.parametrize("axes, H, depth, shares", [
    ({"space": 3}, 40, 2, [16, 12, 12]),
    ({"space": 4}, 8, 2, [4, 4, 0, 0]),
    ({"data": 2, "space": 2}, 24, 3, [16, 8]),
])
def test_uneven_and_empty_space_shares_give_the_unsharded_step(axes, H, depth, shares):
    """``UNet(2, 8, depth)`` float32, one step: uneven ``space`` shares of
    whole multiples of ``2**depth`` rows, and shares with no rows (those
    cards take no part), give the one-device step's loss (rtol 1e-5) and
    gradients (1e-4 of the tensor's norm plus 1e-6 of the whole)."""
    assert [s.stop - s.start for s in t_mesh.space_rows(H, axes["space"], depth)] == shares
    cfg = dict(out_channels=2, base_features=8, depth=depth)
    x, y = _batch(np.random.default_rng(H), 2 * axes.get("data", 1), H, 16, out=2)
    module = TorchUNet(**cfg, dtype="float32")
    init = t_model_io.params_from_jax(t_model_io.init_unet_params(dict(cfg, in_channels=3), seed=4))
    module.load_state_dict(init)
    (loss,), grads, _ = _port_steps(cfg, init, _cpu_mesh(axes), x, y, 1)
    (ref,), ref_grads, _ = _port_steps(cfg, init, None, x, y, 1)
    np.testing.assert_allclose(loss, ref, rtol=1e-5)
    total = math.sqrt(sum(float((g.double() ** 2).sum()) for g in ref_grads.values()))
    for k, g in ref_grads.items():
        assert float((grads[k] - g).abs().max()) <= 1e-4 * float(g.norm()) + 1e-6 * total, k


def test_space_rows_and_mesh_grid():
    assert [(s.start, s.stop) for s in t_mesh.space_rows(40, 3, 2)] == [(0, 16), (16, 28), (28, 40)]
    assert [(s.start, s.stop) for s in t_mesh.space_rows(32, 2, 1)] == [(0, 16), (16, 32)]
    with pytest.raises(ValueError, match="not a multiple of 2\\*\\*2"):
        t_mesh.space_rows(30, 2, 2)
    devices = [torch.device("cpu", i) for i in range(8)]
    mesh = tp.make_mesh({"model": 2, "data": 2, "space": 2}, devices=devices)
    grid = t_mesh.mesh_grid(mesh)
    assert grid.shape == (2, 2, 2)
    # The mesh's devices are (model, data, space); the grid (data, space, model).
    assert all(grid[d, s, m] == mesh.devices[m, d, s] for d in range(2) for s in range(2) for m in range(2))
    assert t_mesh.mesh_grid(tp.make_mesh({"data": 4, "x": 2}, devices=devices)).shape == (8, 1, 1)


def test_shard_params_splits_what_the_jax_rule_splits():
    """``UNet(2, 32, 2)`` under ``{data: 2, model: 2}``: the port splits
    exactly the conv weights whose JAX kernels ``shard_params`` places over
    ``model`` (at least 64 output channels, divisible by the axis), with
    their biases; each card holds half their output channels and every
    other parameter whole; ``{model: 3}`` splits none (64 and 128 do not
    divide by 3)."""
    import jax
    from jax.sharding import PartitionSpec

    from maze_image_processing_pipeline_tpu.parallel import make_mesh as j_make_mesh
    from maze_image_processing_pipeline_tpu.parallel import shard_params as j_shard_params

    cfg = dict(out_channels=2, base_features=32, depth=2)
    flax = t_model_io.init_unet_params(dict(cfg, in_channels=3), seed=0)
    module = TorchUNet(**cfg, dtype="float32")
    module.load_state_dict(t_model_io.params_from_jax(flax))
    j_placed = j_shard_params(flax, j_make_mesh({"data": 2, "model": 2}, devices=jax.devices()[:4]))
    j_split = set()
    for path, leaf in jax.tree_util.tree_flatten_with_path(j_placed)[0]:
        if leaf.sharding.spec != PartitionSpec():
            keys = [p.key for p in path if p.key != "params"]
            assert keys[-1] == "kernel"
            j_split.add(".".join(keys[:-1]))
    assert j_split == {"ConvBlock_1.Conv_0", "ConvBlock_1.Conv_1", "ConvBlock_2.Conv_0", "ConvBlock_2.Conv_1",
                       "Conv_0", "ConvBlock_3.Conv_0", "ConvBlock_3.Conv_1"}
    names = t_mesh.sharded_names(module, 2)
    assert set(names) == {f"{n}.{leaf}" for n in j_split for leaf in ("weight", "bias")}

    placed = tp.shard_params(module, _cpu_mesh({"data": 2, "model": 2}))
    assert sorted(placed) == [(d, 0, m) for d in range(2) for m in range(2)]
    for (d, s, m), held in placed.items():
        for k, p in module.state_dict().items():
            want = p.chunk(2)[m] if k in names else p
            assert held[k].shape == want.shape and torch.equal(held[k], want), (k, m)
    assert t_mesh.sharded_names(module, 3) == []
    assert t_mesh.model_split((128, 64, 3, 3), 2) and not t_mesh.model_split((32, 3, 3, 3), 2)
    assert not t_mesh.model_split((128,), 2)  # 1-D parameters stay whole in the JAX rule


@pytest.mark.parametrize("size, n_outputs", [(2, 8), (4, 64), (3, 72)])
def test_shard_params_splits_the_classifier_as_the_jax_rule(size, n_outputs):
    """``ConvClassifier(n_outputs)`` (features 32-256) under ``{model:
    size}``: the port splits exactly the conv and dense weights whose JAX
    kernels ``shard_params`` places over ``model``, with their biases."""
    import jax
    from jax.sharding import PartitionSpec

    from maze_image_processing_pipeline_tpu.parallel import make_mesh as j_make_mesh
    from maze_image_processing_pipeline_tpu.parallel import shard_params as j_shard_params

    cfg = dict(n_outputs=n_outputs, features=(32, 64, 128, 256))
    flax = t_model_io.init_classifier_params(dict(cfg, in_channels=3), seed=0)
    j_placed = j_shard_params(flax, j_make_mesh({"model": size}, devices=jax.devices()[:size]))
    j_split = set()
    for path, leaf in jax.tree_util.tree_flatten_with_path(j_placed)[0]:
        if leaf.sharding.spec != PartitionSpec():
            keys = [p.key for p in path if p.key != "params"]
            j_split.add(".".join(keys[:-1]))
    module = ConvClassifier(**cfg)
    names = t_mesh.sharded_names(module, size)
    assert set(names) == {f"{n}.{leaf}" for n in j_split for leaf in ("weight", "bias")}
    if size == 2:
        assert j_split == {"Conv_2", "Conv_3", "Conv_4", "Conv_5", "Conv_6", "Conv_7", "Dense_0"}


def test_each_space_card_holds_its_rows(monkeypatch):
    """``{space: 2, model: 2}``: every norm of the forward gets each shard on
    its own card with its share of the rows at that level (half of them),
    and the split convs' outputs half the channels."""
    seen = []
    real = t_unet.sharded_group_norm

    def spy(xs, ws, bs, offsets, C, G, eps=1e-6):
        seen.append([(tuple(x.shape), o, C) for x, o in zip(xs, offsets)])
        return real(xs, ws, bs, offsets, C, G, eps)

    monkeypatch.setattr(t_unet, "sharded_group_norm", spy)
    module = TorchUNet(out_channels=1, base_features=64, depth=1, dtype="float32")
    sharded = ShardedUNet(module, _cpu_mesh({"space": 2, "model": 2}))
    with torch.no_grad():
        out = sharded(torch.rand(1, 32, 8, 3))
    assert out.shape == (1, 32, 8, 1)
    # Level 0 (64 channels, 32 rows), level 1 (128, 16) and the up block
    # (64, 32): two norms each, per model slice, each over both row shards.
    assert len(seen) == 12
    for call in seen:
        C = call[0][2]
        H = 16 if C == 128 else 32
        assert [shape for shape, _, _ in call] == [(1, C // 2, H // 2, 8 // (32 // H))] * 2
        assert {o for _, o, _ in call} in ({0}, {C // 2})


def _cuts(kind, C, H):
    """(channel start, stop, row start, stop) of each shard."""
    if kind == "rows":
        return [(0, C, 0, 3), (0, C, 3, H)]
    if kind == "channels":
        return [(0, C // 2, 0, H), (C // 2, C, 0, H)]
    # Channel cuts that straddle groups (4 channels a group), times rows.
    return [(c0, c1, r0, r1) for c0, c1 in ((0, 2), (2, 7), (7, C)) for r0, r1 in ((0, 4), (4, H))]


@pytest.mark.parametrize("kind", ["rows", "channels", "straddling groups"])
def test_sharded_group_norm_plain_matches_group_norm_plain(kind):
    """The sharded norm on the CPU (the launches' plain versions) on shards
    of rows, of channels along groups and of channels that cut groups: y,
    dx, dweight and dbias (summed over the shards) within 1e-5 of
    ``group_norm_plain`` and ``group_norm_bwd_plain`` (through autograd),
    float32."""
    B, C, H, W, G = 2, 16, 9, 5, 4
    gen = torch.Generator().manual_seed(3)
    x = torch.randn((B, C, H, W), generator=gen) * 2 + 0.5
    ct = torch.randn((B, C, H, W), generator=gen)
    w = torch.rand(C, generator=gen) + 0.5
    b = torch.randn(C, generator=gen)
    xr, wr, br = x.clone().requires_grad_(), w.clone().requires_grad_(), b.clone().requires_grad_()
    y_ref = layers.group_norm_plain(xr, wr, br, G)
    y_ref.backward(ct)
    cuts = _cuts(kind, C, H)
    xs = [x[:, c0:c1, r0:r1].clone().requires_grad_() for c0, c1, r0, r1 in cuts]
    ws = [w[c0:c1].clone().requires_grad_() for c0, c1, _, _ in cuts]
    bs = [b[c0:c1].clone().requires_grad_() for c0, c1, _, _ in cuts]
    ys = layers.sharded_group_norm(xs, ws, bs, [c[0] for c in cuts], C, G)
    torch.autograd.backward(ys, [ct[:, c0:c1, r0:r1] for c0, c1, r0, r1 in cuts])
    dw, db = torch.zeros(C), torch.zeros(C)
    for (c0, c1, r0, r1), xi, yi, wi, bi in zip(cuts, xs, ys, ws, bs):
        torch.testing.assert_close(yi, y_ref[:, c0:c1, r0:r1].detach(), rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(xi.grad, xr.grad[:, c0:c1, r0:r1], rtol=1e-5, atol=1e-5)
        dw[c0:c1] += wi.grad
        db[c0:c1] += bi.grad
    torch.testing.assert_close(dw, wr.grad, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(db, br.grad, rtol=1e-5, atol=1e-5)


def test_split_launches_plain_versions_compose_to_the_whole_norm():
    """The plain partials and apply of K5 and K6 on one whole tensor give
    ``group_stats_plain``'s sums, ``group_norm_plain`` and
    ``group_norm_bwd_plain`` (the dx coefficients by K6's formula)."""
    B, C, H, W, G = 3, 12, 6, 7, 3
    gen = torch.Generator().manual_seed(5)
    x = torch.randn((B, C, H, W), generator=gen) + 1.0
    ct = torch.randn((B, C, H, W), generator=gen)
    w, b = torch.rand(C, generator=gen) + 0.5, torch.randn(C, generator=gen)
    n = C // G * H * W
    sums = layers.group_partials_plain(x, G)
    stats = layers.group_stats_plain(x, G)
    torch.testing.assert_close(sums[0] / n, stats[0])
    torch.testing.assert_close(layers.group_norm_apply_plain(x, w, b, stats, G), layers.group_norm_plain(x, w, b, G))
    rows = layers.group_norm_bwd_partials_plain(x, ct, stats, G)
    dx_ref, dw_ref, db_ref = layers.group_norm_bwd_plain(x, ct, w, stats, G)
    torch.testing.assert_close(rows[0].view(B, C).sum(0), dw_ref, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(rows[1].view(B, C).sum(0), db_ref, rtol=1e-5, atol=1e-5)
    s2 = (w * rows[0].view(B, C)).view(B, G, C // G).sum(-1).reshape(-1)
    s1 = (w * rows[1].view(B, C)).view(B, G, C // G).sum(-1).reshape(-1)
    rstd = stats[1]
    coef = torch.stack([(-rstd * rstd) * s2 / n, (-rstd) * s1 / n])
    torch.testing.assert_close(layers.group_norm_bwd_apply_plain(x, ct, w, stats, coef, G), dx_ref,
                               rtol=1e-5, atol=1e-5)


def test_model_axis_inference_matches_one_device_and_jax(tmp_path):
    """``TorchInference`` (5 crops in batches of 2, padded for the mesh) and
    ``DeviceTiledInference`` (tiles 32 / 24) of a float32 ``UNet(2, 64, 1)``
    on ``{model: 2}`` CPU replicas (its 64- and 128-wide convs split, one
    sharded U-Net) and on ``{data: 2, model: 2}`` (two): the unsharded node
    within 1e-6, the JAX nodes on ``{data: 1, model: 2}`` within rtol 1e-4 /
    atol 2e-5."""
    import jax

    import chip_smoke
    from fixtures import draw_blob
    from maze_image_processing_pipeline_tpu import engine as j_engine
    from maze_image_processing_pipeline_tpu.models import model_io as j_model_io
    from maze_image_processing_pipeline_tpu.models.inference import DeviceTiledInference as JaxTiled
    from maze_image_processing_pipeline_tpu.models.inference import JaxInference
    from maze_image_processing_pipeline_tpu.parallel import make_mesh as j_make_mesh
    from maze_image_processing_pipeline_tpu_torch import engine as t_engine
    from maze_image_processing_pipeline_tpu_torch.models.inference import DeviceTiledInference, TorchInference

    path = chip_smoke.write_unet(str(tmp_path / "unet"), dict(out_channels=2, base_features=64, depth=1), "float32",
                                 seed=2, channel_names=("a", "b"))
    jm, tm = j_model_io.load_model(path, dtype="float32"), t_model_io.load_model(path, dtype="float32")
    j_mesh = j_make_mesh({"data": 1, "model": 2}, devices=jax.devices()[:2])
    rng = np.random.default_rng(3)
    crops = [draw_blob(rng, shape=(32, 32), r=8) for _ in range(5)]
    tiles = [draw_blob(rng, shape=s, r=10) for s in [(32, 32), (50, 40)]]

    def run(engine, make_node, items):
        out = []
        with engine.Pipeline() as p:
            img = engine.Unpack(items)
            engine.Call(lambda v: out.append(np.asarray(v, np.float32)), make_node(img))
        p.run()
        return out

    for name, items, jax_node, node in (
        ("TorchInference", crops, lambda img: JaxInference(jm, img, batch_size=2, mesh=j_mesh),
         lambda img, mesh: TorchInference(tm, img, batch_size=2, mesh=mesh, device="cpu")),
        ("DeviceTiledInference", tiles,
         lambda img: JaxTiled(jm, img, tile_size=32, tile_stride=24, batch_size=2, mesh=j_mesh)[0],
         lambda img, mesh: DeviceTiledInference(tm, img, tile_size=32, tile_stride=24, batch_size=2, mesh=mesh,
                                                device="cpu")[0]),
    ):
        ref = run(j_engine, jax_node, items)
        one = run(t_engine, lambda img: node(img, None), items)
        for axes in ({"model": 2}, {"data": 2, "model": 2}):
            ours = run(t_engine, lambda img: node(img, _cpu_mesh(axes)), items)
            assert [a.shape for a in ours] == [b.shape for b in ref] == [c.shape for c in one], name
            for a, b, c in zip(ours, ref, one):
                np.testing.assert_allclose(a, c, rtol=1e-6, atol=1e-6, err_msg=f"{name} {axes}")
                np.testing.assert_allclose(a, b, rtol=1e-4, atol=2e-5, err_msg=f"{name} {axes}")
    # The nodes' shares: one sharded U-Net or classifier a data index (the
    # classifier's 64- to 256-wide convs and Dense_0 split); a U-Net the
    # model axis splits nothing of stays a replica on each card.
    from maze_image_processing_pipeline_tpu_torch.models.inference import _placement

    for wide, kind in ((tm.module, ShardedUNet), (ConvClassifier(n_outputs=3), ShardedClassifier)):
        devices, forwards = _placement(wide, _cpu_mesh({"data": 2, "model": 2}), "cpu")
        assert len(devices) == 2 and all(isinstance(f.func, kind) and f.func.groups == 2 for f in forwards)
    narrow = TorchUNet(out_channels=1, base_features=8, depth=1)
    devices, forwards = _placement(narrow, _cpu_mesh({"data": 2, "model": 2}), "cpu")
    assert len(devices) == 4 and all(f is narrow for f in forwards)


def test_classifier_inference_on_the_model_axis_matches_one_device(tmp_path):
    """``TorchInference`` of a float32 ``ConvClassifier(64, (16, 64))`` (its
    64-wide conv, ``Dense_0`` and ``Dense_1`` split) on ``{model: 2}`` CPU
    replicas, 5 crops of 32² in batches of 2: the one-device node's
    probabilities within 1e-6."""
    from fixtures import draw_blob
    from maze_image_processing_pipeline_tpu_torch import engine as t_engine
    from maze_image_processing_pipeline_tpu_torch.models.inference import TorchInference
    from maze_image_processing_pipeline_tpu_torch.tools.synth import write_classifier

    path = write_classifier(str(tmp_path / "clf"), dict(n_outputs=64, features=[16, 64]), "float32", seed=3)
    model = t_model_io.load_model(path, dtype="float32")
    rng = np.random.default_rng(4)
    crops = [draw_blob(rng, shape=(32, 32), r=8) for _ in range(5)]
    runs = []
    for mesh in (None, _cpu_mesh({"model": 2})):
        out = []
        with t_engine.Pipeline() as p:
            img = t_engine.Unpack(crops)
            t_engine.Call(lambda v: out.append(np.asarray(v, np.float32)),
                          TorchInference(model, img, batch_size=2, mesh=mesh, device="cpu"))
        p.run()
        runs.append(out)
    assert [a.shape for a in runs[1]] == [b.shape for b in runs[0]] == [(64,)] * 5
    for a, b in zip(*runs):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6)
    assert set(t_mesh.sharded_names(model.module, 2)) == {f"{n}.{leaf}" for n in ("Conv_2", "Conv_3", "Dense_0", "Dense_1")
                                                        for leaf in ("weight", "bias")}



def test_sharded_fit_resumes_and_returns_the_whole_weights(tmp_path):
    """``fit`` of ``UNet(1, 8, 1)`` on ``{space: 2}`` CPU replicas: three
    steps in one run and two steps then a resumed third (the sharded
    state's checkpoint) end on the same parameters, copied back into the
    module."""
    from maze_image_processing_pipeline_tpu_torch.models.train_loop import fit

    def batches():
        rng = np.random.default_rng(6)
        while True:
            yield _batch(rng, 2, 16, 16)

    runs = []
    for name, stops in (("once", (3,)), ("resumed", (2, 3))):
        module = TorchUNet(out_channels=1, base_features=8, depth=1, dtype="float32")
        data = batches()
        for n in stops:
            state = fit(module, data, n, input_shape=(2, 16, 16, 3), checkpoint_dir=str(tmp_path / name),
                        checkpoint_every=2, device="cpu", mesh=_cpu_mesh({"space": 2}))
        assert isinstance(state.module, ShardedUNet) and state.step == 3
        whole = state.module.state_dict()
        assert all(torch.equal(whole[k], v) for k, v in module.state_dict().items())
        runs.append(whole)
    for k, v in runs[0].items():
        torch.testing.assert_close(runs[1][k], v, rtol=1e-6, atol=1e-7)


def test_dryrun_shards_on_four_cpu_replicas():
    """``parallel.dryrun`` on 4 CPU replicas factors ``{data: 1, space: 2,
    model: 2}``: its train steps (the U-Net's and the classifier's) are
    sharded, its inference nodes run, and its
    loki haul's archive equals the one-device run's."""
    from maze_image_processing_pipeline_tpu_torch.parallel.dryrun import dryrun_multichip

    out = dryrun_multichip(4, device="cpu", log=lambda line: None)
    assert out["mesh"] == {"data": 1, "space": 2, "model": 2}
    assert out["train_sharded"] and np.isfinite(out["train_loss"])
    assert out["classifier_sharded"] and np.isfinite(out["classifier_loss"])
    assert out["inference_objects"] == 6 and out["loki_rows"] > 0


# -- on the card ---------------------------------------------------------------

SPLIT_SHAPES = ((2, 64, 32, 24), (3, 24, 17, 9), (2, 512, 8, 8))


@cuda
@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("layout", ["NCHW", "channels_last"])
def test_cuda_split_launches_match_their_plain_versions(dtype, layout):
    """K5's and K6's partials and apply launches against their plain
    versions: the sums and rows within rtol 1e-5 / atol 1e-3 (float32 sums
    in other orders), y and dx within 1e-5 (float32) or one bf16 ulp; each
    call one launch."""
    import chip_smoke

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(9)
    fmt = torch.channels_last if layout == "channels_last" else torch.contiguous_format
    for shape in SPLIT_SHAPES:
        C = shape[1]
        G = min(8, C)
        x = (torch.randn(shape, device=dev, generator=gen) * 2 + 0.5).to(dtype).contiguous(memory_format=fmt)
        ct = torch.randn(shape, device=dev, generator=gen).to(dtype).contiguous(memory_format=fmt)
        w = torch.rand(C, device=dev, generator=gen) + 0.5
        b = torch.randn(C, device=dev, generator=gen)
        stats = layers.group_stats_plain(x, G)
        coef = torch.randn((2, shape[0] * G), device=dev, generator=gen) * 1e-3
        before = {f.__name__: f.launches for f in (layers.group_norm_partials, layers.group_norm_apply,
                                                   layers.group_norm_bwd_partials, layers.group_norm_bwd_apply)}
        got = (layers.group_norm_partials(x, G), layers.group_norm_apply(x, w, b, stats, G),
               layers.group_norm_bwd_partials(x, ct, stats, G), layers.group_norm_bwd_apply(x, ct, w, stats, coef, G))
        ref = (layers.group_partials_plain(x, G), layers.group_norm_apply_plain(x, w, b, stats, G),
               layers.group_norm_bwd_partials_plain(x, ct, stats, G),
               layers.group_norm_bwd_apply_plain(x, ct, w, stats, coef, G))
        torch.cuda.synchronize()
        for f in (layers.group_norm_partials, layers.group_norm_apply, layers.group_norm_bwd_partials,
                  layers.group_norm_bwd_apply):
            assert f.launches == before[f.__name__] + 1, f.__name__
        for k in (0, 2):
            torch.testing.assert_close(got[k], ref[k], rtol=1e-5, atol=1e-3)
        for k in (1, 3):
            assert got[k].stride() == x.stride()
            if dtype == torch.float32:
                torch.testing.assert_close(got[k], ref[k], rtol=1e-5, atol=1e-5)
            else:
                diff = (got[k].float() - ref[k].float()).abs()
                assert bool((diff <= chip_smoke.half_ulp(ref[k].float(), 7)).all()), (shape, k)


@cuda
@pytest.mark.cuda
def test_cuda_sharded_unet_step_on_replicas_matches_one_card():
    """``UNet(1, 64, 1)`` float32 (TF32 off) on ``{space: 2, model: 2}``
    over four replicas of the card: the loss within rtol 1e-5 of the
    one-card step's, and the split K5/K6 launches on the card."""
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    x, y = _batch(np.random.default_rng(1), 2, 64, 32)
    losses = []
    for mesh in (None, tp.make_mesh({"space": 2, "model": 2}, devices=[dev] * 4)):
        module = TorchUNet(out_channels=1, base_features=64, depth=1, dtype="float32")
        state, opt = t_train.create_train_state(module, x.shape, device=dev, mesh=mesh, seed=1)
        before = layers.group_norm_bwd_apply.launches
        state, m = t_train.make_train_step(module, opt, mesh=mesh)(state, x, y)
        losses.append(float(m["loss"]))
        if mesh is not None:
            assert layers.group_norm_bwd_apply.launches > before
    np.testing.assert_allclose(losses[1], losses[0], rtol=1e-5)


@cuda
@pytest.mark.cuda
def test_cuda_sharded_classifier_step_on_replicas_matches_one_card():
    """``ConvClassifier(64, (16, 64))`` float32 (TF32 off) on ``{space: 2,
    model: 2}`` over four replicas of the card, a batch of 4 of 64²: the
    loss within rtol 1e-5 of the one-card step's, and the split K5/K6
    launches on the card."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(2)
    x = rng.random((4, 64, 64, 3)).astype(np.float32)
    y = (rng.random((4, 64)) > 0.5).astype(np.float32)
    losses = []
    for mesh in (None, tp.make_mesh({"space": 2, "model": 2}, devices=[dev] * 4)):
        module = ConvClassifier(n_outputs=64, features=(16, 64), dtype="float32")
        state, opt = t_train.create_train_state(module, x.shape, device=dev, mesh=mesh, seed=1)
        before = (layers.group_norm_apply.launches, layers.group_norm_bwd_apply.launches)
        state, m = t_train.make_train_step(module, opt, loss_fn=t_train.bce_loss, mesh=mesh)(state, x, y)
        losses.append(float(m["loss"]))
        if mesh is not None:
            assert isinstance(state.module, ShardedClassifier)
            assert layers.group_norm_apply.launches > before[0] and layers.group_norm_bwd_apply.launches > before[1]
    np.testing.assert_allclose(losses[1], losses[0], rtol=1e-5)
