"""Models of the PyTorch port against the JAX package: GroupNorm, the U-Net
(weights mapped with ``params_from_jax``), checkpoint reading and the
device pre-processing."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from flax import serialization

from maze_image_processing_pipeline_tpu.models import save_model
from maze_image_processing_pipeline_tpu.models.inference import default_device_pre as j_pre
from maze_image_processing_pipeline_tpu.models.layers import _group_norm_ref
from maze_image_processing_pipeline_tpu.models.model_io import import_torch_state_dict
from maze_image_processing_pipeline_tpu.models.unet import UNet as JUNet
from maze_image_processing_pipeline_tpu_torch.models.inference import default_device_pre, sigmoid_post
from maze_image_processing_pipeline_tpu_torch.models.layers import GroupNorm, group_norm
from maze_image_processing_pipeline_tpu_torch.models.model_io import (
    build_model,
    init_unet_params,
    load_model,
    msgpack_restore,
    params_from_jax,
)
from maze_image_processing_pipeline_tpu_torch.models.unet import UNet

CFG = dict(out_channels=1, base_features=8, depth=2)


def _perturbed_params(seed=3):
    """Seeded U-Net parameters with non-trivial biases and norm scales."""
    rng = np.random.default_rng(seed)
    p = init_unet_params(CFG, seed=1)
    return jax.tree.map(lambda a: (a + 0.1 * rng.standard_normal(a.shape)).astype(np.float32), p)


@pytest.mark.parametrize("shape,groups", [((2, 6, 5, 16), 8), ((3, 9, 4), 4)])
def test_group_norm_matches_jax(shape, groups):
    rng = np.random.default_rng(0)
    x = (rng.standard_normal(shape) * 3 + 1).astype(np.float32)
    C = shape[-1]
    scale = rng.standard_normal(C).astype(np.float32)
    bias = rng.standard_normal(C).astype(np.float32)
    ref = np.asarray(_group_norm_ref(x, scale, bias, groups, 1e-6))
    x_t = torch.from_numpy(np.moveaxis(x, -1, 1).copy())  # channels first
    ours = group_norm(x_t, torch.from_numpy(scale), torch.from_numpy(bias), groups)
    np.testing.assert_allclose(np.moveaxis(ours.numpy(), 1, -1), ref, rtol=1e-5, atol=1e-5)
    # torch's own group_norm computes the variance another way: equal to 1e-5.
    mod = GroupNorm(groups, C)
    with torch.no_grad():
        mod.weight.copy_(torch.from_numpy(scale))
        mod.bias.copy_(torch.from_numpy(bias))
        np.testing.assert_allclose(
            mod(x_t).numpy(), F.group_norm(x_t, groups, mod.weight, mod.bias, eps=1e-6).numpy(),
            rtol=1e-5, atol=1e-5,
        )


def test_init_unet_params_has_the_flax_layout():
    x = np.zeros((1, 32, 32, 3), np.float32)
    ref = JUNet(**CFG, dtype=jnp.float32).init(jax.random.key(0), x)
    ours = init_unet_params(CFG, seed=0)
    assert jax.tree.structure(ref) == jax.tree.structure(ours)
    assert jax.tree.map(np.shape, ref) == jax.tree.map(np.shape, ours)
    flat_ref = list(jax.tree_util.tree_flatten_with_path(ref)[0])
    assert [p for p, _ in flat_ref] == [p for p, _ in jax.tree_util.tree_flatten_with_path(ours)[0]]


def test_unet_matches_flax_apply():
    p = _perturbed_params()
    x = np.random.default_rng(0).random((2, 64, 64, 3)).astype(np.float32)
    ref = np.asarray(JUNet(**CFG, dtype=jnp.float32).apply(p, x))
    model = UNet(**CFG, dtype=torch.float32)
    model.load_state_dict(params_from_jax(p))
    with torch.no_grad():
        ours = model(torch.from_numpy(x))
    assert ours.dtype == torch.float32 and ours.shape == (2, 64, 64, 1)
    np.testing.assert_allclose(ours.numpy(), ref, atol=1e-4)
    # bf16 compute keeps float32 parameters and returns float32 logits.
    bf = UNet(**CFG, dtype="bfloat16")
    bf.load_state_dict(params_from_jax(p))
    with torch.no_grad():
        y = bf(torch.from_numpy(x))
    assert y.dtype == torch.float32 and all(t.dtype == torch.float32 for t in bf.parameters())
    assert float((y - ours).abs().max()) < 0.1 * float(ours.abs().max())


def test_params_from_jax_inverts_import_torch_state_dict():
    p = _perturbed_params()
    sd = params_from_jax(p)
    assert sorted(sd) == sorted(UNet(**CFG).state_dict())
    assert list(params_from_jax(init_unet_params(CFG))) == list(UNet(**CFG).state_dict())
    back = import_torch_state_dict({k: v.numpy() for k, v in sd.items()}, p["params"])
    assert jax.tree.all(jax.tree.map(np.array_equal, back, p["params"]))


@pytest.fixture
def checkpoint(tmp_path):
    p = _perturbed_params()
    path = str(tmp_path / "unet")
    save_model(path, JUNet(**CFG, dtype=jnp.float32), p, outputs={"pred": {"channel_names": ["fg"]}})
    return path, p


def test_msgpack_restore_matches_flax(checkpoint):
    path, _ = checkpoint
    data = open(os.path.join(path, "params.msgpack"), "rb").read()
    ref = serialization.msgpack_restore(data)
    ours = msgpack_restore(data)
    assert jax.tree.structure(ref) == jax.tree.structure(ours)
    assert jax.tree.all(jax.tree.map(np.array_equal, ref, ours))
    # Scalars, strings, nested lists and bfloat16 arrays of the same format.
    tree = {
        "a": np.float32(2.5), "b": "text", "c": [1, -3, 300, 70000, 2**40, -(2**40)],
        "d": jnp.arange(6, dtype=jnp.bfloat16).reshape(2, 3), "e": None, "f": True, "g": 0.25,
        "h": np.arange(40000, dtype=np.int16),
    }
    data = serialization.msgpack_serialize(tree)
    ref, ours = serialization.msgpack_restore(data), msgpack_restore(data)
    assert ours["b"] == "text" and ours["c"] == [1, -3, 300, 70000, 2**40, -(2**40)]
    assert ours["a"] == ref["a"] and ours["e"] is None and ours["f"] is True and ours["g"] == 0.25
    np.testing.assert_array_equal(ours["d"], np.asarray(ref["d"], np.float32))
    np.testing.assert_array_equal(ours["h"], ref["h"])


def test_load_model_reads_a_jax_checkpoint(checkpoint):
    path, p = checkpoint
    model = load_model(path, dtype="float32")
    assert model.meta["outputs"] == {"pred": {"channel_names": ["fg"]}}
    assert model.meta["architecture"]["config"]["dtype"] == "float32"
    x = np.random.default_rng(1).random((1, 32, 32, 3)).astype(np.float32)
    ref = np.asarray(JUNet(**CFG, dtype=jnp.float32).apply(p, x))
    with torch.no_grad():
        np.testing.assert_allclose(model.module(torch.from_numpy(x)).numpy(), ref, atol=1e-4)
    assert load_model(path).module.dtype == torch.float32  # as saved
    assert load_model(os.path.join(path, "params.msgpack"), dtype="bfloat16").module.dtype == torch.bfloat16
    meta = json.load(open(os.path.join(path, "meta.json")))
    assert "s2d" in meta["architecture"]["config"]  # a TPU knob the port drops
    with pytest.raises(ValueError):
        build_model("nope", {})


@pytest.mark.parametrize("dtype", [np.uint8, np.uint16, np.float32])
@pytest.mark.parametrize("shape", [(2, 5, 6), (2, 5, 6, 1), (2, 5, 6, 3)])
def test_device_pre_matches_jax(dtype, shape):
    rng = np.random.default_rng(2)
    x = (rng.random(shape) * 200).astype(dtype)
    ref = np.asarray(j_pre(jnp.asarray(x)))
    ours = default_device_pre(torch.from_numpy(x))
    assert ours.shape == ref.shape
    np.testing.assert_allclose(ours.numpy(), ref, rtol=1e-7)
    y = rng.standard_normal((3, 4)).astype(np.float32)
    np.testing.assert_allclose(
        sigmoid_post(torch.from_numpy(y)).numpy(), np.asarray(jax.nn.sigmoid(y)), rtol=1e-6
    )
