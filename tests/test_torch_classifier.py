"""The port's ``ConvClassifier`` against the JAX package's, on the CPU.

The same seeded numpy inputs and the same parameters (a flax init, mapped
through ``params_from_jax``) go through both models. Even and odd extents pin
flax's stride-2 ``SAME`` padding ((0, 1) at even extents, (1, 1) at odd).
Tolerance: float32 logits within atol 1e-4 (convolutions sum in other
orders in the two frameworks); bfloat16 within 5e-2 of the logits' scale.
Checkpoints round-trip byte-identical through either package's writer.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from maze_image_processing_pipeline_tpu.models import model_io as j_model_io
from maze_image_processing_pipeline_tpu.models.classifier import ConvClassifier as JaxClassifier
from maze_image_processing_pipeline_tpu_torch.models import model_io as t_model_io
from maze_image_processing_pipeline_tpu_torch.models.classifier import ConvClassifier, _same_pad


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the parallel test workers share the cores, and
    torch's per-worker thread pools oversubscribe them many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("extent,expected", [(64, (0, 1)), (65, (1, 1)), (7, (1, 1)), (8, (0, 1)), (1, (1, 1))])
def test_same_padding_matches_flax(extent, expected):
    assert _same_pad(extent, 2) == expected


@pytest.mark.parametrize("shape", [(2, 64, 64, 3), (3, 37, 50, 3), (1, 33, 33, 1)])
@pytest.mark.parametrize("norm", [True, False])
def test_classifier_matches_jax_float32(shape, norm):
    cfg = dict(n_outputs=5, features=(4, 8, 16), norm=norm)
    j_module = JaxClassifier(**cfg, dtype=jnp.float32)
    x = np.random.default_rng(sum(shape)).random(shape, dtype=np.float32)
    params = j_module.init(jax.random.key(1), jnp.zeros((1,) + shape[1:]))
    ref = np.asarray(j_module.apply(params, jnp.asarray(x)))
    module = ConvClassifier(**cfg, dtype="float32", in_channels=shape[-1])
    module.load_state_dict(t_model_io.params_from_jax(jax.tree.map(np.asarray, params)))
    with torch.no_grad():
        ours = module(torch.from_numpy(x)).numpy()
    assert ours.shape == ref.shape == (shape[0], 5) and ours.dtype == np.float32
    np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-4)


def test_classifier_matches_jax_bfloat16():
    cfg = dict(n_outputs=8, features=(8, 16))
    params = t_model_io.init_classifier_params(cfg, seed=3)
    x = np.random.default_rng(0).random((2, 48, 48, 3), dtype=np.float32)
    ref = np.asarray(JaxClassifier(**cfg, dtype=jnp.bfloat16).apply(params, jnp.asarray(x)))
    module = ConvClassifier(**cfg, dtype="bfloat16")
    module.load_state_dict(t_model_io.params_from_jax(params))
    with torch.no_grad():
        ours = module(torch.from_numpy(x)).numpy()
    # bf16 rounds at other places in the two frameworks (conv accumulation,
    # the pooled mean's cast): hold the logits to 5 % of their scale.
    np.testing.assert_allclose(ours, ref, rtol=0, atol=5e-2 * max(1.0, float(np.abs(ref).max())))


def test_classifier_checkpoints_round_trip_byte_identical(tmp_path):
    cfg = dict(n_outputs=4, features=(4, 8))
    # JAX writes, the port reads and writes the same bytes back.
    j_module = JaxClassifier(**cfg, dtype=jnp.float32)
    params = j_module.init(jax.random.key(0), jnp.zeros((1, 32, 32, 3)))
    j_model_io.save_model(str(tmp_path / "jax"), j_module, params, outputs={"probs": {}})
    loaded = t_model_io.load_model(str(tmp_path / "jax"))
    assert isinstance(loaded.module, ConvClassifier) and loaded.module.features == (4, 8)
    t_model_io.save_model(str(tmp_path / "torch"), loaded.module, outputs={"probs": {}})
    for name in ("params.msgpack", "meta.json"):
        assert (tmp_path / "torch" / name).read_bytes() == (tmp_path / "jax" / name).read_bytes(), name
    # The port writes seeded parameters; JAX reads them and computes the same logits.
    module = ConvClassifier(**cfg, dtype="float32")
    module.load_state_dict(t_model_io.params_from_jax(t_model_io.init_classifier_params(cfg, seed=7)))
    t_model_io.save_model(str(tmp_path / "port"), module, outputs={"probs": {}})
    j_loaded = j_model_io.load_model(str(tmp_path / "port"))
    assert json.loads((tmp_path / "port" / "meta.json").read_text())["architecture"]["type"] == "conv_classifier"
    x = np.random.default_rng(1).random((2, 32, 32, 3), dtype=np.float32)
    with torch.no_grad():
        ours = module(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(np.asarray(j_loaded(jnp.asarray(x))), ours, rtol=0, atol=1e-4)
