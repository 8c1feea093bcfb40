"""K5, the GroupNorm forward: the port's plain version against the JAX package.

On the CPU ``models.layers.group_norm`` runs its plain PyTorch version; it is
held against the JAX package's XLA formulation (``_group_norm_ref``, NHWC)
and against the Pallas kernel ``group_norm_pallas`` in interpret mode, on the
same seeded numpy inputs, in float32 and bfloat16, for NCHW-contiguous and
channels_last activations (the port's layout; the JAX package's is NHWC).
Tolerances: float32 within rtol 1e-5 / atol 1e-5 (sums in other orders);
bfloat16 within one bf16 ulp of the reference's magnitude (both round a
float32 result once). On the CPU the launch counter does not move. The
kernel itself runs on the card (``cuda``-marked tests, which add float16
within one float16 ulp and hold the mean and rstd K5 saves for the backward
against ``group_stats_plain`` within rtol 1e-5 / atol 1e-5; ``chip_smoke.py``
phase 2).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from attic.pallas_norm import group_norm_pallas
from maze_image_processing_pipeline_tpu_torch.models import layers


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the parallel test workers share the cores, and
    torch's per-worker thread pools oversubscribe them many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _group_norm_ref(*args):
    # The JAX package's layers module imports flax, which the card's machine
    # lacks: imported here so that the `cuda` tests below collect there.
    from maze_image_processing_pipeline_tpu.models.layers import _group_norm_ref

    return _group_norm_ref(*args)


CASES = [((2, 16, 8, 8), 4), ((3, 16, 5, 7), 8), ((2, 32, 6, 10), 8), ((1, 8, 4, 4), 8)]


def _inputs(shape, seed):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(shape) * 2 + 0.5).astype(np.float32)
    C = shape[1]
    return x, rng.standard_normal(C).astype(np.float32), rng.standard_normal(C).astype(np.float32)


def _port(x_nchw, w, b, G, dtype, channels_last):
    x = torch.from_numpy(x_nchw).to(dtype)
    if channels_last:
        x = x.contiguous(memory_format=torch.channels_last)
    n = layers.group_norm.launches
    y = layers.group_norm(x, torch.from_numpy(w), torch.from_numpy(b), G)
    assert layers.group_norm.launches == n  # the CPU takes the plain version
    assert y.dtype == dtype and y.stride() == x.stride()
    return y.float().numpy()


def _half_ulp(v, mantissa_bits=7):
    """One ulp at |v| of a 16-bit float with ``mantissa_bits`` stored bits
    (bfloat16 7, float16 10), at least 2**-16."""
    e = np.floor(np.log2(np.maximum(np.abs(v), 2.0 ** (mantissa_bits - 16))))
    return 2.0 ** (e - mantissa_bits)


@pytest.mark.parametrize("shape,G", CASES)
@pytest.mark.parametrize("channels_last", [False, True])
def test_plain_group_norm_matches_jax_float32(shape, G, channels_last):
    x, w, b = _inputs(shape, seed=sum(shape))
    x_nhwc = jnp.asarray(x.transpose(0, 2, 3, 1))
    ref = np.asarray(_group_norm_ref(x_nhwc, jnp.asarray(w), jnp.asarray(b), G, 1e-6)).transpose(0, 3, 1, 2)
    pallas = np.asarray(
        group_norm_pallas(x_nhwc, jnp.asarray(w), jnp.asarray(b), num_groups=G, epsilon=1e-6, interpret=True)
    ).transpose(0, 3, 1, 2)
    ours = _port(x, w, b, G, torch.float32, channels_last)
    np.testing.assert_allclose(ours, ref, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(ours, pallas, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("shape,G", CASES[:3])
@pytest.mark.parametrize("channels_last", [False, True])
def test_plain_group_norm_matches_jax_bfloat16(shape, G, channels_last):
    x, w, b = _inputs(shape, seed=1 + sum(shape))
    x_bf = jnp.asarray(x.transpose(0, 2, 3, 1)).astype(jnp.bfloat16)
    ref = np.asarray(_group_norm_ref(x_bf, jnp.asarray(w), jnp.asarray(b), G, 1e-6).astype(jnp.float32))
    ref = ref.transpose(0, 3, 1, 2)
    ours = _port(np.asarray(x_bf.astype(jnp.float32)).transpose(0, 3, 1, 2), w, b, G, torch.bfloat16, channels_last)
    assert np.all(np.abs(ours - ref) <= _half_ulp(ref))


def test_group_norm_module_and_errors():
    x, w, b = _inputs((2, 16, 4, 4), seed=5)
    mod = layers.GroupNorm(4, 16)
    with torch.no_grad():
        mod.weight.copy_(torch.from_numpy(w))
        mod.bias.copy_(torch.from_numpy(b))
        y = mod(torch.from_numpy(x))
    torch.testing.assert_close(y, layers.group_norm_plain(torch.from_numpy(x), mod.weight, mod.bias, 4))
    with pytest.raises(ValueError):
        layers.group_norm(torch.from_numpy(x), mod.weight, mod.bias, 3)


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


# The train step's channel widths (64, 128, 256: 8, 16, 32 channels a group)
# at small spatial sizes.
TRAIN_WIDTHS = [((2, 64, 16, 16), 8), ((2, 128, 8, 8), 8), ((2, 256, 8, 8), 8)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape,G", CASES + TRAIN_WIDTHS + [((4, 512, 9, 11), 8), ((8, 32, 64, 64), 8),
                                                            ((8, 512, 8, 8), 8), ((8, 64, 64, 64), 8)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
@pytest.mark.parametrize("channels_last", [False, True])
def test_cuda_group_norm_matches_plain(shape, G, dtype, channels_last):
    dev = _card()
    x, w, b = _inputs(shape, seed=2)
    xd = torch.from_numpy(x).to(dev, dtype)
    if channels_last:
        xd = xd.contiguous(memory_format=torch.channels_last)
    wd, bd = torch.from_numpy(w).to(dev), torch.from_numpy(b).to(dev)
    n = layers.group_norm.launches
    y = layers.group_norm(xd, wd, bd, G)
    assert layers.group_norm.launches == n + 1 and y.stride() == xd.stride()
    # The mean and rstd K5 saves for the backward (K6).
    _, stats = layers._group_norm_forward(xd, wd, bd, G, 1e-6)
    torch.testing.assert_close(stats, layers.group_stats_plain(xd, G), rtol=1e-5, atol=1e-5)
    ref = layers.group_norm_plain(xd, wd, bd, G).float().cpu().numpy()
    got = y.float().cpu().numpy()
    if dtype == torch.float32:
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)
    else:
        assert np.all(np.abs(got - ref) <= _half_ulp(ref, 7 if dtype == torch.bfloat16 else 10))
    with pytest.raises(ValueError, match="channels_last"):
        layers.group_norm(xd.transpose(2, 3), wd, bd, G)
