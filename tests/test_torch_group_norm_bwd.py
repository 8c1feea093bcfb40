"""K6, the GroupNorm backward, and the differentiable ``group_norm``.

On the CPU ``models.layers.group_norm`` is a ``torch.autograd.Function``
whose backward runs the plain version ``group_norm_bwd_plain``; both are
held against ``jax.vjp`` of the JAX package's ``_group_norm_ref`` (NHWC) and
against the Pallas kernel ``group_norm_bwd_pallas`` in interpret mode, on the
same seeded numpy inputs, in float32 and bfloat16, for NCHW-contiguous and
channels_last activations, at the K5 tests' shapes plus G = C and C = 512.
Tolerances: float32 dx, dweight and dbias within rtol 1e-4 plus 1e-5 of
each tensor's largest magnitude (sums in other orders; the port's backward
uses the forward's mean and rstd and sums about the mean, the reference
differentiates E[x²] − E[x]²); bfloat16 dx within one bf16 ulp of the
reference's magnitude (both round a float32 result once). An incoming
gradient that is a non-contiguous slice (``torch.cat``'s backward) or in the
other layout gives the same result. The kernel runs on the card
(``cuda``-marked tests: K6 against its plain version, on the plain
statistics and through autograd on those K5 saved, at the train step's
channel widths too, one launch per backward, the same bits on a repeated
call, and a U-Net backward that reaches every parameter; ``chip_smoke.py``
phases 2 and 9).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from attic.pallas_norm import group_norm_bwd_pallas
from maze_image_processing_pipeline_tpu_torch.models import layers


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the parallel test workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _group_norm_ref(*args):
    # Imported here (the JAX package's layers module imports flax, which the
    # card's machine lacks) so that the `cuda` tests below collect there.
    from maze_image_processing_pipeline_tpu.models.layers import _group_norm_ref

    return _group_norm_ref(*args)


# test_torch_group_norm.py's shapes ((1, 8, 4, 4) has G = C), and C = 512.
CASES = [((2, 16, 8, 8), 4), ((3, 16, 5, 7), 8), ((2, 32, 6, 10), 8), ((1, 8, 4, 4), 8), ((2, 512, 3, 3), 8)]


def _inputs(shape, seed):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(shape) * 2 + 0.5).astype(np.float32)
    ct = rng.standard_normal(shape).astype(np.float32)
    C = shape[1]
    return x, ct, rng.standard_normal(C).astype(np.float32), rng.standard_normal(C).astype(np.float32)


def _nhwc(a):
    return jnp.asarray(a.transpose(0, 2, 3, 1))


def _jax_vjp(x, ct, w, b, G, dtype=jnp.float32):
    """(dx NCHW, dscale, dbias) of the JAX package's GroupNorm, as float32."""
    fn = lambda x, s, b: _group_norm_ref(x, s, b, G, 1e-6)  # noqa: E731
    _, vjp = jax.vjp(fn, _nhwc(x).astype(dtype), jnp.asarray(w), jnp.asarray(b))
    dx, dw, db = vjp(_nhwc(ct).astype(dtype))
    return np.asarray(dx.astype(jnp.float32)).transpose(0, 3, 1, 2), np.asarray(dw), np.asarray(db)


def _close(ours, ref, what):
    """Within rtol 1e-4 plus 1e-5 of the reference's largest magnitude."""
    ours, ref = np.asarray(ours, np.float64), np.asarray(ref, np.float64)
    tol = 1e-4 * np.abs(ref) + 1e-5 * np.abs(ref).max()
    bad = np.abs(ours - ref) > tol
    assert not bad.any(), f"{what}: {int(bad.sum())} elements off, max diff {np.abs(ours - ref).max():.3g}"


def _half_ulp(v, mantissa_bits=7):
    """One ulp at |v| of a 16-bit float with ``mantissa_bits`` stored bits
    (bfloat16 7, float16 10), at least 2**-16."""
    e = np.floor(np.log2(np.maximum(np.abs(v), 2.0 ** (mantissa_bits - 16))))
    return 2.0 ** (e - mantissa_bits)


def _layout(t, channels_last):
    return t.contiguous(memory_format=torch.channels_last) if channels_last else t.contiguous()


def _through_autograd(x, ct, w, b, G):
    """(y, dx, dweight, dbias) of ``y = group_norm(x)``, ``y.backward(ct)``."""
    x = x.detach().requires_grad_()
    wp, bp = torch.nn.Parameter(w.clone()), torch.nn.Parameter(b.clone())
    y = layers.group_norm(x, wp, bp, G)
    y.backward(ct)
    return y, x.grad, wp.grad, bp.grad


@pytest.mark.parametrize("shape,G", CASES)
@pytest.mark.parametrize("channels_last", [False, True])
def test_plain_backward_matches_jax_float32(shape, G, channels_last):
    x, ct, w, b = _inputs(shape, seed=sum(shape))
    ref = _jax_vjp(x, ct, w, b, G)
    xt = _layout(torch.from_numpy(x), channels_last)
    ctt = _layout(torch.from_numpy(ct), channels_last)
    wt, bt = torch.from_numpy(w), torch.from_numpy(b)
    n5, n6 = layers.group_norm.launches, layers.group_norm_bwd.launches
    stats = layers.group_stats_plain(xt, G)
    plain = layers.group_norm_bwd_plain(xt, ctt, wt, stats, G)
    y, *grads = _through_autograd(xt, ctt, wt, bt, G)
    assert (layers.group_norm.launches, layers.group_norm_bwd.launches) == (n5, n6)  # the CPU takes the plain versions
    assert y.stride() == xt.stride() and grads[0].dtype == torch.float32
    for got in (plain, grads):
        for name, a, r in zip(("dx", "dweight", "dbias"), got, ref):
            _close(a.numpy(), r, f"{name} {shape} G={G}")
    # The autograd Function's backward is the plain version on the same stats.
    for a, p in zip(grads, plain):
        torch.testing.assert_close(a, p, rtol=0, atol=0)


@pytest.mark.parametrize("shape,G", CASES[:2])
def test_plain_backward_matches_pallas_interpret(shape, G):
    x, ct, w, b = _inputs(shape, seed=3 + sum(shape))
    pallas = group_norm_bwd_pallas(_nhwc(x), _nhwc(ct), jnp.asarray(w), num_groups=G, epsilon=1e-6, interpret=True)
    xt, ctt = torch.from_numpy(x), torch.from_numpy(ct)
    ours = layers.group_norm_bwd_plain(xt, ctt, torch.from_numpy(w), layers.group_stats_plain(xt, G), G)
    _close(ours[0].numpy(), np.asarray(pallas[0]).transpose(0, 3, 1, 2), "dx")
    _close(ours[1].numpy(), np.asarray(pallas[1]), "dweight")
    _close(ours[2].numpy(), np.asarray(pallas[2]), "dbias")


@pytest.mark.parametrize("shape,G", CASES[:3] + CASES[4:])
@pytest.mark.parametrize("channels_last", [False, True])
def test_plain_backward_matches_jax_bfloat16(shape, G, channels_last):
    x, ct, w, b = _inputs(shape, seed=1 + sum(shape))
    # bf16-representable inputs, the same on both sides.
    x, ct = (np.array(jnp.asarray(a).astype(jnp.bfloat16).astype(jnp.float32)) for a in (x, ct))
    ref_dx, ref_dw, ref_db = _jax_vjp(x, ct, w, b, G, dtype=jnp.bfloat16)
    xt = _layout(torch.from_numpy(x).bfloat16(), channels_last)
    ctt = _layout(torch.from_numpy(ct).bfloat16(), channels_last)
    _, dx, dw, db = _through_autograd(xt, ctt, torch.from_numpy(w), torch.from_numpy(b), G)
    assert dx.dtype == torch.bfloat16
    assert np.all(np.abs(dx.float().numpy() - ref_dx) <= _half_ulp(ref_dx))
    _close(dw.numpy(), ref_dw, "dweight")
    _close(db.numpy(), ref_db, "dbias")


@pytest.mark.parametrize("channels_last", [False, True])
def test_cotangent_slices_and_other_layouts(channels_last):
    """The incoming gradient as ``torch.cat``'s backward hands it out (a
    channel slice of a wider tensor) and in the other layout."""
    shape, G = (2, 16, 6, 10), 4
    x, ct, w, b = _inputs(shape, seed=9)
    xt = _layout(torch.from_numpy(x), channels_last)
    wt, bt = torch.from_numpy(w), torch.from_numpy(b)
    _, *want = _through_autograd(xt, torch.from_numpy(ct), wt, bt, G)
    wide = torch.cat([torch.from_numpy(ct), torch.ones(shape)], dim=1)
    wide = _layout(wide, not channels_last)
    for ct_in in (wide[:, :16], _layout(torch.from_numpy(ct), not channels_last)):
        assert not ct_in.is_contiguous(memory_format=torch.channels_last if channels_last else torch.contiguous_format)
        _, *got = _through_autograd(xt, ct_in, wt, bt, G)
        for a, e in zip(got, want):
            torch.testing.assert_close(a, e, rtol=1e-5, atol=1e-6)
    # Through torch.cat itself, as the U-Net's decoder concatenates skips.
    xg = xt.detach().requires_grad_()
    y = layers.group_norm(xg, wt, bt, G)
    z = torch.cat([y, torch.zeros(shape)], dim=1)
    (z * torch.cat([torch.from_numpy(ct), torch.ones(shape)], dim=1)).sum().backward()
    torch.testing.assert_close(xg.grad, want[0], rtol=1e-5, atol=1e-6)


def test_plain_backward_errors():
    x, ct, w, _ = _inputs((2, 16, 4, 4), seed=5)
    xt = torch.from_numpy(x)
    with pytest.raises(ValueError):
        layers.group_norm_bwd_plain(xt, torch.from_numpy(ct), torch.from_numpy(w), layers.group_stats_plain(xt, 4), 3)


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize(
    "shape,G",
    CASES + [((2, 64, 16, 16), 8), ((2, 128, 8, 8), 8), ((2, 256, 8, 8), 8),  # the train step's widths
             ((4, 512, 9, 11), 8), ((8, 32, 64, 64), 8), ((2, 24, 7, 5), 8),
             ((8, 512, 8, 8), 8), ((8, 64, 64, 64), 8)],  # the distillation's widths
)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
@pytest.mark.parametrize("channels_last", [False, True])
def test_cuda_group_norm_bwd_matches_plain(shape, G, dtype, channels_last):
    dev = _card()
    x, ct, w, b = _inputs(shape, seed=2)
    xd = _layout(torch.from_numpy(x).to(dev, dtype), channels_last)
    ctd = _layout(torch.from_numpy(ct).to(dev, dtype), channels_last)
    wd = torch.from_numpy(w).to(dev)
    stats = layers.group_stats_plain(xd, G)
    n = layers.group_norm_bwd.launches
    got = layers.group_norm_bwd(xd, ctd, wd, stats, G)
    again = layers.group_norm_bwd(xd, ctd, wd, stats, G)
    assert layers.group_norm_bwd.launches == n + 2 and got[0].stride() == xd.stride()
    for a, r in zip(got, again):  # no float atomics: the same bits
        assert torch.equal(a, r)
    ref = [t.float().cpu().numpy() for t in layers.group_norm_bwd_plain(xd, ctd, wd, stats, G)]
    ulp = 7 if dtype == torch.bfloat16 else 10

    def check(grads, where):
        dx = grads[0].float().cpu().numpy()
        if dtype == torch.float32:
            _close(dx, ref[0], f"dx {where}")
        else:
            assert np.all(np.abs(dx - ref[0]) <= _half_ulp(ref[0], ulp)), where
        _close(grads[1].cpu().numpy(), ref[1], f"dweight {where}")
        _close(grads[2].cpu().numpy(), ref[2], f"dbias {where}")

    check(got, "K6 on the plain statistics")
    # Through autograd: K5 forward (its saved statistics), K6 backward, once each.
    n5, n6 = layers.group_norm.launches, layers.group_norm_bwd.launches
    y, gx, gw, gb = _through_autograd(xd, ctd, wd, torch.from_numpy(b).to(dev), G)
    assert (layers.group_norm.launches, layers.group_norm_bwd.launches) == (n5 + 1, n6 + 1)
    assert gx.stride() == xd.stride() and gw.device == wd.device
    check((gx, gw, gb), "through autograd")
    with pytest.raises(ValueError, match="channels_last"):
        layers.group_norm_bwd(xd.transpose(2, 3), ctd, wd, stats, G)


SMALL_UNET = dict(out_channels=1, base_features=8, depth=2)


def _unet_batch(kind):
    """The distillation batch the card is compared on, or random targets."""
    if kind == "distillation":
        from chip_smoke import distill_batches

        return next(distill_batches(1, size=128, batch=4, seed=21))
    rng = np.random.default_rng(0)
    x = rng.random((4, 128, 128, 3), dtype=np.float32)
    return x, (rng.random((4, 128, 128, 1)) > 0.5).astype(np.float32)


def _unet_first_step(x, y, dev=torch.device("cpu")):
    """The float32 ``UNet(1, 8, 2)`` of seed 3 after one ``bce_dice_loss``
    backward on ``dev``."""
    from maze_image_processing_pipeline_tpu_torch.models.model_io import init_unet_params, params_from_jax
    from maze_image_processing_pipeline_tpu_torch.models.train import bce_dice_loss
    from maze_image_processing_pipeline_tpu_torch.models.unet import UNet

    model = UNet(**SMALL_UNET, dtype="float32")
    model.load_state_dict(params_from_jax(init_unet_params(SMALL_UNET, seed=3)))
    model.to(dev)
    bce_dice_loss(model(torch.from_numpy(x).to(dev)), torch.from_numpy(y).to(dev)).backward()
    return model


def _group_stats_float64(x, num_groups, eps=1e-6):
    """``group_stats_plain`` with the sums in float64, rounded once."""
    xd = x.double().reshape(x.shape[0], num_groups, -1)
    return torch.stack([xd.mean(-1).reshape(-1), torch.rsqrt(xd.var(-1, unbiased=False) + eps).reshape(-1)]).float()


@pytest.mark.parametrize("kind,low,high", [("distillation", 0.0, 1e-3), ("random targets", 1e-3, 1.0)])
def test_float32_statistics_move_first_step_gradients(kind, low, high, monkeypatch):
    """The reason for the card-vs-CPU tolerance below (1e-3 of a tensor's
    norm, on the distillation batch): on the CPU alone, GroupNorm statistics
    summed in float64 instead of float32 move the first-step gradients by
    2.8e-4 of a tensor's norm on that batch, and by 4.8e-3 on random targets
    (such a gradient is a small sum of large terms), which no float32
    comparison of two devices can hold to 1e-3. Measured over the tensors
    whose norm is above 1e-5 of the whole gradient's (the conv biases that
    feed a GroupNorm have an analytically zero gradient)."""
    x, y = _unet_batch(kind)
    grads = {k: p.grad.double() for k, p in _unet_first_step(x, y).named_parameters()}
    monkeypatch.setattr(layers, "group_stats_plain", _group_stats_float64)
    ref = {k: p.grad.double() for k, p in _unet_first_step(x, y).named_parameters()}
    total = float(sum((g ** 2).sum() for g in ref.values()) ** 0.5)
    worst = max(float((grads[k] - g).abs().max() / g.norm()) for k, g in ref.items() if float(g.norm()) > 1e-5 * total)
    assert low < worst < high


@pytest.mark.cuda
def test_cuda_unet_backward_reaches_every_parameter():
    """One U-Net backward on the card: every parameter gets a gradient (the
    first conv's nonzero), every norm runs K6 once, and the gradients agree
    with the CPU's (float32, TF32 off) on the distillation batch within 1e-3
    of each tensor's norm plus 1e-5 of the whole gradient's
    (``test_float32_statistics_move_first_step_gradients`` says why)."""
    dev = _card()
    x, y = _unet_batch("distillation")
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        n6 = layers.group_norm_bwd.launches
        model = _unet_first_step(x, y, dev)
        assert layers.group_norm_bwd.launches == n6 + 10  # 2 norms in each of 5 blocks
        missing = [k for k, p in model.named_parameters() if p.grad is None]
        assert not missing, missing
        assert model.ConvBlock_0.Conv_0.weight.grad.abs().max() > 0
        grads = {k: p.grad.cpu() for k, p in model.named_parameters()}
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    ref = {k: p.grad for k, p in _unet_first_step(x, y).named_parameters()}
    # The floor covers the conv biases that feed a GroupNorm: their gradient
    # is zero, float noise on both sides.
    total = float(sum((g.double() ** 2).sum() for g in ref.values()) ** 0.5)
    for k, g in ref.items():
        assert float((grads[k] - g).abs().max()) <= 1e-3 * float(g.norm()) + 1e-5 * total, k
