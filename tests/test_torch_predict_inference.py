"""The port's inference nodes against the JAX package's, on the CPU.

``DeviceTiledInference`` and ``TorchInference`` of the port run next to the
JAX package's ``DeviceTiledInference`` / ``JaxInference`` on the same seeded
crops and the same checkpoint (``UNet(2, 4, 1)`` and ``ConvClassifier(4,
(4, 8))`` float32, written by the port's ``save_model``), on the cases of
``tests/test_predict_pipeline.py`` that write no ``.h5``: the device blend
against the host blend (``TiledPipeline`` around the batch node) on mixed
crop sizes (multi-tile and smaller than a tile), uint16 inputs, a tile wider
than the bucket's crops, the fused measurement (with the head scaled so that
no probability lies within float noise of 0.5), its overflow fallback, a
channel-count mismatch, and fixed-shape batches with a padded tail.
Tolerances: the port's device blend against its own host blend within rtol
1e-5 / atol 1e-6 (the same forwards, blended in another order); against the
JAX package within rtol 1e-4 / atol 2e-5 (float32 convolutions and norms sum
in other orders in the two frameworks); measured integers exact, axis
lengths within rtol 1e-5.
"""

import numpy as np
import pytest
import torch

import chip_smoke
from fixtures import draw_blob
from maze_image_processing_pipeline_tpu import engine as j_engine
from maze_image_processing_pipeline_tpu.models import inference as j_inf
from maze_image_processing_pipeline_tpu.models import model_io as j_model_io
from maze_image_processing_pipeline_tpu.predict.pipeline import measure_segments
from maze_image_processing_pipeline_tpu_torch import engine as t_engine
from maze_image_processing_pipeline_tpu_torch.engine.tiles import TiledPipeline as TTiledPipeline
from maze_image_processing_pipeline_tpu_torch.models import inference as t_inf
from maze_image_processing_pipeline_tpu_torch.models import model_io as t_model_io


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the parallel test workers share the cores, and
    torch's per-worker thread pools oversubscribe them many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

SIZES = [(64, 64), (100, 90), (40, 56), (90, 120), (170, 170), (150, 200), (64, 64)]


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    root = tmp_path_factory.mktemp("models")
    unet = chip_smoke.write_unet(str(root / "unet"), chip_smoke.SMALL_SEMSEG_UNET, "float32", seed=1,
                                 channel_names=("a", "b"))
    # Head scaled: no probability within float noise of the 0.5 threshold.
    sat = chip_smoke.write_unet(str(root / "unet_sat"), chip_smoke.SMALL_SEMSEG_UNET, "float32", seed=1,
                                gain=1000.0, channel_names=("a", "b"))
    clf = chip_smoke.write_classifier(str(root / "clf"), chip_smoke.SMALL_CLASSIFIER, "float32", seed=2)
    return {k: (j_model_io.load_model(v, dtype="float32"), t_model_io.load_model(v, dtype="float32"))
            for k, v in (("unet", unet), ("unet_sat", sat), ("clf", clf))}


def _run_tiled(engine, mod, model, crops, **kw):
    preds, stats = [], []
    with engine.Pipeline() as p:
        img = engine.Unpack(crops)
        pred, st = mod.DeviceTiledInference(model, img, **kw)
        engine.Call(lambda a, s: (preds.append(np.asarray(a)), stats.append(s)), pred, st)
    p.run()
    return preds, stats


def _run_host_blend(engine, tiled, node, model, crops, ts, stride, **kw):
    out = []
    with engine.Pipeline() as p:
        img = engine.Unpack(crops)
        with tiled((ts, ts), img, tile_stride=(stride, stride), blend_strategy="linear"):
            pred = node(model, img, batch_size=2, **kw)
        engine.Call(lambda a: out.append(np.asarray(a)), pred)
    p.run()
    return out


@pytest.mark.parametrize("ts,stride,sizes", [(64, 48, SIZES), (192, 144, [(100, 90), (80, 110), (120, 60)])])
def test_device_tiled_inference_matches_jax_and_host_blend(models, ts, stride, sizes):
    rng = np.random.default_rng(ts)
    crops = [draw_blob(rng, shape=s, r=12) for s in sizes]
    (jm, tm) = models["unet"]
    ref, _ = _run_tiled(j_engine, j_inf, jm, crops, tile_size=ts, tile_stride=stride, batch_size=2)
    ours, stats = _run_tiled(t_engine, t_inf, tm, crops, tile_size=ts, tile_stride=stride, batch_size=2,
                             device="cpu")
    host = _run_host_blend(t_engine, TTiledPipeline, t_inf.TorchInference, tm, crops, ts, stride, device="cpu")
    assert len(ours) == len(ref) == len(host) == len(crops) and stats == [None] * len(crops)
    for a, b, h, c in zip(ours, ref, host, crops):
        assert a.shape == b.shape == h.shape == c.shape + (2,) and a.dtype == np.float32
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=2e-5)
        np.testing.assert_allclose(a, h, rtol=1e-5, atol=1e-6)


def test_device_tiled_inference_uint16_inputs(models):
    rng = np.random.default_rng(3)
    crops8 = [draw_blob(rng, shape=s, r=10) for s in [(64, 64), (100, 90)]]
    crops16 = [c.astype(np.uint16) * 257 for c in crops8]
    (jm, tm) = models["unet"]
    kw = dict(tile_size=64, tile_stride=48, batch_size=2)
    p8, _ = _run_tiled(t_engine, t_inf, tm, crops8, device="cpu", **kw)
    p16, _ = _run_tiled(t_engine, t_inf, tm, crops16, device="cpu", **kw)
    j16, _ = _run_tiled(j_engine, j_inf, jm, crops16, **kw)
    for a, b, c in zip(p8, p16, j16):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(b, c, rtol=1e-4, atol=2e-5)


def test_fused_measurement_matches_jax(models):
    """The Runner's transfer type (float16); the uint8 cast is held to the
    JAX package's in ``test_torch_segment_measure.py``."""
    rng = np.random.default_rng(4)
    crops = [draw_blob(rng, shape=s, r=14) for s in SIZES]
    (jm, tm) = models["unet_sat"]
    kw = dict(tile_size=64, tile_stride=48, batch_size=4, chunk_size=8, measure_channels=["a", "b"],
              measure_fill_holes=("a",), transfer_dtype=np.float16)
    jp, js = _run_tiled(j_engine, j_inf, jm, crops, **kw)
    tp, ts_ = _run_tiled(t_engine, t_inf, tm, crops, device="cpu", **kw)
    for a, b, sa, sb in zip(tp, jp, ts_, js):
        assert a.dtype == b.dtype == np.float16 and a.shape == b.shape
        # The head's gain of 1000 scales the frameworks' float32 differences
        # in the features (~1e-6) up to ~1e-3 in the few unsaturated pixels.
        np.testing.assert_allclose(a.astype(np.float32), b.astype(np.float32), rtol=0, atol=5e-3)
        for k in ("raw_area", "area", "overflow"):
            np.testing.assert_array_equal(sa[k], sb[k], err_msg=k)
        np.testing.assert_allclose(sa["axis_major_length"], sb["axis_major_length"], rtol=1e-5)
        h = a.shape[0]
        np.testing.assert_array_equal(sa["extremes"][:, :h], sb["extremes"][:, :h])


class Passthrough(torch.nn.Module):
    """Logits of 50·(x − 0.4): the mask is the input's bright pixels."""

    def forward(self, x):
        return (x[..., :1] - 0.4) * 50.0


def test_fused_measurement_overflow_falls_back_to_host():
    crop = np.zeros((64, 160), np.uint8)
    for k in range(34):  # 34 specks (raster ids 1..34, beyond the bound of 32)
        crop[2, 2 + 4 * k] = 255
    crop[30:42, 30:42] = 255  # the true largest component, id 35
    model = t_model_io.LoadedModel(Passthrough(), {})
    preds, stats = _run_tiled(t_engine, t_inf, model, [crop], tile_size=64, tile_stride=48, batch_size=2,
                              measure_channels=["ch"], measure_fill_holes=False, device="cpu")
    assert bool(stats[0]["overflow"][0])
    host_meta, _ = measure_segments({}, None, preds[0][..., :1], ["ch"], False)
    assert host_meta["object_ch_area"] == 144.0


def test_fused_measurement_channel_count_mismatch_errors():
    model = t_model_io.LoadedModel(Passthrough(), {})
    with t_engine.Pipeline() as p:
        img = t_engine.Unpack([np.zeros((64, 64), np.uint8)])
        t_inf.DeviceTiledInference(model, img, tile_size=64, tile_stride=48, batch_size=2,
                                   measure_channels=["x", "y"], device="cpu")
    with pytest.raises(ValueError, match="x.*1 channels"):
        p.run()


@pytest.mark.parametrize("is_batch", [False, True])
def test_torch_inference_matches_jax(models, is_batch):
    """Fixed-shape batches: 7 crops in batches of 3 (the tail padded by
    repeating the last crop), float16 transfer, as the polytaxo stage runs."""
    rng = np.random.default_rng(5)
    crops = [draw_blob(rng, shape=(48, 48), r=8 + i) for i in range(7)]
    (jm, tm) = models["clf"]

    def run(engine, node, model, **kw):
        out = []
        with engine.Pipeline() as p:
            img = engine.Unpack(crops)
            if is_batch:
                with engine.BatchedPipeline(3):
                    pred = node(model, img, is_batch=True, transfer_dtype=np.float16, **kw)
            else:
                pred = node(model, img, batch_size=3, transfer_dtype=np.float16, **kw)
            engine.Call(lambda a: out.append(np.asarray(a)), pred)
        p.run()
        return out

    ref = run(j_engine, j_inf.JaxInference, jm)
    ours = run(t_engine, t_inf.TorchInference, tm, device="cpu", in_flight=1)
    assert len(ours) == len(ref) == 7
    for a, b in zip(ours, ref):
        assert a.shape == b.shape == (4,) and a.dtype == b.dtype == np.float16
        np.testing.assert_allclose(a.astype(np.float32), b.astype(np.float32), rtol=1e-3, atol=1e-3)
