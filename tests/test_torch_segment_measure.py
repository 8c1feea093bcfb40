"""Segment measurement of the port against the JAX package, on the CPU.

``ops.segment_measure.measure_largest_component`` and
``measure_channels_packed`` go through both packages on the same seeded
random masks and canvases (blobs, rings with holes, specks, masks past the
overflow bounds), with hole filling on and off. Integer fields (raw area,
area, row extremes) and the overflow flags must be equal; float fields
within rtol 1e-5 (the port sums moments in float64, the JAX package in
float32). ``BatchedSegmentMeasure`` of both pipelines gives the same meta,
and ``cast_for_transfer`` / ``convex_area_from_extremes`` the same values.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from maze_image_processing_pipeline_tpu import engine as j_engine
from maze_image_processing_pipeline_tpu.ops import segment_measure as j_sm
from maze_image_processing_pipeline_tpu.predict import pipeline as j_pipeline
from maze_image_processing_pipeline_tpu_torch import engine as t_engine
from maze_image_processing_pipeline_tpu_torch.ops import segment_measure as t_sm
from maze_image_processing_pipeline_tpu_torch.predict import pipeline as t_pipeline


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the parallel test workers share the cores, and
    torch's per-worker thread pools oversubscribe them many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _masks(seed, N=6, H=48, W=72):
    """Blobs, rings (holes), specks; a few masks with more than 32
    components or 64 background components (the overflow bounds)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:H, :W]
    out = np.zeros((N, H, W), bool)
    for b in range(N):
        for _ in range(int(rng.integers(0, 4))):
            cy, cx, r = rng.integers(4, H - 4), rng.integers(4, W - 4), int(rng.integers(3, 12))
            d2 = (yy - cy) ** 2 + (xx - cx) ** 2
            blob = d2 <= r * r
            if r > 5 and rng.random() < 0.5:
                blob &= d2 >= (r // 2) ** 2
            out[b] |= blob
        n_specks = int(rng.integers(0, 8)) if b % 3 else int(rng.integers(30, 60))
        out[b, rng.integers(0, H, n_specks), rng.integers(0, W, n_specks)] = True
    out[-1, 1::4, 1::4] = True  # a grid of holes: many background components
    out[-1, 0::4, :] = True
    out[-1, :, 0::4] = True
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("fill_holes", [False, True])
def test_measure_largest_component_matches_jax(seed, fill_holes):
    masks = _masks(seed)
    jp, jr, je, jo = j_sm.measure_largest_component(jnp.asarray(masks), fill_holes=fill_holes)
    tp, tr, te, to = t_sm.measure_largest_component(torch.from_numpy(masks), fill_holes=fill_holes)
    np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
    np.testing.assert_array_equal(to.numpy(), np.asarray(jo))
    assert to.any() and not to.all()  # both sides of the bounds are exercised
    np.testing.assert_array_equal(te.numpy(), np.asarray(je))
    np.testing.assert_array_equal(tp["area"].numpy(), np.asarray(jp["area"]))
    for k in ("axis_major_length", "centroid_row", "centroid_col"):
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]), rtol=1e-5, atol=1e-4, err_msg=k)


@pytest.mark.parametrize("seed", [0, 1])
def test_measure_channels_packed_matches_jax(seed):
    rng = np.random.default_rng(seed)
    Bo, Hb, Wb, C = 5, 64, 128, 2
    canvas = rng.random((Bo, Hb, Wb, C)).astype(np.float32) * 0.45
    yy, xx = np.mgrid[0:Hb, 0:Wb]
    for b in range(Bo):
        for c in range(C):
            for _ in range(int(rng.integers(0, 4))):
                cy, cx = rng.integers(5, 50, 2)
                r = int(rng.integers(3, 12))
                canvas[b][((yy - cy) ** 2 + (xx - cx) ** 2) < r * r, c] = 0.9
                canvas[b, cy : cy + 2, cx : cx + 2, c] = 0.1
            canvas[b, rng.integers(0, Hb, 6), rng.integers(0, Wb, 6), c] = 0.8
    hs = rng.integers(20, Hb + 1, Bo).astype(np.int32)
    ws = rng.integers(40, Wb + 1, Bo).astype(np.int32)
    ref = np.asarray(
        j_sm.measure_channels_packed(
            jnp.asarray(canvas.reshape(-1)), hs, ws, shape=(Bo, Hb, Wb, C), fill_channels=(True, False)
        )
    )
    ours = t_sm.measure_channels_packed(torch.from_numpy(canvas), hs, ws, fill_channels=(True, False)).numpy()
    assert ours.shape == ref.shape
    rs, re_ = j_sm.unpack_channel_stats(ref, Bo, Hb, C)
    os_, oe = t_sm.unpack_channel_stats(ours, Bo, Hb, C)
    np.testing.assert_array_equal(oe, re_)
    for field in (0, 1, 3):  # raw_area, area, overflow
        np.testing.assert_array_equal(os_[:, field], rs[:, field])
    np.testing.assert_allclose(os_[:, 2], rs[:, 2], rtol=1e-5)
    for b in range(Bo):
        for c in range(C):
            if os_[c, 1, b] > 0:
                shape = (int(hs[b]), int(ws[b]))
                assert t_sm.convex_area_from_extremes(oe[c, b], shape) == j_sm.convex_area_from_extremes(re_[c, b], shape)


def test_cast_for_transfer_matches_jax():
    x = np.concatenate([np.linspace(0, 1, 1001, dtype=np.float32), np.float32([0.5, 127.5 / 255, 128.5 / 255])])
    for j_dt, t_dt in ((jnp.uint8, torch.uint8), (jnp.float16, torch.float16), (jnp.float32, torch.float32)):
        ref = np.asarray(j_sm.cast_for_transfer(jnp.asarray(x), j_dt))
        ours = t_sm.cast_for_transfer(torch.from_numpy(x), t_dt).numpy()
        assert ours.dtype == ref.dtype
        np.testing.assert_array_equal(ours, ref)
    assert t_sm.cast_for_transfer(torch.tensor([0.5]), torch.uint8).item() == 127  # half rounds down


def _batched(engine, mod, crops, names, fill, **kw):
    out = []
    with engine.Pipeline() as p:
        probs = engine.Unpack(crops)
        meta = mod.BatchedSegmentMeasure({"object_id": "x", "ignored_foo": 1}, probs, names, fill, chunk_size=3, **kw)
        engine.Call(lambda m: out.append(m), meta)
    p.run()
    return out


def test_batched_segment_measure_matches_jax(rng):
    names = ["Prosoma", "Oilsack"]
    crops = []
    for _ in range(7):
        h, w = int(rng.integers(24, 120)), int(rng.integers(24, 200))
        p = np.zeros((h, w, 2), np.float32)
        yy, xx = np.mgrid[:h, :w]
        for c in range(2):
            for _ in range(int(rng.integers(0, 3))):
                cy, cx = rng.integers(4, h - 4), rng.integers(4, w - 4)
                r = int(rng.integers(3, min(h, w) // 3))
                d2 = (yy - cy) ** 2 + (xx - cx) ** 2
                blob = d2 <= r * r
                if r > 5 and rng.random() < 0.5:
                    blob &= d2 >= (r // 2) ** 2
                p[..., c][blob] = 0.9
        crops.append(p)
    # Beyond the bounds: 34 specks before the largest component (host fallback).
    overflow = np.zeros((32, 160, 2), np.float32)
    overflow[2, 2:138:4] = 0.9
    overflow[20:26, 20:26] = 0.9
    crops.append(overflow)
    ref = _batched(j_engine, j_pipeline, crops, names, True)
    ours = _batched(t_engine, t_pipeline, crops, names, True, device="cpu")
    assert len(ours) == len(ref) == len(crops)
    assert ours[-1]["object_Prosoma_area"] == 36.0
    for a, b in zip(ref, ours):
        assert list(a) == list(b)
        for k in a:
            if isinstance(a[k], float) and not float(a[k]).is_integer():
                assert b[k] == pytest.approx(a[k], rel=1e-5), k
            else:
                assert b[k] == a[k], k
