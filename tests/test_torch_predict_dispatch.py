"""The predict node's dispatch without host synchronisation.

``DeviceTiledInference._run_chunk`` and the fused segment measurement it
calls wait for no card: tiles and extents go up from page-locked memory
without blocking, the border pixels of the hole filling are picked by an
index (:func:`segment_measure._border_index`) instead of a boolean mask,
and the per-frame id count (:func:`label._per_frame_bincount`) is a
``torch.histc`` of given bounds that reads nothing back.

On the CPU: the per-frame count against ``torch.bincount`` of each frame's
ids in range (ids below 0 and at or above S, an empty frame, frames of no
ids, B = 1, S = 32 and 64), exact; K8's plain version counts with
``torch.bincount``, not with the port's count; the border index against the boolean mask's selection,
one-row and one-column frames included.

On the card (``cuda``; this file imports nothing of the JAX package): a
node with the fused measurement and hole filling on both channels, over
crops in four buckets, runs ``_run_chunk`` under
``torch.cuda.set_sync_debug_mode("error")``; its maps and packed stats
match the same node on the CPU at the tolerances of
``test_torch_predict_inference.py``'s fused-measurement test (maps within
5e-3, integers and row extremes exact, axis lengths within rtol 1e-5), and
the node run end to end gives the same results bit for bit. The per-frame
count runs under the same mode at the predict cell's shapes, with more
bins than a block's shared memory holds (S = 40000 and 70000) and over
70,000 frames, with
int32, int64, int16 and uint8 ids, exact against ``torch.bincount``.
"""

import numpy as np
import pytest
import torch

from maze_image_processing_pipeline_tpu_torch import engine
from maze_image_processing_pipeline_tpu_torch.models import inference as t_inf
from maze_image_processing_pipeline_tpu_torch.models import model_io
from maze_image_processing_pipeline_tpu_torch.ops import label as tl
from maze_image_processing_pipeline_tpu_torch.ops import segment_measure as sm
from maze_image_processing_pipeline_tpu_torch.tools.synth import draw_blob, write_unet

# Buckets (64, 128), (128, 128), (256, 256) and (512, 256) at tiles of 64.
SIZES = [(64, 64), (100, 90), (40, 56), (90, 120), (170, 170), (150, 200), (300, 140)]
CHANNELS = ["a", "b"]


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _reference_count(values: torch.Tensor, S: int) -> torch.Tensor:
    """Each frame's ids in [0, S) counted by one ``torch.bincount`` of
    frame * S + id over the ids in range, on the CPU."""
    v = values.cpu().long()
    B = v.shape[0]
    ok = (v >= 0) & (v < S)
    keys = (torch.arange(B)[:, None] * S + v)[ok]
    return torch.bincount(keys, minlength=B * S).reshape(B, S).to(torch.int32)


def _ids(B: int, N: int, S: int, seed: int, dtype=torch.int32) -> torch.Tensor:
    """Ids from -3 to S + 3, most of them 0 (a label image's background);
    frame 1, where there is one, holds none in range."""
    rng = np.random.default_rng(seed)
    v = np.where(rng.random((B, N)) < 0.7, 0, rng.integers(-3, S + 4, (B, N)))
    if B > 1:
        v[1] = rng.choice([-2, -1, S, S + 5], N)
    return torch.from_numpy(v).to(dtype)


@pytest.mark.parametrize("B,N,S", [(1, 1000, 32), (4, 777, 32), (3, 4096, 64), (1, 1, 64), (2, 0, 32)])
def test_per_frame_bincount_matches_bincount(B, N, S):
    v = _ids(B, N, S, seed=B * 1000 + N + S)
    got = tl._per_frame_bincount(v, S)
    assert got.dtype == torch.int32 and got.shape == (B, S)
    assert torch.equal(got, _reference_count(v, S))
    if B > 1:
        assert int(got[1].sum()) == 0  # the frame of no ids in range


def test_k8_plain_reference_counts_with_bincount(monkeypatch):
    """K8's plain version counts the areas with ``per_frame_bincount_plain``
    (``torch.bincount``), never through the port's count."""
    rng = np.random.default_rng(3)
    labels = torch.from_numpy(rng.integers(-2, 40, (3, 17, 23)).astype(np.int32))
    labels[:, :6] = 5  # one region above min_area in every frame
    want = tl.remove_small_objects_plain(labels, 20, 32)

    def refuse(*args):
        raise AssertionError("K8's plain version used _per_frame_bincount")

    monkeypatch.setattr(tl, "_per_frame_bincount", refuse)
    got = tl.remove_small_objects_plain(labels, 20, 32)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    areas = _reference_count(labels.reshape(3, -1), 32)
    assert torch.equal(got[1], ((areas[:, 1:] >= 20).sum(1)).to(torch.int32))
    assert int(got[1].min()) >= 1


@pytest.mark.parametrize("H,W", [(1, 7), (6, 1), (1, 1), (2, 2), (2, 5), (5, 2), (3, 3), (5, 7), (64, 128)])
def test_border_index_matches_mask_selection(H, W):
    border = torch.zeros((H, W), dtype=torch.bool)
    border[0, :] = border[-1, :] = True
    border[:, 0] = border[:, -1] = True
    frames = torch.arange(3 * H * W, dtype=torch.int32).reshape(3, H, W)
    idx = sm._border_index(H, W, torch.device("cpu"))
    assert idx.dtype == torch.int64
    assert torch.equal(frames.reshape(3, -1).index_select(1, idx), frames[:, border])


class FirstChannel(torch.nn.Module):
    def forward(self, x):
        return x[..., :1]


@pytest.mark.parametrize("dtype,channels", [(np.uint8, ()), (np.uint16, ()), (np.float32, (3,)), (np.uint8, (2,))])
def test_tile_cut_matches_padded_stack(dtype, channels):
    """The tiles ``_forward`` gets are the zero-padded tiles of each crop's
    grid, stacked in job order (uint16 widened to [0, 1] first)."""
    rng = np.random.default_rng(7)
    crops = [(rng.random(s + channels) * 1000).astype(dtype) for s in SIZES]
    node, pipe, _, _ = _node(model_io.LoadedModel(FirstChannel(), {}), crops, "cpu", measure_channels=None)
    seen = []
    forward = node._forward
    node._forward = lambda tiles, k: (seen.append(tiles.clone()), forward(tiles, k))[1]
    pipe.run()
    ts, stride = 64, 48
    buckets = {}  # _run_chunk's buckets, in its order
    for i, (h, w) in enumerate(SIZES):
        key = (max(1 << (max(h, ts) - 1).bit_length(), ts), max(1 << (max(w, ts) - 1).bit_length(), ts, 128),
               str(crops[i].dtype), crops[i].shape[2:])
        buckets.setdefault(key, []).append(i)
    want = []
    for key in sorted(buckets, key=str):
        tiles = []
        for i in buckets[key]:
            c = t_inf._host_widen(crops[i])
            for y in t_inf._tile_starts(c.shape[0], ts, stride):
                for x in t_inf._tile_starts(c.shape[1], ts, stride):
                    t = c[y : y + ts, x : x + ts]
                    tiles.append(np.pad(t, [(0, ts - t.shape[0]), (0, ts - t.shape[1])] + [(0, 0)] * len(channels)))
        want.append(np.stack(tiles))
    assert len(seen) == len(want)
    for got, ref in zip(seen, want):
        assert got.numpy().dtype == ref.dtype and np.array_equal(got.numpy(), ref)


def _node(model, crops, device, measure_channels=CHANNELS):
    """A fused-measurement node over ``crops`` in one chunk, the end-to-end
    results collected: (node, pipeline, maps, stats)."""
    maps, stats = [], []
    with engine.Pipeline() as p:
        img = engine.Unpack(crops)
        pred, st = t_inf.DeviceTiledInference(
            model, img, tile_size=64, tile_stride=48, batch_size=4, chunk_size=len(crops),
            measure_channels=measure_channels, measure_fill_holes=True, transfer_dtype=np.float16, device=device)
        engine.Call(lambda a, s: (maps.append(np.asarray(a)), stats.append(s)), pred, st)
    node = next(c for c in p.children if isinstance(c, t_inf.DeviceTiledInference.node_class))
    return node, p, maps, stats


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_run_chunk_makes_no_host_synchronisation(tmp_path, dtype):
    dev = _card()
    rng = np.random.default_rng(4)
    crops = [draw_blob(rng, shape=s, r=14) for s in SIZES]
    # Head scaled: no probability within float noise of the 0.5 threshold.
    fn = write_unet(str(tmp_path / "unet"), dict(out_channels=2, base_features=4, depth=1), dtype, seed=1,
                    gain=1000.0, channel_names=tuple(CHANNELS))
    node, pipe, maps, stats = _node(model_io.load_model(fn, dtype=dtype), crops, "cuda")
    allow_tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False  # float32 convolutions as on the CPU
    try:
        node._run_chunk(crops)  # builds the kernels and cuDNN's plans outside the check
        torch.cuda.synchronize(dev)
        torch.cuda.set_sync_debug_mode("error")
        try:
            parts, layout = node._run_chunk(crops)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        assert len(layout) == 4  # four buckets
        got_maps, got_stats = node._unpack_chunk(parts, layout, crops)
        pipe.run()
    finally:
        torch.backends.cudnn.allow_tf32 = allow_tf32
    assert len(maps) == len(crops)
    for a, b, sa, sb in zip(got_maps, maps, got_stats, stats):
        assert np.array_equal(a, b)
        for k in sa:
            assert np.array_equal(sa[k], sb[k]), k
    if dtype != "float32":
        return
    cpu_node, *_ = _node(model_io.load_model(fn, dtype="float32"), crops, "cpu")
    ref_maps, ref_stats = cpu_node._unpack_chunk(*cpu_node._run_chunk(crops), crops)
    for a, b, sa, sb in zip(got_maps, ref_maps, got_stats, ref_stats):
        assert a.dtype == b.dtype == np.float16 and a.shape == b.shape
        np.testing.assert_allclose(a.astype(np.float32), b.astype(np.float32), rtol=0, atol=5e-3)
        for k in ("raw_area", "area", "overflow"):
            np.testing.assert_array_equal(sa[k], sb[k], err_msg=k)
        np.testing.assert_allclose(sa["axis_major_length"], sb["axis_major_length"], rtol=1e-5)
        h = a.shape[0]
        np.testing.assert_array_equal(sa["extremes"][:, :h], sb["extremes"][:, :h])


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,W,S", [
    (32, 256, 256, 32), (32, 512, 512, 64), (7, 300, 140, 32), (3, 1, 1000, 64),
    (8, 1024, 1280, 40000), (1, 512, 512, 70000),  # more bins than a block's shared memory holds
    (70000, 1, 16, 4),  # 70,000 frames
])
def test_cuda_per_frame_bincount_makes_no_host_synchronisation(B, H, W, S):
    """int32 and int64 ids, and int16 and uint8 ones (widened to int64
    first), exact against ``torch.bincount``."""
    dev = _card()
    cases = [_ids(B, H * W, S, seed=H + S, dtype=dt).to(dev) for dt in (torch.int32, torch.int64, torch.int16, torch.uint8)]
    torch.cuda.synchronize(dev)
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = [tl._per_frame_bincount(v, S) for v in cases]
    finally:
        torch.cuda.set_sync_debug_mode("default")
    for v, g in zip(cases, got):
        assert g.device.type == "cuda" and g.dtype == torch.int32
        assert torch.equal(g.cpu(), _reference_count(v, S))
