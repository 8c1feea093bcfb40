"""The CCL fixpoint of the PyTorch port (``ops/label.py:_fixpoint``).

On the card the whole fixpoint (sweeps of K1, K4 down, K4 up, K1 until no
pixel of a frame changes) is one launch of ``csrc/ccl.cu``, one block per
frame, each frame stopping on its own; rows wider than 8192 take the banded
route (``ccl_route``: ``csrc/ccl_banded.cu``, bands of 512 to 8192
columns, a block each, their edges exchanged through device memory), and
frames whose bands the card cannot hold at once the grid route
(``csrc/ccl_grid.cu``, the whole grid on each row in turn). Its plain
version
``fixpoint_plain`` is held here on seeded numpy masks: its labels against
the batch-wide host loop of the standalone passes (the loop ``label`` ran
before the fixpoint became a kernel) and, through ``label``, against the JAX
package's ``label``; its per-frame sweep counts against the same loop run
on each frame alone. Labels are integers, so every comparison is exact.
Here too: the port's CPU ``label`` against the JAX package's on rows wider
than one block walks; ``ccl_route`` at the path's shapes and above them;
and the banded route's K1 (each band's own scan, its row summary, the
look-back over the neighbours' summaries, the lowering of its edge runs)
replayed in torch against the plain K1 of whole rows; the grid route's
sweeps (chunked K1, the stop rule) replayed against the plain fixpoint; the
banded route's
workspace handing each call its own epoch across host threads. The kernel runs
only on the card (tests marked ``cuda``).

This file imports nothing that the card's machine lacks (no flax, optax or
h5py), so it collects there too.
"""

import threading
import time

import numpy as np
import pytest
import torch

from chip_smoke import (
    FIXPOINT_SHAPES,
    PREDICT_LABEL_SHAPES,
    RELABEL_TIMED,
    blob_masks,
    host_loop_fixpoint,
    serpentine,
)
from maze_image_processing_pipeline_tpu.ops import label as jl
from maze_image_processing_pipeline_tpu_torch.ops import label as tl
from maze_image_processing_pipeline_tpu_torch.ops import row_scan

INF = 2**30
H, W = 26, 30


def _batch() -> np.ndarray:
    """A serpentine, two blob frames, an all-background and an
    all-foreground frame."""
    return np.concatenate(
        [serpentine(1, H, W), blob_masks((2, H, W), seed=5), np.zeros((1, H, W), bool), np.ones((1, H, W), bool)]
    )


def _raster_seed(fg: torch.Tensor) -> torch.Tensor:
    lin = torch.arange(1, H * W + 1, dtype=torch.int32).reshape(1, H, W)
    return torch.where(fg, lin, INF)


def _rank_seed(fg: torch.Tensor, connectivity: int) -> torch.Tensor:
    """``label``'s second seed: each root's raster rank (from 1), ``2**30``
    elsewhere."""
    lab, _ = tl.fixpoint_plain(_raster_seed(fg), fg, connectivity, 256)
    is_root = fg & (lab == _raster_seed(torch.ones_like(fg)))
    ranks = torch.cumsum(is_root.reshape(len(fg), -1).to(torch.int32), 1, dtype=torch.int32).reshape(fg.shape)
    return torch.where(is_root, ranks, INF)


@pytest.mark.parametrize("max_iters", [1, 3, 256])
@pytest.mark.parametrize("seed", ["raster", "rank"])
@pytest.mark.parametrize("connectivity", [1, 2])
def test_fixpoint_plain_matches_the_host_loop_and_single_frames(connectivity, seed, max_iters):
    fg = torch.from_numpy(_batch())
    lab0 = _raster_seed(fg) if seed == "raster" else _rank_seed(fg, connectivity)
    lab, sweeps = tl.fixpoint_plain(lab0, fg, connectivity, max_iters)
    ref, n = host_loop_fixpoint(lab0, fg, connectivity, max_iters)
    assert torch.equal(lab, ref)
    assert sweeps.dtype == torch.int32 and int(sweeps.max()) == n
    for b in range(len(fg)):
        alone, n_b = host_loop_fixpoint(lab0[b : b + 1], fg[b : b + 1], connectivity, max_iters)
        assert torch.equal(lab[b : b + 1], alone)
        assert int(sweeps[b]) == n_b
    # The serpentine needs more sweeps than the blobs; the empty frame one.
    assert int(sweeps[3]) == 1
    if max_iters == 256:
        assert int(sweeps[0]) > 3
    # The CPU wrapper is the plain version and launches nothing.
    launches = tl._fixpoint.launches
    w_lab, w_sweeps = tl._fixpoint(lab0, fg, connectivity, max_iters)
    assert torch.equal(w_lab, lab) and torch.equal(w_sweeps, sweeps) and tl._fixpoint.launches == launches


@pytest.mark.parametrize("max_iters", [1, 3, 256])
@pytest.mark.parametrize("connectivity", [1, 2])
def test_label_through_fixpoint_plain_matches_jax(connectivity, max_iters):
    m = _batch()
    ref, n_ref = jl.label(m, connectivity=connectivity, max_iters=max_iters)
    ours, n = tl.label(torch.from_numpy(m), connectivity=connectivity, max_iters=max_iters)
    np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))
    np.testing.assert_array_equal(n.numpy(), np.asarray(n_ref))


def test_a_background_seed_other_than_inf_counts_as_a_change():
    fg = torch.zeros(2, 3, 4, dtype=torch.bool)
    lab0 = torch.full((2, 3, 4), INF, dtype=torch.int32)
    lab0[1, 1, 2] = 7
    lab, sweeps = tl.fixpoint_plain(lab0, fg, 2, 256)
    assert (lab == INF).all()
    assert sweeps.tolist() == [1, 2]


def test_fixpoint_rejects_what_the_kernel_does_not_take():
    lab = torch.zeros(2, 4, 5, dtype=torch.int32)
    fg = torch.zeros(2, 4, 5, dtype=torch.bool)
    with pytest.raises(TypeError):
        tl._fixpoint(lab.long(), fg, 2, 8)
    with pytest.raises(TypeError):
        tl._fixpoint(lab, fg.float(), 2, 8)
    with pytest.raises(ValueError):
        tl._fixpoint(lab, fg[:, :3], 2, 8)
    with pytest.raises(ValueError):
        tl._fixpoint(lab[0], fg[0], 2, 8)
    with pytest.raises(ValueError):
        tl._fixpoint(lab, fg, 0, 8)


@pytest.mark.parametrize("connectivity", [1, 2])
@pytest.mark.parametrize("shape", [(1, 24, 8193), (1, 8, 20000)])
def test_label_on_wide_rows_matches_jax(shape, connectivity):
    rng = np.random.default_rng(shape[2] + connectivity)
    m = rng.random(shape) < 0.3
    m[0, shape[1] // 2, :] = True  # a row of foreground across every band: one run over 8192 and 46000
    ref, n_ref = jl.label(m, connectivity=connectivity)
    ours, n = tl.label(torch.from_numpy(m), connectivity=connectivity)
    np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))
    np.testing.assert_array_equal(n.numpy(), np.asarray(n_ref))


# The shapes the port's paths label: loki's and the perf lab's frames, the
# dense haul's, the fused measurement's chunks, phase 2's edge shapes.
PATH_SHAPES = (
    (8, 1024, 1280), (8, 1024, 1024), (8, 2048, 2560), (8, 1024, 1), (8, 1024, 1000), (8, 1, 1280), (4, 64, 37),
    (2, 96, 1277),
) + PREDICT_LABEL_SHAPES + FIXPOINT_SHAPES + RELABEL_TIMED


H100_SMS = 132  # an H100 SXM's multiprocessors: one block of the walk each


@pytest.mark.parametrize("connectivity", [1, 2])
@pytest.mark.parametrize("shape", sorted(set(PATH_SHAPES)) + [(1, 7, 8192)])
def test_ccl_route_is_one_block_at_the_path_shapes(shape, connectivity):
    assert tl.ccl_route(*shape, connectivity, H100_SMS) == tl.CclRoute("one_block", shape[2], 1, 0)


@pytest.mark.parametrize("connectivity", [1, 2])
@pytest.mark.parametrize("W", [8193, 12000, 16384, 20000, 50000, 67584, 67585, 1_000_000, 1_081_344, 1_081_345])
def test_ccl_route_bands_wider_rows(W, connectivity):
    """Bands of 512 columns (equal, rounded up to 32) while a frame's bands
    fit the card's blocks, wider ones (at most 8192) where they would not;
    beyond 132 bands of 8192 the card cannot hold a frame's bands and the
    grid route takes it."""
    B, H = 3, 512
    r = tl.ccl_route(B, H, W, connectivity, H100_SMS)
    if W > H100_SMS * tl.CCL_BAND:
        assert r.route == "grid" and r.band == tl.CCL_GRID_CHUNK and r.bands == -(-W // tl.CCL_GRID_CHUNK)
        assert r.slots * 16 == 32 + 32 * B * H * r.bands
        return
    assert r.route == "banded" and r.band <= tl.CCL_BAND and r.band % 32 == 0
    assert (r.bands - 1) * r.band < W <= r.bands * r.band
    if W <= H100_SMS * tl.CCL_BAND_MIN:
        assert r.band <= tl.CCL_BAND_MIN
    assert r.bands <= H100_SMS
    assert r.slots == B * r.bands * (2 * H + 2 + (4 * H if connectivity == 2 else 0))


@pytest.mark.parametrize("sms", [2, 66, H100_SMS])
@pytest.mark.parametrize("B, H", [(1, 1), (9, 3), (2, 992)])
def test_ccl_route_takes_the_grid_route_where_the_bands_stop_fitting(B, H, sms):
    """The grid route starts exactly where a frame needs one band of
    ``CCL_BAND`` more than the card has multiprocessors (on an H100 133
    bands: 1,081,345 columns), for every batch and height; its scratch is
    a 32-B counter block a 8 frames and 32 B a chunk of each row."""
    edge = sms * tl.CCL_BAND
    for connectivity in (1, 2):
        below = tl.ccl_route(B, H, edge, connectivity, sms)
        above = tl.ccl_route(B, H, edge + 1, connectivity, sms)
        assert below.route == "banded" and below.bands == sms and below.band == tl.CCL_BAND
        assert above.route == "grid" and above.bands == -(-(edge + 1) // tl.CCL_GRID_CHUNK)
        assert above.slots * 16 == 32 * -(-B // 8) + 32 * B * H * above.bands
    assert tl.ccl_route(1, 1, 4_000_000, 2, H100_SMS).route == "grid"


@pytest.mark.parametrize("limit, W, route", [(32, 4224, "banded"), (32, 4225, "grid"), (64, 8449, "grid"),
                                             (96, 8449, "banded")])
def test_ccl_route_takes_the_grid_route_at_forced_small_bands(monkeypatch, limit, W, route):
    """With ``CCL_BAND`` lowered (the card tests' way to run the wide routes
    on narrow frames) the grid route starts past 132 bands of the limit
    (bands are rounded to multiples of 32: a limit of 96 gives bands of
    64 where that keeps their count)."""
    monkeypatch.setattr(tl, "CCL_BAND", limit)
    assert tl.ccl_route(3, 61, W, 2, H100_SMS).route == route


@pytest.mark.parametrize("limit, W, band, bands", [(32, 100, 32, 4), (32, 33, 32, 2), (64, 300, 64, 5), (96, 97, 64, 2)])
def test_ccl_route_follows_the_band_limit(monkeypatch, limit, W, band, bands):
    """The card tests lower ``CCL_BAND`` to run the banded route on narrow
    frames: the fewest bands of at most the limit, of equal width rounded
    up to a multiple of 32."""
    monkeypatch.setattr(tl, "CCL_BAND", limit)
    assert tl.CCL_BAND_MIN >= limit
    r = tl.ccl_route(2, 8, W, 2, H100_SMS)
    assert (r.route, r.band, r.bands) == ("banded", band, bands)
    assert tl.ccl_route(2, 8, limit, 2, H100_SMS).route == "one_block"



class _YieldingInt(int):
    """An epoch counter whose addition lets other threads run, so that a
    read-increment-write of the counter that is not under a lock
    interleaves with other threads'."""

    def __add__(self, other):
        time.sleep(0.0005)
        return _YieldingInt(int(self) + other)


def test_exchange_gives_every_call_its_own_epoch_across_threads():
    """Host threads that launch on one stream share its workspace; every
    call of the banded route must get an epoch of its own, else two launches
    read each other's slots as their neighbours'."""
    key = (None, -7001)
    n_threads, calls = 8, 25
    tl._EXCHANGE[key] = [torch.zeros(1 << 16, dtype=torch.int64), _YieldingInt(0)]
    start = threading.Barrier(n_threads)
    got = [[] for _ in range(n_threads)]

    def worker(i):
        start.wait()
        for _ in range(calls):
            ws, epoch = tl._exchange(torch.device("cpu"), key[1], 64)
            got[i].append(int(epoch))

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(n_threads)]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    finally:
        tl._EXCHANGE.pop(key, None)
    assert sorted(e for g in got for e in g) == list(range(1, n_threads * calls + 1))


def test_exchange_zeroes_its_workspace_before_the_epochs_wrap():
    key_stream = -7002
    try:
        ws, epoch = tl._exchange(torch.device("cpu"), key_stream, 8)
        assert epoch == 1 and not ws.any()
        ws.fill_(5)
        tl._EXCHANGE[(None, key_stream)][1] = 2**32 - 2
        ws2, epoch = tl._exchange(torch.device("cpu"), key_stream, 8)
        assert ws2 is ws and epoch == 2**32 - 1 and bool((ws == 5).all())
        ws3, epoch = tl._exchange(torch.device("cpu"), key_stream, 8)
        assert ws3 is ws and epoch == 1 and not ws.any()
    finally:
        tl._EXCHANGE.pop((None, key_stream), None)


def _banded_k1(lab: torch.Tensor, fg: torch.Tensor, band: int) -> torch.Tensor:
    """csrc/ccl_banded.cu's K1 across bands, replayed on (rows, W): each band's own
    K1; its summary (the run at its left edge, at its right edge, kInf where
    the edge pixel is background; all foreground or not); the look-back over
    the neighbours' summaries as far as they are all foreground; the band's
    first run lowered to what crosses in from the left, its last run to what
    crosses in from the right (a band all foreground: to both)."""
    W = lab.shape[-1]
    cuts = [(c0, min(W, c0 + band)) for c0 in range(0, W, band)]
    local = [row_scan.hpass_plain(lab[:, a:b], fg[:, a:b]) for a, b in cuts]
    masks = [fg[:, a:b].bool() for a, b in cuts]
    head = [torch.where(m[:, 0], v[:, 0], INF) for v, m in zip(local, masks)]
    tail = [torch.where(m[:, -1], v[:, -1], INF) for v, m in zip(local, masks)]
    full = [m.all(1) for m in masks]
    out = []
    for j, (v, m) in enumerate(zip(local, masks)):
        left = torch.full_like(head[j], INF)
        going = m[:, 0].clone()
        for k in range(j - 1, -1, -1):
            left = torch.where(going, torch.minimum(left, tail[k]), left)
            going &= full[k]
        right = torch.full_like(head[j], INF)
        going = m[:, -1].clone()
        for k in range(j + 1, len(cuts)):
            right = torch.where(going, torch.minimum(right, head[k]), right)
            going &= full[k]
        cols = torch.arange(v.shape[1])
        bg = ~m
        first_bg = torch.where(bg.any(1), bg.int().argmax(1), v.shape[1])
        last_bg = torch.where(bg.any(1), v.shape[1] - 1 - bg.flip(1).int().argmax(1), -1)
        in_head = cols[None] < first_bg[:, None]
        in_tail = cols[None] > last_bg[:, None]
        cross = torch.where(in_head, left[:, None], INF)
        cross = torch.minimum(cross, torch.where(in_tail, right[:, None], INF))
        out.append(torch.where(m, torch.minimum(v, cross), v))
    return torch.cat(out, 1)


@pytest.mark.parametrize("band", [1, 5, 32, 37, 64])
@pytest.mark.parametrize("density", [0.5, 0.9, 1.0])
def test_banded_k1_replay_matches_the_plain_k1(band, density):
    rng = np.random.default_rng(band)
    rows, W = 40, 301
    fg = torch.from_numpy(rng.random((rows, W)) < density)
    fg[3] = True
    fg[4] = False
    fg[5, ::band] = False  # background on every band's first column
    lab = torch.from_numpy(rng.integers(1, INF, (rows, W), dtype=np.int32))
    assert torch.equal(_banded_k1(lab, fg, band), row_scan.hpass_plain(lab, fg))


def _grid_k1(lab: torch.Tensor, fg: torch.Tensor, chunk: int):
    """csrc/ccl_grid.cu's K1 replayed on (rows, W): each chunk's own K1 and
    its edge runs; the chains of edge runs leftwards and rightwards (a chunk
    foreground throughout passes the run on, lowered by its own); each
    chunk's first and last run lowered to what crosses in. Returns the
    labels and, per row, whether a label changed."""
    W = lab.shape[-1]
    out, sums = [], []
    for c0 in range(0, W, chunk):
        v, m = row_scan.hpass_plain(lab[:, c0:c0 + chunk], fg[:, c0:c0 + chunk]), fg[:, c0:c0 + chunk].bool()
        bg = ~m
        cw = m.shape[1]
        first = torch.where(bg.any(1), bg.int().argmax(1), cw)
        last = torch.where(bg.any(1), cw - 1 - bg.flip(1).int().argmax(1), -1)
        sums.append((torch.where(m[:, 0], v[:, 0], INF), torch.where(m[:, -1], v[:, -1], INF), first, last, first == cw))
        out.append(v)
    n = len(sums)
    left, right = [None] * n, [None] * n
    run = torch.full((lab.shape[0],), INF, dtype=torch.int32)
    for q in range(n):
        left[q] = run
        run = torch.where(sums[q][4], torch.minimum(run, sums[q][1]), sums[q][1])
    run = torch.full((lab.shape[0],), INF, dtype=torch.int32)
    for q in range(n - 1, -1, -1):
        right[q] = run
        run = torch.where(sums[q][4], torch.minimum(run, sums[q][0]), sums[q][0])
    for q, v in enumerate(out):
        cols = torch.arange(v.shape[1])[None]
        _, _, first, last, whole = sums[q]
        low = torch.where(cols < first[:, None], left[q][:, None], INF)
        low = torch.minimum(low, torch.where(cols > last[:, None], right[q][:, None], INF))
        out[q] = torch.minimum(v, low)
    new = torch.cat(out, 1)
    return new, (new != lab).any(1)


def _grid_fixpoint(lab0: torch.Tensor, fg: torch.Tensor, connectivity: int, max_iters: int, chunk: int):
    """csrc/ccl_grid.cu's fixpoint replayed: every frame's `last` sweep that
    changed it; K1 on the active frames' rows (the first sweep and the
    closing K1 of each), K4 down and up a row at a time, the stop rule read
    from `last` after each sweep."""
    B, H, W = lab0.shape
    lab = lab0.clone()
    last = [0] * B
    sweeps = torch.zeros(B, dtype=torch.int32)
    sweep = 1
    while True:
        act = [b for b in range(B) if last[b] >= sweep - 1]
        for step in (["k1"] if sweep == 1 else []) + ["down", "up", "k1"]:
            for b in act:
                if step == "k1":
                    new, ch = _grid_k1(lab[b], fg[b], chunk)
                else:
                    new = tl.vertical_pass_plain(lab[b], fg[b], connectivity, reverse=step == "up")
                    ch = (new != lab[b]).any()
                if bool(ch.any()):
                    last[b] = sweep
                lab[b] = new
        more = False
        for b in act:
            if last[b] >= sweep and sweep < max_iters:
                more = True
            else:
                sweeps[b] = sweep
        if not more:
            return lab, sweeps
        sweep += 1


@pytest.mark.parametrize("chunk", [1, 7, 32])
@pytest.mark.parametrize("connectivity", [1, 2])
def test_grid_route_replay_matches_fixpoint_plain(connectivity, chunk):
    """The grid route's sweeps, chunked K1 and stop rule replayed in torch:
    the plain fixpoint's labels and per-frame sweep counts, on a serpentine,
    blobs, an empty and a full frame, both seeds, capped at 1, 3 and 256
    sweeps."""
    fg = torch.from_numpy(_batch())
    for lab0 in (_raster_seed(fg), _rank_seed(fg, connectivity)):
        for max_iters in (1, 3, 256):
            lab, sweeps = _grid_fixpoint(lab0, fg, connectivity, max_iters, chunk)
            ref, ref_sweeps = tl.fixpoint_plain(lab0, fg, connectivity, max_iters)
            assert torch.equal(lab, ref) and torch.equal(sweeps, ref_sweeps)


# -- on the card ----------------------------------------------------------------

# Loki's frames, the fused measurement's chunks, and ragged rows and frames.
CARD_SHAPES = ((8, 1024, 1280),) + PREDICT_LABEL_SHAPES + (
    (4, 64, 1), (4, 64, 37), (2, 128, 1000), (2, 96, 1277), (2, 96, 1280), (5, 1, 1280), (3, 1, 37),
)


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("shape", CARD_SHAPES)
def test_cuda_fixpoint_matches_plain(shape):
    dev = _card()
    rng = np.random.default_rng(sum(shape))
    B, h, w = shape
    lin = torch.arange(1, h * w + 1, dtype=torch.int32, device=dev).reshape(1, h, w)
    masks = [blob_masks(shape, seed=1), rng.random(shape) < 0.5]
    for fg_np in masks:
        fg = torch.from_numpy(fg_np).to(dev)
        random_lab = torch.from_numpy(rng.integers(1, INF, shape, dtype=np.int32)).to(dev)
        for lab0 in (torch.where(fg, lin, INF), random_lab):
            for connectivity in (1, 2):
                n = tl._fixpoint.launches
                lab, sweeps = tl._fixpoint(lab0, fg, connectivity, 256)
                assert tl._fixpoint.launches == n + 1
                ref, ref_sweeps = tl.fixpoint_plain(lab0, fg, connectivity, 256)
                assert torch.equal(lab, ref) and torch.equal(sweeps, ref_sweeps)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 1024, 1280), (4, 256, 256), (3, 97, 37)])
def test_cuda_fixpoint_matches_plain_on_capped_serpentines(shape):
    dev = _card()
    fg = torch.from_numpy(serpentine(*shape)).to(dev)
    lin = torch.arange(1, shape[1] * shape[2] + 1, dtype=torch.int32, device=dev).reshape(shape[1:])
    lab0 = torch.where(fg, lin, INF)
    for connectivity in (1, 2):
        for max_iters in (1, 3):
            lab, sweeps = tl._fixpoint(lab0, fg, connectivity, max_iters)
            ref, ref_sweeps = tl.fixpoint_plain(lab0, fg, connectivity, max_iters)
            assert torch.equal(lab, ref) and torch.equal(sweeps, ref_sweeps)
            assert int(sweeps.min()) == max_iters


@pytest.mark.cuda
def test_cuda_label_is_one_launch_a_fixpoint_and_no_standalone_pass():
    dev = _card()
    m = torch.from_numpy(blob_masks((8, 256, 256), seed=2)).to(dev)
    before = (tl._fixpoint.launches, row_scan.hpass.launches, tl.vertical_pass.launches)
    labels, n = tl.label(m, connectivity=2)
    after = (tl._fixpoint.launches, row_scan.hpass.launches, tl.vertical_pass.launches)
    assert after == (before[0] + 2, before[1], before[2])
    ref, n_ref = tl.label(m.cpu(), connectivity=2)
    assert torch.equal(labels.cpu(), ref) and torch.equal(n.cpu(), n_ref)


@pytest.mark.cuda
def test_cuda_label_makes_no_host_synchronisation():
    dev = _card()
    m = torch.from_numpy(blob_masks((8, 256, 256), seed=3)).to(dev)
    tl.label(m, connectivity=1)  # builds and loads the kernels outside the check
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for connectivity in (1, 2):
            labels, n = tl.label(m, connectivity=connectivity)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert n.device.type == "cuda"
    ref, n_ref = tl.label(m.cpu(), connectivity=2)
    assert torch.equal(labels.cpu(), ref) and torch.equal(n.cpu(), n_ref)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 512, 4097), (2, 256, 6000), (1, 128, 8192)])
def test_cuda_fixpoint_one_block_on_rows_wider_than_4096(shape):
    """Rows of 4097 to 8192 columns give the one-block route fewer than 16
    ring stages, and it hung, or with an odd number of stages gave wrong
    labels: a scanner (more of them than stages), or a loader (a slot taken
    by both loaders in turn), met a slot two mbarrier phases early
    (csrc/ccl_rows.cuh: `plan` now keeps the stages even and the scanners at
    most the stages). Serpentines capped at 3 sweeps showed the loaders'
    case."""
    dev = _card()
    assert tl.ccl_route(*shape, 2, H100_SMS).route == "one_block"
    fg, seeds = _wide_inputs(shape, dev, seed=shape[2])
    serp = torch.from_numpy(serpentine(*shape)).to(dev)
    lin = torch.arange(1, shape[1] * shape[2] + 1, dtype=torch.int32, device=dev).reshape(shape[1:])
    for connectivity in (1, 2):
        for lab0, mask, max_iters in ((seeds[0], fg, 256), (seeds[1], fg, 256), (torch.where(serp, lin, INF), serp, 3)):
            lab, sweeps = tl._fixpoint(lab0, mask, connectivity, max_iters)
            ref, ref_sweeps = tl.fixpoint_plain(lab0, mask, connectivity, max_iters)
            assert torch.equal(lab, ref) and torch.equal(sweeps, ref_sweeps)


# The banded route: rows one past a block's 8192 columns, and well beyond.
WIDE_SHAPES = ((2, 512, 8193), (2, 512, 12000))


def _wide_inputs(shape, dev, seed):
    rng = np.random.default_rng(seed)
    B, h, w = shape
    lin = torch.arange(1, h * w + 1, dtype=torch.int32, device=dev).reshape(1, h, w)
    fg_np = blob_masks(shape, seed=seed) | (rng.random(shape) < 0.3)
    fg_np[:, h // 2, :] = True  # a run across every band
    fg = torch.from_numpy(fg_np).to(dev)
    random_lab = torch.from_numpy(rng.integers(1, INF, shape, dtype=np.int32)).to(dev)
    return fg, (torch.where(fg, lin, INF), random_lab)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", WIDE_SHAPES)
def test_cuda_fixpoint_banded_matches_plain(shape):
    dev = _card()
    assert tl.ccl_route(*shape, 2, H100_SMS).route == "banded"
    fg, seeds = _wide_inputs(shape, dev, seed=shape[2])
    for lab0 in seeds:
        for connectivity in (1, 2):
            n = tl._fixpoint.launches
            lab, sweeps = tl._fixpoint(lab0, fg, connectivity, 256)
            assert tl._fixpoint.launches == n + 1
            ref, ref_sweeps = tl.fixpoint_plain(lab0, fg, connectivity, 256)
            assert torch.equal(lab, ref) and torch.equal(sweeps, ref_sweeps)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", WIDE_SHAPES)
def test_cuda_fixpoint_banded_matches_plain_on_capped_serpentines(shape):
    dev = _card()
    fg = torch.from_numpy(serpentine(*shape)).to(dev)
    lin = torch.arange(1, shape[1] * shape[2] + 1, dtype=torch.int32, device=dev).reshape(shape[1:])
    lab0 = torch.where(fg, lin, INF)
    for connectivity in (1, 2):
        for max_iters in (1, 3):
            lab, sweeps = tl._fixpoint(lab0, fg, connectivity, max_iters)
            ref, ref_sweeps = tl.fixpoint_plain(lab0, fg, connectivity, max_iters)
            assert torch.equal(lab, ref) and torch.equal(sweeps, ref_sweeps)
            assert int(sweeps.min()) == max_iters


@pytest.mark.cuda
@pytest.mark.parametrize("band", [32, 64, 96])
@pytest.mark.parametrize("shape", [(5, 61, 300), (3, 1, 200), (40, 16, 97)])
def test_cuda_fixpoint_forced_bands_match_plain(monkeypatch, shape, band):
    """The banded route at narrow bands (``CCL_BAND`` lowered: up to 10 bands
    a frame, ragged last bands of 1 to 44 columns, more frames than the card
    holds at once: 40 frames of 4 bands), both seeds, both connectivities,
    and serpentines capped at 1 and 3 sweeps."""
    dev = _card()
    monkeypatch.setattr(tl, "CCL_BAND", band)
    assert tl.ccl_route(*shape, 2, H100_SMS).route == "banded"
    rng = np.random.default_rng(band + shape[2])
    B, h, w = shape
    lin = torch.arange(1, h * w + 1, dtype=torch.int32, device=dev).reshape(1, h, w)
    for fg_np in (rng.random(shape) < 0.6, serpentine(*shape) if h > 4 else np.ones(shape, bool)):
        fg = torch.from_numpy(fg_np).to(dev)
        random_lab = torch.from_numpy(rng.integers(1, INF, shape, dtype=np.int32)).to(dev)
        for lab0 in (torch.where(fg, lin, INF), random_lab):
            for connectivity in (1, 2):
                for max_iters in (1, 3, 256):
                    lab, sweeps = tl._fixpoint(lab0, fg, connectivity, max_iters)
                    ref, ref_sweeps = tl.fixpoint_plain(lab0, fg, connectivity, max_iters)
                    assert torch.equal(lab, ref) and torch.equal(sweeps, ref_sweeps), (connectivity, max_iters)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 64, 8193), (2, 256, 12000)])
def test_cuda_vertical_pass_banded_matches_plain(shape):
    dev = _card()
    fg, seeds = _wide_inputs(shape, dev, seed=7)
    for lab in seeds:
        for connectivity in (1, 2):
            for reverse in (False, True):
                n = tl.vertical_pass.launches
                out = tl.vertical_pass(lab, fg, connectivity, reverse)
                assert tl.vertical_pass.launches == n + 1
                assert torch.equal(out, tl.vertical_pass_plain(lab, fg, connectivity, reverse))


@pytest.mark.cuda
def test_cuda_hpass_wide_rows_match_plain():
    dev = _card()
    shape = (2, 64, 50000)
    rng = np.random.default_rng(5)
    lab = torch.from_numpy(rng.integers(1, INF, shape, dtype=np.int32)).to(dev)
    for density in (0.5, 0.999, 1.0):
        fg_np = rng.random(shape) < density
        fg_np[0, 3, 4096:8192] = True  # a chunk foreground throughout, inside a longer run
        fg = torch.from_numpy(fg_np).to(dev)
        n = row_scan.hpass.launches
        out = row_scan.hpass(lab, fg)
        assert row_scan.hpass.launches == n + 1
        assert torch.equal(out, row_scan.hpass_plain(lab, fg))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 128, 8193), (2, 128, 12000)])
def test_cuda_label_on_wide_rows_is_one_launch_a_fixpoint_without_host_sync(shape):
    """At WIDE_SHAPES' widths, 128 rows: the CPU's label() is the slow part."""
    dev = _card()
    fg, _ = _wide_inputs(shape, dev, seed=11)
    tl.label(fg, connectivity=2)  # builds the kernels and the workspace outside the check
    torch.cuda.synchronize()
    for connectivity in (1, 2):
        before = (tl._fixpoint.launches, row_scan.hpass.launches, tl.vertical_pass.launches)
        torch.cuda.set_sync_debug_mode("error")
        try:
            labels, n = tl.label(fg, connectivity=connectivity)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        assert (tl._fixpoint.launches, row_scan.hpass.launches, tl.vertical_pass.launches) == (
            before[0] + 2, before[1], before[2])
        ref, n_ref = tl.label(fg.cpu(), connectivity=connectivity)
        assert torch.equal(labels.cpu(), ref) and torch.equal(n.cpu(), n_ref)


@pytest.mark.cuda
def test_cuda_label_raises_where_the_card_cannot_hold_a_frames_bands():
    """Pins the repair of C4 (ROADMAP queue C): the card once raised on this
    frame, because a frame's bands must all be resident at once (on an H100
    rows above 132 × 8192 columns), where the JAX ``label`` labels it. The
    grid route takes such frames now: ``label()`` equals ``label()``
    through the plain versions, as does the fixpoint's sweep count."""
    from chip_smoke import plain_label

    dev = _card()
    rng = np.random.default_rng(13)
    for fg_np in (np.ones((1, 1, 4_000_000), bool), rng.random((1, 1, 4_000_000)) < 0.9):
        fg = torch.from_numpy(fg_np).to(dev)
        assert tl.ccl_route_of(fg, 2).route == "grid"
        for connectivity in (1, 2):
            labels, n = tl.label(fg, connectivity=connectivity)
            ref, n_ref = plain_label(fg, connectivity)
            assert torch.equal(labels, ref) and torch.equal(n, n_ref)


@pytest.mark.cuda
@pytest.mark.parametrize("band, shape", [(32, (3, 61, 4300)), (32, (2, 1, 9000)), (64, (2, 1, 9000)),
                                         (64, (5, 16, 8449))])
def test_cuda_fixpoint_grid_route_matches_plain(monkeypatch, shape, band):
    """The grid route at forced small bands (``CCL_BAND`` lowered so that a
    frame needs more than 132 bands): both seeds, both connectivities,
    serpentines capped at 1 and 3 sweeps, labels and sweep counts, and the
    8-connected pass alone both ways."""
    dev = _card()
    monkeypatch.setattr(tl, "CCL_BAND", band)
    B, h, w = shape
    if tl.ccl_route_of(torch.empty(shape, device=dev), 2).route != "grid":
        pytest.skip(f"{shape} at bands of {band} fits this card's bands")
    rng = np.random.default_rng(band + w)
    lin = torch.arange(1, h * w + 1, dtype=torch.int32, device=dev).reshape(1, h, w)
    for fg_np in (rng.random(shape) < 0.6, serpentine(*shape) if h > 4 else np.ones(shape, bool)):
        fg = torch.from_numpy(fg_np).to(dev)
        random_lab = torch.from_numpy(rng.integers(1, INF, shape, dtype=np.int32)).to(dev)
        for lab0 in (torch.where(fg, lin, INF), random_lab):
            for connectivity in (1, 2):
                for max_iters in (1, 3, 256):
                    n = tl._fixpoint.launches
                    lab, sweeps = tl._fixpoint(lab0, fg, connectivity, max_iters)
                    assert tl._fixpoint.launches == n + 1
                    ref, ref_sweeps = tl.fixpoint_plain(lab0, fg, connectivity, max_iters)
                    assert torch.equal(lab, ref) and torch.equal(sweeps, ref_sweeps), (connectivity, max_iters)
            for reverse in (False, True):
                out = tl.vertical_pass(lab0, fg, 2, reverse)
                assert torch.equal(out, tl.vertical_pass_plain(lab0, fg, 2, reverse))


def test_plain_label_is_label_through_the_plain_versions():
    """``chip_smoke.plain_label``, the card's reference for ``label()`` on
    wide rows, is ``label()`` itself on the CPU, and leaves the module as it
    was."""
    from chip_smoke import plain_label

    m = torch.from_numpy(_batch())
    for connectivity in (1, 2):
        ref, n_ref = tl.label(m, connectivity=connectivity)
        ours, n = plain_label(m, connectivity)
        assert torch.equal(ours, ref) and torch.equal(n, n_ref)
    assert tl._fixpoint.__name__ == "_fixpoint" and tl.cumsum_rows is row_scan.cumsum_rows
