"""The CCL fixpoint of the PyTorch port (``ops/label.py:_fixpoint``).

On the card the whole fixpoint (sweeps of K1, K4 down, K4 up, K1 until no
pixel of a frame changes) is one launch of ``csrc/ccl.cu``, one block per
frame, each frame stopping on its own. Its plain version
``fixpoint_plain`` is held here on seeded numpy masks: its labels against
the batch-wide host loop of the standalone passes (the loop ``label`` ran
before the fixpoint became a kernel) and, through ``label``, against the JAX
package's ``label``; its per-frame sweep counts against the same loop run
on each frame alone. Labels are integers, so every comparison is exact.
The kernel runs only on the card (tests marked ``cuda``).

This file imports nothing that the card's machine lacks (no flax, optax or
h5py), so it collects there too.
"""

import numpy as np
import pytest
import torch

from chip_smoke import PREDICT_LABEL_SHAPES, blob_masks, host_loop_fixpoint, serpentine
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
