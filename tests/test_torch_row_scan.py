"""The CCL row scans of the PyTorch port (ops/row_scan.py).

The plain versions are held, bit for bit, against the JAX package's Pallas
kernels run in interpret mode (one grid step, (1, 16, 128)), and against a
numpy loop at edge shapes. The CUDA kernels themselves run only on the card
(tests marked ``cuda``; ``python3 chip_smoke.py`` covers the main path's
shapes).
"""

import numpy as np
import pytest
import torch

from maze_image_processing_pipeline_tpu.ops.pallas_scan import (
    cumsum_lanes_pallas,
    hpass_pallas,
)
from maze_image_processing_pipeline_tpu_torch.ops import row_scan

INF = 2**30


def _inputs(shape, density, seed):
    rng = np.random.default_rng(seed)
    fg = rng.random(shape) < density
    lab = rng.integers(1, 2**30, shape, dtype=np.int32)
    return lab, fg


def _hpass_numpy(lab, fg):
    """Run minimum per horizontal foreground run, by a plain loop."""
    out = np.full(lab.shape, INF, np.int32)
    for idx in np.ndindex(lab.shape[:-1]):
        row_l, row_f = lab[idx], fg[idx]
        x = 0
        W = row_l.shape[0]
        while x < W:
            if not row_f[x]:
                x += 1
                continue
            end = x
            while end < W and row_f[end]:
                end += 1
            out[idx + (slice(x, end),)] = row_l[x:end].min()
            x = end
    return out


@pytest.mark.parametrize("density", [0.0, 0.4, 0.8, 1.0])
def test_hpass_plain_matches_pallas_interpret(density):
    lab, fg = _inputs((1, 16, 128), density, seed=int(density * 10))
    ref = np.asarray(hpass_pallas(lab, fg, tile_rows=16, interpret=True))
    ours = row_scan.hpass_plain(torch.from_numpy(lab), torch.from_numpy(fg))
    np.testing.assert_array_equal(ours.numpy(), ref)


@pytest.mark.parametrize("density", [0.1, 0.6])
def test_cumsum_plain_matches_pallas_interpret(density):
    rng = np.random.default_rng(3)
    x = (rng.random((1, 16, 128)) < density).astype(np.int32) * rng.integers(
        1, 5, (1, 16, 128), dtype=np.int32
    )
    ref = np.asarray(cumsum_lanes_pallas(x, tile_rows=16, interpret=True))
    ours = row_scan.cumsum_rows_plain(torch.from_numpy(x))
    np.testing.assert_array_equal(ours.numpy(), ref)


@pytest.mark.parametrize("shape", [(3, 5, 1), (2, 1, 37), (2, 7, 100), (4, 33)])
def test_hpass_edge_shapes(shape):
    lab, fg = _inputs(shape, 0.6, seed=sum(shape))
    ours = row_scan.hpass(torch.from_numpy(lab), torch.from_numpy(fg))
    np.testing.assert_array_equal(ours.numpy(), _hpass_numpy(lab, fg))
    # uint8 masks are taken as well as bool ones.
    ours_u8 = row_scan.hpass(torch.from_numpy(lab), torch.from_numpy(fg.astype(np.uint8)))
    np.testing.assert_array_equal(ours_u8.numpy(), ours.numpy())


def test_cpu_tensors_take_the_plain_version_without_counting():
    before = (row_scan.hpass.launches, row_scan.cumsum_rows.launches)
    lab, fg = _inputs((2, 4, 9), 0.5, seed=1)
    row_scan.hpass(torch.from_numpy(lab), torch.from_numpy(fg))
    x = torch.ones(2, 4, 9, dtype=torch.int32)
    np.testing.assert_array_equal(row_scan.cumsum_rows(x).numpy(), np.cumsum(x.numpy(), -1))
    assert (row_scan.hpass.launches, row_scan.cumsum_rows.launches) == before


def test_wrappers_reject_what_the_kernels_do_not_take():
    lab = torch.zeros(2, 8, dtype=torch.int64)
    fg = torch.zeros(2, 8, dtype=torch.bool)
    with pytest.raises(TypeError):
        row_scan.hpass(lab, fg)
    with pytest.raises(TypeError):
        row_scan.hpass(lab.int(), fg.float())
    with pytest.raises(ValueError):
        row_scan.hpass(lab.int(), fg[:, :4])
    with pytest.raises(TypeError):
        row_scan.cumsum_rows(lab)


@pytest.mark.cuda
@pytest.mark.parametrize(
    "shape", [(8, 1024, 1280), (8, 1024, 1), (8, 1024, 1000), (8, 1, 1280), (3, 37)]
)
def test_cuda_kernels_match_plain(shape):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    for density in (0.0, 0.05, 0.5, 1.0):
        lab, fg = _inputs(shape, density, seed=7)
        lab_d, fg_d = torch.from_numpy(lab).cuda(), torch.from_numpy(fg).cuda()
        n = row_scan.hpass.launches
        out = row_scan.hpass(lab_d, fg_d)
        assert row_scan.hpass.launches == n + 1
        assert torch.equal(out, row_scan.hpass_plain(lab_d, fg_d))
        x = fg_d.to(torch.int32)
        assert torch.equal(row_scan.cumsum_rows(x), row_scan.cumsum_rows_plain(x))
