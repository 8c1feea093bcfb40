"""K4 (CCL vertical pass) and K8 (small-object removal) of the PyTorch port.

The plain versions (``ops/label.py:vertical_pass_plain`` and
``remove_small_objects_plain``) are held, bit for bit, against the TPU
kernels in interpret mode (``attic/pallas_label.py``,
``attic/pallas_relabel.py``) and against the JAX package's functions, on
seeded numpy inputs; the results are integers, so equality is exact. The
wrappers take the plain versions for CPU tensors. The CUDA kernels run only
on the card (tests marked ``cuda``; ``python3 chip_smoke.py`` covers the
main path's shapes): K8 also on all of its routes (one read, two reads,
and device memory beyond the largest R of the cluster route), both staged
widths and unaligned frames, one device operation a call; K8's plan is tested on the CPU in
``test_torch_relabel_plan.py``.
"""

import json
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from attic.pallas_label import vertical_pass_pallas
from attic.pallas_relabel import remove_small_objects_pallas
from maze_image_processing_pipeline_tpu.ops import label as jl
from maze_image_processing_pipeline_tpu_torch.ops import label as tl

INF = 2**30


def _vp_inputs(shape, density, seed):
    rng = np.random.default_rng(seed)
    fg = rng.random(shape) < density
    lab = np.where(fg, rng.integers(1, 2**30, shape, dtype=np.int32), INF).astype(np.int32)
    return lab, fg


def _labels(shape, R, seed):
    """Label frames with ids in [0, R + 20): some beyond the table, some
    negative, background most common, region sizes spread around min_area."""
    rng = np.random.default_rng(seed)
    ids = (rng.random(shape) ** 3 * (R + 20)).astype(np.int32)  # high ids rare
    ids[rng.random(shape) < 0.5] = 0
    ids[rng.random(shape) < 0.02] = -3
    return ids


# Two frames, H = 21 (not a multiple of the TPU kernel's strip of 8), W = 24.
@pytest.mark.parametrize("connectivity", [1, 2])
@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("density", [0.0, 0.5, 1.0])
def test_vertical_pass_plain_matches_pallas_and_jax(connectivity, reverse, density):
    lab, fg = _vp_inputs((2, 21, 24), density, seed=int(10 * density) + 2 * connectivity + reverse)
    ours = tl.vertical_pass_plain(torch.from_numpy(lab), torch.from_numpy(fg), connectivity, reverse).numpy()
    kernel = vertical_pass_pallas(
        jnp.asarray(lab), jnp.asarray(fg), connectivity=connectivity, reverse=reverse, strip=8, interpret=True
    )
    np.testing.assert_array_equal(ours, np.asarray(kernel))
    ref = jl._vertical_pass(jnp.asarray(lab), jnp.asarray(fg), connectivity, reverse, strip=8)
    np.testing.assert_array_equal(ours, np.asarray(ref))
    # The wrapper takes the plain version for CPU tensors.
    wrapped = tl.vertical_pass(torch.from_numpy(lab), torch.from_numpy(fg), connectivity, reverse)
    np.testing.assert_array_equal(wrapped.numpy(), ours)


@pytest.mark.parametrize("min_area", [0, 1, 3, 5])  # 0: absent ids are kept too
def test_remove_small_objects_plain_matches_pallas_and_jax(min_area):
    R = 32
    labels = np.abs(_labels((2, 19, 40), R, seed=min_area))
    out, n = tl.remove_small_objects_plain(torch.from_numpy(labels), min_area, num_segments=R)
    k_out, k_n = remove_small_objects_pallas(
        jnp.asarray(labels), min_area, num_segments=R, tile_rows=8, interpret=True
    )
    np.testing.assert_array_equal(out.numpy(), np.asarray(k_out))
    np.testing.assert_array_equal(n.numpy(), np.asarray(k_n))
    j_out, j_n = jl.remove_small_objects(jnp.asarray(labels), min_area, R)
    np.testing.assert_array_equal(out.numpy(), np.asarray(j_out))
    np.testing.assert_array_equal(n.numpy(), np.asarray(j_n))
    assert (labels >= R).any() and int(n.min()) > 0
    if min_area > 1:
        assert int(n.max()) < R - 1  # some regions were dropped
    w_out, w_n = tl.remove_small_objects(torch.from_numpy(labels), min_area, num_segments=R)
    assert torch.equal(w_out, out) and torch.equal(w_n, n)


@pytest.mark.parametrize(
    "case,R,min_area", [("R = 1", 1, 3), ("R = 1", 1, 0), ("one region covering each frame", 32, 5)]
)
def test_remove_small_objects_edge_cases_match_pallas_and_jax(case, R, min_area):
    """R = 1 (nothing can be kept) and a region covering each frame: the
    plain version bit-exact against the TPU kernel in interpret mode and the
    JAX function, and the wrapper on the CPU."""
    shape = (2, 19, 40)
    if case == "R = 1":
        labels = np.abs(_labels(shape, 6, seed=12))  # ids 0..25, every one but 0 beyond the table
    else:
        labels = np.full(shape, 7, np.int32)
    out, n = tl.remove_small_objects_plain(torch.from_numpy(labels), min_area, num_segments=R)
    k_out, k_n = remove_small_objects_pallas(
        jnp.asarray(labels), min_area, num_segments=R, tile_rows=8, interpret=True
    )
    j_out, j_n = jl.remove_small_objects(jnp.asarray(labels), min_area, R)
    for ref_out, ref_n in ((k_out, k_n), (j_out, j_n)):
        np.testing.assert_array_equal(out.numpy(), np.asarray(ref_out))
        np.testing.assert_array_equal(n.numpy(), np.asarray(ref_n))
    assert n.tolist() == [0 if R == 1 else 1] * 2
    w_out, w_n = tl.remove_small_objects(torch.from_numpy(labels), min_area, num_segments=R)
    assert torch.equal(w_out, out) and torch.equal(w_n, n)


def test_remove_small_objects_plain_maps_negative_ids_to_zero_as_jax():
    R = 16
    labels = _labels((1, 12, 30), R, seed=9)
    out, n = tl.remove_small_objects_plain(torch.from_numpy(labels), 2, num_segments=R)
    j_out, j_n = jl.remove_small_objects(jnp.asarray(labels), 2, R)
    np.testing.assert_array_equal(out.numpy(), np.asarray(j_out))
    np.testing.assert_array_equal(n.numpy(), np.asarray(j_n))
    assert (out.numpy()[labels < 0] == 0).all()


def test_wrappers_reject_what_the_kernels_do_not_take():
    lab = torch.zeros(2, 4, 5, dtype=torch.int32)
    fg = torch.zeros(2, 4, 5, dtype=torch.bool)
    with pytest.raises(TypeError):
        tl.vertical_pass(lab.long(), fg, 2, False)
    with pytest.raises(TypeError):
        tl.vertical_pass(lab, fg.float(), 2, False)
    with pytest.raises(ValueError):
        tl.vertical_pass(lab, fg[:, :3], 2, False)
    with pytest.raises(ValueError):
        tl.vertical_pass(lab, fg, 3, False)
    with pytest.raises(TypeError):
        tl.remove_small_objects(lab.long(), 3, 8)
    with pytest.raises(ValueError):
        tl.remove_small_objects(lab, 3, 0)


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(8, 1024, 1280), (8, 1024, 1), (8, 1024, 1000), (8, 1, 1280), (3, 5, 37)])
def test_cuda_vertical_pass_matches_plain(shape):
    dev = _card()
    for density in (0.0, 0.05, 0.5, 1.0):
        lab, fg = _vp_inputs(shape, density, seed=3)
        lab_d, fg_d = torch.from_numpy(lab).to(dev), torch.from_numpy(fg).to(dev)
        for connectivity in (1, 2):
            for reverse in (False, True):
                n = tl.vertical_pass.launches
                out = tl.vertical_pass(lab_d, fg_d, connectivity, reverse)
                assert tl.vertical_pass.launches == n + 1
                assert torch.equal(out, tl.vertical_pass_plain(lab_d, fg_d, connectivity, reverse))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(8, 1024, 1280), (8, 1024, 1), (8, 1024, 1000), (8, 1, 1280), (3, 5, 37)])
def test_cuda_remove_small_objects_matches_plain(shape):
    dev = _card()
    R = 256
    labels = torch.from_numpy(_labels(shape, R, seed=4)).to(dev)
    for min_area in (1, 30, 10**9):
        n0 = tl.remove_small_objects.launches
        out, n = tl.remove_small_objects(labels, min_area, R)
        assert tl.remove_small_objects.launches == n0 + 1
        ref, n_ref = tl.remove_small_objects_plain(labels, min_area, R)
        assert torch.equal(out, ref) and torch.equal(n, n_ref)


@pytest.mark.cuda
@pytest.mark.parametrize(
    "shape,R,offset",
    [
        ((8, 2048, 2560), 256, 0),  # the dense haul's frames: the two-read route
        ((8, 1024, 1280), 4096, 0),  # uint16 staging, two reads
        ((3, 1001, 1277), 256, 0),  # H*W odd: frames not 16-B aligned
        ((2, 96, 1280), 256, 1),  # rows not 16-B aligned
        ((1, 1024, 1280), 1, 0),  # B = 1, R = 1
    ],
)
def test_cuda_remove_small_objects_routes_match_plain(shape, R, offset):
    """Both routes (one read, two reads), both staged widths and the
    unaligned path, bit-exact against the plain version and the same bits
    from two calls, with min_area 0, 1 and 30."""
    dev = _card()
    labels = torch.from_numpy(_labels(shape, R, seed=5))
    lab = torch.empty(labels.numel() + offset, dtype=torch.int32, device=dev)[offset:].view(shape).copy_(labels)
    for min_area in (0, 1, 30):
        out, n = tl.remove_small_objects(lab, min_area, R)
        again = tl.remove_small_objects(lab, min_area, R)
        ref, n_ref = tl.remove_small_objects_plain(lab, min_area, R)
        assert torch.equal(out, ref) and torch.equal(n, n_ref)
        assert torch.equal(out, again[0]) and torch.equal(n, again[1])
    plan = tl.remove_small_objects_plan(lab, R)
    assert plan.one_read == (shape[1] * shape[2] <= 1310720 and R <= 256), plan


@pytest.mark.cuda
def test_cuda_remove_small_objects_raises_beyond_the_largest_r():
    """One id beyond the largest R of the cluster route the plan takes the
    device-memory route, and both equal the plain version (C5: this test
    pinned the raise before)."""
    dev = _card()
    r_max = tl.relabel_max_segments(tl._relabel_capacity(dev)[0])
    lab = torch.zeros((1, 8, 8), dtype=torch.int32, device=dev)
    out, n = tl.remove_small_objects(lab, 0, r_max)
    assert int(n) == r_max - 1 and int(out.abs().max()) == 0
    labels = torch.from_numpy(_labels((2, 64, 80), r_max + 1, seed=7)).to(dev)
    for R, route in ((r_max, "two reads"), (r_max + 1, "device memory")):
        assert tl.remove_small_objects_plan(labels, R).route == route
        for min_area in (0, 1, 2):
            out, n = tl.remove_small_objects(labels, min_area, R)
            ref, n_ref = tl.remove_small_objects_plain(labels, min_area, R)
            assert torch.equal(out, ref) and torch.equal(n, n_ref), (R, min_area)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,R", [((8, 1024, 1280), 40000), ((1, 512, 512), 70000), ((3, 37, 41), 40000)])
def test_cuda_remove_small_objects_device_memory_route(shape, R):
    """The device-memory route (bins and table past a block's shared
    memory, or ids past uint16), aligned and not (H*W odd), bit-exact
    against the plain version and the same bits from two calls, with
    min_area 0, 1 and 30; one launch counted a call, on that route."""
    dev = _card()
    lab = torch.from_numpy(chip_smoke.large_id_labels(shape, R, seed=8)).to(dev)
    n0 = tl.remove_small_objects.__dict__.get("launches_by_route", {}).get("device memory", 0)
    chip_smoke.check_relabel_c5(lab, R, str(shape))
    assert tl.remove_small_objects.launches_by_route["device memory"] == n0 + 6


@pytest.mark.cuda
def test_cuda_remove_small_objects_is_one_device_operation():
    """Each K8 call is one kernel, with no memset and no copy, at loki's,
    the perf lab's and the dense haul's shapes (counted by torch.profiler in
    a process of its own, ``tools/norm_ops.py --relabel``), and makes no
    host synchronisation."""
    dev = _card()
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run(
        [sys.executable, "-m", "maze_image_processing_pipeline_tpu_torch.tools.norm_ops", "--relabel"],
        cwd=repo, capture_output=True, text=True, timeout=600,
    )
    assert out.returncode == 0, out.stderr[-3000:]
    cases = json.loads(out.stdout.strip().splitlines()[-1])["relabel"]
    assert [c["shape"] for c in cases] == [[8, 1024, 1280], [8, 1024, 1024], [8, 2048, 2560]]
    for case in cases:
        ops = case["ops"]
        assert len(ops) == 1 and sum(ops.values()) == 1 and "relabel_cluster_kernel" in next(iter(ops)), case
    assert {c["route"] for c in cases} == {"one read", "two reads"}
    lab = torch.from_numpy(_labels((8, 1024, 1280), 256, seed=6)).to(dev)
    tl.remove_small_objects(lab, 30, 256)  # warm: build, occupancy query
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        tl.remove_small_objects(lab, 30, 256)
    finally:
        torch.cuda.set_sync_debug_mode(0)
