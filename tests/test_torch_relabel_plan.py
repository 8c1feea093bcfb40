"""The plan of the one-launch small-object removal kernel K8
(``ops.label.relabel_plan``) and the kernel's steps, on the CPU.

The plan is held to what ``csrc/relabel.cu`` relies on, with an H100's
numbers (232,448 bytes of shared memory a block; 132, 66, 30, 15 and 7
clusters of 1, 2, 4, 8 and 16 such blocks at once, as the card's occupancy
query reported them) and with a small card: the shares cover each frame
exactly, are multiples of 8 pixels, stage at most what a block holds, and
the route is one read exactly where a share fits. At the path's shapes it
takes clusters of 8 and reads each label once (16 clusters of 16 would need
two waves of 7), at the dense haul's frames it reads part of each share
twice, and where R's bins and table do not fit a block (R > 38,712 on an
H100) or the ids pass uint16 it takes the device-memory route.

The kernel's steps (stage each share, count it, sum the cluster's bins,
build the table, relabel from the staged share and read the rest again) are
replayed in numpy on the plan's partition and held, bit for bit, against
the plain version, on both cluster routes and both staged widths; so are
the device-memory route's (count by chunks into the bins, the table in
place, gather).
"""

import math
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from maze_image_processing_pipeline_tpu_torch.ops import label as tl

H100 = (232448, (132, 66, 30, 15, 7))  # shared bytes a block; clusters of 1, 2, 4, 8, 16
SMALL = (20000, (16, 8, 4, 2, 1))
# Cards of one-block clusters and little shared memory, where a share does not fit.
TINY_U8 = (4096, (8, 0, 0, 0, 0))
TINY_U16 = (6000, (8, 0, 0, 0, 0))
CSRC = Path(tl.__file__).resolve().parents[1] / "csrc" / "relabel.cu"

PATH = [(8, 1024, 1280), (8, 1024, 1024)]  # loki's frames, the perf lab's
DENSE = (8, 2048, 2560)
ODD = [(1, 1024, 1280), (3, 1001, 1277), (4, 33, 1276), (2, 3, 5), (8, 1024, 1), (8, 1, 1280), (5, 0, 7)]


def _check_plan(plan, B, HW, R, card):
    smem_block, active = card
    fixed = tl.relabel_fixed_bytes(R)
    per_px = tl.relabel_stage_bytes(R)
    assert plan.cluster in tl.CLUSTER_SIZES and active[tl.CLUSTER_SIZES.index(plan.cluster)] >= 1
    assert plan.share % 8 == 0 and plan.stage % 8 == 0
    assert (plan.cluster - 1) * plan.share < HW <= plan.cluster * plan.share or HW == plan.share == 0
    assert 0 <= plan.stage <= plan.share
    assert plan.smem == fixed + -(-plan.stage * per_px // 16) * 16 <= smem_block
    # One read exactly where the share fits what a block can stage.
    cap = (smem_block - fixed) // per_px // 8 * 8
    assert plan.one_read == (plan.share <= cap)
    assert plan.stage == min(plan.share, cap)


@pytest.mark.parametrize("card", [H100, SMALL], ids=["h100", "small"])
@pytest.mark.parametrize("shape", PATH + [DENSE] + ODD)
@pytest.mark.parametrize("R", [1, 256, 257, 4096])
def test_plan_fits_the_kernel(shape, R, card):
    B, H, W = shape
    plan = tl.relabel_plan(B, H * W, R, *card)
    if tl.relabel_fixed_bytes(R) > card[0]:  # bins and table in device memory
        assert plan.route == "device memory" and (plan.cluster, plan.smem) == (0, 0) and not plan.one_read
        return
    _check_plan(plan, B, H * W, R, card)


@pytest.mark.parametrize(
    "shape,R,cluster,route,smem",
    [
        ((8, 1024, 1280), 256, 8, "one read", 165536),  # loki's frames: 160 KB of uint8 a block, one wave of 8 clusters
        ((8, 1024, 1024), 256, 8, "one read", 132768),  # the perf lab's
        ((8, 2048, 2560), 256, 16, "two reads", 232448),  # the dense haul's: 5.2 MB a frame
        ((1, 1024, 1280), 256, 16, "one read", 83616),  # one frame: the whole card's clusters of 16 are free
        ((8, 1024, 1280), 4096, 8, "two reads", 232448),  # uint16 staging: 320 KB a share of 8
        ((8, 1024, 1), 256, 2, "one read", 2208),
    ],
)
def test_plan_on_h100(shape, R, cluster, route, smem):
    B, H, W = shape
    plan = tl.relabel_plan(B, H * W, R, *H100)
    assert (plan.cluster, plan.route, plan.smem) == (cluster, route, smem)


def test_plan_largest_r_and_the_raise_beyond_it():
    """The largest R of the cluster route, and beyond it the device-memory
    route (it raised before); a card that runs no cluster still raises."""
    r_max = tl.relabel_max_segments(H100[0])
    assert tl.relabel_fixed_bytes(r_max) <= H100[0] < tl.relabel_fixed_bytes(r_max + 1)
    assert 256 < r_max < 65536  # uint16 staging holds every id below R
    assert r_max == 38712
    plan = tl.relabel_plan(8, 1024 * 1280, r_max, *H100)
    assert plan.route == "two reads" and plan.stage < 64
    for R in (r_max + 1, 40000, 65536, 65537, 70000, 10**6):
        assert tl.relabel_plan(8, 1024 * 1280, R, *H100).route == "device memory"
    with pytest.raises(ValueError, match="no cluster"):
        tl.relabel_plan(8, 1024, 256, H100[0], (0, 0, 0, 0, 0))


def test_ids_past_uint16_take_the_device_memory_route():
    """Past R = 65536 the cluster route's uint16 table cannot hold the ids,
    whatever a card's shared memory: a card of 1 MB a block still takes the
    device-memory route there."""
    big = (1 << 20, (8, 4, 2, 1, 0))
    assert tl.relabel_plan(1, 4096, tl.RELABEL_MAX_CLUSTER_R, *big).route == "one read"
    assert tl.relabel_plan(1, 4096, tl.RELABEL_MAX_CLUSTER_R + 1, *big).route == "device memory"
    src = CSRC.read_text()
    assert "R > 65536" in src and tl.RELABEL_MAX_CLUSTER_R == 65536
    assert "(R <= 65536 && layout(R, 0).total <= static_cast<size_t>(in.smem))" in src


def _device_memory_steps(labels: np.ndarray, min_area: int, R: int) -> tuple:
    """The device-memory route's steps in numpy, chunk by chunk of
    csrc/relabel.cu's kChunk pixels: count each chunk into the frame's
    (R,) bins (id 0 and ids outside [0, R) not counted), turn the bins into
    the table cumsum(keep) * keep in place (keep: id > 0 and area >=
    min_area; n the last sum), and gather each chunk's labels from it."""
    chunk = int(re.search(r"constexpr long long kChunk = (\d+);", CSRC.read_text()).group(1))
    B = labels.shape[0]
    flat = labels.reshape(B, -1)
    HW = flat.shape[1]
    bins = np.zeros((B, R), np.int32)
    for f in range(B):
        for lo in range(0, max(HW, 1), chunk):
            v = flat[f, lo : lo + chunk]
            v = v[(v > 0) & (v < R)]
            np.add.at(bins[f], v, 1)
    keep = (bins >= min_area) & (np.arange(R) > 0)
    table = (np.cumsum(keep, axis=1) * keep).astype(np.int32)
    n = keep.sum(1).astype(np.int32)
    out = np.empty_like(flat)
    for f in range(B):
        for lo in range(0, HW, chunk):
            v = flat[f, lo : lo + chunk]
            out[f, lo : lo + chunk] = table[f][np.where((v > 0) & (v < R), v, 0)]
    return out.reshape(labels.shape), n


@pytest.mark.parametrize("shape,R", [((2, 200, 180), 40000), ((1, 37, 41), 70000), ((3, 5, 7), 38713)])
@pytest.mark.parametrize("min_area", [0, 1, 3])
def test_device_memory_steps_match_plain(shape, R, min_area):
    rng = np.random.default_rng(R + min_area)
    labels = rng.integers(-3, R + 20, shape, dtype=np.int32)
    labels[rng.random(shape) < 0.3] = 0
    labels[:, :4, :4] = R - 1  # the largest id, present
    assert tl.relabel_plan(shape[0], shape[1] * shape[2], R, *H100).route == "device memory"
    out, n = _device_memory_steps(labels, min_area, R)
    ref, n_ref = tl.remove_small_objects_plain(torch.from_numpy(labels), min_area, R)
    np.testing.assert_array_equal(out, ref.numpy())
    np.testing.assert_array_equal(n, n_ref.numpy())


def test_fixed_bytes_follow_the_kernel_source():
    """The scratch the plan reserves is the kernel's: the scan's warp totals
    and carry, (threads / 32 + 8) ints, rounded to 16 B."""
    src = CSRC.read_text()
    threads = int(re.search(r"constexpr int kThreads = (\d+);", src).group(1))
    assert "kScratchInts = kWarps + 8" in src
    assert tl._RELABEL_SCRATCH == -(-4 * (threads // 32 + 8) // 16) * 16
    assert tl.relabel_fixed_bytes(256) == 1024 + 512 + tl._RELABEL_SCRATCH
    assert re.search(r"constexpr int kClusterSizes\[\] = \{1, 2, 4, 8, 16\};", src)


def _kernel_steps(labels: np.ndarray, min_area: int, R: int, plan) -> tuple:
    """csrc/relabel.cu's steps in numpy, block by block on the plan's
    partition: stage [lo, mid) as uint8 / uint16 (ids outside [0, R) as 0),
    count [lo, hi) into the block's bins, sum the cluster's bins, build the
    table, relabel the staged part and read [mid, hi) again."""
    B = labels.shape[0]
    flat = labels.reshape(B, -1)
    HW = flat.shape[1]
    stage_t = np.uint8 if tl.relabel_stage_bytes(R) == 1 else np.uint16
    out = np.empty_like(flat)
    n = np.empty(B, np.int32)
    for f in range(B):
        bins, staged, parts = [], [], []
        for rank in range(plan.cluster):
            lo = min(HW, rank * plan.share)
            hi = min(HW, lo + plan.share)
            mid = min(hi, lo + plan.stage)
            v = flat[f, lo:hi]
            v = np.where((v > 0) & (v < R), v, 0)
            staged.append(v[: mid - lo].astype(stage_t))
            assert staged[-1].nbytes <= plan.smem - tl.relabel_fixed_bytes(R)
            b = np.bincount(v, minlength=R).astype(np.int32)
            b[0] = 0
            bins.append(b)
            parts.append((lo, mid, hi))
        area = np.sum(bins, axis=0)
        keep = (area >= min_area) & (np.arange(R) > 0)
        table = (np.cumsum(keep) * keep).astype(np.uint16)
        n[f] = keep.sum()
        for (lo, mid, hi), s in zip(parts, staged):
            out[f, lo:mid] = table[s]
            rest = flat[f, mid:hi]
            out[f, mid:hi] = table[np.where((rest > 0) & (rest < R), rest, 0)]
    return out.reshape(labels.shape), n


@pytest.mark.parametrize(
    "shape,R,card",
    [
        ((3, 37, 41), 32, H100),  # one read, uint8, H*W odd
        ((2, 64, 160), 32, TINY_U8),  # two reads, uint8
        ((2, 48, 64), 300, TINY_U16),  # two reads, uint16
        ((2, 48, 64), 300, H100),  # one read, uint16
        ((2, 40, 40), 1, H100),
    ],
)
@pytest.mark.parametrize("min_area", [0, 1, 5])
def test_kernel_steps_match_plain(shape, R, card, min_area):
    rng = np.random.default_rng(math.prod(shape) + R)
    labels = (rng.random(shape) ** 3 * (R + 20)).astype(np.int32)
    labels[rng.random(shape) < 0.4] = 0
    labels[rng.random(shape) < 0.02] = -2
    plan = tl.relabel_plan(shape[0], shape[1] * shape[2], R, *card)
    out, n = _kernel_steps(labels, min_area, R, plan)
    ref, n_ref = tl.remove_small_objects_plain(torch.from_numpy(labels), min_area, R)
    np.testing.assert_array_equal(out, ref.numpy())
    np.testing.assert_array_equal(n, n_ref.numpy())


def test_routes_of_the_step_cases():
    """The replayed cases cover both routes and both staged widths."""
    assert tl.relabel_plan(2, 64 * 160, 32, *TINY_U8).route == "two reads"
    assert tl.relabel_plan(2, 48 * 64, 300, *TINY_U16).route == "two reads"
    assert tl.relabel_plan(2, 48 * 64, 300, *H100).route == "one read"
    assert tl.relabel_stage_bytes(256) == 1 and tl.relabel_stage_bytes(257) == 2


def test_cpu_tensors_take_the_plain_version_and_have_no_plan():
    lab = torch.zeros((2, 4, 5), dtype=torch.int32)
    n0 = tl.remove_small_objects.launches
    tl.remove_small_objects(lab, 3, 8)
    assert tl.remove_small_objects.launches == n0
    with pytest.raises(ValueError, match="CUDA"):
        tl.remove_small_objects_plan(lab, 8)
