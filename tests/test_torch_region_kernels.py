"""K3 (region histogram) and K7 (fused region measurement) of the PyTorch port.

On the card both are one kernel (``csrc/region_measure.cu``): one launch
reads the labels and the intensity once and writes K7's partials and K3's
histogram.

* K3's plain version (``ops/region_histogram.py:region_histogram_plain``) is
  held, bit for bit, against the TPU kernel ``region_histogram_pallas`` in
  interpret mode (``attic/pallas_hist.py``), with and without its
  background-skip variant and at a height that is not a multiple of its row
  strip.
* K7's plain version (``ops/regionprops_fused.py:regionprops_fused_plain``)
  is held against ``regionprops_fused_pallas`` in interpret mode
  (``attic/pallas_props.py``) on the regions present, at the tolerance of
  ``tests/test_attic_kernels.py``: integers exact, the rest within rtol 2e-3
  / atol 2e-2 (the Pallas kernel sums in float32), the orientation modulo pi.
* The plain version of the kernel's partials
  (``region_props_partials_plain``, the perimeter units included), through
  the kernel route's derivation (``_props_from_partials``) with K3's plain
  histogram, gives the plain version's props exactly, and the Pallas
  kernel's at that tolerance; its perimeter units are the per-pixel
  perimeter's.
* The wrappers take the plain versions for CPU tensors and refuse, on any
  other device, what the kernels do not take. The kernel itself runs on the
  card (tests marked ``cuda``: partials and histogram bit-exact against the
  plain versions and the same twice, one launch a call, no host
  synchronisation; on the shared-memory route at the paths' shapes, on the
  device-memory route at C5's larger R and wider frames;
  ``python3 chip_smoke.py`` phase 2). Its plan is tested on the CPU in
  ``test_torch_region_plan.py``.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.ndimage as ndi
import torch

import chip_smoke
from attic.pallas_hist import region_histogram_pallas
from attic.pallas_props import regionprops_fused_pallas
from maze_image_processing_pipeline_tpu_torch.ops import region_histogram as rh
from maze_image_processing_pipeline_tpu_torch.ops import regionprops_fused as rf


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the parallel test workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _scene(shape, R, seed, beyond=False, negative=False):
    """8-connected blob labels (ids in raster order) and uint8 intensity;
    optionally ids beyond R and negative ids sprinkled in."""
    rng = np.random.default_rng(seed)
    m = ndi.binary_dilation(rng.random(shape) < 0.05, iterations=2)
    lab = np.stack([ndi.label(f, np.ones((3, 3)))[0] for f in m]).astype(np.int32)
    if beyond:
        lab[rng.random(shape) < 0.02] = R + 3
    if negative:
        lab[rng.random(shape) < 0.02] = -2
    img = rng.integers(0, 256, shape).astype(np.uint8)
    return lab, img


# H = 21: not a multiple of the Pallas kernels' strip of 8 rows.
@pytest.mark.parametrize("skip_empty", [False, True])
def test_region_histogram_plain_matches_pallas(skip_empty):
    R = 8
    lab, img = _scene((2, 21, 40), R, seed=1, beyond=True, negative=not skip_empty)
    ours = rh.region_histogram_plain(torch.from_numpy(lab), torch.from_numpy(img), R).numpy()
    ref = region_histogram_pallas(
        jnp.asarray(lab), jnp.asarray(img), num_segments=R, tile_rows=8, skip_empty=skip_empty, interpret=True
    )
    np.testing.assert_array_equal(ours, np.asarray(ref))
    assert ours[:, 1:].sum() > 0 and ours.sum() < lab.size  # regions counted, out-of-range ids dropped
    wrapped = rh.region_histogram(torch.from_numpy(lab), torch.from_numpy(img), R)
    assert torch.equal(wrapped, torch.from_numpy(ours))


def test_region_histogram_plain_clips_float_intensity_as_pallas():
    R = 4
    lab, _ = _scene((1, 16, 24), R, seed=2)
    img = np.random.default_rng(3).uniform(-20, 300, lab.shape).astype(np.float32)
    ours = rh.region_histogram_plain(torch.from_numpy(lab), torch.from_numpy(img), R).numpy()
    ref = region_histogram_pallas(jnp.asarray(lab), jnp.asarray(img), num_segments=R, interpret=True)
    np.testing.assert_array_equal(ours, np.asarray(ref))


PALLAS_EXACT = {"area", "min_row", "max_row", "min_col", "max_col", "histogram", "intensity_min",
                "intensity_max", "intensity_sum"}


def _assert_matches_pallas(ours, ref, lab, R):
    """``ours`` against the Pallas kernel's props on the regions present
    (1..max id of each frame): integers exact, the rest at the tolerance of
    tests/test_attic_kernels.py, the orientation modulo pi."""
    assert set(ours) == set(ref)
    n = lab.reshape(len(lab), -1).max(-1)
    assert (n < R).all() and n.min() >= 1
    for k in ref:
        for b in range(len(lab)):
            o, r = ours[k].numpy()[b, 1 : n[b] + 1], np.asarray(ref[k])[b, 1 : n[b] + 1]
            if k in PALLAS_EXACT:
                np.testing.assert_array_equal(o, r, err_msg=k)
            elif k == "orientation":
                d = np.abs(o - r) % np.pi
                assert (np.minimum(d, np.pi - d) < 2e-2).all(), k
            else:
                np.testing.assert_allclose(o, r, rtol=2e-3, atol=2e-2, err_msg=k)


@pytest.mark.parametrize("shape,R", [((2, 24, 64), 16), ((1, 19, 40), 8)])
def test_regionprops_fused_plain_matches_pallas(shape, R):
    lab, img = _scene(shape, R, seed=4)
    ours = rf.regionprops_fused_plain(torch.from_numpy(lab), torch.from_numpy(img), num_segments=R)
    ref = regionprops_fused_pallas(jnp.asarray(lab), jnp.asarray(img), num_segments=R, interpret=True)
    assert lab.reshape(len(lab), -1).max(-1).min() > 1
    _assert_matches_pallas(ours, ref, lab, R)
    wrapped = rf.regionprops_fused(torch.from_numpy(lab), torch.from_numpy(img), num_segments=R)
    assert all(torch.equal(wrapped[k], ours[k]) for k in ours)


def _threshold_crops(shape, seed):
    """Crops as the threshold path measures them: a bright disc on dark
    noise, zero padded; labels ``intensity > 50`` (region 1)."""
    rng = np.random.default_rng(seed)
    N, H, W = shape
    img = np.zeros(shape, np.uint8)
    yy, xx = np.mgrid[:H, :W]
    for i in range(N):
        h, w = int(rng.integers(H // 2, H + 1)), int(rng.integers(W // 2, W + 1))
        img[i, :h, :w] = rng.integers(0, 40, (h, w))
        disc = (yy - h / 2) ** 2 + (xx - w / 2) ** 2 <= (min(h, w) / 3) ** 2
        img[i][disc] = rng.integers(120, 250)
    return (img > 50).astype(np.int32), img


PARTIAL_CASES = {
    "(2, 24, 64), R=16": lambda: (*_scene((2, 24, 64), 16, seed=11), 16),
    "ragged (1, 19, 37), R=8": lambda: (*_scene((1, 19, 37), 8, seed=12), 8),
    "H=1 (3, 1, 40), R=8": lambda: (np.array([[[0, 1, 1, 0, 2] * 8]] * 3, np.int32),
                                    np.random.default_rng(13).integers(0, 256, (3, 1, 40)).astype(np.uint8), 8),
    "threshold crops (4, 16, 32), R=2": lambda: (*_threshold_crops((4, 16, 32), seed=14), 2),
}


@pytest.mark.parametrize("case", list(PARTIAL_CASES))
def test_partials_plain_props_match_pallas(case):
    lab, img, R = PARTIAL_CASES[case]()
    labels, inten = torch.from_numpy(lab), torch.from_numpy(img)
    partials = rf.region_props_partials_plain(labels, inten, R)
    ours = rf._props_from_partials(*partials, rh.region_histogram_plain(labels, inten, R), True, 16)
    ref = regionprops_fused_pallas(jnp.asarray(lab), jnp.asarray(img), num_segments=R, interpret=True)
    _assert_matches_pallas(ours, ref, lab, R)


def test_perimeter_units_sum_to_the_per_pixel_perimeter():
    R = 8
    lab, _ = _scene((3, 17, 33), R, seed=15, beyond=True, negative=True)
    labels = torch.from_numpy(lab)
    sums = rf.region_props_partials_plain(labels, None, R)[0]
    units = sums[..., 0].double() + sums[..., 1].double() * rf._CUT
    seg = torch.where((labels >= 0) & (labels < R), labels, R).long().reshape(len(lab), -1)
    ref = torch.zeros(len(lab), R + 1, dtype=torch.float64)
    ref.scatter_add_(1, seg, rf._per_pixel_perimeter(labels > 0).reshape(len(lab), -1))
    np.testing.assert_array_equal(units.numpy(), ref[:, :R].numpy())
    assert units[:, 1:].max() > 0
    assert (sums[..., 2:] == 0).all()  # no intensity: no intensity sums


def _perimeter_units(lab):
    """K7's perimeter count: each 2x2 block of the padded foreground mask
    goes to its raster-last foreground corner, as n1 (length 1) and n065
    (corner cuts; a diagonal pair is two)."""
    B, H, W = lab.shape
    fg = np.pad(lab > 0, ((0, 0), (1, 1), (1, 1)))

    def nb(dy, dx):
        return fg[:, 1 + dy : 1 + dy + H, 1 + dx : 1 + dx + W]

    nw, n, ne, w, e, sw, s, se = nb(-1, -1), nb(-1, 0), nb(-1, 1), nb(0, -1), nb(0, 1), nb(1, -1), nb(1, 0), nb(1, 1)
    one = np.ones_like(n)
    n1, n065 = np.zeros(lab.shape, np.int64), np.zeros(lab.shape, np.int64)
    p = lab > 0
    for a, b, c, d, take in ((nw, n, w, one, p), (n, ne, one, e, p & ~e), (w, one, sw, s, p & ~sw & ~s),
                             (one, e, s, se, p & ~e & ~s & ~se)):
        count = a.astype(int) + b + c + d
        n065 += np.where(take, (count == 1) | (count == 3), 0) + 2 * np.where(take, (count == 2) & (a == d), 0)
        n1 += np.where(take, (count == 2) & (a != d), 0)
    return n1, n065


@pytest.mark.parametrize("with_intensity", [True, False])
@pytest.mark.parametrize("compute_histogram", [True, False])
def test_kernel_route_derivation_matches_plain(with_intensity, compute_histogram):
    R = 8
    lab, img = _scene((3, 17, 33), R, seed=5, beyond=True, negative=True)
    labels, inten = torch.from_numpy(lab), torch.from_numpy(img)
    partials = rf.region_props_partials_plain(labels, inten if with_intensity else None, R)
    # Its perimeter units are the count made here by numpy.
    seg = torch.from_numpy(np.where((lab >= 0) & (lab < R), lab, R)).long().reshape(len(lab), -1)
    units = torch.zeros(len(lab), R + 1, 2, dtype=torch.int64)
    for k, u in enumerate(_perimeter_units(lab)):
        units[..., k].scatter_add_(1, seg, torch.from_numpy(u).reshape(len(lab), -1))
    assert torch.equal(partials[0][..., :2], units[:, :R])
    hist = rh.region_histogram_plain(labels, inten, R) if with_intensity else None
    ours = rf._props_from_partials(*partials, hist, compute_histogram, 16)
    ref = rf.regionprops_fused_plain(labels, inten if with_intensity else None, num_segments=R,
                                     compute_histogram=compute_histogram)
    # Without the histogram the plain version takes integer intensity's
    # moments per pixel; the kernel route always from the histogram.
    if with_intensity and not compute_histogram:
        ref = {**ref, **rf.regionprops_fused_plain(labels, inten, num_segments=R)}
        ref.pop("histogram")
    assert set(ours) == set(ref)
    for k in ref:
        np.testing.assert_array_equal(ours[k].numpy(), ref[k].numpy(), err_msg=k)
    assert ref["perimeter"][:, 1:].max() > 0


def test_wrappers_refuse_what_the_kernels_do_not_take():
    lab = torch.zeros(2, 4, 5, dtype=torch.int32)
    with pytest.raises(ValueError):
        rh.region_histogram(lab, torch.zeros(2, 4, 4, dtype=torch.uint8), 4)
    with pytest.raises(TypeError):
        rh.region_histogram(lab.float(), torch.zeros(2, 4, 5, dtype=torch.uint8), 4)
    with pytest.raises(ValueError):
        rf.regionprops_fused(lab, None, num_segments=0)
    # Off the CPU a wrapper never falls back to its plain version: float
    # intensity (K7 takes uint8) and int64 labels are refused before any
    # launch (``meta`` tensors stand in for the card's here).
    meta = torch.zeros(2, 4, 5, dtype=torch.int32, device="meta")
    with pytest.raises(TypeError, match="uint8"):
        rf.regionprops_fused(meta, torch.zeros(2, 4, 5, device="meta"), num_segments=4)
    with pytest.raises(TypeError, match="int32"):
        rf.regionprops_fused(meta.long(), None, num_segments=4)
    with pytest.raises(TypeError, match="int32"):
        rh.region_histogram(meta.long(), meta.to(torch.uint8), 4)


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_float_intensity_raises():
    dev = _card()
    lab = torch.zeros(2, 4, 5, dtype=torch.int32, device=dev)
    with pytest.raises(TypeError, match="uint8"):
        rf.regionprops_fused(lab, torch.zeros(2, 4, 5, device=dev), num_segments=4)


CUDA_SHAPES = [((8, 1024, 1280), 64), ((8, 1024, 1), 64), ((8, 1, 1280), 64), ((3, 1000, 1280), 64),
               ((256, 64, 128), 2), ((8, 512, 512), 2)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape,R", CUDA_SHAPES)
def test_cuda_kernels_match_plain(shape, R):
    dev = _card()
    lab_np = chip_smoke.region_labels(shape, R, seed=6) if R > 2 else (np.random.default_rng(6).random(shape) < 0.3)
    lab = torch.from_numpy(lab_np.astype(np.int32)).to(dev)
    img = torch.from_numpy(np.random.default_rng(7).integers(0, 256, shape, dtype=np.uint8)).to(dev)
    n3, n7 = rh.region_histogram.launches, rf.regionprops_fused.launches
    assert torch.equal(rh.region_histogram(lab, img, R), rh.region_histogram_plain(lab, img, R))
    got, ref = rf.regionprops_fused(lab, img, num_segments=R), rf.regionprops_fused_plain(lab, img, num_segments=R)
    assert (rh.region_histogram.launches, rf.regionprops_fused.launches) == (n3 + 2, n7 + 1)
    chip_smoke.compare_props(got, ref, str(shape))


@pytest.mark.cuda
@pytest.mark.parametrize("option", [dict(intensity=None), dict(compute_histogram=False), dict(n_feret_angles=0)])
def test_cuda_kernel_options_match_plain(option):
    dev = _card()
    shape, R = (2, 37, 1000), 64
    lab = torch.from_numpy(chip_smoke.region_labels(shape, R, seed=8)).to(dev)
    img = torch.from_numpy(np.random.default_rng(9).integers(0, 256, shape, dtype=np.uint8)).to(dev)
    args = {"intensity": img, "num_segments": R, **option}
    chip_smoke.compare_props(rf.regionprops_fused(lab, **args), rf.regionprops_fused_plain(lab, **args), str(option))


# The kernel's cases of chip_smoke.py phase 2 (loki's shape on blob,
# serpentine, rectangle, all-background and one-region frames, ids beyond R
# and negative ids; ragged widths and heights; rows not 16-B aligned; the
# dense haul's width with intensity 255; R = 256; the threshold buckets),
# by name.
@functools.lru_cache(maxsize=1)
def _region_cases():
    return {c[0]: c for c in chip_smoke.region_cases()}


def _region_case(where):
    return _region_cases()[where]


REGION_CASE_NAMES = [
    "(8, 1024, 1280) blobs", "(8, 1024, 1280) serpentine", "(8, 1024, 1280) rectangles",
    "(8, 1024, 1280) background", "(8, 1024, 1280) one region", "(8, 1024, 1280) blobs, ids beyond R and negative",
    "(8, 1024, 1) rectangles", "(8, 1, 1280) rectangles", "(2, 37, 1000) rectangles", "(2, 96, 1277) rectangles",
    "(4, 64, 37) rectangles", "(2, 96, 1280) rectangles, rows not 16-B aligned",
    "(2, 2048, 2560) rectangles, intensity 255", "(2, 512, 640) rectangles",
    "(256, 64, 128) threshold crops", "(8, 512, 512) threshold crops",
]


@pytest.mark.cuda
@pytest.mark.parametrize("where", REGION_CASE_NAMES)
def test_cuda_region_kernel_bit_exact(where):
    dev = _card()
    _, lab_np, img_np, R, offset = _region_case(where)
    lab, img = chip_smoke.on_card(lab_np, dev, offset), chip_smoke.on_card(img_np, dev, offset)
    chip_smoke.check_region_kernel(lab, img, R, where)
    chip_smoke.check_region_kernel(lab, None, R, f"{where} without intensity")
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_cuda_regionprops_fused_is_one_launch_without_host_sync():
    dev = _card()
    _, lab_np, img_np, R, _ = _region_case("(8, 1024, 1280) blobs")
    lab, img = torch.from_numpy(lab_np).to(dev), torch.from_numpy(img_np).to(dev)
    rf.regionprops_fused(lab, img, num_segments=R)  # builds the kernels, warms the allocator
    torch.cuda.synchronize()
    n3, n7 = rh.region_histogram.launches, rf.regionprops_fused.launches
    torch.cuda.set_sync_debug_mode("error")
    try:
        props = rf.regionprops_fused(lab, img, num_segments=R)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    # One launch that writes both the partials and the histogram.
    assert (rh.region_histogram.launches, rf.regionprops_fused.launches) == (n3 + 1, n7 + 1)
    chip_smoke.compare_props(props, rf.regionprops_fused_plain(lab, img, num_segments=R), "sync-debug run")


@pytest.mark.cuda
def test_cuda_wrappers_raise_on_what_the_kernel_refuses():
    """What the shared-memory route refuses (R = 2^15, rows wider than
    2^16) takes the device-memory route and equals the plain versions (C5:
    this test pinned the raise before)."""
    dev = _card()
    lab = torch.zeros(1, 4, 5, dtype=torch.int32, device=dev)
    lab[0, 1:3, 1:4] = torch.tensor([[1, 1, (1 << 15) - 1], [2, 0, 5]], dtype=torch.int32)
    img = torch.from_numpy(np.random.default_rng(10).integers(0, 256, (1, 4, 5), dtype=np.uint8)).to(dev)
    R = 1 << 15
    chip_smoke.compare_props(rf.regionprops_fused(lab, img, num_segments=R),
                             rf.regionprops_fused_plain(lab, img, num_segments=R), "R = 2^15")
    assert torch.equal(rh.region_histogram(lab, img, R), rh.region_histogram_plain(lab, img, R))
    wide = torch.zeros(1, 1, (1 << 16) + 1, dtype=torch.int32, device=dev)
    wide[0, 0, 7:70] = 3
    got = rf.regionprops_fused(wide, None, num_segments=4)
    chip_smoke.compare_props(got, rf.regionprops_fused_plain(wide, None, num_segments=4), "2^16 + 1 columns")


@functools.lru_cache(maxsize=1)
def _c5_cases():
    return {c[0]: c for c in chip_smoke.c5_region_cases()}


C5_NAMES = [f"{shape} R = {R}" + (", the histogram alone" if alone else "")
            for shape, R, alone in chip_smoke.MEASURE_C5]


@pytest.mark.cuda
@pytest.mark.parametrize("where", C5_NAMES)
def test_cuda_device_memory_route_bit_exact(where):
    """C5's shapes on the device-memory route: the partials (with and
    without intensity) and the histogram bit-exact against the plain
    versions and the same bits from two launches; the props within
    tolerance; one launch counted a call, on that route."""
    dev = _card()
    _, lab_np, img_np, R, alone = _c5_cases()[where]
    lab, img = torch.from_numpy(lab_np).to(dev), torch.from_numpy(img_np).to(dev)
    n3 = rh.region_histogram.__dict__.get("launches_by_route", {}).get("device memory", 0)
    assert chip_smoke.check_region_c5(lab, img, R, alone, where) == "device memory"
    assert rh.region_histogram.launches_by_route["device memory"] > n3
    torch.cuda.synchronize()
