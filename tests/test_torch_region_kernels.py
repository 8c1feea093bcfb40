"""K3 (region histogram) and K7 (fused region measurement) of the PyTorch port.

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
* The kernel route's derivation (``_props_from_partials``), fed the partials
  K7 computes (here by numpy, with the kernel's perimeter-unit count), gives
  the plain version's props: exact, the perimeter included.
* The wrappers take the plain versions for CPU tensors and refuse, on any
  other device, what the kernels do not take. The kernels themselves run on
  the card (tests marked ``cuda``, at phase 2's shapes and with the
  wrapper's options: no intensity, no histogram, no feret;
  ``python3 chip_smoke.py`` phase 2).
"""

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


@pytest.mark.parametrize("shape,R", [((2, 24, 64), 16), ((1, 19, 40), 8)])
def test_regionprops_fused_plain_matches_pallas(shape, R):
    lab, img = _scene(shape, R, seed=4)
    ours = rf.regionprops_fused_plain(torch.from_numpy(lab), torch.from_numpy(img), num_segments=R)
    ref = regionprops_fused_pallas(jnp.asarray(lab), jnp.asarray(img), num_segments=R, interpret=True)
    assert set(ours) == set(ref)
    n = lab.reshape(len(lab), -1).max(-1)
    assert (n < R).all() and n.min() > 1
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
    wrapped = rf.regionprops_fused(torch.from_numpy(lab), torch.from_numpy(img), num_segments=R)
    assert all(torch.equal(wrapped[k], ours[k]) for k in ours)


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
    partials = chip_smoke.plain_partials(labels, inten, R)
    seg = torch.from_numpy(np.where((lab >= 0) & (lab < R), lab, R)).long().reshape(len(lab), -1)
    units = torch.zeros(len(lab), R + 1, 2, dtype=torch.int64)
    for k, u in enumerate(_perimeter_units(lab)):
        units[..., k].scatter_add_(1, seg, torch.from_numpy(u).reshape(len(lab), -1))
    sums = torch.cat([units[:, :R], partials[0]], dim=-1)
    hist = rh.region_histogram_plain(labels, inten, R) if with_intensity else None
    ours = rf._props_from_partials(sums, *partials[1:], hist, compute_histogram, 16)
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
