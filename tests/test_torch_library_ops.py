"""The library functions of ``ops/`` and ``models/model_io.py`` in the PyTorch
port against the JAX package, on the CPU.

The same numpy inputs from a seed go through each JAX function and its port:
(2, 48, 64) frames of blobs with holes and a few (40, 56) crops. Tolerances:

* exact: the image ops (``convert_img_dtype``, ``gray2rgb``,
  ``center_crop_or_pad``, ``rescale_max_intensity_batch``,
  ``threshold_mask``), ``edt`` and its squares, the ``isotropic_*``
  morphology at integer and fractional radii, ``fill_holes``, the integer
  keys of ``regionprops`` (area, bounding box, intensity extremes) and its
  histogram;
* the float keys of ``regionprops``: rtol 1e-5, atol 1e-4; the orientation
  modulo pi; skew and kurtosis rtol 1e-4 (they divide by std³ / std⁴). The
  port sums the same float32 terms in float64, XLA in float32: the
  differences are XLA's rounding (up to 8.3e-6 relative here, the
  background's perimeter);
* ``import_torch_state_dict``: every leaf equal, and each of its three
  errors (module count, an unconsumed torch parameter, a shape) raised on
  the same inputs as in the JAX package.
"""

import ast
import inspect
from collections import OrderedDict

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.ndimage as ndi
import torch

from maze_image_processing_pipeline_tpu.models import model_io as j_model_io
from maze_image_processing_pipeline_tpu.ops import edt as j_edt
from maze_image_processing_pipeline_tpu.ops import image as j_image
from maze_image_processing_pipeline_tpu.ops import label as j_label
from maze_image_processing_pipeline_tpu.ops import morphology as j_morph
from maze_image_processing_pipeline_tpu.ops import regionprops as j_rp
from maze_image_processing_pipeline_tpu_torch.models import model_io as t_model_io
from maze_image_processing_pipeline_tpu_torch.models.classifier import ConvClassifier
from maze_image_processing_pipeline_tpu_torch.ops import edt as t_edt
from maze_image_processing_pipeline_tpu_torch.ops import image as t_image
from maze_image_processing_pipeline_tpu_torch.ops import morphology as t_morph
from maze_image_processing_pipeline_tpu_torch.ops import regionprops as t_rp


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the parallel test workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _blob_frames(seed: int, shape=(2, 48, 64)) -> np.ndarray:
    """Dilated random seeds (blobs of several sizes, some touching the
    border), with a ring (one hole) and a 3×3 hole punched into a square."""
    rng = np.random.default_rng(seed)
    m = ndi.binary_dilation(rng.random(shape) < 0.02, iterations=2)
    B, H, W = shape
    yy, xx = np.mgrid[:H, :W]
    rr = (yy - H // 2) ** 2 + (xx - W // 2) ** 2
    m[0] |= (rr <= 81) & (rr >= 16)
    m[-1, 5:14, 5:14] = True
    m[-1, 8:11, 8:11] = False
    return m


def _crops(seed: int, n: int = 3, shape=(40, 56)) -> np.ndarray:
    rng = np.random.default_rng(seed)
    out = np.stack([rng.random(shape) < 0.45 for _ in range(n)])
    out[0] = ndi.binary_dilation(rng.random(shape) < 0.05, iterations=3)
    out[1, ::2, ::2] = False  # a grid of one-pixel holes
    return out


def _intensity(seed: int, shape) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 256, shape).astype(np.uint8)


def _eq(ours: torch.Tensor, ref, what: str) -> None:
    ref = np.asarray(ref)
    o = ours.numpy()
    assert o.shape == ref.shape and o.dtype == ref.dtype, (what, o.shape, ref.shape, o.dtype, ref.dtype)
    np.testing.assert_array_equal(o, ref, err_msg=what)


# -- ops/image.py --------------------------------------------------------------


@pytest.mark.parametrize("src, dst", [
    ("uint8", "float32"), ("uint16", "float32"), ("float32", "float32"),
    ("float64", "float32"), ("uint8", "float16"),
])
def test_convert_img_dtype_matches_jax(src, dst):
    rng = np.random.default_rng(1)
    if src.startswith("uint"):
        x = rng.integers(0, np.iinfo(src).max, (2, 48, 64), endpoint=True).astype(src)
    else:
        x = (rng.random((2, 48, 64)) * 3 - 1).astype(src)
    ref = np.asarray(j_image.convert_img_dtype(jnp.asarray(x), jnp.dtype(dst)), np.float32)
    ours = t_image.convert_img_dtype(torch.from_numpy(x), dst)
    assert ours.dtype == getattr(torch, dst)
    _eq(ours.to(torch.float32), ref, f"{src} -> {dst}")


def test_convert_img_dtype_raises_as_jax():
    x = np.zeros((4, 4), np.uint8)
    for module, arr in ((j_image, jnp.asarray(x)), (t_image, torch.from_numpy(x))):
        for target in ("int32", "bfloat16"):  # bfloat16 is not a numpy floating kind
            with pytest.raises(ValueError, match="Target dtype must be floating"):
                module.convert_img_dtype(arr, target)
    xi = np.zeros((4, 4), np.int16)
    with pytest.raises(ValueError, match="Unsupported image dtype"):
        j_image.convert_img_dtype(jnp.asarray(xi), "float32")
    with pytest.raises(ValueError, match="Unsupported image dtype"):
        t_image.convert_img_dtype(torch.from_numpy(xi), "float32")


def test_gray2rgb_threshold_mask_and_rescale_batch_match_jax():
    rng = np.random.default_rng(2)
    frames = rng.integers(0, 200, (3, 48, 64)).astype(np.uint8)
    frames[1] = 0  # an empty frame keeps its zeros
    frames[2] //= 7
    _eq(t_image.gray2rgb(torch.from_numpy(frames)), j_image.gray2rgb(jnp.asarray(frames)), "gray2rgb")
    for thr in (0, 50, 127.5):
        _eq(t_image.threshold_mask(torch.from_numpy(frames), thr), j_image.threshold_mask(jnp.asarray(frames), thr),
            f"threshold {thr}")
    _eq(t_image.rescale_max_intensity_batch(torch.from_numpy(frames)),
        j_image.rescale_max_intensity_batch(jnp.asarray(frames)), "rescale_max_intensity_batch")


@pytest.mark.parametrize("shape, channels_last", [
    ((40, 56), True), ((2, 40, 56, 3), True), ((3, 40, 56), False), ((2, 40, 56), True), ((2, 31, 70, 1), True),
])
@pytest.mark.parametrize("size", [32, 48, 64])
def test_center_crop_or_pad_matches_jax(shape, channels_last, size):
    x = np.random.default_rng(3).integers(1, 255, shape).astype(np.uint8)
    ref = j_image.center_crop_or_pad(jnp.asarray(x), size, channels_last=channels_last)
    _eq(t_image.center_crop_or_pad(torch.from_numpy(x), size, channels_last=channels_last), ref, "crop")


# -- ops/edt.py and ops/morphology.py ------------------------------------------


@pytest.mark.parametrize("max_distance", [0, 3, 16])
def test_edt_matches_jax(max_distance):
    sites = _blob_frames(4)
    _eq(t_edt.squared_edt(torch.from_numpy(sites), max_distance),
        j_edt.squared_edt(jnp.asarray(sites), max_distance), "squared_edt")
    _eq(t_edt.edt(torch.from_numpy(sites), max_distance), j_edt.edt(jnp.asarray(sites), max_distance), "edt")


@pytest.mark.parametrize("radius", [0, 1, 1.5, 2, 2.5, 3.2])
@pytest.mark.parametrize("op", ["isotropic_erosion", "isotropic_dilation", "isotropic_opening",
                                "isotropic_closing"])
def test_isotropic_morphology_matches_jax(op, radius):
    for mask in (_blob_frames(5), _crops(6)):
        _eq(getattr(t_morph, op)(torch.from_numpy(mask), radius), getattr(j_morph, op)(jnp.asarray(mask), radius),
            f"{op}({radius})")


def test_isotropic_thresholds_are_strict():
    """One site: dilation by 1 adds nothing (no pixel lies at distance < 1
    but the site), by 1.5 its 8 neighbours (1 and √2), by 2 only those; an
    erosion by 1 of a 3×3 square keeps its centre."""
    one = torch.zeros((7, 7), dtype=torch.bool)
    one[3, 3] = True
    assert int(t_morph.isotropic_dilation(one, 1).sum()) == 1
    assert int(t_morph.isotropic_dilation(one, 1.5).sum()) == 9
    assert int(t_morph.isotropic_dilation(one, 2).sum()) == 9
    sq = torch.zeros((7, 7), dtype=torch.bool)
    sq[2:5, 2:5] = True
    assert t_morph.isotropic_erosion(sq, 1).nonzero().tolist() == [[3, 3]]


# -- ops/regionprops.py --------------------------------------------------------

EXACT = {"area", "min_row", "min_col", "max_row", "max_col", "intensity_min", "intensity_max", "histogram"}
HIGHER = {"intensity_skew", "intensity_kurtosis"}


def _compare_props(ours, ref):
    assert set(ours) == set(ref)
    for k, r in ref.items():
        r = np.asarray(r)
        o = ours[k].numpy()
        assert o.shape == r.shape and o.dtype == r.dtype, k
        if k in EXACT:
            np.testing.assert_array_equal(o, r, err_msg=k)
        elif k == "orientation":
            d = np.abs(o - r) % np.pi
            np.testing.assert_array_less(np.minimum(d, np.pi - d), 1e-4 + 1e-5 * np.abs(r) + 1e-12, err_msg=k)
        elif k in HIGHER:
            np.testing.assert_allclose(o, r, rtol=1e-4, atol=1e-4, err_msg=k)
        else:
            np.testing.assert_allclose(o, r, rtol=1e-5, atol=1e-4, err_msg=k)


@pytest.fixture(scope="module")
def labelled():
    frames = np.asarray(j_label.label(jnp.asarray(_blob_frames(7)), connectivity=2)[0])
    crops = np.asarray(j_label.label(jnp.asarray(_crops(8)), connectivity=2)[0])
    return {"frames": frames, "crops": crops}


@pytest.mark.parametrize("which, R", [("frames", 64), ("frames", 8), ("crops", 64)])
@pytest.mark.parametrize("intensity", ["uint8", "float32", None])
def test_regionprops_matches_jax(labelled, which, R, intensity):
    """Every key, with and without intensity; R = 8 leaves ids beyond the
    region axis (not measured)."""
    labels = labelled[which]
    inten = None if intensity is None else _intensity(9, labels.shape).astype(intensity)
    if intensity == "float32":
        inten += np.random.default_rng(10).random(labels.shape).astype(np.float32)
    hist = intensity is not None
    ref = j_rp.regionprops(jnp.asarray(labels), None if inten is None else jnp.asarray(inten), num_segments=R,
                           compute_histogram=hist)
    ours = t_rp.regionprops(torch.from_numpy(labels), None if inten is None else torch.from_numpy(inten),
                            num_segments=R, compute_histogram=hist)
    _compare_props(ours, ref)
    if hist:
        assert ours["histogram"].shape == labels.shape[:-2] + (R, 256)


def test_regionprops_without_feret_on_one_frame_and_bbox(labelled):
    labels = labelled["frames"][1]
    inten = _intensity(11, labels.shape)
    kw = dict(num_segments=32, n_feret_angles=0)
    ref = j_rp.regionprops(jnp.asarray(labels), jnp.asarray(inten), **kw)
    ours = t_rp.regionprops(torch.from_numpy(labels), torch.from_numpy(inten), **kw)
    assert "feret_diameter_max" not in ours and "histogram" not in ours
    _compare_props(ours, ref)
    for i in range(1, int(labels.max()) + 1):
        assert t_rp.bbox_from_props(ours, i) == j_rp.bbox_from_props(ref, i)


@pytest.mark.parametrize("which", ["frames", "crops", "checkerboard", "serpentine"])
def test_fill_holes_matches_jax(which):
    if which == "frames":
        mask = _blob_frames(12)
    elif which == "crops":
        mask = _crops(13)
    elif which == "checkerboard":  # the most background components a frame holds
        yy, xx = np.mgrid[:40, :56]
        mask = ((yy + xx) % 2 == 0)[None]
    else:  # a walled spiral-like serpentine with a pocket at its end
        mask = np.zeros((1, 40, 56), bool)
        mask[0, ::4, 2:-2] = True
        mask[0, :, 2] = mask[0, :, -3] = True
        mask[0, 18:22, 20:24] = False
        mask[0, 17, 19:25] = mask[0, 22, 19:25] = True
        mask[0, 17:23, 19] = mask[0, 17:23, 24] = True
    _eq(t_rp.fill_holes(torch.from_numpy(mask)), j_rp.fill_holes(jnp.asarray(mask)), which)


# -- models/model_io.py: import_torch_state_dict --------------------------------


def test_import_torch_state_dict_is_a_copy_of_the_original():
    def tree(fn):
        return ast.dump(ast.parse(inspect.getsource(fn)))

    assert tree(t_model_io.import_torch_state_dict) == tree(j_model_io.import_torch_state_dict)


def _classifier_params(seed: int):
    cfg = dict(n_outputs=5, features=(8, 16), in_channels=3)
    flax = t_model_io.init_classifier_params(cfg, seed=seed)
    module = ConvClassifier(n_outputs=5, features=(8, 16), dtype="float32")
    module.load_state_dict(t_model_io.params_from_jax(flax))
    return flax, module.state_dict()


def test_import_torch_state_dict_matches_jax():
    """A torch state dict of the port's classifier (flax module names, in
    flax call order) against a template of other weights: every leaf equal
    between the two functions and to the flax tree it was made from; the
    port's ``params_from_jax`` of the result gives the state dict back."""
    flax, state = _classifier_params(1)
    template, _ = _classifier_params(2)
    ref = j_model_io.import_torch_state_dict(state, template)
    ours = t_model_io.import_torch_state_dict(state, template)

    def leaves(d, path=()):
        for k, v in d.items():
            if isinstance(v, dict):
                yield from leaves(v, path + (k,))
            else:
                yield path + (k,), v

    got, want, orig = dict(leaves(ours)), dict(leaves(ref)), dict(leaves(flax))
    assert list(got) == list(want) == list(orig)
    for path in want:
        assert got[path].dtype == want[path].dtype and np.array_equal(got[path], want[path]), path
        assert np.array_equal(got[path], orig[path]), path
    back = t_model_io.params_from_jax(ours)
    assert list(back) == list(state)
    assert all(torch.equal(back[k], v) for k, v in state.items())


def _broken(kind: str, state, template):
    state = OrderedDict(state)
    if kind == "module count":
        for k in [k for k in state if k.startswith("Dense_1.")]:
            del state[k]
    elif kind == "unconsumed":  # a BatchNorm where the flax model has a GroupNorm
        state["GroupNorm_0.running_mean"] = torch.zeros(8)
        state["GroupNorm_0.running_var"] = torch.ones(8)
    else:
        state["Conv_1.weight"] = state["Conv_1.weight"][:, :4]
    return state


@pytest.mark.parametrize("kind, match", [
    ("module count", "Module count mismatch"), ("unconsumed", "no counterpart in flax module"),
    ("shape", "Shape mismatch"),
])
def test_import_torch_state_dict_raises_as_jax(kind, match):
    _, state = _classifier_params(1)
    template, _ = _classifier_params(2)
    broken = _broken(kind, state, template)
    with pytest.raises(ValueError, match=match) as j_err:
        j_model_io.import_torch_state_dict(broken, template)
    with pytest.raises(ValueError, match=match) as t_err:
        t_model_io.import_torch_state_dict(broken, template)
    assert str(t_err.value) == str(j_err.value)
