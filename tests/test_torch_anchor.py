"""K9 (the layout anchor) and the frame-chain perf lab of the PyTorch port.

* ``anchor_plain`` (the CPU path and K9's oracle) against the identity Pallas
  copy of ``tools/perf_lab.py:anchor``, rebuilt here and run in interpret
  mode, on seeded masks: exact (a copy), bool and other dtypes; transposed
  views give the contiguous copy of their values.
* The port lab's ``chain``, ``chain_anchor``, ``chain_plain`` and ``morph_anchor_label`` at
  (2, 256, 320) (at (2, 128, 160) the 25 blobs of a frame merge into one
  region) against the JAX lab's chain built from the JAX package's ops
  (``morph_chain`` → ``label`` → ``remove_small_objects`` →
  ``regionprops_fused``): labels and counts exact, integer props exact,
  float props within rtol 1e-5 / atol 1e-3 (``tests/test_torch_regionprops.py``'s
  tolerance: float64 moment sums in the port, float32 in JAX).
* The lab's ``main``: ``tests/test_torch_perf_lab_main.py``.
* On the card only (``cuda``): K9 against ``anchor_plain``, bit-exact, at
  the lab's shapes, a tail that is not a multiple of 16 bytes, (1, 1, 1),
  transposed and sliced views and every element size; the tiled transpose
  at odd shapes.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from maze_image_processing_pipeline_tpu.ops import label as jl
from maze_image_processing_pipeline_tpu.ops import morphology as jmorph
from maze_image_processing_pipeline_tpu.ops.regionprops_fused import regionprops_fused as j_props
from maze_image_processing_pipeline_tpu_torch.ops.anchor import anchor, anchor_plain
from maze_image_processing_pipeline_tpu_torch.tools import perf_lab

EXACT = {"area", "min_row", "max_row", "min_col", "max_col", "histogram", "intensity_min", "intensity_max"}


def pallas_anchor(mask):
    """``tools/perf_lab.py:anchor`` (lines 94-110) in interpret mode: one
    (1, H, W) block per frame (the TPU's VMEM memory space has no meaning in
    interpret mode and is left out)."""

    def _copy(in_ref, out_ref):
        out_ref[:] = in_ref[:]

    B, H, W = mask.shape
    blk = pl.BlockSpec((1, H, W), lambda b: (b, 0, 0))
    return pl.pallas_call(
        _copy, grid=(B,), in_specs=[blk], out_specs=blk,
        out_shape=jax.ShapeDtypeStruct(mask.shape, mask.dtype), interpret=True,
    )(mask)


@pytest.mark.parametrize("dtype", [np.bool_, np.uint8, np.int32, np.float32])
def test_anchor_plain_matches_pallas_identity(dtype):
    rng = np.random.default_rng(0)
    x = (rng.random((2, 16, 24)) * 100).astype(dtype) if dtype != np.bool_ else rng.random((2, 16, 24)) < 0.3
    ref = np.asarray(pallas_anchor(jnp.asarray(x)))
    ours = anchor(torch.from_numpy(x))
    assert ours.is_contiguous() and ours.dtype == torch.from_numpy(x).dtype
    np.testing.assert_array_equal(ours.numpy(), ref)


def test_anchor_plain_copies_views_contiguously():
    rng = np.random.default_rng(1)
    base = torch.from_numpy(rng.random((3, 17, 29)) < 0.5)
    for view in (base.transpose(1, 2), base[:, 1::2, ::3], base.expand(3, 17, 29)):
        n = anchor.launches
        out = anchor(view)
        assert anchor.launches == n  # the CPU takes the plain version
        assert out.is_contiguous() and out.data_ptr() != view.data_ptr()
        np.testing.assert_array_equal(out.numpy(), np.ascontiguousarray(view.numpy()))
    with pytest.raises(ValueError):
        anchor(base[0])


def _jax_chain(frames):
    """The JAX lab's chain (``tools/perf_lab.py:chain`` with the XLA
    ``regionprops_fused``), from the JAX package's ops."""
    mask = frames > perf_lab.THRESHOLD
    mask = jmorph.binary_closing(jmorph.binary_opening(mask, perf_lab.RADIUS), perf_lab.RADIUS)
    labels, _ = jl.label(mask, connectivity=2)
    labels, n = jl.remove_small_objects(labels, perf_lab.MIN_AREA, num_segments=perf_lab.RSMALL_SEGMENTS)
    props = j_props(labels, frames, num_segments=perf_lab.NUM_SEGMENTS)
    return np.asarray(mask), np.asarray(labels), np.asarray(n), props


@pytest.fixture(scope="module")
def lab_scene():
    frames = perf_lab.lab_frames((256, 320), batch=2)
    return frames, _jax_chain(jnp.asarray(frames))


@pytest.mark.parametrize("variant", ["chain", "chain_anchor", "chain_plain"])
def test_lab_chain_matches_jax(lab_scene, variant):
    frames, (_, ref_labels, ref_n, ref_props) = lab_scene
    if variant == "chain_plain":
        labels, n, props = perf_lab.experiments(torch.from_numpy(frames))["chain_plain"]()
    else:
        labels, n, props = perf_lab.chain(torch.from_numpy(frames), anchored=variant == "chain_anchor")
    np.testing.assert_array_equal(labels.numpy(), ref_labels)
    np.testing.assert_array_equal(n.numpy(), ref_n)
    assert int(ref_n.min()) >= 5  # the frames hold regions that survive the chain
    assert set(props) == set(ref_props)
    for k, r in ref_props.items():
        if k in EXACT:
            np.testing.assert_array_equal(props[k].numpy(), np.asarray(r), err_msg=k)
        else:
            np.testing.assert_allclose(props[k].numpy(), np.asarray(r), rtol=1e-5, atol=1e-3, err_msg=k)


def test_lab_morph_anchor_label_matches_jax(lab_scene):
    frames, (ref_mask, _, _, _) = lab_scene
    ref_labels, ref_n = jl.label(jnp.asarray(ref_mask), connectivity=2)
    exps = perf_lab.experiments(torch.from_numpy(frames))
    for name in ("morph_label", "morph_anchor_label"):
        labels, n = exps[name]()
        np.testing.assert_array_equal(labels.numpy(), np.asarray(ref_labels), err_msg=name)
        np.testing.assert_array_equal(n.numpy(), np.asarray(ref_n), err_msg=name)


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(8, 1024, 1024), (8, 2048, 2560), (8, 1023, 1277), (1, 1, 1), (3, 5, 37)])
@pytest.mark.parametrize("dtype", [torch.bool, torch.uint8, torch.int16, torch.int32, torch.float32, torch.int64])
def test_cuda_anchor_matches_plain(shape, dtype):
    dev = _card()
    gen = torch.Generator(device=dev).manual_seed(3)
    base = (torch.rand(shape, device=dev, generator=gen) * 1000).to(dtype)
    for view in (base, base.transpose(1, 2), base[:, ::2, 1:], base[1:] if shape[0] > 1 else base):
        if view.numel() == 0:
            continue
        n = anchor.launches
        out = anchor(view)
        assert anchor.launches == n + 1
        assert out.is_contiguous() and out.shape == view.shape and out.dtype == dtype
        assert torch.equal(out, anchor_plain(view))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(3, 37, 1001), (2, 129, 33), (1, 5, 3), (4, 1000, 1024), (2, 1, 7)])
@pytest.mark.parametrize("dtype", [torch.bool, torch.uint8, torch.int16, torch.int32, torch.int64])
def test_cuda_anchor_tiled_transpose_matches_plain(shape, dtype):
    """The transposed view (stride-1 axis h) takes the shared-memory tile:
    ragged tiles at both edges, words and single bytes, a base offset that
    breaks 4-byte alignment."""
    dev = _card()
    gen = torch.Generator(device=dev).manual_seed(5)
    base = (torch.rand((shape[0], shape[2] + 1, shape[1]), device=dev, generator=gen) * 1000).to(dtype)
    for view in (base[:, :-1].transpose(1, 2), base[:, 1:].transpose(1, 2)):
        n = anchor.launches
        out = anchor(view)
        assert anchor.launches == n + 1
        assert out.is_contiguous() and out.shape == view.shape
        assert torch.equal(out, anchor_plain(view))
