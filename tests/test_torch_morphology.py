"""Bounded EDT and disk morphology of the PyTorch port against the JAX
package: the same seeded masks, bit-exact results."""

import numpy as np
import pytest
import scipy.ndimage as ndi
import torch

from maze_image_processing_pipeline_tpu.ops import edt as je
from maze_image_processing_pipeline_tpu.ops import morphology as jm
from maze_image_processing_pipeline_tpu_torch.ops import edt as te
from maze_image_processing_pipeline_tpu_torch.ops import morphology as tm


@pytest.fixture(scope="module")
def mask():
    rng = np.random.default_rng(0)
    m = ndi.binary_dilation(rng.random((2, 37, 53)) < 0.06, iterations=2)
    m[0, :3, :] = True  # objects touching the border
    m[1, :, -2:] = True
    return m


@pytest.mark.parametrize("r", [0, 1, 2, 3, 5])
def test_squared_edt_matches_jax(mask, r):
    for sites in (mask, ~mask):
        ref = np.asarray(je.squared_edt(sites, r))
        ours = te.squared_edt(torch.from_numpy(sites), r)
        assert ours.dtype == torch.int32
        np.testing.assert_array_equal(ours.numpy(), ref)


def test_squared_edt_without_sites_clamps(mask):
    ours = te.squared_edt(torch.zeros(1, 9, 11, dtype=torch.bool), 2)
    assert (ours == 9).all()
    with pytest.raises(ValueError):
        te.squared_edt(torch.from_numpy(mask), -1)


@pytest.mark.parametrize(
    "op", ["binary_erosion", "binary_dilation", "binary_opening", "binary_closing"]
)
@pytest.mark.parametrize("r", [0, 1, 2, 4])
def test_morphology_matches_jax(mask, op, r):
    ref = np.asarray(getattr(jm, op)(mask, r))
    ours = getattr(tm, op)(torch.from_numpy(mask), r)
    assert ours.dtype == torch.bool
    np.testing.assert_array_equal(ours.numpy(), ref)
