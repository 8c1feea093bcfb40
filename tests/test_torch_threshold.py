"""The threshold path of the PyTorch port against the JAX package, on the CPU.

* ``engine/image.py:BatchedImageProperties(device="cpu")`` against the JAX
  package's node on the crops of ``tests/test_threshold_device.py`` (blobs
  and rings of many sizes, so several shape buckets and chunks form), on
  nested rings (background components that do and do not touch the border),
  on the background-overflow fallback to the host, and in arrival order:
  the filled area and every integer-valued prop exact, the other props
  within rtol 1e-5 / atol 1e-3 (the JAX package sums in float32, the port in
  float64 or exactly), the orientation modulo pi.
* ``ops/threshold_props.py:threshold_measure`` against the JAX function on
  one padded bucket.
* ``maze-ipp loki`` with threshold segmentation: the JAX Runner
  (``device: true``) and the port's (``device: "cpu"``) write equal archives
  (``chip_smoke.compare_archives``), and so do both host paths (``device:
  false``).
* Without a card, the port's ``device: true`` and ``"auto"`` (the default)
  raise: there is no quiet fallback to the host.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from fixtures import make_loki_sample
from maze_image_processing_pipeline_tpu import engine as j_engine
from maze_image_processing_pipeline_tpu.engine import image as j_image
from maze_image_processing_pipeline_tpu.loki.pipeline import Runner as JaxRunner
from maze_image_processing_pipeline_tpu.ops.threshold_props import threshold_measure as j_measure
from maze_image_processing_pipeline_tpu_torch import engine as t_engine
from maze_image_processing_pipeline_tpu_torch.engine import image as t_image
from maze_image_processing_pipeline_tpu_torch.loki.pipeline import Runner as TorchRunner
from maze_image_processing_pipeline_tpu_torch.ops.threshold_props import threshold_measure

THRESHOLD = 60
ARCHIVE = "LOKI_PS122-1_7.zip"
EXACT = {"area", "min_row", "max_row", "min_col", "max_col", "histogram", "intensity_min", "intensity_max"}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the parallel test workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _crops(rng, n=13):
    """The crops of tests/test_threshold_device.py: varied sizes, blobs and
    rings (holes for the filled area)."""
    out = []
    for i in range(n):
        h, w = int(rng.integers(20, 180)), int(rng.integers(20, 300))
        img = (rng.random((h, w)) * 40).astype(np.uint8)
        yy, xx = np.mgrid[:h, :w]
        d2 = (yy - h // 2) ** 2 + (xx - w // 2) ** 2
        r = max(4, min(h, w) // 3)
        blob = d2 <= r * r
        if i % 2:
            blob &= d2 >= (r // 2) ** 2
        img[blob] = rng.integers(120, 250)
        out.append(img)
    return out


def _rings():
    img = np.zeros((65, 130), np.uint8)  # odd sizes: padded in its bucket
    yy, xx = np.mgrid[:65, :130]
    d2 = (yy - 32) ** 2 + (xx - 60) ** 2
    img[(d2 <= 900) & (d2 >= 625)] = 200
    img[(d2 <= 400) & (d2 >= 100)] = 200
    return img


def _stripes():
    img = np.zeros((40, 140), np.uint8)
    img[::2, :] = 200  # ~20 background components
    return img


def _run(engine, image_mod, crops, **kw):
    out = []
    with engine.Pipeline() as p:
        img = engine.Unpack(crops)
        props = image_mod.BatchedImageProperties(img, THRESHOLD, **kw)
        engine.Call(lambda pr: out.append(pr), props)
    p.run()
    return out


def _assert_props_close(ours, ref, where):
    assert set(ours) == set(ref), where
    for k, r in ref.items():
        o, r = np.asarray(ours[k], np.float64), np.asarray(r, np.float64)
        if k in EXACT:
            np.testing.assert_array_equal(o, r, err_msg=f"{k} {where}")
        elif k == "orientation":
            d = abs(float(o) - float(r)) % np.pi
            assert min(d, np.pi - d) <= 1e-3, f"{k} {where}"
        else:
            np.testing.assert_allclose(o, r, rtol=1e-5, atol=1e-3, err_msg=f"{k} {where}")


@pytest.mark.parametrize(
    "case,kw",
    [("crops", dict(chunk_size=5)), ("rings", {}), ("overflow", dict(n_bg_segments=4))],
)
def test_batched_image_properties_matches_jax(case, kw):
    crops = {"crops": _crops(np.random.default_rng(42)), "rings": [_rings()], "overflow": [_stripes()]}[case]
    ref = _run(j_engine, j_image, crops, **kw)
    ours = _run(t_engine, t_image, crops, device="cpu", **kw)
    assert len(ours) == len(ref) == len(crops)
    for i, (o, r, crop) in enumerate(zip(ours, ref, crops)):
        assert o["__area_filled__"] == r["__area_filled__"], i
        assert o["__props__"]["area"] == float((crop > THRESHOLD).sum()), i  # arrival order
        _assert_props_close(o["__props__"], r["__props__"], f"crop {i}")


def test_threshold_measure_matches_jax():
    crops = _crops(np.random.default_rng(7), n=6) + [_rings()]
    batch = np.zeros((8, 256, 512), np.uint8)
    for j, c in enumerate(crops):
        batch[j, : c.shape[0], : c.shape[1]] = c
    r_props, r_filled, r_nbg = j_measure(jnp.asarray(batch), float(THRESHOLD), n_bg_segments=16)
    props, filled, n_bg = threshold_measure(torch.from_numpy(batch), float(THRESHOLD), n_bg_segments=16)
    np.testing.assert_array_equal(filled.numpy(), np.asarray(r_filled))
    np.testing.assert_array_equal(n_bg.numpy(), np.asarray(r_nbg))
    for j in range(len(crops)):
        _assert_props_close({k: v[j].numpy() for k, v in props.items()},
                            {k: np.asarray(v)[j] for k, v in r_props.items()}, f"crop {j}")
    assert (filled.numpy()[: len(crops)] > props["area"].numpy()[: len(crops)]).any()  # holes filled


@pytest.fixture(scope="module")
def haul(tmp_path_factory):
    root = tmp_path_factory.mktemp("thr_haul")
    make_loki_sample(str(root / "data"), n_frames=3, objects_per_frame=2)
    return root


def _task(data, target_dir, device):
    return {
        "input": {"path": str(data)},
        "segmentation": {"threshold": {"threshold_brighter": THRESHOLD, "device": device}},
        "postprocess": {"rescale_max_intensity": True},
        "output": {"target_dir": str(target_dir), "store_mask": True},
    }


@pytest.mark.parametrize("device,jax_device", [("cpu", True), (False, False)])
def test_loki_threshold_archive_matches_jax(haul, device, jax_device):
    ref_dir, our_dir = haul / f"jax_{jax_device}", haul / f"torch_{device}"
    JaxRunner._configure_and_run(_task(haul / "data", ref_dir, jax_device))
    TorchRunner._configure_and_run(_task(haul / "data", our_dir, device))
    rows = chip_smoke.compare_archives(str(ref_dir / ARCHIVE), str(our_dir / ARCHIVE))
    assert rows == 6


@pytest.mark.parametrize("device", [True, "auto", "cuda"])
def test_threshold_device_raises_without_a_card(haul, monkeypatch, tmp_path, device):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    task = _task(haul / "data", tmp_path, device)
    if device == "auto":
        del task["segmentation"]["threshold"]["device"]  # the default
    with pytest.raises(RuntimeError, match="no CUDA card"):
        TorchRunner._configure_and_run(task)
