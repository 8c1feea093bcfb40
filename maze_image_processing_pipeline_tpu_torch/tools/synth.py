"""Synthetic inputs of the port's haul driver and smoke run, made by the
port's own code from a seed: LOKI sample trees, EcoTaxa crop archives, the
polytaxo taxonomy files, the models' distillation batches, seeded U-Net
and classifier checkpoints, and label frames of rectangles for the region
kernels.

``make_loki_tree`` writes the layout of ``tests/fixtures.py:make_loki_sample``
and draws from the seed in the same order, so the same arguments give the
same vignettes at the same positions (encoded by the port's ``encode_image``).
``distill_batches`` makes ``tools/bench_e2e.py``'s distillation batches (the
JAX haul driver's); ``vignette_batches`` makes ``chip_smoke.py`` phase 9's,
tiles like the stitched frames the loki U-Net then segments.
"""

from __future__ import annotations

import os
from typing import Iterator, Optional, Tuple, Union

import numpy as np

__all__ = [
    "OBJECT_ID_FMT",
    "TAXONOMY_YAML",
    "ECOTAXA_TAXONOMY",
    "draw_blob",
    "make_loki_tree",
    "make_crop_archive",
    "make_taxonomy_files",
    "distill_batches",
    "vignette_batches",
    "write_classifier",
    "write_unet",
    "region_labels",
    "large_id_labels",
]

OBJECT_ID_FMT = "{date} {time}  {ms:03d}  {seq:06d} {posx:04d} {posy:04d}"

# The taxonomy of tests/test_predict_pipeline.py and tools/bench_e2e.py.
TAXONOMY_YAML = """
Copepoda:
  _index: 0
  Calanoida:
    _index: 1
  Cyclopoida:
    _index: 2
  _tags:
    oil-sack: 3
"""
ECOTAXA_TAXONOMY = {
    "display_name": ["Copepoda", "Calanoida", "Cyclopoida", "Calanoida with oil", "Copepoda with oil",
                     "Cyclopoida with oil"],
    "lineage": ["Copepoda", "Copepoda>Calanoida", "Copepoda>Cyclopoida", "Copepoda>Calanoida>oil-sack",
                "Copepoda>oil-sack", "Copepoda>Cyclopoida>oil-sack"],
}


def draw_blob(rng, shape=(60, 80), r=12, intensity=180) -> np.ndarray:
    """A bright elliptical blob on dark noise: a fake plankton vignette."""
    img = (rng.random(shape) * 20).astype(np.uint8)
    yy, xx = np.mgrid[0 : shape[0], 0 : shape[1]]
    cy, cx = shape[0] // 2, shape[1] // 2
    img[((yy - cy) ** 2 / (r * r) + (xx - cx) ** 2 / (1.8 * r) ** 2) <= 1.0] = intensity
    return img


def make_loki_tree(root: str, n_frames: int, objects_per_frame: Union[int, Tuple[int, int]], frame_shape,
                   seed: int = 0, big_every: int = 0,
                   crop_size_range: Optional[Tuple[Tuple[int, int], Tuple[int, int]]] = None) -> str:
    """A LOKI sample tree as the camera writes it: ``Log/LOKI_*.log``,
    ``meta.yaml``, ``Telemetrie/*.tmd`` and ``Pictures/<hour>/<object id>.png``
    at random positions of ``frame_shape`` frames. Vignettes are 60×80;
    with ``big_every``, every ``big_every``-th is 150-400 px a side; with
    ``crop_size_range`` ((h_min, w_min), (h_max, w_max)) each is drawn
    log-uniformly from the range. ``objects_per_frame`` is a count or an
    inclusive (lo, hi) range drawn per frame. Returns the sample root."""
    from ..dataio.imageio import encode_image

    rng = np.random.default_rng(seed)
    sample = os.path.join(root, "LOKI_00001.01")
    for d in ("Log", "Telemetrie"):
        os.makedirs(os.path.join(sample, d), exist_ok=True)
    with open(os.path.join(sample, "Log", "LOKI_00001.log"), "w") as f:
        f.write("DEVICE: LOKI\nCRUISE: PS122\nSTATION: PS122-1\nHAUL: 7\nVESSEL: Polarstern\n"
                "REGION: Arctic Ocean\nLOCATION: Central Arctic\nGPS_LAT: 84.95\nGPS_LON: 134.72\n"
                "BOTTOM_DEPTH: 4200\n")
    with open(os.path.join(sample, "meta.yaml"), "w") as f:
        f.write("sample_program: MOSAiC\n")
    date = "20220103"
    times = [f"12{(62 + 30 * i) // 60:02d}{(62 + 30 * i) % 60:02d}" for i in range(n_frames)]
    for i, t in enumerate(times):
        with open(os.path.join(sample, "Telemetrie", f"{date} {t}.tmd"), "w") as f:
            f.write(f"GPS_LON;134.{70 + i}\nGPS_LAT;84.{90 + i}\nPRESS;{10.5 + i}\n"
                    f"TEMP;{-1.5 + 0.1 * i}\nOXY_CON;{300 + i}\nCOND_SALY;{34.2}\n")
    pic_dir = os.path.join(sample, "Pictures", f"{date} 12")
    os.makedirs(pic_dir, exist_ok=True)
    H, W = frame_shape
    for t in times:
        if isinstance(objects_per_frame, tuple):
            n_objects = int(rng.integers(objects_per_frame[0], objects_per_frame[1] + 1))
        else:
            n_objects = objects_per_frame
        for oi in range(n_objects):
            if crop_size_range is not None:
                (h0, w0), (h1, w1) = crop_size_range
                ch = int(np.exp(rng.uniform(np.log(h0), np.log(h1))))
                cw = int(np.exp(rng.uniform(np.log(w0), np.log(w1))))
                ch, cw = min(ch, H - 10), min(cw, W - 10)
                r = max(4, min(ch, cw) // 4 + int(rng.integers(0, 4)))
            else:
                ch, cw = 60, 80
                if big_every and oi % big_every == 0:
                    ch, cw = (int(v) for v in rng.integers(150, 401, 2))
                r = 8 + int(rng.integers(0, 6)) if ch == 60 else int(min(ch, cw) // 4)
            posx = int(rng.integers(0, max(1, W - cw - 10)))
            posy = int(rng.integers(0, max(1, H - ch - 10)))
            oid = OBJECT_ID_FMT.format(date=date, time=t, ms=333, seq=oi, posx=posx, posy=posy)
            with open(os.path.join(pic_dir, oid + ".png"), "wb") as f:
                f.write(encode_image(draw_blob(rng, (ch, cw), r), oid + ".png"))
    return sample


def make_taxonomy_files(root: str) -> tuple:
    """The polytaxo taxonomy (YAML) and its EcoTaxa translation (CSV)."""
    import pandas as pd

    os.makedirs(root, exist_ok=True)
    tax_fn, csv_fn = os.path.join(root, "taxonomy.yaml"), os.path.join(root, "ecotaxa_taxonomy.csv")
    with open(tax_fn, "w") as f:
        f.write(TAXONOMY_YAML)
    pd.DataFrame(ECOTAXA_TAXONOMY).to_csv(csv_fn, index=False)
    return tax_fn, csv_fn


def make_crop_archive(fn: str, sizes, seed: int, with_annotations: bool = False) -> str:
    """An EcoTaxa archive of blob crops of the given (h, w) sizes, written by
    the port's ``EcotaxaWriter`` (PNG images, one TSV row each)."""
    from ..dataio import EcotaxaWriter
    from ..engine import Call, Pipeline, Unpack

    rng = np.random.default_rng(seed)
    crops = [draw_blob(rng, (h, w), r=int(max(3, min(h, w) // 4))) for h, w in sizes]

    def meta_for(i):
        m = {"object_id": f"obj{i:04d}", "object_area": 100.0 + i}
        if with_annotations:
            m["object_annotation_category"] = "Copepoda"
            m["object_annotation_status"] = "validated" if i % 3 == 0 else "predicted"
        return m

    with Pipeline() as p:
        i = Unpack(list(range(len(crops))))
        EcotaxaWriter(fn, [(Call(lambda k: f"obj{k:04d}.png", i), Call(lambda k: crops[k], i))], Call(meta_for, i))
    p.run()
    return fn


def distill_batches(n_out: int, size: int = 128, batch: int = 8, seed: int = 0,
                    rng: Optional[np.random.Generator] = None) -> Iterator[tuple]:
    """``tools/bench_e2e.py``'s distillation batches (``ensure_models``):
    noise up to 90 with four bright discs an image, targets the threshold at
    100 (two channels: 100 and 180), images scaled to [0, 1]. ``rng``, if
    given, replaces the generator made from ``seed`` (``tools/bench_e2e.py``
    draws both U-Nets' batches from one generator)."""
    rng = np.random.default_rng(seed) if rng is None else rng
    yy, xx = np.mgrid[0:size, 0:size]
    while True:
        x = (rng.random((batch, size, size, 3)) * 90).astype(np.float32)
        for i in range(batch):
            for _ in range(4):
                cy, cx = rng.integers(10, size - 10, 2)
                r = rng.integers(4, 14)
                x[i][(yy - cy) ** 2 + (xx - cx) ** 2 <= r * r] = rng.integers(120, 250)
        yield x / 255.0, _threshold_targets(x, n_out)


def vignette_batches(n_out: int, size: int = 128, batch: int = 8, seed: int = 0) -> Iterator[tuple]:
    """Tiles of a stitched LOKI frame, as the loki U-Net sees them, with
    ``distill_batches``' targets (``chip_smoke.py`` phase 9's distillation).
    Each tile is black with one to three of ``make_loki_tree``'s 60×80
    vignettes (``draw_blob``: noise below 20, an ellipse of radius 8-13)
    pasted in turn, the last on top as ``Stitch`` pastes them, and cut where
    they cross the tile's edge. The ellipses' intensities are drawn from
    30-250, so that the tiles show both sides of the threshold."""
    rng = np.random.default_rng(seed)
    while True:
        x = np.zeros((batch, size, size), np.float32)
        for i in range(batch):
            for _ in range(int(rng.integers(1, 4))):
                v = draw_blob(rng, (60, 80), 8 + int(rng.integers(0, 6)), int(rng.integers(30, 251)))
                oy, ox = int(rng.integers(-30, size - 30)), int(rng.integers(-40, size - 40))
                y0, x0, y1, x1 = max(oy, 0), max(ox, 0), min(oy + 60, size), min(ox + 80, size)
                x[i, y0:y1, x0:x1] = v[y0 - oy : y1 - oy, x0 - ox : x1 - ox]
        x = np.repeat(x[..., None], 3, axis=-1)
        yield x / 255.0, _threshold_targets(x, n_out)


def _threshold_targets(x: np.ndarray, n_out: int) -> np.ndarray:
    """The distillation's teacher: channel 0 of (B, H, W, 3) intensities
    above 100 (a second channel: above 180)."""
    if n_out == 1:
        return (x[..., :1] > 100).astype(np.float32)
    return np.stack([(x[..., 0] > 100), (x[..., 0] > 180)], axis=-1).astype(np.float32)


def write_classifier(path: str, cfg: dict, dtype: str, seed: int) -> str:
    """A ``ConvClassifier`` checkpoint of seeded random weights, written by
    the port's ``save_model`` (one output, ``probs``, without channel names,
    as ``tools/bench_e2e.py`` writes it)."""
    from ..models.classifier import ConvClassifier
    from ..models.model_io import init_classifier_params, params_from_jax, save_model

    module = ConvClassifier(**cfg, dtype=dtype)
    module.load_state_dict(params_from_jax(init_classifier_params(cfg, seed=seed)))
    save_model(path, module, outputs={"probs": {}})
    return path


def write_unet(path: str, cfg: dict, dtype: str, seed: int, gain=None, channel_names=("foreground",)) -> str:
    """A ``UNet`` checkpoint of seeded random weights, written by the port's
    ``save_model``. ``gain`` scales the 1×1 head and sets its bias to
    ``-gain / 2``, so that logits lie far from 0 (no score within float noise
    of the 0.5 threshold) and featureless pixels score as background."""
    from ..models.model_io import init_unet_params, params_from_jax, save_model
    from ..models.unet import UNet

    params = init_unet_params(cfg, seed=seed)
    if gain is not None:
        head = params["params"][f"Conv_{cfg['depth']}"]
        head["kernel"] *= gain
        head["bias"][:] = -gain / 2
    module = UNet(**cfg, dtype=dtype)
    module.load_state_dict(params_from_jax(params))
    save_model(path, module, outputs={"pred": {"channel_names": list(channel_names)}})
    return path


def region_labels(shape, R: int, seed: int) -> np.ndarray:
    """Label frames of rectangles with ids 1..R+44 (so some lie beyond the
    R-entry table), sizes from 1 to 48 px a side, on background 0."""
    rng = np.random.default_rng(seed)
    out = np.zeros(shape, np.int32)
    H, W = shape[-2:]
    for f in np.ndindex(shape[:-2]):
        for i in range(1, R + 45):
            h, w = rng.integers(1, min(H, 48) + 1), rng.integers(1, min(W, 48) + 1)
            y, x = rng.integers(0, H - h + 1), rng.integers(0, W - w + 1)
            out[f + (slice(y, y + h), slice(x, x + w))] = i
    return out


def large_id_labels(shape, R: int, seed: int) -> np.ndarray:
    """``region_labels`` with negative ids on 1% of the pixels and each
    frame's last pixels holding R - 1, R - 2, ... (the largest ids present):
    the inputs of the region kernels' device-memory routes at large R."""
    rng = np.random.default_rng(seed)
    lab = region_labels(shape, R, seed)
    lab[rng.random(shape) < 0.01] = -3
    flat = lab.reshape(-1, shape[-2] * shape[-1])
    k = min(64, flat.shape[1] // 4, R)
    flat[:, -k:] = R - 1 - np.arange(k)
    return lab
