"""Inputs of the benchmark, made from a seed: LOKI sample trees, EcoTaxa
crop archives and the U-Nets' distillation batches.

A frozen copy of the port's ``tools/synth.py`` generators (``draw_blob``,
``make_loki_tree``, ``make_crop_archive``, ``vignette_batches``,
``distill_batches``, ``_threshold_targets``): the same shapes and
distributions; the distillation batches the same generators. The copy
encodes its PNGs and writes its archives itself (:func:`encode_png`,
:func:`write_ecotaxa_zip`) and imports nothing of the port, so a later
change to the program cannot change the inputs. A haul's or an archive's
sizes and places come from a layout seed fixed in the traffic mix, and the
run's seed draws their order and the pixels: every seed gets the same work.

Each generator also returns what it drew (the vignettes and their places,
the crops), which the reference reads instead of decoding the files.
"""

from __future__ import annotations

import os
import struct
import zipfile
import zlib
from typing import Dict, Iterator, List, Optional, Sequence, Tuple, Union

import numpy as np

OBJECT_ID_FMT = "{date} {time}  {ms:03d}  {seq:06d} {posx:04d} {posy:04d}"
FRAME_ID_FMT = "{date} {time}  {ms:03d}"


def encode_png(img: np.ndarray) -> bytes:
    """An 8-bit grey PNG of a (H, W) uint8 image (no row filter)."""
    img = np.ascontiguousarray(img, np.uint8)
    H, W = img.shape
    raw = np.zeros((H, W + 1), np.uint8)
    raw[:, 1:] = img

    def chunk(kind: bytes, data: bytes) -> bytes:
        return struct.pack(">I", len(data)) + kind + data + struct.pack(">I", zlib.crc32(kind + data))

    head = struct.pack(">IIBBBBB", W, H, 8, 0, 0, 0, 0)
    return b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", head) + chunk(b"IDAT", zlib.compress(raw.tobytes(), 1)) \
        + chunk(b"IEND", b"")


def draw_blob(rng, shape=(60, 80), r=12, intensity=180, core: Optional[int] = None) -> np.ndarray:
    """A bright elliptical blob on dark noise: a fake plankton vignette;
    with ``core``, an inner ellipse of half the radii at that intensity
    (a second body part)."""
    img = (rng.random(shape) * 20).astype(np.uint8)
    yy, xx = np.mgrid[0 : shape[0], 0 : shape[1]]
    cy, cx = shape[0] // 2, shape[1] // 2
    ellipse = (yy - cy) ** 2 / (r * r) + (xx - cx) ** 2 / (1.8 * r) ** 2
    img[ellipse <= 1.0] = intensity
    if core is not None:
        img[ellipse <= 0.25] = core
    return img


def make_loki_tree(root: str, n_frames: int, objects_per_frame: Union[int, Tuple[int, int]], frame_shape,
                   seed: int, layout_seed: int,
                   crop_size_range: Optional[Tuple[Tuple[int, int], Tuple[int, int]]] = None
                   ) -> Tuple[str, Dict[str, List[Tuple[np.ndarray, int, int]]]]:
    """A LOKI sample tree as the camera writes it (``Log/LOKI_*.log``,
    ``meta.yaml``, ``Telemetrie/*.tmd``, ``Pictures/<hour>/<object id>.png``)
    with the vignettes of ``frame_shape`` frames at random places: 60×80, or
    drawn log-uniformly from ``crop_size_range``. ``objects_per_frame`` is a
    count or an inclusive (lo, hi) range drawn per frame.

    ``layout_seed`` draws each frame's vignettes (count, size, ellipse radius
    and place); ``seed`` the order of the frames in the haul and every
    vignette's noise, so that every seed gets the same work in another
    order. Returns the sample root and, per frame id, the ``(vignette, posy,
    posx)`` it holds in the order the camera numbers them."""
    lay = np.random.default_rng(layout_seed)
    H, W = frame_shape
    layouts = []
    for _ in range(n_frames):
        if isinstance(objects_per_frame, (tuple, list)):
            n_objects = int(lay.integers(objects_per_frame[0], objects_per_frame[1] + 1))
        else:
            n_objects = objects_per_frame
        frame = []
        for _ in range(n_objects):
            if crop_size_range is not None:
                (h0, w0), (h1, w1) = crop_size_range
                ch = int(np.exp(lay.uniform(np.log(h0), np.log(h1))))
                cw = int(np.exp(lay.uniform(np.log(w0), np.log(w1))))
                ch, cw = min(ch, H - 10), min(cw, W - 10)
                r = max(4, min(ch, cw) // 4 + int(lay.integers(0, 4)))
            else:
                ch, cw = 60, 80
                r = 8 + int(lay.integers(0, 6))
            posx = int(lay.integers(0, max(1, W - cw - 10)))
            posy = int(lay.integers(0, max(1, H - ch - 10)))
            frame.append((ch, cw, r, posy, posx))
        layouts.append(frame)
    rng = np.random.default_rng(seed)
    layouts = [layouts[i] for i in rng.permutation(n_frames)]

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
    frames: Dict[str, List[Tuple[np.ndarray, int, int]]] = {}
    for t, frame in zip(times, layouts):
        members = frames.setdefault(FRAME_ID_FMT.format(date=date, time=t, ms=333), [])
        for oi, (ch, cw, r, posy, posx) in enumerate(frame):
            oid = OBJECT_ID_FMT.format(date=date, time=t, ms=333, seq=oi, posx=posx, posy=posy)
            blob = draw_blob(rng, (ch, cw), r)
            with open(os.path.join(pic_dir, oid + ".png"), "wb") as f:
                f.write(encode_png(blob))
            members.append((blob, posy, posx))  # the reader takes them in file-name order: seq first
    return sample, frames


def write_ecotaxa_zip(fn: str, names: Sequence[str], images: Sequence[np.ndarray], rows: Sequence[dict]) -> str:
    """An EcoTaxa archive: ``ecotaxa_export.tsv`` (header, ``[t]``/``[f]``
    type row, one row an object with its ``img_file_name``) and the PNGs."""
    cols = list(rows[0]) + ["img_file_name"]
    types = ["[f]" if isinstance(rows[0][c], (int, float)) else "[t]" for c in cols[:-1]] + ["[t]"]
    lines = ["\t".join(cols), "\t".join(types)]
    lines += ["\t".join([str(r[c]) for c in cols[:-1]] + [n]) for r, n in zip(rows, names)]
    with zipfile.ZipFile(fn, "w", zipfile.ZIP_STORED) as z:  # fixed dates: the same seed, the same bytes
        z.writestr(zipfile.ZipInfo("ecotaxa_export.tsv"), "\n".join(lines) + "\n")
        for n, img in zip(names, images):
            z.writestr(zipfile.ZipInfo(n), encode_png(img))
    return fn


def crop_sizes(rng, n: int, size_range: Tuple[Tuple[int, int], Tuple[int, int]]) -> List[Tuple[int, int]]:
    """``n`` crop sizes (h, w), each side log-uniform in ``size_range``."""
    (h0, w0), (h1, w1) = size_range
    return [(int(np.exp(rng.uniform(np.log(h0), np.log(h1)))), int(np.exp(rng.uniform(np.log(w0), np.log(w1)))))
            for _ in range(n)]


def make_crop_archive(fn: str, sizes, seed: int, intensity: int = 180, core: Optional[int] = None
                      ) -> Dict[str, np.ndarray]:
    """An EcoTaxa archive of blob crops of the given (h, w) sizes, in the
    order given (the port's ``make_crop_archive`` draws; ``intensity`` and
    ``core`` as :func:`draw_blob` takes them); returns the crops by object
    id."""
    rng = np.random.default_rng(seed)
    crops = [draw_blob(rng, (h, w), int(max(3, min(h, w) // 4)), intensity, core) for h, w in sizes]
    ids = [f"obj{i:04d}" for i in range(len(crops))]
    write_ecotaxa_zip(fn, [i + ".png" for i in ids], crops,
                      [{"object_id": i, "object_area": 100.0 + k} for k, i in enumerate(ids)])
    return dict(zip(ids, crops))


def threshold_targets(x: np.ndarray, n_out: int) -> np.ndarray:
    """The distillation's teacher: channel 0 of (B, H, W, 3) intensities
    above 100 (a second channel: above 180; the crop traffic draws its
    blobs' bodies and cores well to either side of it)."""
    if n_out == 1:
        return (x[..., :1] > 100).astype(np.float32)
    return np.stack([(x[..., 0] > 100), (x[..., 0] > 180)], axis=-1).astype(np.float32)


def distill_batches(n_out: int, size: int = 128, batch: int = 8, seed: int = 0) -> Iterator[tuple]:
    """Noise up to 90 with four bright discs an image; threshold targets;
    images scaled to [0, 1]."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:size, 0:size]
    while True:
        x = (rng.random((batch, size, size, 3)) * 90).astype(np.float32)
        for i in range(batch):
            for _ in range(4):
                cy, cx = rng.integers(10, size - 10, 2)
                r = rng.integers(4, 14)
                x[i][(yy - cy) ** 2 + (xx - cx) ** 2 <= r * r] = rng.integers(120, 250)
        yield x / 255.0, threshold_targets(x, n_out)


def vignette_batches(n_out: int, size: int = 128, batch: int = 8, seed: int = 0) -> Iterator[tuple]:
    """Tiles of a stitched LOKI frame: black, with one to three 60×80
    vignettes pasted in turn and cut at the tile's edge, their ellipses'
    intensities drawn from 30-250; threshold targets."""
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
        yield x / 255.0, threshold_targets(x, n_out)


def batch_stream(name: str, n_out: int, seed: int) -> Iterator[tuple]:
    """The distillation batches a configuration names."""
    if name == "vignette_batches":
        return vignette_batches(n_out, seed=seed)
    if name == "distill_batches":
        return distill_batches(n_out, seed=seed)
    raise ValueError(f"unknown distillation batches {name!r}")


def read_archive_rows(fn: str) -> List[dict]:
    """The rows of an EcoTaxa archive's ``ecotaxa_export.tsv``, as strings,
    the type row left out."""
    with zipfile.ZipFile(fn) as z:
        name = next(n for n in z.namelist() if n.endswith(".tsv"))
        text = z.read(name).decode()
    lines = text.splitlines()
    cols = lines[0].split("\t")
    body = lines[1:]
    if body and all(v in ("[t]", "[f]") for v in body[0].split("\t")):
        body = body[1:]
    return [dict(zip(cols, line.split("\t"))) for line in body if line]


def bytes_of_tree(path: str) -> int:
    """Bytes of the files under ``path``."""
    total = 0
    for d, _, files in os.walk(path):
        for f in files:
            try:
                total += os.path.getsize(os.path.join(d, f))
            except OSError:
                pass
    return total

