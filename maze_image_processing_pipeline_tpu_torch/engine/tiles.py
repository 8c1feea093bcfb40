"""Overlapping tiling of large frames with blended reassembly.

Capability parity: ``morphocut.tiles.TiledPipeline`` as used at
``loki/pipeline.py:513`` (1024² tiles, stride 896) and
``predict/pipeline.py:645-656`` (``blend_strategy="linear"``).

TPU-first notes: tiles are emitted at a *fixed static shape* (padded at the
frame border) so that downstream device stages compile once; the linear-blend
weights are separable ramps, so identical per-tile outputs reassemble to the
untiled result exactly (``sum(w*v)/sum(w) == v``).

Copy of ``maze_image_processing_pipeline_tpu/engine/tiles.py`` for the PyTorch port,
which imports nothing of the JAX package; only imports differ.
``tests/test_torch_host_copies.py`` holds the two equal.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from .core import Pipeline, Stream, StreamObject, Variable, closing_if_closable

__all__ = ["TiledPipeline"]

# Private StreamObject keys (negative ints never collide with Variable ids).
_TILE_INFO_KEY = -2


class _TileInfo:
    __slots__ = (
        "source_id",
        "index",
        "n_tiles",
        "y",
        "x",
        "valid_h",
        "valid_w",
        "orig_shape",
        "incoming_keys",
    )

    def __init__(
        self, source_id, index, n_tiles, y, x, valid_h, valid_w, orig_shape, incoming_keys
    ):
        self.source_id = source_id
        self.index = index
        self.n_tiles = n_tiles
        self.y = y
        self.x = x
        self.valid_h = valid_h
        self.valid_w = valid_w
        self.orig_shape = orig_shape
        self.incoming_keys = incoming_keys


def _tile_starts(extent: int, tile: int, stride: int) -> List[int]:
    """In-bounds tile start offsets covering [0, extent)."""
    if extent <= tile:
        return [0]
    starts = list(range(0, extent - tile, stride))
    starts.append(extent - tile)
    # Deduplicate (when (extent - tile) is a multiple of stride)
    out: List[int] = []
    for s in starts:
        if not out or s != out[-1]:
            out.append(s)
    return out


def _linear_weight(tile_h: int, tile_w: int) -> np.ndarray:
    """Separable ramp weights: 1 at the tile center rows/cols, ramping to the edge."""
    wy = np.minimum(np.arange(tile_h) + 1, np.arange(tile_h)[::-1] + 1).astype(np.float32)
    wx = np.minimum(np.arange(tile_w) + 1, np.arange(tile_w)[::-1] + 1).astype(np.float32)
    return wy[:, None] * wx[None, :]


class TiledPipeline(Pipeline):
    """Split ``image`` into overlapping tiles for the enclosed region, then reassemble.

    Args:
        tile_shape: (tile_h, tile_w) static tile shape.
        image: Variable holding the frame image (H, W[, C]).
        tile_stride: stride between tile starts; defaults to ``tile_shape``
            (non-overlapping).
        blend_strategy: ``"flat"`` (later tiles overwrite; reference loki
            default) or ``"linear"`` (ramped overlap blending; reference
            predict path).

    Every variable assigned *inside* the region whose value is an ndarray with
    leading shape ``tile_shape`` is reassembled to frame shape; other new
    variables are broadcast from the last tile. Tiles dropped inside the
    region (e.g. empty-tile filters) simply contribute nothing.
    """

    def __init__(
        self,
        tile_shape: Tuple[int, int],
        image: Variable,
        tile_stride: Optional[Tuple[int, int]] = None,
        blend_strategy: str = "flat",
    ) -> None:
        self.tile_shape = tuple(tile_shape)
        self.image = image
        self.tile_stride = tuple(tile_stride) if tile_stride is not None else self.tile_shape
        if blend_strategy not in ("flat", "linear"):
            raise ValueError(f"Unknown blend_strategy: {blend_strategy!r}")
        self.blend_strategy = blend_strategy
        super().__init__()

    # -- tiling ------------------------------------------------------------

    def _split(self, stream: Stream) -> Stream:
        th, tw = self.tile_shape
        sy, sx = self.tile_stride
        for source_id, obj in enumerate(stream):
            image = np.asarray(obj[self.image])
            H, W = image.shape[:2]
            ys = _tile_starts(H, th, sy)
            xs = _tile_starts(W, tw, sx)
            n_tiles = len(ys) * len(xs)
            index = 0
            for y in ys:
                for x in xs:
                    valid_h = min(th, H - y)
                    valid_w = min(tw, W - x)
                    tile = image[y : y + valid_h, x : x + valid_w]
                    if valid_h < th or valid_w < tw:
                        pad = [(0, th - valid_h), (0, tw - valid_w)] + [(0, 0)] * (
                            image.ndim - 2
                        )
                        tile = np.pad(tile, pad)
                    new_obj = obj.copy()
                    new_obj[self.image] = tile
                    new_obj.values[_TILE_INFO_KEY] = _TileInfo(
                        source_id,
                        index,
                        n_tiles,
                        y,
                        x,
                        valid_h,
                        valid_w,
                        image.shape,
                        frozenset(obj.values.keys()),
                    )
                    index += 1
                    yield new_obj

    # -- reassembly --------------------------------------------------------

    class _FrameAccumulator:
        def __init__(self, outer: "TiledPipeline", template: StreamObject):
            self.outer = outer
            self.template = template
            self.orig_shape = template.values[_TILE_INFO_KEY].orig_shape
            self.acc: Dict[int, np.ndarray] = {}
            self.weight: Dict[int, np.ndarray] = {}
            self.scalars: Dict[int, object] = {}
            # Keys present *before* the region ran (captured at split time):
            # these stay frame-level and are not reassembled (except image).
            self.tile_keys = template.values[_TILE_INFO_KEY].incoming_keys

        def add(self, obj: StreamObject) -> None:
            info: _TileInfo = obj.values[_TILE_INFO_KEY]
            th, tw = self.outer.tile_shape
            H, W = self.orig_shape[:2]
            vh, vw = info.valid_h, info.valid_w
            if self.outer.blend_strategy == "linear":
                w_full = _linear_weight(th, tw)
            else:
                # flat: later tiles overwrite. The weight plane stores the
                # 1-based index of the pixel's last writer (exact for any
                # tile count, unlike weight-growth emulations).
                w_full = np.full((th, tw), float(info.index + 1), dtype=np.float32)

            for key, value in obj.values.items():
                if key in self.tile_keys and key != self.outer.image.id:
                    # pre-existing (frame-level) variable: keep template's copy
                    continue
                if key == _TILE_INFO_KEY:
                    continue
                value_arr = value
                if (
                    isinstance(value_arr, np.ndarray)
                    and value_arr.shape[:2] == (th, tw)
                ):
                    if key not in self.acc:
                        out_shape = (H, W) + value_arr.shape[2:]
                        self.acc[key] = np.zeros(out_shape, dtype=np.float32)
                        self.weight[key] = np.zeros((H, W), dtype=np.float32)
                    w = w_full[:vh, :vw]
                    v = value_arr[:vh, :vw].astype(np.float32)
                    if self.outer.blend_strategy == "flat":
                        # Overwrite raw values where this tile's index beats
                        # the pixel's previous writer.
                        region_w = self.weight[key][info.y : info.y + vh, info.x : info.x + vw]
                        replace = w > region_w
                        rb = replace if v.ndim == 2 else replace[..., None]
                        acc_region = self.acc[key][info.y : info.y + vh, info.x : info.x + vw]
                        np.copyto(acc_region, v, where=rb)
                        np.copyto(region_w, w, where=replace)
                    else:
                        wb = w if v.ndim == 2 else w[..., None]
                        self.acc[key][info.y : info.y + vh, info.x : info.x + vw] += v * wb
                        self.weight[key][info.y : info.y + vh, info.x : info.x + vw] += w
                    self._dtypes = getattr(self, "_dtypes", {})
                    self._dtypes[key] = value_arr.dtype
                else:
                    self.scalars[key] = value

        def finalize(self) -> StreamObject:
            out = self.template.copy()
            del out.values[_TILE_INFO_KEY]
            for key, acc in self.acc.items():
                if self.outer.blend_strategy == "flat":
                    blended = acc  # raw values; unwritten pixels stay 0
                else:
                    w = self.weight[key]
                    w_safe = np.where(w > 0, w, 1.0)
                    blended = acc / (w_safe if acc.ndim == 2 else w_safe[..., None])
                dtype = self._dtypes[key]
                if np.issubdtype(dtype, np.bool_):
                    out.values[key] = blended > 0.5
                elif np.issubdtype(dtype, np.integer):
                    out.values[key] = np.rint(blended).astype(dtype)
                else:
                    out.values[key] = blended.astype(dtype)
            for key, value in self.scalars.items():
                out.values[key] = value
            return out

    def transform_stream(self, stream: Stream) -> Stream:
        inner = self._chain_children(self._split(stream))

        with closing_if_closable(inner):
            current: Optional[TiledPipeline._FrameAccumulator] = None
            current_sid: Optional[int] = None
            for obj in inner:
                info: _TileInfo = obj.values[_TILE_INFO_KEY]
                if current_sid is not None and info.source_id != current_sid:
                    yield current.finalize()
                    current = None
                if current is None:
                    current = TiledPipeline._FrameAccumulator(self, obj)
                    current_sid = info.source_id
                current.add(obj)
            if current is not None:
                yield current.finalize()
