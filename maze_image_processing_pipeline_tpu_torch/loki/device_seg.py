"""Model-based LOKI re-segmentation on the device.

Counterpart of ``maze_image_processing_pipeline_tpu/loki/device_seg.py``:

* :class:`DeviceTiledSegmentation` — frames in groups of ``frame_batch``:
  upload, cut tiles on the device, U-Net forward with sigmoid, linear-ramp
  blend back into frames, the frame chain (:func:`_build_frame_chain`),
  per-region crop masks cut on the device; the host assembles
  :class:`..engine.image.RegionInfo` objects. With ``device_crops: false``
  or segment merging (``merge_segments_distance > 0``) the label frames
  come to the host instead (label-frame mode): merging runs there
  (:func:`..ops.merge_labels.merge_labels`) and ``FindRegions`` cuts the
  crops;
* :class:`DeviceFramePostprocess` — the frame chain on one host-blended
  frame at a time (the host-blend path);
* with a ``mesh`` (:func:`..parallel.make_mesh`), frame groups (and, on the
  host-blend path, frames) go round-robin over its devices, one group a
  device in flight, each device with its own replica of the U-Net; objects
  still leave in arrival order and the results do not depend on the mesh;
* :func:`build_torch_segmentation` — the stage builder: [stitch →]
  segmentation (device blend, or tiles → :class:`..models.inference.
  TorchInference` → host blend → :class:`DeviceFramePostprocess`, which the
  full-frame debug archive needs) → region fan-out → ROI crops → metadata →
  ZooProcess features.

Not ported: the sparse crop upload (``_build_compose``): the dense upload's
host → device copies take under 1 % of a haul's wall on the card (ROADMAP,
queue A, "Not ported").
"""

from __future__ import annotations

import collections
import contextlib
import logging
import os
from types import SimpleNamespace
from typing import Dict, List, Tuple

import numpy as np
import torch

from .. import tracing
from ..dataio import EcotaxaWriter
from ..engine import DataParallelPipeline, Filter, Stitch, StreamBuffer, TiledPipeline
from ..engine.core import (
    Call,
    Node,
    RawOrVariable,
    ReturnOutputs,
    Stream,
    Variable,
    closing_if_closable,
)
from ..engine.image import (
    CalculateZooProcessFeatures,
    ExtractROI,
    FindRegions,
    RegionInfo,
)
from ..engine.tiles import _linear_weight, _tile_starts
from ..models.inference import TorchInference, default_device_pre, sigmoid_post
from ..models.inference import resolve_device as _resolve_device
from ..ops.crops import UNPACK_LUT, extract_region_crops
from ..ops.fill_holes import region_filled_extra
from ..ops.label import clear_border, label, remove_small_objects
from ..ops.merge_labels import merge_labels
from ..ops.morphology import binary_closing, binary_opening
from ..ops.regionprops_fused import regionprops_fused
from ..parallel.mesh import mesh_devices, replicate, require_local
from .meta import format_object_id

__all__ = ["DeviceTiledSegmentation", "DeviceFramePostprocess", "build_torch_segmentation"]

logger = logging.getLogger(__name__)

# The defaults of the JAX package's SegmentationPostprocessingConfig.
DEFAULT_POSTPROCESS = SimpleNamespace(
    opening_radius=0,
    closing_radius=0,
    merge_segments_distance=0,
    min_area=0,
    clear_border=False,
    max_regions=64,
)


def _build_frame_chain(cfg, compute_filled: bool = True):
    """The frame postprocess: mask → morphology → CCL → [clear_border] →
    [remove_small] → fused region measurement (K7, K3) → [filled area].

    Returns ``(chain, pack_keys)``. ``chain(pred, image)`` takes (B, H, W)
    float32 predictions and uint8 frames on one device and returns
    ``(labels, flat)``: the int32 label frames, and ONE flat float32 buffer
    of the counts, the packed (K, B, R) statistics and the (B, R, 256)
    histograms, so the host needs one copy. ``pack_keys`` (sorted prop keys,
    histogram excluded) is filled at the first call. ``compute_filled``
    adds ``area_filled`` and ``area_filled_ambiguous`` (the JAX package
    leaves them out when segments are merged).
    """
    pack_keys: list = []
    R = cfg.max_regions

    def chain(pred: torch.Tensor, image: torch.Tensor):
        mask = pred > 0.5
        if cfg.opening_radius > 0:
            mask = binary_opening(mask, cfg.opening_radius)
        if cfg.closing_radius > 0:
            mask = binary_closing(mask, cfg.closing_radius)
        labels, n = label(mask, connectivity=2)
        if cfg.clear_border:
            labels, n = clear_border(labels, num_segments=4 * R)
        if cfg.min_area > 0:
            labels, n = remove_small_objects(labels, cfg.min_area, num_segments=4 * R)
        props = regionprops_fused(labels, image, num_segments=R, compute_histogram=True)
        if compute_filled:
            extra, ambiguous = region_filled_extra(labels, num_segments=R, bg_segments=4 * R)
            props["area_filled"] = props["area"] + extra
            props["area_filled_ambiguous"] = ambiguous.to(torch.float32)
        keys = sorted(k for k in props if k != "histogram")
        if not pack_keys:
            pack_keys.extend(keys)
        flat = torch.cat(
            [
                n.to(torch.float32).reshape(-1),
                torch.stack([props[k] for k in keys]).reshape(-1),
                props["histogram"].reshape(-1),
            ]
        )
        return labels, flat

    return chain, pack_keys


def _unpack_stats_batch(flat, B, pack_keys):
    """Unpack a frame group's stats buffer (numpy) into
    ``[(n_regions, props)]`` per frame."""
    K = len(pack_keys)
    R = (flat.size - B) // (B * (K + 256))
    n_all = flat[:B]
    packed_all = flat[B : B + K * B * R].reshape(K, B, R)
    hist_all = flat[B + K * B * R :].reshape(B, R, 256)
    out = []
    for b in range(B):
        props = {k: packed_all[i, b] for i, k in enumerate(pack_keys)}
        props["histogram"] = hist_all[b]
        out.append((int(n_all[b]), props))
    return out


def _finalize_frame(labels, n, props, post_cfg, device):
    """The host epilogue of a frame: overflow warning, then, with
    ``merge_segments_distance > 0``, bridge-merging of the label frame
    (distance fields on ``device``); merged props are stale, so they are
    dropped and ``FindRegions`` measures each crop on the host."""
    if n >= post_cfg.max_regions:
        # Not a data loss: the excess is measured on the host.
        logger.warning(
            "Frame has %d regions, exceeding max_regions=%d; the excess "
            "is measured on the host (slow path) — raise max_regions if "
            "this happens often.",
            n,
            post_cfg.max_regions,
        )
    if post_cfg.merge_segments_distance > 0:
        labels = merge_labels(labels, max_distance=post_cfg.merge_segments_distance, device=device)
        props = None
    return labels, props, n


class _Holder:
    """An arrived frame's place in the arrival-order emission queue."""

    __slots__ = ("obj", "key", "result", "dispatched")

    def __init__(self, obj, key):
        self.obj = obj
        self.key = key
        self.result = None
        self.dispatched = False


@ReturnOutputs
class DeviceTiledSegmentation(Node):
    """Tile inference → device blend → frame postprocess → device crops.

    Frames are processed in groups of ``frame_batch`` frames of one shape
    bucket (multiples of 256, at least one tile); each group is one upload,
    ``ceil(tiles / batch_size)`` model forwards, one frame chain and one
    device→host copy of the statistics and one of the crop masks. Objects
    leave the node in arrival order. With a mesh the groups go round-robin
    over its devices, and a group is fetched once every device has one
    dispatched (one device: as soon as it is dispatched).

    Args:
        image: frame variable (H, W) or (H, W, C) uint8; channel 0 is used.
        model: a :class:`..models.model_io.LoadedModel` (NHWC in, logits out).
        config: segmentation settings read by attribute (``tile_size``,
            ``tile_stride``, ``batch_size``, ``frame_batch``,
            ``skip_empty_tiles``, ``padding``, ``min_intensity``; optional
            ``device_crops``), e.g. the JAX package's
            ``JaxSegmentationConfig``.
        postprocess_config: frame-chain settings (``opening_radius``,
            ``closing_radius``, ``clear_border``, ``min_area``,
            ``max_regions``, ``merge_segments_distance``).
        device: the torch device that runs the model and the chain; the
            card unless the caller asks for the CPU. Without a card a CUDA
            device raises: the node never carries on on the CPU.
        mesh: optional :class:`..parallel.mesh.Mesh` whose devices take the
            frame groups in turn (``device`` is not read).
    """

    outputs = ("labels", "props", "n_regions", "regions")

    def __init__(
        self,
        image: RawOrVariable[np.ndarray],
        model,
        config,
        postprocess_config,
        device="cuda",
        mesh=None,
    ) -> None:
        self.image = image
        super().__init__()
        require_local(mesh, "DeviceTiledSegmentation")
        self._devices = [_resolve_device(d) for d in mesh_devices(mesh, device)]
        self._modules = {d: m.eval() for d, m in replicate(model.module, self._devices).items()}
        self._cfg = config
        self._post_cfg = postprocess_config
        self._skip_empty = bool(getattr(config, "skip_empty_tiles", True))
        self._frame_batch = max(1, getattr(config, "frame_batch", 4))
        # Device crops need the labels as the chain left them; merging
        # changes them on the host, so it takes the label-frame mode.
        merging = postprocess_config.merge_segments_distance > 0
        self._crops_mode = bool(getattr(config, "device_crops", True)) and not merging
        self._chain, self._pack_keys = _build_frame_chain(postprocess_config, compute_filled=not merging)
        ts = config.tile_size
        weight = torch.from_numpy(_linear_weight(ts, ts))
        self._weights = {d: weight.to(d) for d in self._modules}

    # -- one frame group -------------------------------------------------

    @tracing.span("loki.forward")
    def _predict(self, frames: torch.Tensor, jobs, hs, ws, device) -> torch.Tensor:
        """Tile forward + linear-ramp blend on ``device`` → (B, Hb, Wb)
        float32 scores."""
        ts = self._cfg.tile_size
        bs = self._cfg.batch_size or 8
        module, weight = self._modules[device], self._weights[device]
        canvas = torch.zeros(frames.shape, dtype=torch.float32, device=device)
        wsum = torch.zeros_like(canvas)
        for i in range(0, len(jobs), bs):
            chunk = jobs[i : i + bs]
            tiles = torch.stack([frames[b, y : y + ts, x : x + ts] for b, y, x in chunk])
            pred = sigmoid_post(module(default_device_pre(tiles)))[..., 0].float()
            for j, (b, y, x) in enumerate(chunk):
                canvas[b, y : y + ts, x : x + ts] += pred[j] * weight
                wsum[b, y : y + ts, x : x + ts] += weight
        # Pixels covered only by skipped (empty) tiles keep weight 0 → 0.
        pred = canvas / torch.clamp(wsum, min=1.0)
        Hb, Wb = frames.shape[-2:]
        rows = torch.arange(Hb, device=device)[None, :, None]
        cols = torch.arange(Wb, device=device)[None, None, :]
        hs_t = torch.as_tensor(hs, device=device)[:, None, None]
        ws_t = torch.as_tensor(ws, device=device)[:, None, None]
        return torch.where((rows < hs_t) & (cols < ws_t), pred, 0.0)

    @tracing.span("loki.dispatch")
    def _dispatch_group(self, imgs: np.ndarray, hs, ws, dims, device) -> SimpleNamespace:
        """Launch one (B, Hb, Wb) frame group on ``device``: upload, tile
        forward and blend, the frame chain. Nothing is read back."""
        ts, stride = self._cfg.tile_size, self._cfg.tile_stride
        B, Hb, Wb = imgs.shape
        with tracing.span("loki.tile_select"):
            offsets = [(y, x) for y in _tile_starts(Hb, ts, stride) for x in _tile_starts(Wb, ts, stride)]
            jobs = [
                (b, oy, ox)
                for b in range(B)
                for oy, ox in offsets
                if not self._skip_empty or imgs[b, oy : oy + ts, ox : ox + ts].any()
            ]
        tracing.count("frame_groups")
        tracing.count("frames", len(dims))
        tracing.count("tiles", len(jobs))
        tracing.count("tiles_skipped", B * len(offsets) - len(jobs))  # empty, or a partial group's padding
        with torch.inference_mode():
            with tracing.span("loki.upload"):
                frames = torch.from_numpy(imgs).to(device)
            pred = self._predict(frames, jobs, hs, ws, device)
            with tracing.span("loki.chain"):
                labels, flat = self._chain(pred, frames)
        return SimpleNamespace(imgs=imgs, dims=dims, frames=frames, labels=labels, flat=flat, device=device)

    @tracing.span("loki.finish")
    def _finish_group(self, g: SimpleNamespace):
        """Fetch a dispatched group → per frame ``(labels, props, n_regions,
        regions)``: in crops mode the labels stay on the device (None) and
        ``regions`` holds the frame's RegionInfo objects; in label-frame mode
        ``labels`` is the frame's (H, W) int32 label image on the host and
        ``regions`` is None."""
        B = g.imgs.shape[0]
        with torch.inference_mode():
            with tracing.span("loki.fetch_wait"):
                flat = g.flat.cpu().numpy()
            stats = _unpack_stats_batch(flat, B, self._pack_keys)
            if self._crops_mode:
                regions = self._crops(g.labels, g.frames, g.imgs, stats, g.dims)
                tracing.count("objects", sum(map(len, regions)))
            else:
                with tracing.span("loki.fetch_wait"):
                    labels_host = g.labels.cpu().numpy()
                tracing.count("objects", sum(n for n, _ in stats))
        results = []
        for b, (H, W) in enumerate(g.dims):
            n, props = stats[b]
            if self._crops_mode:
                _, props, n = _finalize_frame(None, n, props, self._post_cfg, g.device)
                results.append((None, props, n, regions[b]))
            else:
                lab, props, n = _finalize_frame(labels_host[b, :H, :W], n, props, self._post_cfg, g.device)
                results.append((lab, props, n, None))
        return results

    # -- crops -------------------------------------------------------------

    def _plan_crops(self, stats, dims, Hp, Wp):
        """Per-region crop windows, bucketed by power-of-two window size."""
        padding = int(getattr(self._cfg, "padding", 0))
        min_intensity = getattr(self._cfg, "min_intensity", None)
        R = self._post_cfg.max_regions
        buckets: Dict[Tuple[int, int], list] = {}
        region_plans = []
        for b, (H, W) in enumerate(dims):
            n, props = stats[b]
            plans = []
            for r in range(1, min(n, R - 1) + 1):
                if props["area"][r] <= 0:
                    continue
                if min_intensity is not None and props["intensity_max"][r] < min_intensity:
                    continue
                y0b = int(props["min_row"][r])
                x0b = int(props["min_col"][r])
                y1b = int(props["max_row"][r])
                x1b = int(props["max_col"][r])
                py0 = max(0, y0b - padding)
                px0 = max(0, x0b - padding)
                py1 = min(H, y1b + padding)
                px1 = min(W, x1b + padding)
                h, w = py1 - py0, px1 - px0
                Sh = min(1 << max(6, (h - 1).bit_length()), Hp)
                Sw = min(1 << max(7, (w - 1).bit_length()), Wp)
                wy = min(py0, Hp - Sh)
                wx = min(px0, Wp - Sw)
                key = (Sh, Sw)
                slot = len(buckets.setdefault(key, []))
                buckets[key].append((r, b, wy, wx))
                plans.append(
                    dict(
                        label=r,
                        bbox=(y0b, x0b, y1b, x1b),
                        bbox_padded=(py0, px0, py1, px1),
                        bucket=key,
                        slot=slot,
                        win=(wy, wx),
                    )
                )
            region_plans.append(plans)
        return buckets, region_plans

    @tracing.span("loki.crops")
    def _crops(self, labels, frames, frames_host, stats, dims) -> List[list]:
        """Cut every region's 2-bit mask window on the device (one copy to
        the host for all of them), slice intensity from the host frames and
        assemble RegionInfo objects per frame."""
        import scipy.ndimage as ndi

        Hp, Wp = frames.shape[-2:]
        buckets, region_plans = self._plan_crops(stats, dims, Hp, Wp)
        keys = sorted(buckets)
        parts = []
        for key in keys:
            jobs = np.asarray(buckets[key], np.int64)
            Sh, Sw = key
            parts.append(
                extract_region_crops(
                    frames, labels, *(torch.from_numpy(jobs[:, i]) for i in range(4)),
                    size_h=Sh, size_w=Sw, include_intensity=False, pack_bits=True,
                )
            )
        flat = np.zeros(0, np.uint8)
        if parts:
            packed = torch.cat(parts)
            with tracing.span("loki.fetch_wait"):
                flat = packed.cpu().numpy()
        views = {}
        o = 0
        for key in keys:
            Sh, Sw = key
            N = len(buckets[key])
            views[key] = flat[o : o + N * Sh * Sw // 4].reshape(N, Sh, Sw // 4)
            o += N * Sh * Sw // 4

        R = self._post_cfg.max_regions
        labels_host = None
        if any(stats[b][0] > R - 1 for b in range(len(dims))):
            with tracing.span("loki.fetch_wait"):
                labels_host = labels.cpu().numpy()

        regions_per_frame = []
        for b, plans in enumerate(region_plans):
            n, props = stats[b]
            amb = props.get("area_filled_ambiguous")
            filled = props.get("area_filled")
            regions = []
            for p in plans:
                r = p["label"]
                wy, wx = p["win"]
                py0, px0, py1, px1 = p["bbox_padded"]
                sy, sx = py0 - wy, px0 - wx
                hh, ww = py1 - py0, px1 - px0
                win_i = frames_host[b, py0:py1, px0:px1]
                # Unpack the 2-bit fields of this window only (byte columns
                # cover [sx, sx + ww) rounded out to whole bytes).
                xb0, xb1 = sx // 4, -(-(sx + ww) // 4)
                pb = views[p["bucket"]][p["slot"], sy : sy + hh, xb0:xb1]
                win_b = UNPACK_LUT[pb].reshape(hh, -1)[:, sx - 4 * xb0 : sx - 4 * xb0 + ww]
                mask = (win_b & 1) > 0
                other = (win_b & 2) > 0
                props_r = {
                    k: (v[..., r, :] if k == "histogram" else v[..., r])
                    for k, v in props.items()
                }
                if filled is not None and not (amb is not None and amb[r] > 0):
                    area_filled = float(filled[r])
                else:
                    area_filled = float(ndi.binary_fill_holes(mask).sum())
                regions.append(
                    RegionInfo(
                        r,
                        p["bbox"],
                        p["bbox_padded"],
                        mask,
                        win_i.copy(),
                        props_r,
                        area_filled,
                        other_mask=other,
                    )
                )
            if n > R - 1 and labels_host is not None:
                regions.extend(
                    self._host_overflow_regions(labels_host[b], frames_host[b], dims[b], int(n))
                )
            regions_per_frame.append(regions)
        return regions_per_frame

    def _host_overflow_regions(self, labels_p, frame_p, dim, n):
        """Host extraction of the regions the fused pass does not measure
        (label >= max_regions), as FindRegions' host path does."""
        import scipy.ndimage as ndi

        from ..ops.host_props import host_region_props

        H, W = dim
        labels = np.asarray(labels_p)[:H, :W]
        frame = np.asarray(frame_p)[:H, :W]
        padding = int(getattr(self._cfg, "padding", 0))
        min_intensity = getattr(self._cfg, "min_intensity", None)
        R = self._post_cfg.max_regions
        out = []
        slices = ndi.find_objects(labels)
        for idx in range(R - 1, min(n, len(slices))):
            sl = slices[idx]
            if sl is None:
                continue
            lab_id = idx + 1
            bbox = (sl[0].start, sl[1].start, sl[0].stop, sl[1].stop)
            py0 = max(0, bbox[0] - padding)
            px0 = max(0, bbox[1] - padding)
            py1 = min(H, bbox[2] + padding)
            px1 = min(W, bbox[3] + padding)
            lab_crop = labels[py0:py1, px0:px1]
            mask = lab_crop == lab_id
            inten = frame[py0:py1, px0:px1]
            if (
                min_intensity is not None
                and float(np.max(inten[mask], initial=0)) < min_intensity
            ):
                continue
            props = {k: v[1] for k, v in host_region_props(mask, inten).items()}
            for key, off in (
                ("min_row", py0),
                ("max_row", py0),
                ("centroid_row", py0),
                ("weighted_centroid_row", py0),
                ("min_col", px0),
                ("max_col", px0),
                ("centroid_col", px0),
                ("weighted_centroid_col", px0),
            ):
                if key in props:
                    props[key] = props[key] + off
            out.append(
                RegionInfo(
                    lab_id,
                    bbox,
                    (py0, px0, py1, px1),
                    mask,
                    inten.copy(),
                    props,
                    float(ndi.binary_fill_holes(mask).sum()),
                    other_mask=(lab_crop > 0) & ~mask,
                )
            )
        return out

    # -- the stream --------------------------------------------------------

    def transform_stream(self, stream: Stream) -> Stream:
        B = self._frame_batch
        ts = self._cfg.tile_size
        arrival: "collections.deque[_Holder]" = collections.deque()
        # One open group per shape bucket; objects still leave in arrival
        # order through `arrival`.
        open_groups: Dict[Tuple[int, int], list] = {}
        # Dispatched groups, oldest first: one a device in flight.
        pending: "collections.deque" = collections.deque()
        n_dev = len(self._devices)
        group_idx = 0

        def finish_one():
            holders, g = pending.popleft()
            for h, result in zip(holders, self._finish_group(g)):
                h.result = result

        def flush_group(key):
            nonlocal group_idx
            group = open_groups.pop(key, None)
            if not group:
                return
            Hb, Wb = key
            imgs = np.zeros((B, Hb, Wb), group[0][0].dtype)
            hs = np.zeros((B,), np.int64)
            ws = np.zeros((B,), np.int64)
            for b, (image, H, W, _) in enumerate(group):
                imgs[b, :H, :W] = image
                hs[b], ws[b] = H, W
            dims = [(H, W) for _, H, W, _ in group]
            device = self._devices[group_idx % n_dev]
            group_idx += 1
            holders = [h for *_, h in group]
            for h in holders:
                h.dispatched = True
            pending.append((holders, self._dispatch_group(imgs, hs, ws, dims, device)))
            while len(pending) >= n_dev:
                finish_one()

        def emit_one():
            h = arrival.popleft()
            if h.result is None and not h.dispatched:
                # The head's group is still open: flush it partially to
                # keep the arrival order.
                flush_group(h.key)
            while h.result is None:
                finish_one()
            labels, props, n, regions = h.result
            self.prepare_output(h.obj, labels, props, n, regions)
            return h.obj

        with closing_if_closable(stream):
            for obj in stream:
                image = np.asarray(self.prepare_input(obj, "image"))
                if image.ndim == 3:
                    image = image[..., 0]
                H, W = image.shape
                key = (-(-max(H, ts) // 256) * 256, -(-max(W, ts) // 256) * 256)
                h = _Holder(obj, key)
                arrival.append(h)
                open_groups.setdefault(key, []).append((image, H, W, h))
                if len(open_groups[key]) >= B:
                    flush_group(key)
                while arrival and arrival[0].result is not None:
                    yield emit_one()
                # Bound the frames held back by rare shape buckets.
                while len(arrival) > 4 * B:
                    yield emit_one()
            for key in list(open_groups):
                flush_group(key)
            while arrival:
                yield emit_one()

    def _input_names(self):
        return ("image",)


@ReturnOutputs
class DeviceFramePostprocess(Node):
    """The frame chain on host-blended frames, one frame a call.

    Counterpart of ``DeviceFramePostprocess`` in the JAX package's
    ``loki/device_seg.py``: binarize → opening → closing → label(8) →
    [clear_border] → [remove_small] → fused region measurement, on each
    frame zero-padded to a multiple of ``bucket``; two frames a device are
    dispatched before the oldest is fetched (labels and one stats buffer),
    as in the JAX package. With a mesh whole frames go round-robin over its
    devices.

    Args:
        pred: (H, W) or (H, W, 1) foreground probability frame variable.
        image: (H, W) uint8 intensity frame variable.
        config: frame-chain settings (``SegmentationPostprocessingConfig``).
        bucket: pad both extents to a multiple of this.
        device: the torch device of the chain; the card unless the caller
            asks for the CPU.
        mesh: optional :class:`..parallel.mesh.Mesh` whose devices take the
            frames in turn (``device`` is not read).
    """

    outputs = ("labels", "props", "n_regions")

    def __init__(
        self,
        pred: RawOrVariable[np.ndarray],
        image: RawOrVariable[np.ndarray],
        config,
        bucket: int = 256,
        device="cuda",
        mesh=None,
    ) -> None:
        self.pred = pred
        self.image = image
        self.config = config
        self.bucket = bucket
        super().__init__()
        require_local(mesh, "DeviceFramePostprocess")
        self._devices = [_resolve_device(d) for d in mesh_devices(mesh, device)]
        self._chain, self._pack_keys = _build_frame_chain(
            config, compute_filled=config.merge_segments_distance == 0
        )

    def _padded(self, x: np.ndarray, device) -> torch.Tensor:
        H, W = x.shape[:2]
        out = np.zeros((1, -(-H // self.bucket) * self.bucket, -(-W // self.bucket) * self.bucket), x.dtype)
        out[0, :H, :W] = x
        return torch.from_numpy(out).to(device)

    def transform_stream(self, stream: Stream) -> Stream:
        pending: "collections.deque" = collections.deque()
        in_flight = 2 * len(self._devices)
        frame_idx = 0

        def emit(entry):
            obj, (labels, flat), (H, W), device = entry
            labels = labels.cpu().numpy()[0, :H, :W]
            ((n, props),) = _unpack_stats_batch(flat.cpu().numpy(), 1, self._pack_keys)
            labels, props, n = _finalize_frame(labels, n, props, self.config, device)
            self.prepare_output(obj, labels, props, n)
            return obj

        with closing_if_closable(stream):
            for obj in stream:
                pred = np.asarray(self.prepare_input(obj, "pred"))
                image = np.asarray(self.prepare_input(obj, "image"))
                if pred.ndim == 3:
                    pred = pred[..., 0]
                device = self._devices[frame_idx % len(self._devices)]
                frame_idx += 1
                with torch.inference_mode():
                    out = self._chain(self._padded(pred, device), self._padded(image, device))
                pending.append((obj, out, pred.shape, device))
                while len(pending) > in_flight:
                    yield emit(pending.popleft())
            while pending:
                yield emit(pending.popleft())


def build_torch_segmentation(
    config,
    target_dir: str,
    image: Variable,
    meta: Variable,
    process_meta: Dict,
    device="cuda",
    mesh=None,
):
    """Model segmentation: [stitch →] tile inference → device blend and
    postprocess → region extraction → ROI, metadata and ZooProcess features.

    ``config`` carries the ``JaxSegmentationConfig`` fields (read by
    attribute); ``device`` runs the model and the frame chain (the card
    unless the caller asks for the CPU); a ``mesh`` (:func:`..parallel.
    make_mesh`) spreads them over its devices instead. Returns ``(roi,
    meta, mask)`` variables.
    """
    from ..models.model_io import load_model

    device = _resolve_device(device)

    if config.stitch:
        StreamBuffer(16)
        image = Stitch(
            image,
            groupby=Call(lambda m: m["object_frame_id"], meta),
            offset=(
                Call(lambda m: m["object_posy"], meta),
                Call(lambda m: m["object_posx"], meta),
            ),
        )
        if config.stitch.skip_single:
            Filter(Call(lambda img: img.n_regions > 1, image))
    else:
        process_meta["process_segmentation_stitch"] = False

    model = load_model(config.model_fn, dtype=config.dtype)
    postprocess_config = config.postprocess or DEFAULT_POSTPROCESS

    regions = None
    if getattr(config, "device_blend", True) and config.full_frame_archive_fn is None:
        labels, props, n_regions, regions = DeviceTiledSegmentation(
            image, model, config, postprocess_config, device=device, mesh=mesh
        )
    else:
        # Host blend: the debug archive needs the blended prediction on the
        # host.
        with TiledPipeline(
            (config.tile_size, config.tile_size),
            image,
            tile_stride=(config.tile_stride, config.tile_stride),
            blend_strategy="linear",
        ):
            # Skip empty tiles (no pixels above zero).
            Filter(Call(lambda img: bool((np.asarray(img) > 0).any()), image))
            batch_size = config.batch_size or 8
            if mesh is not None:
                # Each device needs a full share: round the batch up.
                batch_size = -(-batch_size // mesh.size) * mesh.size
            foreground_pred = TorchInference(
                model, image, batch_size=batch_size, transfer_dtype=np.float16, device=device, mesh=mesh
            )
            # Single foreground channel: channel 0 of the sigmoid output.
            foreground_pred = Call(lambda p: np.asarray(p)[..., 0].astype(np.float32), foreground_pred)

        labels, props, n_regions = DeviceFramePostprocess(
            foreground_pred, image, postprocess_config, device=device, mesh=mesh
        )
        if config.full_frame_archive_fn is not None:
            _build_full_frame_debug_output(config, target_dir, image, foreground_pred, labels, meta)
            StreamBuffer(2)

    region = FindRegions(
        labels,
        image,
        padding=config.padding,
        min_intensity=config.min_intensity,
        props=props,
        regions=regions,
    )

    def recalc_metadata(region, m):
        m = dict(m)
        y0, x0, y1, x1 = region.bbox
        m["object_posx"] = x0
        m["object_posy"] = y0
        m["object_sequence"] = int(region.label)
        m["object_width"] = x1 - x0
        m["object_height"] = y1 - y0
        m["object_id"] = format_object_id(m)
        m["object_frac_invalid"] = float(
            (np.asarray(region.image_intensity)[region.image] == 0).mean()
        )
        return m

    with contextlib.ExitStack() as region_stack:
        if config.n_threads > 1:
            region_stack.enter_context(DataParallelPipeline(executor=config.n_threads))
        roi = ExtractROI(
            image,
            region,
            alpha=1 if config.apply_mask else 0,
            bg_color=config.background_color,
            keep_background=config.keep_background,
            labels=labels,
        )
        meta = Call(recalc_metadata, region, meta)
        meta = CalculateZooProcessFeatures(region, meta, prefix="object_")
        mask = Call(lambda r: r.image, region)

    return roi, meta, mask


def _build_full_frame_debug_output(config, target_dir, image, foreground_pred, labels, meta):
    """Debug archive with input / label-overlay / score images per frame
    (the JAX package's ``_build_full_frame_debug_output``)."""

    def label_overlay(lab, img):
        import cv2

        lab = np.asarray(lab)
        img = np.asarray(img)
        # Shape guard, parity with the reference's assert_compatible_shape.
        if lab.shape[:2] != img.shape[:2]:
            raise ValueError(f"labels {lab.shape} and image {img.shape} are incompatible")
        norm = (lab * 37 % 255).astype(np.uint8)
        color = cv2.applyColorMap(norm, cv2.COLORMAP_JET)
        color[lab == 0] = 0
        base = np.stack([img] * 3, axis=-1) if img.ndim == 2 else img
        out = (0.5 * base + 0.5 * color).astype(np.uint8)
        out[lab == 0] = base[lab == 0]
        return out

    segment_image = Call(label_overlay, labels, image)
    score_image = Call(lambda p: np.clip(np.asarray(p) * 255, 0, 255).astype(np.uint8), foreground_pred)
    archive_fn = Call(lambda m: os.path.join(target_dir, config.full_frame_archive_fn.format_map(m)), meta)
    frame_id = Call(lambda m: m["object_frame_id"], meta)
    EcotaxaWriter(
        archive_fn,
        [
            ("img/" + frame_id + ".png", image),
            ("overlay/" + frame_id + ".png", segment_image),
            ("score/" + frame_id + ".png", score_image),
        ],
    )
