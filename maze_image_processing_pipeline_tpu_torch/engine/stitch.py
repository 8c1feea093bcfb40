"""Frame reconstruction from stored crops ("stitching").

Capability parity: ``morphocut.stitch.Stitch`` as used at
``loki/pipeline.py:477-481`` — consecutive stream objects with equal
``groupby`` key are pasted into one full-frame canvas at their
``(offset_y, offset_x)`` positions; one object per frame is emitted, keeping
the first member's other variables. The stitched value exposes
``n_regions`` (used by the ``skip_single`` debug filter,
``loki/pipeline.py:483-485``).

Copy of ``maze_image_processing_pipeline_tpu/engine/stitch.py`` for the PyTorch port,
which imports nothing of the JAX package; only imports differ.
``tests/test_torch_host_copies.py`` holds the two equal.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from .core import Node, Output, RawOrVariable, ReturnOutputs, Stream, closing_if_closable
from .stream import StreamEstimator, stream_groupby

__all__ = ["Stitch", "StitchedImage"]


class StitchedImage(np.ndarray):
    """ndarray subclass carrying the number of stitched source regions.

    ``sources`` (set only on the instance Stitch emits, not on derived
    views) holds the pasted ``[(crop, oy, ox), ...]`` in paste order plus
    the fill value: device consumers (``loki.device_seg``) upload the
    crops and re-compose on the accelerator instead of shipping the
    mostly-background canvas (~1% occupancy on LOKI frames) through a
    bandwidth-bound host→device link. Composition on device reproduces
    the exact last-write-wins paste below."""

    n_regions: int = 1
    sources = None
    fill_value = 0

    def __array_finalize__(self, obj):
        if obj is not None:
            self.n_regions = getattr(obj, "n_regions", 1)


@ReturnOutputs
@Output("image")
class Stitch(Node):
    """Reassemble full frames from crops grouped by a frame key."""

    def __init__(
        self,
        image: RawOrVariable[np.ndarray],
        groupby: RawOrVariable,
        offset: Tuple[RawOrVariable[int], RawOrVariable[int]],
        fill_value: float = 0,
    ) -> None:
        self.image = image
        self.groupby = groupby
        self.offset = offset
        self.fill_value = fill_value
        super().__init__()

    def transform_stream(self, stream: Stream) -> Stream:
        est = StreamEstimator()
        with closing_if_closable(stream):
            for _key, substream in stream_groupby(stream, self.groupby):
                members = []
                incoming = None
                for obj in substream:
                    image = self.prepare_input(obj, "image")
                    oy, ox = self.prepare_input(obj, "offset")
                    # Consume once per member (not once per group): the
                    # estimator's emit/consume rate must reflect the
                    # crops-per-frame contraction, or downstream
                    # ETA/totals inflate by that factor.
                    incoming = est.consume(obj.n_remaining_hint)
                    members.append((obj, np.asarray(image), int(oy), int(ox)))

                if not members:
                    continue

                H = max(oy + img.shape[0] for _, img, oy, _ in members)
                W = max(ox + img.shape[1] for _, img, _, ox in members)
                extra = members[0][1].shape[2:]
                dtype = members[0][1].dtype

                canvas = np.full((H, W) + extra, self.fill_value, dtype=dtype)
                for _, img, oy, ox in members:
                    canvas[oy : oy + img.shape[0], ox : ox + img.shape[1]] = img

                stitched = canvas.view(StitchedImage)
                stitched.n_regions = len(members)
                stitched.sources = [
                    (img, oy, ox) for _, img, oy, ox in members
                ]
                stitched.fill_value = self.fill_value

                first = members[0][0]
                out = first.copy()
                out[self.output_vars[0]] = stitched
                out.n_remaining_hint = incoming.emit()
                yield out
