"""Bridge-merging of nearby labelled segments.

Counterpart of ``maze_image_processing_pipeline_tpu/ops/merge_labels.py``
(reference ``maze_ipp/merge_labels.py:29-113``, used by the segmentation
post-processing at ``loki/pipeline.py:451-457``): segments closer than
``max_distance`` are unified, their closest points joined by a bridge whose
width ``path_tolerance`` sets.

The per-label distance fields, the expensive part, are computed for all
labels in one batched device call (:func:`.edt.squared_edt` over the label
masks); the greedy nearest-first merge loop (data-dependent, small) runs on
the host over the fetched fields, as the original's does, with the same
numpy code.
"""

from __future__ import annotations

import math
from typing import List, Optional

import numpy as np
import torch

from .edt import squared_edt

__all__ = ["merge_labels"]


def _label_distance_fields(labels: np.ndarray, ids: np.ndarray, bound: int, device) -> np.ndarray:
    """(R, H, W) float32 distance-to-label fields in one device call."""
    with torch.inference_mode():
        lab = torch.from_numpy(np.ascontiguousarray(labels)).to(device)
        masks = lab[None, :, :] == torch.from_numpy(ids).to(device)[:, None, None]
        sq = squared_edt(masks, bound).cpu().numpy()
    return np.sqrt(sq.astype(np.float32))


def merge_labels(
    labels: np.ndarray,
    index: Optional[List[int]] = None,
    max_distance: Optional[float] = None,
    path_tolerance: float = 5,
    return_merge_distances: bool = False,
    labels_out: Optional[np.ndarray] = None,
    device="cuda",
):
    """Merge neighbouring labels by bridging their closest points.

    Args:
        labels: 2D label image (numpy).
        index: labels to process (default: all positive labels).
        max_distance: maximum gap distance to merge; None merges everything.
        path_tolerance: widens the bridge (sum-of-distances band).
        return_merge_distances: additionally return the gap distance at which
            each merge happened.
        labels_out: optional output buffer (defaults to a copy).
        device: the torch device of the distance fields; the card unless the
            caller asks for the CPU.

    Returns:
        labels_out, and merge_distances if requested.
    """
    from ..models.inference import resolve_device

    device = resolve_device(device)
    labels = np.asarray(labels)
    if index is None:
        uniq = np.unique(labels)
        index = [int(v) for v in uniq[uniq > 0]]
    else:
        index = [int(v) for v in index]

    if labels_out is not None and labels_out is not labels:
        # The early return below must hand back the input labels, not an
        # untouched (possibly uninitialized) caller buffer.
        np.copyto(labels_out, labels)
    if return_merge_distances:
        empty_result = (labels if labels_out is None else labels_out, [])
    else:
        empty_result = labels if labels_out is None else labels_out
    if len(index) < 2:
        return empty_result

    if labels_out is None:
        labels_out = labels.copy()

    H, W = labels.shape
    if max_distance is None:
        bound = int(math.ceil(math.hypot(H, W)))
    else:
        bound = int(math.ceil(max_distance + path_tolerance)) + 1

    ids = np.asarray(index, dtype=labels.dtype)
    fields = _label_distance_fields(labels, ids, bound, device)  # (R, H, W)
    field_of = {lab_id: fields[i] for i, lab_id in enumerate(index)}

    # Seed the cluster with the first label.
    first = index.pop(0)
    labels_out[labels == first] = first

    distmap = field_of[first].copy()
    max_dist = float(distmap.max())
    labelmap = np.full(labels.shape, first, dtype=labels.dtype)

    merge_distances: List[float] = []

    while index:
        # Unmerged label nearest to the current cluster.
        nearest_pos = int(
            np.argmin(
                [distmap[labels == lab_id].min(initial=max_dist) for lab_id in index]
            )
        )
        cur = index.pop(nearest_pos)
        cur_dist = field_of[cur]

        total = distmap + cur_dist
        merge_dist = float(total.min())

        if max_distance is not None and merge_dist > max_distance:
            # Greedy order guarantees no later candidate is nearer.
            break

        bridge = (labels == cur) | (total <= merge_dist + path_tolerance)
        merge_distances.append(merge_dist)

        target_labels = np.unique(labelmap[bridge])
        target = int(target_labels[0])
        if len(target_labels) > 1:
            # The bridge band touched more than one cluster member; keep the
            # nearest one (smallest distance at the meeting point).
            meet = np.unravel_index(np.argmin(total), total.shape)
            target = int(labelmap[meet])

        labels_out[bridge] = target

        closer = cur_dist < distmap
        labelmap[closer] = target
        distmap[closer] = cur_dist[closer]

    if return_merge_distances:
        return labels_out, merge_distances
    return labels_out
