"""Frame-to-frame duplicate detection ("zoomie"): re-imaged organism tracking.

Capability parity with ``maze_ipp/loki/zoomie2.py`` (SURVEY.md §2a row 8):
LOKI photographs the same organism on consecutive frames as it drifts
through the imaging channel; these nodes link such re-detections into
duplicate sets so only the first instance is exported.

* :class:`DetectDuplicatesSimple` — cheap per-frame matcher scoring object
  pairs with a caller-provided function (bbox IoU in the loki pipeline),
  solved as an assignment problem (Hungarian), with age-based eviction.
* :class:`DetectDuplicates` — the feature-based variant: ORB keypoints +
  descriptor matching + robust (RANSAC) euclidean-transform fitting, with
  an optional cheap pre-score stage (OpenCV replaces the reference's
  scikit-image ORB/ransac stack).
* :class:`StoreDupsets` — debug dump of duplicate sets as image folders.

These are inherently *stateful, order-dependent* host stages (SURVEY.md
§3.4); they sit downstream of the device stages and overlap with TPU work
through stream buffers.

Copy of ``maze_image_processing_pipeline_tpu/loki/zoomie.py`` for the PyTorch port,
which imports nothing of the JAX package; only imports differ.
``tests/test_torch_host_copies.py`` holds the two equal.
"""

from __future__ import annotations

import logging
import os
from typing import Any, Callable, Iterable, List, Optional, Tuple, TypeVar

import numpy as np
from scipy.optimize import linear_sum_assignment
from scipy.spatial.distance import cdist

from ..engine.core import Node, Output, RawOrVariable, ReturnOutputs, Stream, closing_if_closable
from ..engine.stream import stream_groupby

logger = logging.getLogger(__name__)

T = TypeVar("T")

__all__ = [
    "DetectDuplicates",
    "DetectDuplicatesSimple",
    "StoreDupsets",
    "orb_detector_extractor",
    "match_descriptors_hungarian",
]


class _TrackedObject:
    __slots__ = ("id", "score_args", "img", "description", "age")

    def __init__(self, id: Any, score_args: Any, img=None, description=None) -> None:
        self.id = id
        self.score_args = score_args
        self.img = img
        self.description = description
        self.age = 0


def orb_detector_extractor(img: np.ndarray, n_keypoints: int = 100):
    """ORB keypoints + binary descriptors via OpenCV.

    Replaces the scikit-image ORB detector of the reference
    (``zoomie2.py:148-151``, ``loki/pipeline.py:685-699``).
    """
    import cv2

    img = np.asarray(img)
    if img.dtype != np.uint8:
        img = np.clip(img, 0, 255).astype(np.uint8)
    orb = cv2.ORB_create(nfeatures=n_keypoints)
    keypoints, descriptors = orb.detectAndCompute(img, None)
    if not keypoints or descriptors is None:
        return None
    pts = np.array([kp.pt[::-1] for kp in keypoints], dtype=np.float32)  # (row, col)
    return pts, descriptors


def match_descriptors_hungarian(desc0, desc1, metric: Optional[str] = None, quantile: float = 0.9):
    """One-to-one descriptor matching via the assignment problem.

    Returns index pairs (i, j); the worst ``1-quantile`` matches by distance
    are discarded (contract of ``zoomie2.py:74-89``).
    """
    if metric is None:
        metric = "hamming" if np.issubdtype(np.asarray(desc0).dtype, np.bool_) else "euclidean"
    distances = cdist(
        np.unpackbits(desc0, axis=1) if desc0.dtype == np.uint8 and metric == "hamming" else desc0,
        np.unpackbits(desc1, axis=1) if desc1.dtype == np.uint8 and metric == "hamming" else desc1,
        metric=metric,
    )
    ii, jj = linear_sum_assignment(distances)
    if quantile < 1.0:
        keep = distances[ii, jj].argsort().argsort() < len(ii) * quantile
        ii, jj = ii[keep], jj[keep]
    return np.column_stack((ii, jj))


def _feature_match_score(description0, description1) -> float:
    """Inlier ratio of a RANSAC-estimated euclidean transform between matches."""
    import cv2

    if description0 is None or description1 is None:
        return 0.0
    pts0, desc0 = description0
    pts1, desc1 = description1
    matches = match_descriptors_hungarian(desc0, desc1, metric="hamming")
    if matches.shape[0] < 3:
        return 0.0

    src = pts0[matches[:, 0]][:, ::-1]  # (x, y) for OpenCV
    dst = pts1[matches[:, 1]][:, ::-1]
    m, inliers = cv2.estimateAffinePartial2D(
        src, dst, method=cv2.RANSAC, ransacReprojThreshold=3.0, maxIters=100
    )
    if inliers is None:
        return 0.0
    return float(inliers.mean())


class _SimpleMatcher:
    """Hungarian matching of current-frame objects against recent objects."""

    def __init__(self, score_fn: Callable[[T, T], float], min_similarity: float, max_age: int):
        self.score_fn = score_fn
        self.min_similarity = min_similarity
        self.max_age = max_age
        self._prev: List[_TrackedObject] = []

    def match_and_update(self, ids: Iterable, score_args: Iterable) -> List:
        new_objects = [_TrackedObject(i, s) for i, s in zip(ids, score_args)]

        if self._prev:
            sim = np.zeros((len(self._prev), len(new_objects)))
            for i, prev in enumerate(self._prev):
                for j, cur in enumerate(new_objects):
                    sim[i, j] = self.score_fn(prev.score_args, cur.score_args)

            ii, jj = linear_sum_assignment(sim, maximize=True)
            for i, j in zip(ii, jj):
                if sim[i, j] >= self.min_similarity:
                    logger.debug(
                        "'%s' is dup of '%s' (%.2f)",
                        new_objects[j].id,
                        self._prev[i].id,
                        sim[i, j],
                    )
                    new_objects[j].id = self._prev[i].id

        self._advance(new_objects)
        return [o.id for o in new_objects]

    def _advance(self, new_objects: List[_TrackedObject]) -> None:
        kept = {}
        for o in self._prev:
            o.age += 1
            if o.age <= self.max_age:
                kept[o.id] = o
        for o in new_objects:
            kept[o.id] = o
        self._prev = list(kept.values())


class _FeatureMatcher(_SimpleMatcher):
    """Two-stage matcher: cheap pre-score, then ORB/RANSAC feature matching.

    Feature extraction and pairwise scoring run in a thread pool when
    ``n_workers > 1`` (the parallel analog of the reference's
    ProcessPoolExecutor at ``zoomie2.py:196-298``; cv2/scipy release the GIL
    in the hot native code, so threads avoid the pickling cost of processes).
    """

    def __init__(
        self,
        min_similarity: float = 0.25,
        detector_extractor: Optional[Callable] = None,
        pre_score_fn: Optional[Callable] = None,
        pre_score_thr: Optional[float] = None,
        combine_score_fn: Optional[Callable] = None,
        max_age: int = 1,
        n_workers: int = 0,
    ):
        self.detector_extractor = detector_extractor or orb_detector_extractor
        self.pre_score_fn = pre_score_fn
        self.pre_score_thr = pre_score_thr
        # Optional (feature_score, prev_args, cur_args) -> score hook: the
        # reference's _match_pair combines geometric plausibility into the
        # stage-2 feature score (zoomie2.py:130-140); without it the final
        # match is pure ORB/RANSAC inlier ratio.
        self.combine_score_fn = combine_score_fn
        self.min_similarity = min_similarity
        self.max_age = max_age
        self._prev: List[_TrackedObject] = []
        self._pool = None
        if n_workers > 1:
            from concurrent.futures import ThreadPoolExecutor

            self._pool = ThreadPoolExecutor(n_workers, thread_name_prefix="zoomie")

    def _map(self, fn, items):
        items = list(items)
        if self._pool is not None and len(items) > 1:
            return list(self._pool.map(fn, items))
        return [fn(it) for it in items]

    def match_and_update(self, ids, images, score_args) -> List:
        new_objects = [
            _TrackedObject(i, s, img=img)
            for i, img, s in zip(ids, images, score_args)
        ]

        if not self._prev:
            self._advance(new_objects)
            return [o.id for o in new_objects]

        prev_matched, new_matched = set(), set()
        # Stage 1: cheap geometric pre-matching.
        if self.pre_score_fn is not None and self.pre_score_thr is not None:
            sim = np.zeros((len(self._prev), len(new_objects)))
            for i, prev in enumerate(self._prev):
                for j, cur in enumerate(new_objects):
                    sim[i, j] = self.pre_score_fn(prev.score_args, cur.score_args)
            ii, jj = linear_sum_assignment(sim, maximize=True)
            for i, j in zip(ii, jj):
                if sim[i, j] >= self.pre_score_thr:
                    new_objects[j].id = self._prev[i].id
                    prev_matched.add(i)
                    new_matched.add(j)

        # Stage 2: feature matching for still-unmatched pairs (parallel).
        need_prev = [
            p
            for i, p in enumerate(self._prev)
            if i not in prev_matched and p.description is None
        ]
        need_new = [c for j, c in enumerate(new_objects) if j not in new_matched]
        for o, desc in zip(
            need_prev + need_new,
            self._map(self.detector_extractor, (o.img for o in need_prev + need_new)),
        ):
            o.description = desc

        pairs = [
            (i, j)
            for i in range(len(self._prev))
            if i not in prev_matched
            for j in range(len(new_objects))
            if j not in new_matched
        ]
        def pair_score(ij):
            i, j = ij
            score = _feature_match_score(
                self._prev[i].description, new_objects[j].description
            )
            if self.combine_score_fn is not None:
                score = self.combine_score_fn(
                    score,
                    self._prev[i].score_args,
                    new_objects[j].score_args,
                )
            return score

        scores = self._map(pair_score, pairs)
        sim = np.zeros((len(self._prev), len(new_objects)))
        for (i, j), s in zip(pairs, scores):
            sim[i, j] = s

        ii, jj = linear_sum_assignment(sim, maximize=True)
        for i, j in zip(ii, jj):
            if sim[i, j] >= self.min_similarity:
                new_objects[j].id = self._prev[i].id

        self._advance(new_objects)
        return [o.id for o in new_objects]


@ReturnOutputs
@Output("dupset_id")
class DetectDuplicatesSimple(Node):
    """Assign duplicate-set ids using a pairwise score function per frame.

    Objects sharing a ``groupby`` key form one frame; consecutive frames are
    matched (Hungarian, ``score_fn`` e.g. bbox IoU) and matched objects
    inherit the earlier object's id as ``dupset_id``.
    """

    def __init__(
        self,
        groupby: RawOrVariable,
        image_id: RawOrVariable,
        score_fn: Callable[[T, T], float],
        score_arg: RawOrVariable[T] = None,
        min_similarity: float = 0.95,
        max_age: int = 1,
    ) -> None:
        self.groupby = groupby
        self.image_id = image_id
        self.score_fn = score_fn
        self.score_arg = score_arg
        self.min_similarity = min_similarity
        self.max_age = max_age
        super().__init__()

    def transform_stream(self, stream: Stream) -> Stream:
        matcher = _SimpleMatcher(self.score_fn, self.min_similarity, self.max_age)
        with closing_if_closable(stream):
            for _key, substream in stream_groupby(stream, self.groupby):
                group = [
                    (obj, *self.prepare_input(obj, ("image_id", "score_arg")))
                    for obj in substream
                ]
                if not group:
                    continue
                objs, ids, args = zip(*group)
                dupset_ids = matcher.match_and_update(ids, args)
                for obj, dupset_id in zip(objs, dupset_ids):
                    yield self.prepare_output(obj, dupset_id)


@ReturnOutputs
@Output("dupset_id")
class DetectDuplicates(Node):
    """Feature-based duplicate detection (ORB + RANSAC inlier scoring)."""

    def __init__(
        self,
        image_id: RawOrVariable,
        image: RawOrVariable[np.ndarray],
        groupby: RawOrVariable,
        score_fn: Optional[Callable] = None,
        score_arg: RawOrVariable = None,
        pre_score_thr: Optional[float] = None,
        combine_score_fn: Optional[Callable] = None,
        min_similarity: float = 0.25,
        detector_extractor: Optional[Callable] = None,
        max_age: int = 1,
        n_workers: Optional[int] = None,
    ) -> None:
        self.image_id = image_id
        self.image = image
        self.groupby = groupby
        self.score_fn = score_fn
        self.combine_score_fn = combine_score_fn
        self.score_arg = score_arg
        self.pre_score_thr = pre_score_thr
        self.min_similarity = min_similarity
        self.detector_extractor = detector_extractor
        self.max_age = max_age
        self.n_workers = (os.cpu_count() or 1) if n_workers is None else n_workers
        super().__init__()

    def transform_stream(self, stream: Stream) -> Stream:
        matcher = _FeatureMatcher(
            min_similarity=self.min_similarity,
            detector_extractor=self.detector_extractor,
            pre_score_fn=self.score_fn,
            pre_score_thr=self.pre_score_thr,
            combine_score_fn=self.combine_score_fn,
            max_age=self.max_age,
            n_workers=self.n_workers,
        )
        with closing_if_closable(stream):
            for _key, substream in stream_groupby(stream, self.groupby):
                group = [
                    (obj, *self.prepare_input(obj, ("image_id", "image", "score_arg")))
                    for obj in substream
                ]
                if not group:
                    continue
                objs, ids, images, args = zip(*group)
                dupset_ids = matcher.match_and_update(ids, images, args)
                for obj, dupset_id in zip(objs, dupset_ids):
                    yield self.prepare_output(obj, dupset_id)


class StoreDupsets(Node):
    """Debug: dump duplicate sets as per-dupset image folders.

    Parity with ``zoomie2.py:491-548``: masters (first instances) are saved
    once a duplicate appears; with ``save_singletons`` masters without any
    duplicates are stored flat in the output directory.
    """

    def __init__(
        self,
        image_id: RawOrVariable[str],
        dupset_id: RawOrVariable[str],
        image: RawOrVariable[np.ndarray],
        groupby: RawOrVariable[str],
        output_dir: str,
        save_singletons: bool = False,
    ) -> None:
        self.image_id = image_id
        self.dupset_id = dupset_id
        self.image = image
        self.groupby = groupby
        self.output_dir = output_dir
        self.save_singletons = save_singletons
        super().__init__()

    def transform_stream(self, stream: Stream) -> Stream:
        from ..dataio.imageio import encode_image

        def store(path: str, image_id: str, image) -> None:
            os.makedirs(path, exist_ok=True)
            with open(os.path.join(path, f"{image_id}.jpg"), "wb") as f:
                f.write(encode_image(np.asarray(image), f"{image_id}.jpg"))

        masters_old: dict = {}
        masters: dict = {}
        with closing_if_closable(stream):
            for _key, substream in stream_groupby(stream, self.groupby):
                for obj in substream:
                    image_id, dupset_id, image = self.prepare_input(
                        obj, ("image_id", "dupset_id", "image")
                    )
                    dupset_path = os.path.join(self.output_dir, str(dupset_id))
                    if image_id == dupset_id:
                        masters[image_id] = image
                    else:
                        store(dupset_path, image_id, image)
                        master_img = masters_old.pop(dupset_id, None)
                        if master_img is not None:
                            store(dupset_path, dupset_id, master_img)
                    yield obj

                if self.save_singletons:
                    for image_id, image in masters_old.items():
                        store(self.output_dir, image_id, image)
                masters_old = masters
                masters = {}
