"""Region pipelines: batching, data-parallel threads, error absorption.

Capability parity (SURVEY.md §2b):

* :class:`BatchedPipeline` — groups objects into :class:`~.batch.Batch` es for
  the enclosed nodes, then unbatches.
* :class:`DataParallelPipeline` — thread-parallel execution of the enclosed
  region. On TPU the preferred construct is a batched device stage (one model,
  sharded batch; see :mod:`..models.inference`), but this exists for
  CPU-bound host regions (decode, compression).
* :class:`MergeNodesPipeline` — per-object error absorption: an exception
  while processing one object drops the object and invokes a handler.
* :class:`AggregateErrorsPipeline` — collect per-object exceptions and raise
  them together (as an ExceptionGroup) when the stream ends.

Copy of ``maze_image_processing_pipeline_tpu/engine/pipelines.py`` for the PyTorch port,
which imports nothing of the JAX package; only imports differ.
``tests/test_torch_host_copies.py`` holds the two equal.
"""

from __future__ import annotations

import logging
import queue
import threading
from typing import Callable, List, Optional, Tuple

from .batch import Batch
from .core import Pipeline, Stream, StreamObject, closing_if_closable

logger = logging.getLogger(__name__)

__all__ = [
    "BatchedPipeline",
    "DataParallelPipeline",
    "MergeNodesPipeline",
    "AggregateErrorsPipeline",
]


class BatchedPipeline(Pipeline):
    """Group up to ``batch_size`` objects into one batched object for the region.

    Inside the region, every variable value present on the member objects is a
    :class:`Batch` (list) of the members' values. Variables *newly assigned*
    inside the region are distributed back element-wise if they hold a Batch
    of matching length, or broadcast otherwise.
    """

    def __init__(self, batch_size: int) -> None:
        if batch_size <= 0:
            raise ValueError("batch_size must be positive")
        self.batch_size = batch_size
        super().__init__()

    def transform_stream(self, stream: Stream) -> Stream:
        def batched(stream: Stream):
            with closing_if_closable(stream):
                members: List[StreamObject] = []
                for obj in stream:
                    members.append(obj)
                    if len(members) >= self.batch_size:
                        yield self._merge(members)
                        members = []
                if members:
                    yield self._merge(members)

        inner = self._chain_children(batched(stream))

        for merged in inner:
            yield from self._split(merged)

    @staticmethod
    def _merge(members: List[StreamObject]) -> StreamObject:
        keys = set()
        for m in members:
            keys.update(m.values.keys())
        values = {
            k: Batch([m.values.get(k) for m in members]) for k in keys
        }
        merged = StreamObject(values, n_remaining_hint=members[0].n_remaining_hint)
        merged.values[_MEMBERS_KEY] = members  # type: ignore[index]
        return merged

    @staticmethod
    def _split(merged: StreamObject):
        members: List[StreamObject] = merged.values.pop(_MEMBERS_KEY)  # type: ignore[arg-type]
        n = len(members)
        for k, v in merged.values.items():
            if isinstance(v, Batch) and len(v) == n:
                for m, item in zip(members, v):
                    m.values[k] = item
            else:
                for m in members:
                    m.values[k] = v
        yield from members


# Sentinel key (negative, never collides with Variable ids) for batch members.
_MEMBERS_KEY = -1


class DataParallelPipeline(Pipeline):
    """Run the enclosed region in N worker threads, preserving stream order.

    Each object is processed through the region *independently* (the region's
    nodes are shared between threads and must be thread-compatible; the
    built-in per-object nodes are). Results carry their input sequence number
    and are re-emitted in input order through a reordering buffer, so
    stateful order-dependent downstream stages (Stitch grouping, dedup,
    HDF5 append — the reference places all three after its
    ``DataParallelPipeline``, ``predict/pipeline.py:692``) stay correct.

    Set ``preserve_order=False`` to emit in completion order (slightly lower
    latency when downstream is order-independent).
    """

    _SENTINEL = object()

    def __init__(
        self, executor: int = 2, queue_size: int = 4, preserve_order: bool = True
    ) -> None:
        self.n_workers = int(executor)
        self.queue_size = queue_size
        self.preserve_order = preserve_order
        super().__init__()

    def transform_stream(self, stream: Stream) -> Stream:
        if self.n_workers <= 1:
            yield from self._chain_children(stream)
            return

        in_q: "queue.Queue" = queue.Queue(maxsize=self.queue_size)
        # Bounded: workers block here when the consumer is slow, which also
        # bounds the reordering buffer (≤ in_q + out_q + n_workers items).
        out_q: "queue.Queue" = queue.Queue(maxsize=self.queue_size)
        errors: List[BaseException] = []
        n_workers = self.n_workers
        stop = threading.Event()

        def put(q, item) -> bool:
            # Shutdown-aware bounded put (same defect class as
            # StreamBuffer): without it, early consumer termination leaves
            # feeder/workers blocked on full queues forever, leaking the
            # threads and skipping upstream finalizers.
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def feeder() -> None:
            try:
                with closing_if_closable(stream):
                    for seq, obj in enumerate(stream):
                        if not put(in_q, (seq, obj)):
                            return
            except BaseException as exc:  # noqa: BLE001
                errors.append(exc)
            finally:
                for _ in range(n_workers):
                    if not put(in_q, self._SENTINEL):
                        break

        def worker() -> None:
            try:
                while not stop.is_set():
                    try:
                        item = in_q.get(timeout=0.1)
                    except queue.Empty:
                        continue
                    if item is self._SENTINEL:
                        return
                    seq, obj = item
                    try:
                        results = list(self._chain_children(iter([obj])))
                    except BaseException as exc:  # noqa: BLE001
                        errors.append(exc)
                        results = []
                    if not put(out_q, (seq, results)):
                        return
            finally:
                put(out_q, self._SENTINEL)

        threads = [threading.Thread(target=feeder, daemon=True, name="dp-feeder")]
        threads += [
            threading.Thread(target=worker, daemon=True, name=f"dp-worker-{i}")
            for i in range(n_workers)
        ]
        for t in threads:
            t.start()

        finished = 0
        reorder: dict = {}
        next_seq = 0
        try:
            while finished < n_workers:
                item = out_q.get()
                if item is self._SENTINEL:
                    finished += 1
                    continue
                seq, results = item
                if self.preserve_order:
                    reorder[seq] = results
                    while next_seq in reorder:
                        yield from reorder.pop(next_seq)
                        next_seq += 1
                else:
                    yield from results
            for seq in sorted(reorder):  # pragma: no cover - safety drain
                yield from reorder.pop(seq)
            if errors:
                raise errors[0]
        finally:
            stop.set()
            for t in threads:
                t.join(timeout=5)


class MergeNodesPipeline(Pipeline):
    """Per-object error absorption region.

    The enclosed nodes are applied to each object individually; if any raises,
    the object is dropped and ``on_error(exc, *resolved_on_error_args)`` is
    called (reference usage: skip unreadable images,
    ``loki/pipeline.py:914-921``).
    """

    def __init__(
        self,
        on_error: Optional[Callable] = None,
        on_error_args: Tuple = (),
    ) -> None:
        self.on_error = on_error
        self.on_error_args = on_error_args
        super().__init__()

    def transform_stream(self, stream: Stream) -> Stream:
        with closing_if_closable(stream):
            for obj in stream:
                try:
                    results = list(self._chain_children(iter([obj])))
                except Exception as exc:  # noqa: BLE001 - absorbed by contract
                    if self.on_error is not None:
                        args = [self._resolve(obj, a) for a in self.on_error_args]
                        self.on_error(exc, *args)
                    else:
                        logger.error("Dropping object after error", exc_info=True)
                    continue
                yield from results


try:  # ExceptionGroup is a 3.11+ builtin; pyproject declares >=3.10.
    _ExceptionGroup = ExceptionGroup
except NameError:  # pragma: no cover - Python 3.10

    class _ExceptionGroup(Exception):
        def __init__(self, message, exceptions):
            super().__init__(message)
            self.exceptions = tuple(exceptions)


class AggregateErrorsPipeline(Pipeline):
    """Collect per-object errors; raise them together at end of stream."""

    def __init__(self, max_errors: int = 100) -> None:
        self.max_errors = max_errors
        super().__init__()

    def transform_stream(self, stream: Stream) -> Stream:
        errors: List[Exception] = []
        with closing_if_closable(stream):
            for obj in stream:
                try:
                    results = list(self._chain_children(iter([obj])))
                except Exception as exc:  # noqa: BLE001 - aggregated by contract
                    errors.append(exc)
                    if len(errors) >= self.max_errors:
                        break
                    continue
                yield from results

        if errors:
            raise _ExceptionGroup(
                f"{len(errors)} object(s) failed in {type(self).__name__}", errors
            )
