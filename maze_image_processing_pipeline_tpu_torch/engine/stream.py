"""Stream utility nodes: fan-out, filtering, truncation, buffering, grouping.

Capability parity targets (see ``SURVEY.md`` §2b): ``Unpack``, ``Filter``,
``Slice``, ``StreamBuffer``, ``Progress``, ``stream_groupby`` and
``StreamEstimator`` (remaining-count propagation via ``n_remaining_hint``).

Copy of ``maze_image_processing_pipeline_tpu/engine/stream.py`` for the PyTorch port,
which imports nothing of the JAX package; only imports differ.
``tests/test_torch_host_copies.py`` holds the two equal. ``queue`` is
:data:`..tracing.queue`: ``StreamBuffer``'s queue records its blocking waits
as program spans while tracing is on.
"""

from __future__ import annotations

import threading
from typing import Any, Callable, Iterable, Optional, Tuple, Union

from ..tracing import queue
from .core import (
    Node,
    RawOrVariable,
    Stream,
    StreamObject,
    Variable,
    closing_if_closable,
)

__all__ = [
    "Unpack",
    "Filter",
    "Slice",
    "StreamBuffer",
    "Progress",
    "stream_groupby",
    "StreamEstimator",
]


class StreamEstimator:
    """Propagates remaining-object estimates through rate-changing nodes.

    A node that consumes objects (each carrying ``n_remaining_hint`` — the
    estimated number of objects *including itself* still to come) and emits a
    different number of objects uses this to attach updated hints to its
    output. The estimate is the observed global emit/consume ratio applied to
    the upstream hint.
    """

    def __init__(self) -> None:
        self.n_consumed = 0
        self.n_emitted = 0

    class _Incoming:
        def __init__(self, estimator: "StreamEstimator", hint: Optional[float]):
            self._est = estimator
            self._hint = hint
            self._emitted_here = 0

        def emit(self, n_to_come_local: Optional[float] = None) -> Optional[float]:
            """Return the ``n_remaining_hint`` for the next emitted object.

            Args:
                n_to_come_local: if known, the exact number of objects
                    (including this one) still to be emitted for the *current*
                    consumed object (e.g. remaining items of an Unpack
                    sequence).
            """
            est = self._est
            est.n_emitted += 1
            self._emitted_here += 1
            if self._hint is None:
                return None
            rate = est.n_emitted / max(est.n_consumed, 1)
            remaining_upstream = max(self._hint - 1, 0)
            if n_to_come_local is not None:
                return remaining_upstream * rate + n_to_come_local
            # Estimate: remaining upstream objects scaled by the observed
            # rate, plus nothing known about the current object's remainder.
            return max(remaining_upstream * rate, 1)

        def __enter__(self) -> "StreamEstimator._Incoming":
            return self

        def __exit__(self, *exc) -> None:
            pass

    def consume(self, n_remaining_hint: Optional[float]) -> "StreamEstimator._Incoming":
        self.n_consumed += 1
        return StreamEstimator._Incoming(self, n_remaining_hint)


class _UnpackNode(Node):
    """Fan out: one object becomes one object per element of a sequence.

    ``value = Unpack(collection)`` — ``collection`` may be a raw sequence or a
    Variable holding one; ``value`` is the per-element variable.
    """

    outputs = ("value",)

    def __init__(self, collection: RawOrVariable[Iterable]) -> None:
        self.collection = collection
        super().__init__()

    def transform_stream(self, stream: Stream) -> Stream:
        est = StreamEstimator()
        with closing_if_closable(stream):
            for obj in stream:
                collection = list(self.prepare_input(obj, "collection"))
                n = len(collection)
                with est.consume(obj.n_remaining_hint) as incoming:
                    for i, value in enumerate(collection):
                        new_obj = obj.copy()
                        new_obj[self.output_vars[0]] = value
                        new_obj.n_remaining_hint = incoming.emit(n_to_come_local=n - i)
                        yield new_obj


def Unpack(collection) -> Variable:
    """Insert an :class:`_UnpackNode`; returns the per-element Variable."""
    node = _UnpackNode(collection)
    return node.output_vars[0]


Unpack.node_class = _UnpackNode  # type: ignore[attr-defined]


class Filter(Node):
    """Keep only objects for which the predicate holds.

    Accepts either a Variable (truthiness decides), or a callable applied to
    the full :class:`StreamObject` (parity with the reference's
    ``Filter(lambda obj: obj[mask].any())`` usage).
    """

    def __init__(self, predicate: Union[Variable, Callable[[StreamObject], Any]]):
        self.predicate = predicate
        super().__init__()

    def transform_stream(self, stream: Stream) -> Stream:
        est = StreamEstimator()
        pred = self.predicate
        with closing_if_closable(stream):
            for obj in stream:
                with est.consume(obj.n_remaining_hint) as incoming:
                    if isinstance(pred, Variable):
                        keep = obj[pred]
                    else:
                        keep = pred(obj)
                    if not keep:
                        continue
                    obj.n_remaining_hint = incoming.emit()
                    yield obj


class Slice(Node):
    """Pass through only the first ``n`` objects (debug truncation)."""

    def __init__(self, n: int) -> None:
        self.n = n
        super().__init__()

    def transform_stream(self, stream: Stream) -> Stream:
        with closing_if_closable(stream):
            if self.n <= 0:
                return
            for i, obj in enumerate(stream):
                if obj.n_remaining_hint is not None:
                    obj.n_remaining_hint = min(obj.n_remaining_hint, self.n - i)
                yield obj
                # Stop right after the nth object: checking at the loop top
                # would pull (and fully compute) one extra upstream object
                # only to discard it.
                if i + 1 >= self.n:
                    break


class StreamBuffer(Node):
    """Decouple producer and consumer stages with a bounded queue + thread.

    This is the engine's pipeline-parallelism primitive: upstream nodes run in
    a background thread feeding a bounded queue so e.g. image decode, TPU
    inference and archive writing overlap (reference:
    ``morphocut.stream.StreamBuffer`` used at ``loki/pipeline.py:475,586,873,
    1156``).
    """

    _SENTINEL = object()

    def __init__(self, maxsize: int) -> None:
        self.maxsize = maxsize
        super().__init__()

    def transform_stream(self, stream: Stream) -> Stream:
        q: "queue.Queue" = queue.Queue(maxsize=self.maxsize)
        error: list = []
        stop = threading.Event()

        def put(item) -> bool:
            # Bounded-blocking put that notices consumer shutdown: a plain
            # q.put() would block forever when the consumer abandons the
            # generator early (Slice, downstream error), leaking the thread
            # and skipping every upstream finalizer (writer close, archive
            # finalize).
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def worker() -> None:
            try:
                with closing_if_closable(stream):
                    for obj in stream:
                        if not put(obj):
                            return  # consumer gone; context closes upstream
            except BaseException as exc:  # noqa: BLE001 - forwarded to consumer
                error.append(exc)
            finally:
                put(self._SENTINEL)

        thread = threading.Thread(target=worker, daemon=True, name="StreamBuffer")
        thread.start()

        try:
            while True:
                item = q.get()
                if item is self._SENTINEL:
                    break
                yield item
            if error:
                raise error[0]
        finally:
            stop.set()
            thread.join(timeout=5)


class Progress(Node):
    """Live progress display over the stream (TTY path).

    Uses :mod:`rich` when attached to a terminal; falls back to a plain
    counter. The non-TTY rate/ETA logger is
    :class:`maze_image_processing_pipeline_tpu.progress.LogProgress`.
    """

    def __init__(self, description: RawOrVariable[str] = "", monitor_interval: float = 0.1):
        self.description = description
        super().__init__()

    def transform_stream(self, stream: Stream) -> Stream:
        try:
            from tqdm import tqdm
        except ImportError:  # pragma: no cover
            tqdm = None

        if tqdm is None:  # pragma: no cover
            yield from stream
            return

        with closing_if_closable(stream):
            pbar = tqdm(unit="it")
            try:
                for obj in stream:
                    description = self.prepare_input(obj, "description")
                    if description:
                        pbar.set_description(str(description), refresh=False)
                    if obj.n_remaining_hint is not None:
                        pbar.total = pbar.n + obj.n_remaining_hint
                    pbar.update()
                    yield obj
            finally:
                pbar.close()


def stream_groupby(stream: Stream, by: Union[Variable, Tuple, Callable, None]):
    """Yield ``(key, substream)`` pairs of consecutive objects with equal key.

    ``by`` may be a Variable, a tuple of Variables/raws, or a callable on the
    StreamObject. Substreams must be consumed before advancing (as with
    :func:`itertools.groupby`).
    """

    def key_fn(obj: StreamObject):
        if isinstance(by, Variable):
            return obj[by]
        if isinstance(by, tuple):
            return tuple(obj[b] if isinstance(b, Variable) else b for b in by)
        if callable(by):
            return by(obj)
        return by

    stream = iter(stream)
    pending: list = []

    def substream(first_key):
        while True:
            if pending:
                obj = pending.pop()
            else:
                try:
                    obj = next(stream)
                except StopIteration:
                    return
            if key_fn(obj) != first_key:
                pending.append(obj)
                return
            yield obj

    while True:
        if pending:
            obj = pending.pop()
        else:
            try:
                obj = next(stream)
            except StopIteration:
                return
        key = key_fn(obj)
        pending.append(obj)
        sub = substream(key)
        yield key, sub
        # Drain any unconsumed remainder so grouping stays consistent.
        for _ in sub:
            pass
