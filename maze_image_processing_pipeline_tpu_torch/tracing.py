"""Program spans and counters: where a run's host time goes, layer by layer.

The Runners, the stream engine's queues, the device nodes, the norm and
labelling calls and the ``.h5`` writer mark their work with :func:`span`
and :func:`count`. Tracing is off unless something turns it on
(:func:`enable`; ``MAZE_IPP_TRACE_DIR`` and ``MAZE_IPP_PROFILE_DIR`` through
:mod:`.runner`), and off it costs a call and a dictionary lookup a span:
:func:`span` returns a shared no-op object (one a name), reads no clock and
opens no profiler annotation.

On, a span records its name, thread, start and end (``time.perf_counter_ns``),
its parent (the innermost span open on the same thread) and the unit it
belongs to (:func:`unit`: one ``_configure_and_run`` of a Runner, a haul or
an archive), into memory. Add :func:`clock_offset_ns` to a span's times to
place it on the profiler's clock (``time.time_ns``'s base, as kineto stamps
its events): the offset is measured when tracing is turned on. Only while
:func:`annotating` (``runner.profile_trace``) does every span also open a
``maze::<name>`` ``record_function``, so that it shows in the operator's
Chrome trace; an annotation's device-side copy would otherwise count as
device work in a trace that another profiler reads.

:data:`queue` stands in for the standard library's module where the engine
imports it (``engine/stream.py``): its ``Queue`` records a blocking ``get``
as a ``queue.get_wait`` span and a blocking ``put`` as ``queue.put_wait``,
each with the queue's ``maxsize``.

Span names: ``unit``, ``unit.build``, ``model.load``; ``queue.get_wait``,
``queue.put_wait``; ``loki.dispatch`` (``loki.tile_select``, ``loki.upload``,
``loki.forward``, ``loki.chain``), ``loki.finish`` (``loki.fetch_wait``,
``loki.crops``);
``predict.chunk`` (``predict.tile_cut``, ``predict.forward``, ``measure``),
``predict.unpack`` (``predict.fetch_wait``); ``group_norm``, ``label``;
``h5.create`` (``h5.pack``), ``h5.close``. Counters: ``frames``,
``frame_groups``, ``tiles``, ``tiles_skipped``, ``objects``, ``chunks``,
``canvases``, ``group_norm.bytes``, ``label.bytes``, ``h5.raw_bytes``,
``h5.stored_bytes`` and ``launches.<kernel>`` (every
``ops.row_scan.count_launch``).
"""

from __future__ import annotations

import contextlib
import functools
import itertools
import json
import logging
import os
import queue as _queue
import threading
import time
from collections import defaultdict
from types import SimpleNamespace
from typing import Callable, Dict, List, NamedTuple, Optional

__all__ = [
    "Span",
    "span",
    "count",
    "unit",
    "enable",
    "disable",
    "enabled",
    "reset",
    "spans",
    "counters",
    "take",
    "clock_offset_ns",
    "annotating",
    "export_units",
    "summary",
    "write_unit",
    "queue",
]

logger = logging.getLogger(__name__)

_on = False
_annotate = False
_spans: list = []
_counters: Dict[str, float] = {}
_count_lock = threading.Lock()
_ids = itertools.count(1)
_unit_ids = itertools.count(1)
_unit: Optional[int] = None
_local = threading.local()
_offset_ns: Optional[int] = None
_sinks: List[Callable[[int], None]] = []
_nulls: Dict[str, "_Null"] = {}


class Span(NamedTuple):
    """One recorded span; times in ``time.perf_counter_ns``'s base."""

    name: str
    id: int
    parent: int  # the id of the innermost span open on the same thread; 0 for none
    thread: int  # threading.get_ident() of the thread that ran it
    unit: Optional[int]  # the unit open when it started (:func:`unit`)
    start_ns: int
    end_ns: int
    attrs: Optional[dict]


def _traced(name: str, fn):
    """``fn`` inside a span ``name`` whenever tracing is on at the call."""

    @functools.wraps(fn)
    def traced(*args, **kwargs):
        if not _on:
            return fn(*args, **kwargs)
        with _Open(name, None):
            return fn(*args, **kwargs)

    return traced


class _Null:
    """What :func:`span` returns while tracing is off: a context manager that
    does nothing, and a decorator that traces the function's later calls."""

    __slots__ = ("name",)

    def __init__(self, name: str) -> None:
        self.name = name

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def __call__(self, fn):
        return _traced(self.name, fn)


def _stack() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


class _Open:
    """A span being recorded."""

    __slots__ = ("name", "attrs", "id", "parent", "unit", "start", "annotation")

    def __init__(self, name: str, attrs: Optional[dict]) -> None:
        self.name = name
        self.attrs = attrs

    def __enter__(self):
        stack = _stack()
        self.parent = stack[-1] if stack else 0
        self.id = next(_ids)
        self.unit = _unit
        stack.append(self.id)
        self.annotation = None
        if _annotate:
            import torch

            self.annotation = torch.profiler.record_function("maze::" + self.name)
            self.annotation.__enter__()
        self.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> bool:
        end = time.perf_counter_ns()
        if self.annotation is not None:
            self.annotation.__exit__(None, None, None)
        stack = _stack()
        if stack and stack[-1] == self.id:
            stack.pop()
        elif self.id in stack:
            stack.remove(self.id)
        _spans.append(Span(self.name, self.id, self.parent, threading.get_ident(), self.unit, self.start, end,
                           self.attrs))
        return False

    def __call__(self, fn):
        return _traced(self.name, fn)


def span(name: str, **attrs):
    """A span named ``name``: ``with span("x"):`` or ``@span("x")``.

    Off, the shared no-op object of the name; on, a span that records
    ``attrs`` with its times. A decorated function checks at each call."""
    if not _on:
        null = _nulls.get(name)
        if null is None:
            null = _nulls.setdefault(name, _Null(name))
        return null
    return _Open(name, attrs or None)


def count(name: str, n=1) -> None:
    """Add ``n`` to the counter ``name`` while tracing is on."""
    if _on:
        with _count_lock:
            _counters[name] = _counters.get(name, 0) + n


@contextlib.contextmanager
def unit(kind: str):
    """One unit of work (a Runner's ``_configure_and_run``): a new unit id
    for every span that starts inside, a ``unit`` span around it; at its
    end the sinks of :func:`export_units` run. Yields the id (None while
    tracing is off)."""
    global _unit
    if not _on:
        yield None
        return
    uid = next(_unit_ids)
    outer = _unit
    _unit = uid
    try:
        with _Open("unit", {"kind": kind}):
            yield uid
    finally:
        _unit = outer
        for sink in list(_sinks):
            sink(uid)


def _measure_offset() -> int:
    """``time.time_ns() - time.perf_counter_ns()``, from the tightest of a
    few back-to-back reads."""
    best = None
    for _ in range(8):
        p0 = time.perf_counter_ns()
        t = time.time_ns()
        p1 = time.perf_counter_ns()
        if best is None or p1 - p0 < best[0]:
            best = (p1 - p0, t - (p0 + p1) // 2)
    return best[1]


def enable() -> None:
    """Turn tracing on and measure the clock offset."""
    global _on, _offset_ns
    _offset_ns = _measure_offset()
    _on = True


def disable() -> None:
    """Turn tracing off; what was recorded stays until :func:`reset` or
    :func:`take`."""
    global _on
    _on = False


def enabled() -> bool:
    return _on


def reset() -> None:
    """Drop every recorded span and counter."""
    del _spans[:]
    with _count_lock:
        _counters.clear()


def spans() -> List[Span]:
    """The spans recorded so far, in the order they ended."""
    return list(_spans)


def counters() -> Dict[str, float]:
    with _count_lock:
        return dict(_counters)


def take():
    """(spans, counters) recorded so far, dropped from memory."""
    got = _spans[:]
    del _spans[: len(got)]
    with _count_lock:
        ctr = dict(_counters)
        _counters.clear()
    return got, ctr


def clock_offset_ns() -> int:
    """Nanoseconds to add to a span's times to place them on the
    profiler's clock (``time.time_ns``'s base), as measured by
    :func:`enable` (now, if tracing was never on)."""
    return _offset_ns if _offset_ns is not None else _measure_offset()


@contextlib.contextmanager
def annotating():
    """Tracing on for the block, every span also a ``maze::<name>``
    ``record_function`` for the profiler that runs around it. Where the
    block turned tracing on, its spans are dropped at the end (the profiler
    keeps them)."""
    global _annotate
    was_on, was_annotating = _on, _annotate
    if not was_on:
        enable()
    _annotate = True
    try:
        yield
    finally:
        _annotate = was_annotating
        if not was_on:
            disable()
            reset()


def summary(spans_: List[Span], counters_: Optional[Dict[str, float]] = None) -> dict:
    """Each span name's count and total and self milliseconds (self: less
    the time of its children, on its thread), longest total first, and the
    counters."""
    in_children: Dict[int, int] = defaultdict(int)
    for s in spans_:
        if s.parent:
            in_children[s.parent] += s.end_ns - s.start_ns
    by: Dict[str, list] = {}
    for s in spans_:
        d = s.end_ns - s.start_ns
        e = by.setdefault(s.name, [0, 0, 0])
        e[0] += 1
        e[1] += d
        e[2] += d - in_children.get(s.id, 0)
    return {
        "spans": {n: {"count": c, "total_ms": t / 1e6, "self_ms": st / 1e6}
                  for n, (c, t, st) in sorted(by.items(), key=lambda kv: -kv[1][1])},
        "counters": dict(sorted((counters_ or {}).items())),
    }


def write_unit(prefix: str, spans_: List[Span], counters_: Dict[str, float]) -> None:
    """``<prefix>.spans.jsonl`` (one span a line) and ``<prefix>.summary.json``
    (:func:`summary`)."""
    with open(prefix + ".spans.jsonl", "w") as f:
        for s in spans_:
            f.write(json.dumps(s._asdict()) + "\n")
    with open(prefix + ".summary.json", "w") as f:
        json.dump(summary(spans_, counters_), f, indent=1)


@contextlib.contextmanager
def export_units(directory: Optional[str], name: str):
    """Where ``directory`` is set, tracing on for the block; at the end of
    each unit its spans and counters go to ``<directory>/<name>-unit<id>``
    (:func:`write_unit`) and leave memory."""
    if not directory:
        yield None
        return
    logger.info("Writing the program's spans and counters of each unit to %s", directory)
    os.makedirs(directory, exist_ok=True)

    def sink(uid: int) -> None:
        write_unit(os.path.join(directory, f"{name}-unit{uid}"), *take())

    was_on = _on
    enable()
    _sinks.append(sink)
    try:
        yield directory
    finally:
        _sinks.remove(sink)
        if not was_on:
            disable()


class _Queue(_queue.Queue):
    """``queue.Queue`` whose blocking ``get`` and ``put`` record the time
    they waited while tracing is on."""

    def get(self, block=True, timeout=None):
        if not (_on and block):
            return super().get(block, timeout)
        try:
            return super().get(False)
        except _queue.Empty:
            pass
        with _Open("queue.get_wait", {"maxsize": self.maxsize}):
            return super().get(True, timeout)

    def put(self, item, block=True, timeout=None):
        if not (_on and block):
            return super().put(item, block, timeout)
        try:
            return super().put(item, False)
        except _queue.Full:
            pass
        with _Open("queue.put_wait", {"maxsize": self.maxsize}):
            return super().put(item, True, timeout)


# The names of the standard library's ``queue`` that the engine uses.
queue = SimpleNamespace(Queue=_Queue, Empty=_queue.Empty, Full=_queue.Full)
