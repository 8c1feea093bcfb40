"""Wrappers around named calls of the program: spans, call shapes and hooks.

A target is ``"<module>:<attribute path>"``; a ``@ReturnOutputs`` node is
reached through its ``node_class`` (``...device_seg:DeviceTiledSegmentation.
node_class._dispatch_group``). A wrapper adds no synchronisation: it reads
the host clock before and after the call and, while the profiler runs,
marks the call with ``record_function("bench::<span>")`` so that the device
operations it launched can be found in the trace.
"""

from __future__ import annotations

import functools
import importlib
import time
from collections import defaultdict
from typing import Callable, Dict, List, Optional, Tuple

import torch

PREFIX = "bench::"
HBM = 3.35e12  # bytes a second, H100 SXM HBM3: the memory rooflines' bound


def _resolve(target: str):
    module_name, path = target.split(":")
    owner = importlib.import_module(module_name)
    parts = path.split(".")
    for p in parts[:-1]:
        owner = getattr(owner, p)
    return owner, parts[-1]


def _summary(x):
    """(shape, bytes an element) of a tensor; None otherwise."""
    if isinstance(x, torch.Tensor):
        return tuple(x.shape), x.element_size()
    return None


class Recorder:
    """Installs wrappers and keeps what they record until :meth:`remove`.

    ``spans[name]`` holds the host-clock (start, end) of each call made while
    :attr:`active`; ``shapes[name]`` the (shape, element bytes) of its tensor
    arguments and of its result, where asked for."""

    def __init__(self) -> None:
        self.active = False
        self.profiling = False
        self.spans: Dict[str, List[Tuple[float, float]]] = defaultdict(list)
        self.shapes: Dict[str, List[tuple]] = defaultdict(list)
        self._undo: List[Tuple[object, str, object]] = []

    def wrap(self, target: str, span: Optional[str] = None, shapes: bool = False,
             before: Optional[Callable] = None, after: Optional[Callable] = None) -> None:
        """Wrap ``target``: a span named ``span`` (with the call's tensor
        shapes if ``shapes``), ``before(args, kwargs)`` and ``after(args,
        kwargs, result)`` hooks."""
        owner, attr = _resolve(target)
        orig = owner.__dict__[attr] if isinstance(owner, type) else getattr(owner, attr)
        rec = self

        def wrapper(*args, **kwargs):
            if before is not None:
                before(args, kwargs)
            timed = span is not None and rec.active
            t0 = time.perf_counter()
            if timed and rec.profiling:
                with torch.profiler.record_function(PREFIX + span):
                    out = orig(*args, **kwargs)
            else:
                out = orig(*args, **kwargs)
            if timed:
                rec.spans[span].append((t0, time.perf_counter()))
                if shapes:
                    outs = out if isinstance(out, tuple) else (out,)
                    rec.shapes[span].append(
                        ([s for s in map(_summary, args) if s], [s for s in map(_summary, outs) if s]))
            if after is not None:
                after(args, kwargs, out)
            return out

        functools.update_wrapper(wrapper, orig)  # keeps attributes the program counts on
        setattr(owner, attr, wrapper)
        self._undo.append((owner, attr, orig))

    def remove(self) -> None:
        for owner, attr, orig in reversed(self._undo):
            setattr(owner, attr, orig)
        self._undo.clear()


def tensor_bytes(summaries) -> int:
    """Bytes of the tensors of (shape, bytes an element) summaries, each
    counted once."""
    total = 0
    for shape, size in summaries:
        n = 1
        for d in shape:
            n *= d
        total += n * size
    return total


def union_seconds(intervals, lo: float, hi: float) -> float:
    """Length of the union of (start, end) intervals, clipped to [lo, hi]:
    overlapping intervals count once."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted((max(s, lo), min(e, hi)) for s, e in intervals):
        if e <= s:
            continue
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total
