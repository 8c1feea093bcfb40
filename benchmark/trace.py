"""The device trace of a traced run, reduced to what the readers need.

``Trace.from_profiler`` walks the profiler's kineto events once:

* device operations (kernels, copies, sets): start, end, name and the
  CUDA runtime call that launched them (their shared correlation id);
* the host start of every CUDA runtime call (``cudaLaunchKernel`` ...), in
  whatever thread it ran: the moment each device operation was launched;
* the ``bench::`` annotations of :mod:`.spans`, including the window's.

:meth:`Trace.device_seconds_in` gives the device time of the operations
launched inside the annotations of a span, whatever kernels implement the
call; :meth:`Trace.busy_seconds` the union of device activity over the
window (overlapping operations count once).
"""

from __future__ import annotations

import bisect
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

from .spans import PREFIX, union_seconds

WINDOW = "window"


def _ns(e, what: str) -> int:
    f = getattr(e, what + "_ns", None)
    if f is not None:
        return int(f())
    return int(getattr(e, what + "_us")() * 1000)


class Trace:
    def __init__(self) -> None:
        self.device: List[Tuple[int, int, str, int]] = []
        self.launch_ns: Dict[int, int] = {}  # runtime call's correlation id -> its host start
        self.annotations: Dict[str, List[Tuple[int, int]]] = defaultdict(list)

    @classmethod
    def from_profiler(cls, prof) -> "Trace":
        from torch._C._autograd import DeviceType

        t = cls()
        for e in prof.profiler.kineto_results.events():
            start = _ns(e, "start")
            end = start + _ns(e, "duration")
            name = e.name()
            if e.device_type() == DeviceType.CPU:
                if name.startswith(PREFIX):
                    t.annotations[name[len(PREFIX):]].append((start, end))
                elif name.startswith("cu"):  # a runtime or driver call: CUPTI's correlation id
                    t.launch_ns[e.correlation_id()] = start
            elif not name.startswith(PREFIX):  # the annotations' device-side copies
                t.device.append((start, end, name, e.correlation_id()))
        return t

    @property
    def window(self) -> Optional[Tuple[int, int]]:
        w = self.annotations.get(WINDOW)
        return (w[0][0], w[0][1]) if w else None

    def window_seconds(self) -> float:
        w = self.window
        return (w[1] - w[0]) * 1e-9 if w else 0.0

    def busy_seconds(self) -> float:
        w = self.window
        if w is None:
            return 0.0
        return union_seconds([(s, e) for s, e, _, _ in self.device], *w) * 1e-9

    def device_seconds_in(self, span: str) -> Optional[float]:
        """Device seconds of the operations launched inside ``span``'s
        annotations; None where the span never ran."""
        ann = sorted(self.annotations.get(span, ()))
        if not ann:
            return None
        starts = [s for s, _ in ann]
        total = 0
        for s, e, _, cid in self.device:
            t = self.launch_ns.get(cid)
            if t is None:
                continue
            i = bisect.bisect_right(starts, t) - 1
            if i >= 0 and t <= ann[i][1]:
                total += e - s
        return total * 1e-9

    def top_device_ops(self, n: int = 10) -> List[list]:
        w = self.window
        by: Dict[str, int] = defaultdict(int)
        for s, e, name, _ in self.device:
            if w is None or (e > w[0] and s < w[1]):
                by[name] += e - s
        return [[k, v * 1e-9] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]

    def idle_gaps(self, n: int = 10) -> List[list]:
        """The window's idle time (no device operation running), summed by
        the innermost ``bench::`` span the host was in at each gap's middle
        (``host outside spans`` where none)."""
        w = self.window
        if w is None:
            return []
        ivs = sorted((max(s, w[0]), min(e, w[1])) for s, e, _, _ in self.device if e > w[0] and s < w[1])
        gaps, cur = [], w[0]
        for s, e in ivs:
            if s > cur:
                gaps.append((cur, s))
            cur = max(cur, e)
        if cur < w[1]:
            gaps.append((cur, w[1]))
        named = {name: sorted(lst) for name, lst in self.annotations.items() if name != WINDOW}
        starts = {name: [s for s, _ in lst] for name, lst in named.items()}
        by: Dict[str, int] = defaultdict(int)
        for g0, g1 in gaps:
            mid = (g0 + g1) // 2
            label, best = "host outside spans", None
            for name, lst in named.items():
                i = bisect.bisect_right(starts[name], mid) - 1
                if i >= 0 and lst[i][1] >= mid and (best is None or lst[i][0] > best):
                    label, best = "host in " + name, lst[i][0]
            by[label] += g1 - g0
        return [[k, v * 1e-9] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]
