"""Rate/ETA progress logging for non-TTY runs.

Capability parity with ``maze_ipp/log_progress.py`` (interval-gated log
lines with rate + ETA, SI/IEC number formatting, a stream node deriving
totals from ``n_remaining_hint``), re-designed around a **sliding-window
rate estimator**: instead of smoothing per-interval rates with an EMA,
``ProgressLogger`` keeps a deque of recent ``(monotonic_time, count)``
checkpoints and reports the exact average rate over the trailing
``window`` seconds. That makes the displayed rate directly interpretable
("what happened in the last N minutes"), immune to the first-items
warm-up skewing the estimate (old checkpoints simply age out — the
problem the reference handled with ``smoothing_min_n_done``), and
monotonic-clock-safe under NTP steps.

Copy of ``maze_image_processing_pipeline_tpu/progress.py`` for the PyTorch port,
which imports nothing of the JAX package; only imports differ.
``tests/test_torch_host_copies.py`` holds the two equal.
"""

from __future__ import annotations

import collections
import logging
import time
from typing import Optional

from .engine.core import Node, RawOrVariable, Stream, closing_if_closable

logger = logging.getLogger(__name__)

__all__ = ["ProgressLogger", "LogProgress", "format_number", "format_interval"]

_SI = [(1e12, "T"), (1e9, "G"), (1e6, "M"), (1e3, "k")]
_IEC = [(2**40, "Ti"), (2**30, "Gi"), (2**20, "Mi"), (2**10, "ki")]


def format_number(x: float, format: Optional[str] = "si") -> str:
    """Format with SI ('si') or binary ('iec') prefixes, or plain (None)."""
    if format == "si":
        table = _SI
    elif format == "iec":
        table = _IEC
    elif format is None:
        return f"{x:.2f}"
    else:
        raise ValueError(f"Unsupported format: {format!r}")
    for factor, suffix in table:
        if abs(x) >= factor:
            return f"{x / factor:.2f}{suffix}"
    return f"{x:.2f}"


def format_interval(t: float) -> str:
    mins, s = divmod(int(t), 60)
    h, m = divmod(mins, 60)
    if h:
        return f"{h:d}:{m:02d}:{s:02d}"
    return f"{m:02d}:{s:02d}"


class ProgressLogger:
    """Log items/sec + ETA at a fixed interval from a sliding-rate window.

    Args:
        description: prefix for every log line.
        n_total: total item count (enables percent + ETA); may be updated
            on the fly via the attribute.
        log_interval: seconds between log lines (0 = every update).
        unit: item unit shown after the rate.
        number_format: 'si', 'iec', or None (plain).
        window: trailing seconds the rate is averaged over. The window
            also absorbs slow warm-up items: once they age out they no
            longer bias the estimate.
    """

    def __init__(
        self,
        *,
        description: Optional[str] = None,
        n_total: Optional[float] = None,
        log_interval: float = 60,
        unit: str = "it",
        number_format: Optional[str] = "si",
        window: float = 300.0,
    ) -> None:
        if window <= 0:
            raise ValueError(f"window must be positive, got {window}")
        self.description = description
        self.n_total = n_total
        self.log_interval = log_interval
        self.unit = unit
        self.number_format = number_format
        self.window = window

        self.n_done = 0
        self._t0 = time.monotonic()
        # (t, n_done) checkpoints spanning at most `window` seconds.
        self._checkpoints = collections.deque([(self._t0, 0)])
        self._t_next_log = self._t0  # first update may log immediately

    # -- rate model ---------------------------------------------------------

    def _observe(self, n: int, now: float) -> None:
        self.n_done += n
        cp = self._checkpoints
        # Coalesce: merge updates landing within window/128 of the previous
        # checkpoint into the tail entry, bounding the deque at ~130
        # entries regardless of update rate (a 1 MHz counter would
        # otherwise hold rate×window tuples).
        if len(cp) >= 2 and now - cp[-2][0] < self.window / 128:
            cp[-1] = (now, self.n_done)
        else:
            cp.append((now, self.n_done))
        horizon = now - self.window
        # Drop the head only while the NEXT entry still covers the full
        # window (the retained head may straddle the horizon).
        while len(cp) > 2 and cp[1][0] <= horizon:
            cp.popleft()

    def rate(self) -> float:
        """Average items/sec over the trailing window."""
        (t_old, n_old), (t_new, n_new) = self._checkpoints[0], self._checkpoints[-1]
        if t_new <= t_old:
            return 0.0
        return (n_new - n_old) / (t_new - t_old)

    # -- logging ------------------------------------------------------------

    def update(self, n: int = 1) -> None:
        now = time.monotonic()
        self._observe(n, now)
        if now < self._t_next_log:
            return
        self._t_next_log = now + self.log_interval
        self._emit(now)

    def finish(self) -> None:
        """Log a final summary line (total, wall time, mean rate)."""
        now = time.monotonic()
        elapsed = max(now - self._t0, 1e-9)
        mean_rate = self.n_done / elapsed
        msg = (
            f"done: {format_number(self.n_done, self.number_format)} "
            f"{self.unit} in {format_interval(elapsed)} "
            f"({format_number(mean_rate, self.number_format)} {self.unit}/s)"
        )
        if self.description:
            msg = f"{self.description}: {msg}"
        logger.info(msg)

    def _emit(self, now: float) -> None:
        # A near-empty window span (the very first updates) yields a
        # meaningless extrapolation; show '?' until there is signal.
        span = self._checkpoints[-1][0] - self._checkpoints[0][0]
        rate = self.rate() if span >= min(1.0, self.window / 2) else 0.0
        elapsed = now - self._t0
        done_s = format_number(self.n_done, self.number_format)
        rate_s = (
            f"{format_number(rate, self.number_format)} {self.unit}/s"
            if rate > 0
            else f"? {self.unit}/s"
        )

        if self.n_total:
            pct = self.n_done / self.n_total
            left = max(self.n_total - self.n_done, 0)
            eta_s = format_interval(left / rate) if rate > 0 else "?"
            total_s = format_number(self.n_total, self.number_format)
            msg = (
                f"{done_s}/{total_s} ({pct:.1%}) | {rate_s} | "
                f"{format_interval(elapsed)} elapsed, {eta_s} left"
            )
        else:
            msg = f"{done_s}/? | {rate_s} | {format_interval(elapsed)} elapsed"

        if self.description:
            msg = f"{self.description}: {msg}"
        logger.info(msg)


class LogProgress(Node):
    """Stream node logging progress; totals come from ``n_remaining_hint``."""

    def __init__(
        self,
        description: Optional[RawOrVariable[str]] = None,
        *,
        log_interval: float = 60,
        unit: str = "it",
        number_format: Optional[str] = "si",
        window: float = 300.0,
    ) -> None:
        self.description = description
        self.log_interval = log_interval
        self.unit = unit
        self.number_format = number_format
        self.window = window
        super().__init__()

    def transform_stream(self, stream: Stream) -> Stream:
        plog = ProgressLogger(
            log_interval=self.log_interval,
            unit=self.unit,
            number_format=self.number_format,
            window=self.window,
        )
        try:
            with closing_if_closable(stream):
                for n_processed, obj in enumerate(stream):
                    description = self.prepare_input(obj, "description")
                    if description is not None:
                        plog.description = str(description)
                    if obj.n_remaining_hint is not None:
                        plog.n_total = n_processed + obj.n_remaining_hint
                    plog.update()
                    yield obj
        finally:
            # Also on early generator close / mid-stream exceptions: the
            # summary is the one place totals get logged on non-TTY runs.
            plog.finish()
