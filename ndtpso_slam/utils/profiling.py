"""Timing / observability: rate meters and device profiler traces.

The reference self-reports an average publish rate and an instantaneous
matching rate around the scan callback (`ndtpso_slam_node.cpp:183-184,
232-240`); :class:`RateMeter` keeps that metric first-class.  `trace`
wraps `jax.profiler` for XLA device timelines — the capability upgrade over
wall-clock-only timing (SURVEY.md §5).
"""

from __future__ import annotations

import contextlib
import time
from typing import Optional


class RateMeter:
    """Average + instantaneous rate tracking for a repeated operation."""

    def __init__(self):
        self.start_time: Optional[float] = None
        self.last_elapsed: float = 0.0
        self.count: int = 0

    def tick(self):
        """Context manager timing one iteration."""
        return _Tick(self)

    @property
    def matching_rate_hz(self) -> float:
        """Instantaneous rate of the last iteration (`1/elapsed`)."""
        return 1.0 / self.last_elapsed if self.last_elapsed > 0 else 0.0

    @property
    def average_rate_hz(self) -> float:
        """Cumulative average rate since the first iteration."""
        if self.start_time is None or self.count == 0:
            return 0.0
        total = time.monotonic() - self.start_time
        return self.count / total if total > 0 else 0.0


class _Tick:
    def __init__(self, meter: RateMeter):
        self._m = meter

    def __enter__(self):
        now = time.monotonic()
        if self._m.start_time is None:
            self._m.start_time = now
        self._t0 = now
        return self

    def __exit__(self, *exc):
        self._m.last_elapsed = time.monotonic() - self._t0
        self._m.count += 1


@contextlib.contextmanager
def trace(logdir: str = "/tmp/ndtpso_trace"):
    """Capture a jax.profiler trace (view with TensorBoard / xprof)."""
    import jax

    jax.profiler.start_trace(logdir)
    try:
        yield logdir
    finally:
        jax.profiler.stop_trace()
