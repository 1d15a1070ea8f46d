"""Time primitives: Duration/Time/Timer/Rate/EventFrequency.

reference: include/lama/time.h (ns-resolution Duration/Time at :44,131;
Timer :218; Rate :238; EventFrequency :269) and timer.h (ScopedTimer — see
utils/summary.py for the registry-backed version).
"""

from __future__ import annotations

import time as _time


class Duration:
    """Nanosecond duration (time.h:44-127)."""

    __slots__ = ("ns",)

    def __init__(self, seconds: float = 0.0, ns: int = None):
        self.ns = int(seconds * 1e9) if ns is None else int(ns)

    def to_sec(self) -> float:
        return self.ns * 1e-9

    def __add__(self, other):
        return Duration(ns=self.ns + other.ns)

    def __sub__(self, other):
        return Duration(ns=self.ns - other.ns)

    def __lt__(self, other):
        return self.ns < other.ns

    def __repr__(self):
        return f"Duration({self.to_sec():.9f}s)"


class Time:
    """Absolute time (time.h:131-216)."""

    __slots__ = ("ns",)

    def __init__(self, seconds: float = None, ns: int = None):
        if ns is not None:
            self.ns = int(ns)
        elif seconds is not None:
            self.ns = int(seconds * 1e9)
        else:
            self.ns = _time.time_ns()

    @staticmethod
    def now() -> "Time":
        return Time()

    def to_sec(self) -> float:
        return self.ns * 1e-9

    def __sub__(self, other) -> Duration:
        return Duration(ns=self.ns - other.ns)

    def __add__(self, d: Duration) -> "Time":
        return Time(ns=self.ns + d.ns)


class Timer:
    """Stopwatch (time.h:218-236)."""

    def __init__(self, start: bool = False):
        self._t0 = None
        if start:
            self.reset()

    def reset(self) -> None:
        self._t0 = _time.perf_counter_ns()

    def elapsed(self) -> Duration:
        if self._t0 is None:
            return Duration(0.0)
        return Duration(ns=_time.perf_counter_ns() - self._t0)


class Rate:
    """Loop-rate keeper (time.h:238-267)."""

    def __init__(self, hz: float):
        self.period = 1.0 / hz
        self._last = _time.perf_counter()

    def sleep(self) -> None:
        target = self._last + self.period
        now = _time.perf_counter()
        if target > now:
            _time.sleep(target - now)
        self._last = _time.perf_counter()


class EventFrequency:
    """Windowed event frequency estimate (time.h:269-310)."""

    def __init__(self, window: int = 32):
        self._stamps = []
        self._window = window

    def event(self) -> None:
        self._stamps.append(_time.perf_counter())
        if len(self._stamps) > self._window:
            self._stamps.pop(0)

    def frequency(self) -> float:
        if len(self._stamps) < 2:
            return 0.0
        span = self._stamps[-1] - self._stamps[0]
        return (len(self._stamps) - 1) / span if span > 0 else 0.0
