"""Execution summaries and scoped timers.

reference:
* ``Slam2D::Summary`` / ``PFSlam2D::Summary`` — per-update wall-clock,
  per-phase timings, memory probes and a pretty report with Hz and realtime
  factor (src/slam2d.cpp:46-90, src/pf_slam2d.cpp:49-104);
* ``ScopedTimer`` + global named-timer registry with Welford online
  mean/variance (include/lama/timer.h:42-110).

Host side: the drivers synchronise the device before they read the clock
(and only when a summary is asked for). :class:`PhaseClock` times the
phases of one update apart, synchronising at each boundary.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import time
from typing import Dict, List

import torch


@dataclasses.dataclass
class Welford:
    """Online mean/variance (timer.h:70-99)."""

    n: int = 0
    mean: float = 0.0
    m2: float = 0.0

    def add(self, x: float) -> None:
        self.n += 1
        d = x - self.mean
        self.mean += d / self.n
        self.m2 += d * (x - self.mean)

    @property
    def var(self) -> float:
        return self.m2 / (self.n - 1) if self.n > 1 else 0.0

    @property
    def std(self) -> float:
        return math.sqrt(self.var)


class TimerRegistry:
    """Global named-timer registry (timer.h:42-68)."""

    def __init__(self) -> None:
        self.timers: Dict[str, Welford] = {}

    @contextlib.contextmanager
    def scoped(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.timers.setdefault(name, Welford()).add(
                time.perf_counter() - t0)

    def report(self) -> str:
        lines = ["-- timers --"]
        for name, w in sorted(self.timers.items()):
            lines.append(f"{name:30s} mean {w.mean*1e3:9.3f} ms  "
                         f"std {w.std*1e3:8.3f} ms  n {w.n}")
        return "\n".join(lines)


GLOBAL_TIMERS = TimerRegistry()


@dataclasses.dataclass
class Summary:
    """Per-update probes (slam2d.h:57-88, pf_slam2d.h:88-129)."""

    timestamps: List[float] = dataclasses.field(default_factory=list)
    time_total: List[float] = dataclasses.field(default_factory=list)
    time_solving: List[float] = dataclasses.field(default_factory=list)
    time_normalizing: List[float] = dataclasses.field(default_factory=list)
    time_resampling: List[float] = dataclasses.field(default_factory=list)
    time_mapping: List[float] = dataclasses.field(default_factory=list)
    memory: List[float] = dataclasses.field(default_factory=list)

    def probe(self, timestamp: float, total: float, solving: float = 0.0,
              mapping: float = 0.0, normalizing: float = 0.0,
              resampling: float = 0.0, memory: float = 0.0) -> None:
        self.timestamps.append(timestamp)
        self.time_total.append(total)
        self.time_solving.append(solving)
        self.time_mapping.append(mapping)
        self.time_normalizing.append(normalizing)
        self.time_resampling.append(resampling)
        self.memory.append(memory)

    @staticmethod
    def _stats(xs: List[float]):
        if not xs:
            return 0.0, 0.0, 0.0, 0.0
        n = len(xs)
        mean = sum(xs) / n
        var = sum((x - mean) ** 2 for x in xs) / n if n > 1 else 0.0
        return mean, math.sqrt(var), min(xs), max(xs)

    def report(self) -> str:
        """Pretty report with Hz and realtime factor (slam2d.cpp:61-87)."""
        n = len(self.time_total)
        if n == 0:
            return "No summary data."
        span = (self.timestamps[-1] - self.timestamps[0]) if n > 1 else 0.0
        total_exec = sum(self.time_total)
        hz = n / total_exec if total_exec > 0 else float("inf")
        rt = span / total_exec if total_exec > 0 else float("inf")
        out = [f"updates: {n}   data span: {span:.1f} s   "
               f"exec: {total_exec:.2f} s   {hz:.1f} Hz   "
               f"realtime x{rt:.1f}"]
        for name, xs in [("update", self.time_total),
                         ("solving", self.time_solving),
                         ("normalizing", self.time_normalizing),
                         ("resampling", self.time_resampling),
                         ("mapping", self.time_mapping)]:
            mean, std, lo, hi = self._stats(xs)
            if any(x > 0 for x in xs):
                out.append(f"  {name:12s} {mean*1e3:8.2f} ± {std*1e3:7.2f} ms  "
                           f"[{lo*1e3:.2f}, {hi*1e3:.2f}]")
        mem = self.memory[-1] if self.memory else 0
        out.append(f"  memory      {mem/2**20:8.1f} MiB")
        return "\n".join(out)


def device_sync(device) -> None:
    """Wait until a CUDA ``device`` has finished its queued work (nothing
    to wait for on the CPU)."""
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class PhaseClock:
    """Times the phases of one update: :meth:`mark` ends a phase. On a CUDA
    device each boundary waits for the device, so a phase's time is the
    time the device took to finish it after the previous boundary."""

    def __init__(self, device) -> None:
        self.device = torch.device(device)
        self.phases: Dict[str, float] = {}
        device_sync(self.device)
        self._t = time.perf_counter()

    def mark(self, name: str) -> None:
        device_sync(self.device)
        now = time.perf_counter()
        self.phases[name] = now - self._t
        self._t = now
