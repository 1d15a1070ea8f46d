"""Device time through torch.profiler: the CUDA activities (kernels,
copies, fills) a function launches, timed by the card itself, free of the
host's enqueue time that wall-clock micro-benchmarks of µs-scale work
measure instead.

Usage:
    ms = device_time_ms(fn, args_fn, n=4)

``args_fn(k)`` returns the argument tuple for call k. Returns the median
over the calls of the device time one call launched. Needs a CUDA device.

The pieces are public for scripts that post-process a profile of their
own: :func:`profile_calls` profiles calls of a function, :func:`cuda_rows`
keeps a profile's CUDA rows, :func:`event_us`, :func:`device_us` and
:func:`launch_count` read them.
"""

from __future__ import annotations

import torch


def _require_cuda() -> None:
    if not torch.cuda.is_available():
        raise RuntimeError("devprof reads CUDA activities: no CUDA device")


def event_us(row) -> float:
    """Self device µs of one ``key_averages()`` row."""
    return getattr(row, "self_device_time_total",
                   getattr(row, "self_cuda_time_total", 0.0))


def cuda_rows(prof) -> list:
    """The CUDA activities of a finished profile (``key_averages()`` rows;
    CPU rows and annotations left out)."""
    return [a for a in prof.key_averages()
            if str(a.device_type).endswith("CUDA")]


def device_us(rows, match: str = "") -> float:
    """Device µs of the ``rows`` whose name holds ``match``."""
    return sum(event_us(a) for a in rows if match in a.key)


def launch_count(rows) -> int:
    """Activities (kernels, copies, fills) the ``rows`` count."""
    return sum(a.count for a in rows)


def profile_calls(fn, reps: int = 1, args: tuple = ()):
    """torch.profiler's CUDA profile of ``reps`` calls of ``fn(*args)``,
    the device drained before and after (no warm-up call)."""
    from torch.profiler import ProfilerActivity, profile
    _require_cuda()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn(*args)
        torch.cuda.synchronize()
    return prof


def device_time_ms(fn, args_fn, n: int = 4) -> float:
    """Median device ms of one call of ``fn`` over ``n`` profiled calls
    (after one warm-up call); nan when the profiler saw no device time."""
    _require_cuda()
    fn(*args_fn(59999))
    per_call = sorted(device_us(cuda_rows(profile_calls(fn, 1, args_fn(k))))
                      / 1e3 for k in range(n))
    if not per_call or per_call[-1] == 0.0:
        return float("nan")
    return per_call[len(per_call) // 2]


def device_breakdown(fn, args_fn, n: int = 2, top: int = 12) -> list:
    """(name, ms a call) of the ``top`` device activities of ``fn`` by
    device time, over ``n`` profiled calls after one warm-up call."""
    _require_cuda()
    fn(*args_fn(59999))
    calls = iter(range(n))
    prof = profile_calls(lambda: fn(*args_fn(next(calls))), n)
    rows = [(a.key, event_us(a) / 1e3 / n) for a in cuda_rows(prof)]
    rows.sort(key=lambda r: -r[1])
    return rows[:top]
