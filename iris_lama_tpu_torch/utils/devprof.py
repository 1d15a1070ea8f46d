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
:func:`launch_count` read them; :func:`launches_by_name` and
:func:`launches_by_window` count a call's or a run's launches by kernel
name. The profiler can drop device activities, never add one (H100, torch
2.11): the head of a profile, which ``PAD`` empty kernels take, and now
and then a stretch of a long one, which short windows and repeats spare.
"""

from __future__ import annotations

import torch

PAD = 256                     # empty kernels that open a profile
PAD_KERNEL = "spin_kernel"    # their name: torch.cuda._sleep's kernel
# the port's kernels by their names on the device trace (csrc/*.cu): B1
# (deposit_counts, the pair), B2, B3 (any; up to R = 64; the two beyond),
# B4 and B6, B5, B7 and B8, the PF's motion step
DEPOSIT, SELECT4 = "deposit_kernel", "select4_kernel"
EDT, EDT_TILE, EDT_COLUMNS, EDT_ROWS = ("edt_", "edt_tile", "edt_columns",
                                        "edt_rows")
GN_SOLVE, GN_EVAL = "gn_solve_kernel", "gn_eval_kernel"
SCATTER, MOTION = "scatter_grid_kernel", "motion_kernel"
_ELEMENT = {"int8": "signed char", "uint8": "unsigned char",
            "int16": "short", "int32": "int"}


def typed(kernel: str, dtype) -> str:
    """The name of ``kernel``'s instantiation for windows of ``dtype`` (a
    torch dtype or its name), as it opens on the device trace
    (``gn_solve_kernel<signed char, 5, false, false>``)."""
    return f"{kernel}<{_ELEMENT[str(dtype).removeprefix('torch.')]}"


def _require_cuda() -> None:
    if not torch.cuda.is_available():
        raise RuntimeError("devprof reads CUDA activities: no CUDA device")


def event_us(row) -> float:
    """Self device µs of one ``key_averages()`` row."""
    return getattr(row, "self_device_time_total",
                   getattr(row, "self_cuda_time_total", 0.0))


def cuda_rows(prof) -> list:
    """The CUDA activities of a finished profile (``key_averages()`` rows;
    CPU rows, annotations and the opening pad left out)."""
    return [a for a in prof.key_averages()
            if str(a.device_type).endswith("CUDA")
            and PAD_KERNEL not in a.key]


def device_us(rows, match: str = "") -> float:
    """Device µs of the ``rows`` whose name holds ``match``."""
    return sum(event_us(a) for a in rows if match in a.key)


def launch_count(rows, match: str = "") -> int:
    """Activities (kernels, copies, fills) the ``rows`` whose name holds
    ``match`` count: a kernel's launches by its name."""
    return sum(a.count for a in rows if match in a.key)


def pad_profile() -> None:
    """Open a running profile: ``PAD`` empty kernels, drained, which take
    a drop of its first device activities."""
    for _ in range(PAD):
        torch.cuda._sleep(0)
    torch.cuda.synchronize()


def profile_calls(fn, reps: int = 1, args: tuple = ()):
    """torch.profiler's CUDA profile of ``reps`` calls of ``fn(*args)``,
    opened by :func:`pad_profile`, the device drained before and after (no
    warm-up call)."""
    from torch.profiler import ProfilerActivity, profile
    _require_cuda()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        pad_profile()
        for _ in range(reps):
            fn(*args)
        torch.cuda.synchronize()
    return prof


def launches_by_window(windows, kernels: dict, tries: int = 1) -> tuple:
    """The device activities a run launched, by name: ``kernels`` maps a
    label to a part of an activity's name (``GN_SOLVE``, ``typed(GN_SOLVE,
    dtype)``; "" for all), ``windows()`` starts a fresh run and returns its
    windows, callables each profiled on its own. With ``tries`` > 1 the
    run, the same work each time, is made that many times and each
    window's count is the largest seen. Returns the last run's window
    results and {label: launches}."""
    best = None
    for _ in range(tries):
        outs, per = [], []
        for window in windows():
            rows = cuda_rows(profile_calls(lambda: outs.append(window())))
            per.append([launch_count(rows, k) for k in kernels.values()])
        best = per if best is None else [list(map(max, a, b))
                                         for a, b in zip(best, per)]
    return outs, {label: sum(c) for label, c in zip(kernels, zip(*best))}


def launches_by_name(fn, kernels: dict, tries: int = 1) -> tuple:
    """``fn()``'s result and the device activities the call launched, by
    name (as :func:`launches_by_window`, the call one window)."""
    outs, counts = launches_by_window(lambda: [fn], kernels, tries)
    return outs[0], counts


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
