"""Spans from the benchmark's own files, and the reduction of one
torch.profiler trace to what the per-layer readers read.

Spans: in a traced run the functions a driver file lists are wrapped in
``torch.profiler.record_function`` from outside (the pattern of the port's
``prof_torch_slam2d.py`` and ``prof_torch_pf.py``); the program itself
carries no instrumentation. The timed loop is wrapped in one more span,
:data:`WINDOW`, which marks the traced window on the trace's timeline.

The reduction keeps, from the profiler's raw events (all on one
nanosecond timeline):

- the spans (user annotations) by name;
- the device activities: kernels, copies and fills, by name, with their
  start and end (the sums by name follow ``utils/devprof.py``'s row
  arithmetic: device time summed per name, activities counted);
- the CUDA runtime and driver calls of the host, by name.

The device's busy time is the union of the activities' intervals inside
the window, on the trace's own timeline: not the sum of kernel times over
a wall time that the profiler itself stretches.
"""

from __future__ import annotations

import bisect
import dataclasses
import functools
import importlib
from collections import defaultdict

WINDOW = "bench.window"


def resolve(target: str):
    """``"package.module:Attr.path"`` -> (owner object, attribute name)."""
    mod_name, path = target.split(":")
    owner = importlib.import_module(mod_name)
    parts = path.split(".")
    for p in parts[:-1]:
        owner = getattr(owner, p)
    return owner, parts[-1]


def patch(target: str, make):
    """Replace the function at ``target`` by ``make(function)``, keeping
    the attributes the program keeps on it (launch counters). Returns a
    function that puts the original back."""
    owner, attr = resolve(target)
    fn = getattr(owner, attr)
    setattr(owner, attr, functools.wraps(fn)(make(fn)))
    return lambda: setattr(owner, attr, fn)


def install_spans(spans: dict):
    """Wrap every function of ``spans`` ({span name: target}) in a
    ``record_function`` of the span's name. Returns a function that puts
    the originals back."""
    from torch.profiler import record_function

    def spanned(name):
        def make(fn):
            def wrapped(*a, **kw):
                with record_function(name):
                    return fn(*a, **kw)
            return wrapped
        return make

    undo = [patch(target, spanned(name)) for name, target in spans.items()]

    def restore():
        for u in reversed(undo):
            u()

    return restore


def merged(intervals):
    """Sorted, disjoint union of (start, end) intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return out


def clip(intervals, lo, hi):
    return [(max(s, lo), min(e, hi)) for s, e in intervals
            if e > lo and s < hi]


def kernel_base(name: str) -> str:
    """A kernel's function name without its return type, namespaces,
    template and argument lists (``void (anonymous
    namespace)::select4_kernel<signed char>(signed char const*, ...)`` ->
    ``select4_kernel``)."""
    base = name.replace("(anonymous namespace)::", "")
    base = base.split("(")[0].split("<")[0].strip()
    return base.split(" ")[-1].split("::")[-1]


@dataclasses.dataclass
class TraceView:
    """One traced window, reduced."""

    window: tuple            # (start ns, end ns)
    spans: dict              # span name -> sorted [(start ns, end ns)]
    device: list             # [(name, start ns, end ns)] inside the window
    runtime: list            # [(name, start ns, end ns)] inside the window
    n_updates: int           # integrated updates in the window
    kernel_calls: dict       # kernel base name -> shapes of one call
    busy: list               # merged device intervals inside the window
    host: dict = None        # the untraced stretch before it: integrated
    #                          "updates" over its "seconds", or None

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e9

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy) / 1e9

    def span_total_ns(self, name: str) -> int:
        return sum(e - s for s, e in self.spans.get(name, ()))

    def device_by_name(self) -> dict:
        """{name: (device seconds, activities)} (devprof's row sums)."""
        out = defaultdict(lambda: [0.0, 0])
        for name, s, e in self.device:
            row = out[name]
            row[0] += (e - s) / 1e9
            row[1] += 1
        return {k: tuple(v) for k, v in out.items()}

    def host_label(self, t: int) -> str:
        """The innermost span that holds host time ``t`` (the one that
        started last), else ``"harness"``."""
        best, best_start = "harness", None
        for name, iv in self.spans.items():
            if name == WINDOW:
                continue
            i = bisect.bisect_right(iv, (t, float("inf"))) - 1
            if i >= 0 and iv[i][0] <= t < iv[i][1]:
                if best_start is None or iv[i][0] > best_start:
                    best, best_start = name, iv[i][0]
        return best

    def idle_gaps(self) -> list:
        """[(start ns, end ns)] of the window that no device activity
        covers."""
        lo, hi = self.window
        gaps, t = [], lo
        for s, e in self.busy:
            if s > t:
                gaps.append((t, s))
            t = max(t, e)
        if t < hi:
            gaps.append((t, hi))
        return gaps


def _events(prof):
    """(name, on the device?, start ns, end ns, user annotation?) of every
    raw event of a finished profile, from what every torch 2.x event
    offers (its device type, name, start and duration)."""
    import torch
    cuda = torch.autograd.DeviceType.CUDA
    for ev in prof.profiler.kineto_results.events():
        if hasattr(ev, "start_ns"):
            start, length = ev.start_ns(), ev.duration_ns()
        else:
            start, length = ev.start_us() * 1000, ev.duration_us() * 1000
        note = getattr(ev, "is_user_annotation", None)
        yield (ev.name(), ev.device_type() == cuda, start, start + length,
               note() if note else None)


def reduce(prof, span_names, n_updates: int, kernel_calls: dict,
           host: dict = None):
    """A :class:`TraceView` of a finished profile whose timed loop ran in
    the :data:`WINDOW` span (``host``: the untraced stretch's readings). Device events are kernels, copies and fills,
    less the device-side marks of the spans; host events named ``cuda*``
    or ``cu*`` are calls into the CUDA runtime or driver."""
    names = set(span_names) | {WINDOW}
    spans = defaultdict(list)
    device, runtime = [], []
    for name, on_device, s, e, note in _events(prof):
        if on_device:
            if name not in names:
                device.append((name, s, e))
        elif name in names and note is not False:
            spans[name].append((s, e))
        elif name.startswith("cu") and note is not True:
            runtime.append((name, s, e))
    if not spans.get(WINDOW):
        raise RuntimeError("the trace holds no window span")
    lo, hi = spans[WINDOW][0]
    device = [d for d in device if d[2] > lo and d[1] < hi]
    runtime = [r for r in runtime if lo <= r[1] < hi]
    busy = merged(clip([(s, e) for _, s, e in device], lo, hi))
    return TraceView((lo, hi), {k: sorted(v) for k, v in spans.items()},
                     device, runtime, n_updates, kernel_calls,
                     [tuple(b) for b in busy], host)


def breakdown(view: TraceView, top: int = 10) -> dict:
    """The device operations that took most time, and the device's idle
    time by what the host was doing, each ``top`` long."""
    ops = sorted(((n, v[0]) for n, v in view.device_by_name().items()),
                 key=lambda r: -r[1])[:top]
    idle = defaultdict(float)
    for s, e in view.idle_gaps():
        idle[view.host_label((s + e) // 2)] += (e - s) / 1e9
    gaps = sorted(idle.items(), key=lambda r: -r[1])[:top]
    return {"device_ops": [[n, v] for n, v in ops],
            "idle_gaps": [[n, v] for n, v in gaps]}
