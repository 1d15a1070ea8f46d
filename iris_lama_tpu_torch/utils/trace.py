"""The port's spans and host-read counters: its one tracing system.

Spans. :func:`span` marks a stretch of host code under a ``lama.*`` name.
While a ``torch.profiler.profile`` records, the span is a profiler event on
the profiler's own timeline, the one its device activities lie on (each
span nests the CUDA runtime calls it makes, and their correlation ids tie
those calls to the kernels and copies they launch); when nothing records,
:func:`span` returns one shared no-op context (under a microsecond an
enter and exit). There is no switch, no environment variable and no buffer
of the port's own: the profiler holds the spans and writes them out with
its trace. To see them, wrap the node in the profiler::

    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts) as prof:
        for cloud, odom, ts in stream:
            if slam.update(cloud, odom, ts):
                slam.pose()
    print(prof.key_averages().table(sort_by="cpu_time_total"))
    prof.export_chrome_trace("slam.json")

A span is a function-scope profiler event (``_RecordFunctionFast``), not a
``record_function`` user annotation: the profiler makes a device-side copy
of every user annotation that launched work, which a reader of the device
timeline would count as device activity; a function-scope event has none,
so the spans add nothing to the device's timeline.

The drivers run one host thread, so the spans of one update nest inside
its ``lama.update``:

- ``lama.update``: ``update`` / ``update_prepadded`` of Slam2D and PFSlam2D;
  ``lama.stage``: the scan padded and copied to the device;
- ``lama.match``: the scan match; ``lama.map_update``: the map update;
- ``lama.reorg.scroll`` / ``lama.reorg.full``: a band scroll or a full
  flush and regather, entered only when one runs;
- PFSlam2D: ``lama.motion`` (the queued odometry packets applied), with one
  ``lama.motion.draw`` a packet (the normal draw and its copy), and
  ``lama.resample`` (weights, Neff, the resample and the rows' gather);
- the spill tier: ``lama.spill`` and ``lama.refill``;
- GraphSlam2D: ``lama.graph.<phase>`` around each of its timed phases
  (``front_end``, ``sync``, ``key_scan``, ``close_loops`` with
  ``correlate``, ``process_pending`` with ``coarse``, ``optimize``,
  ``rebuild``); the map rebuild ``lama.rebuild`` (rasterize and EDT) and
  ``lama.rebuild.pack`` (the dense grids packed into a pool);
- ``lama.read.<site>``: each host read of device data (:func:`host_read`).

Counters. :func:`host_read` counts each read under ``reads.<site>``: plain
host integers of the process, always on, read by :func:`counts` without a
device read. The sites: ``irls_stop`` (a scan match's IRLS stop flag),
``pgo_stop`` (the pose-graph LM's stop flag), ``key_gate``, ``verify``,
``coarse`` and ``pgo_nodes`` (GraphSlam2D's gate block, harvested
verification and coarse batches, optimised key poses), ``rebuild`` (the
rebuilt grids read for packing),
``escapes`` (the safe-zone escape counters), ``safe_zone`` (the per-update
safe-zone check once no re-org trigger is safe), ``reorg_origin`` (a band
scroll's window origins), ``pose`` (the published pose), ``spill`` (the
spill tier's reads), and ``lineage``, ``memory``, ``info``,
``trajectory``, ``loc_cell`` and ``refresh`` off the update path.
:func:`count` adds to any other counter: ``graph.*`` counts GraphSlam2D's
key poses, searches, verified rows, coarse jobs, accepted loops,
optimisations and map rebuilds (``algos/graph_slam2d.py``).
Device work is counted on the profiler's device trace, by kernel name
(``utils/devprof.py``), not here.
"""

from __future__ import annotations

import collections
import contextlib

import torch
from torch._C._profiler import _RecordFunctionFast

_OFF = contextlib.nullcontext()
_COUNTS: collections.Counter = collections.Counter()


def span(name: str):
    """A context that marks ``name`` on the profiler's timeline while a
    profiler records; else the shared no-op context."""
    if torch.autograd._profiler_enabled():
        return _RecordFunctionFast(name)
    return _OFF


class _Phase:
    """A span whose close also ends a ``utils.summary.PhaseClock`` phase."""

    __slots__ = ("_span", "_clock", "_mark")

    def __init__(self, name: str, clock, mark: str) -> None:
        self._span, self._clock, self._mark = span(name), clock, mark

    def __enter__(self):
        self._span.__enter__()
        return self

    def __exit__(self, *exc):
        self._clock.mark(self._mark)
        return self._span.__exit__(*exc)


def phase(name: str, clock=None, mark: str = ""):
    """:func:`span` ``name``, closing together with phase ``mark`` of
    ``clock`` (a ``PhaseClock``; None: the span alone), so the summary's
    phases and the spans share their boundaries."""
    return span(name) if clock is None else _Phase(name, clock, mark)


def host_read(t: torch.Tensor, site: str, numpy: bool = False):
    """``t.tolist()`` (``numpy=True``: ``t.cpu().numpy()``): a read of
    device data on the host, which waits for the device. Spanned as
    ``lama.read.<site>`` and counted under ``reads.<site>``."""
    count("reads." + site)
    with span("lama.read." + site):
        return t.cpu().numpy() if numpy else t.tolist()


def count(key: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``key`` (a plain host integer)."""
    _COUNTS[key] += n


def counts() -> dict:
    """A copy of the process's counters (``reads.<site>``: host reads;
    ``graph.*``: GraphSlam2D's loop-closure and map work)."""
    return dict(_COUNTS)
