"""The closed loop: one robot's node hands every scan of the stream to the
driver's ``update(cloud, odometry, timestamp)`` and, when it returns True,
reads the pose on the host before the next scan goes in.

An update's latency runs from the scan's hand-over to its pose on the host;
the rate is the integrated updates over the whole window, the scans that
the driver's gate turned away counting in the time.
"""

from __future__ import annotations

import dataclasses
import time


@dataclasses.dataclass
class Update:
    """One integrated update: lap position, odometry and published pose
    (x, y, theta), and whether the timed window ran it."""

    scan: int                # lap position
    j: int                   # place in the stream (scans since the start)
    fed: int                 # scans handed over since the last update
    odom: tuple
    pose: tuple
    timed: bool
    raw: tuple = None        # the pose as the driver holds it, if the
    #                          node's read gives it


def feed(node, clouds, stream, record: list, timed: bool):
    """Hand the next scan to the driver. Returns its latency in seconds
    when the driver integrated it, else None."""
    j = stream.j
    k, odom, ts = stream.next()
    cloud, od = clouds[k], node.odometry(odom)
    t0 = time.perf_counter()
    if not node.update(cloud, od, ts):
        return None
    pose = node.pose()
    dt = time.perf_counter() - t0
    last = record[-1].j if record else -1
    record.append(Update(k, j, j - last, odom, pose, timed,
                         getattr(node, "last_raw", None)))
    return dt


def warm_up(node, clouds, stream, warm: dict, record: list,
            max_scans: int) -> int:
    """Run the stream until ``warm["updates"]`` updates are integrated and
    the driver has re-organised its maps ``warm["reorgs"]`` times.
    Returns the scans fed."""
    n_up = 0
    for scans in range(1, max_scans + 1):
        if feed(node, clouds, stream, record, False) is not None:
            n_up += 1
        if n_up >= warm["updates"] and node.reorgs() >= warm["reorgs"]:
            return scans
    raise RuntimeError(f"warm-up did not see {warm} in {max_scans} scans")


def timed(node, clouds, stream, seconds: float, record: list,
          ordinal: int = 0) -> dict:
    """The measured window, or a stretch of it: the stream for
    ``seconds``. ``ordinal`` is the place in the window of the stretch's
    first update. Returns the latencies (s) and the stretch's start and
    end on the host clock."""
    lat = []
    observe = getattr(node, "observe", None)
    t_start = time.perf_counter()
    t_end = t_start
    while t_end - t_start < seconds:
        dt = feed(node, clouds, stream, record, True)
        if dt is not None:
            if observe is not None:
                observe(ordinal + len(lat))
            lat.append(dt)
        t_end = time.perf_counter()
    return {"latency_s": lat, "start": t_start, "end": t_end}
