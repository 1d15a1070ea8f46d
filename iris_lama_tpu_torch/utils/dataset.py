"""Dataset readers: CARMEN log format (Intel / MIT Killian / ACES logs).

The reference library is driven by ROS nodes, but its benchmark datasets
(BASELINE.md: Intel Research Lab, MIT Killian Court, ACES) are distributed
as CARMEN logger files. This reader parses the two laser message flavors:

  FLASER num_readings [ranges...] x y theta odom_x odom_y odom_theta ts host log_ts
  ROBOTLASER1 type start_angle fov res max_range accuracy remission_mode
      num_readings [ranges...] ... laser_pose(x y theta) robot_pose(x y theta)
      tv rv fwd side turn timestamp host log_ts

yielding (cloud, odometry, timestamp) triples ready for the SLAM drivers.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Iterator, Optional, TextIO, Tuple, Union

import numpy as np

from ..core.pose import Pose2D
from .cloud import PointCloudXYZ


@dataclasses.dataclass
class LaserScanRecord:
    cloud: PointCloudXYZ
    odometry: Pose2D
    timestamp: float


def _parse_flaser(parts, max_range):
    n = int(parts[1])
    ranges = np.asarray(parts[2:2 + n], np.float64)
    base = 2 + n
    # x y theta (laser pose), odom_x odom_y odom_theta
    ox, oy, oth = (float(parts[base + 3]), float(parts[base + 4]),
                   float(parts[base + 5]))
    ts = float(parts[base + 6])
    fov = math.pi  # FLASER is a 180-degree SICK by convention
    angles = np.linspace(-fov / 2, fov / 2, n)
    cloud = PointCloudXYZ.from_ranges(ranges, angles, max_range)
    return LaserScanRecord(cloud, Pose2D(ox, oy, oth), ts)


def _parse_robotlaser(parts, max_range):
    start_angle = float(parts[2])
    fov = float(parts[3])
    ang_res = float(parts[4])
    laser_max = float(parts[5])
    n = int(parts[8])
    ranges = np.asarray(parts[9:9 + n], np.float64)
    base = 9 + n
    n_rem = int(parts[base])
    base += 1 + n_rem
    lx, ly, lth = (float(parts[base]), float(parts[base + 1]),
                   float(parts[base + 2]))
    rx, ry, rth = (float(parts[base + 3]), float(parts[base + 4]),
                   float(parts[base + 5]))
    ts = float(parts[base + 11])
    angles = start_angle + np.arange(n) * ang_res
    mr = min(max_range, laser_max if laser_max > 0 else max_range)
    # place the sensor relative to the robot (laser pose vs robot pose)
    robot = Pose2D(rx, ry, rth)
    laser = Pose2D(lx, ly, lth)
    rel = robot - laser
    quat = np.array([math.cos(rel.rotation() / 2), 0.0, 0.0,
                     math.sin(rel.rotation() / 2)])
    cloud = PointCloudXYZ.from_ranges(ranges, angles, mr)
    cloud.sensor_origin = np.array([rel.x(), rel.y(), 0.0])
    cloud.sensor_orientation = quat
    return LaserScanRecord(cloud, robot, ts)


def read_carmen_log(source: Union[str, TextIO], max_range: float = 80.0,
                    flavor: Optional[str] = None
                    ) -> Iterator[LaserScanRecord]:
    """Iterate laser records of a CARMEN log (path or file object)."""
    close = False
    if isinstance(source, str):
        f = open(source, "r")
        close = True
    else:
        f = source
    try:
        for line in f:
            parts = line.split()
            if not parts:
                continue
            tag = parts[0]
            try:
                if tag == "FLASER" and flavor in (None, "FLASER"):
                    yield _parse_flaser(parts, max_range)
                elif tag == "ROBOTLASER1" and flavor in (None, "ROBOTLASER1"):
                    yield _parse_robotlaser(parts, max_range)
            except (ValueError, IndexError):
                continue   # malformed line; skip like the CARMEN tools do
    finally:
        if close:
            f.close()


def write_carmen_flaser(path: str, records) -> None:
    """Write FLASER records (for tests / dataset generation)."""
    with open(path, "w") as f:
        for rec in records:
            r = np.linalg.norm(rec.cloud.points[:, :2], axis=1)
            n = len(r)
            o = rec.odometry
            vals = " ".join(f"{v:.3f}" for v in r)
            f.write(f"FLASER {n} {vals} {o.x():.6f} {o.y():.6f} "
                    f"{o.rotation():.6f} {o.x():.6f} {o.y():.6f} "
                    f"{o.rotation():.6f} {rec.timestamp:.6f} host "
                    f"{rec.timestamp:.6f}\n")
