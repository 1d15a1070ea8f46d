"""The traffic generator: a robot driving a closed route through a walled
world, its lidar and its wheel odometry, made from a seed.

A frozen copy of ``iris_lama_tpu_torch/utils/simulator.py`` (exact segment
raycasting, the office world's walls and pillars, noisy odometry), changed
in three ways:

- the route is closed: its waypoints end where they start, Chaikin corner
  cutting runs round the loop, and the lap is resampled at one scan's
  travel, so the harness replays it lap after lap with no seam;
- the odometry noise is proportional to the distance travelled
  (``trans_per_m`` and ``rot_per_m`` sigmas), so it does not depend on the
  scan rate;
- a lap's scans are raycast on the device in set-up, in blocks of scans,
  in float64.

Pillars are kept off the route (``keep_off_route_m``), so a seed moves
clutter and noise but never puts a wall across the robot's path. Only
``torch`` and ``numpy`` are used: the program is not imported.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch


def wrap(a):
    return np.arctan2(np.sin(a), np.cos(a))


def compose(a, b):
    """a * b for (x, y, theta) poses, float64."""
    c, s = math.cos(a[2]), math.sin(a[2])
    return (a[0] + c * b[0] - s * b[1], a[1] + s * b[0] + c * b[1],
            float(wrap(a[2] + b[2])))


def between(a, b):
    """a^-1 * b for (x, y, theta) poses, float64 (arrays of poses too)."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    c, s = np.cos(a[..., 2]), np.sin(a[..., 2])
    dx, dy = b[..., 0] - a[..., 0], b[..., 1] - a[..., 1]
    return np.stack([c * dx + s * dy, -s * dx + c * dy,
                     wrap(b[..., 2] - a[..., 2])], -1)


def chaikin_closed(points: np.ndarray, rounds: int) -> np.ndarray:
    """Corner cutting round a closed polygon [n, 2] (first != last)."""
    p = np.asarray(points, np.float64)
    for _ in range(rounds):
        nxt = np.roll(p, -1, axis=0)
        q = 0.75 * p + 0.25 * nxt
        r = 0.25 * p + 0.75 * nxt
        p = np.stack([q, r], 1).reshape(-1, 2)
    return p


def route_polygon(route: dict) -> np.ndarray:
    """The closed route's polygon [n, 2], its first vertex not repeated."""
    wp = np.asarray(route["waypoints"], np.float64)
    if not np.allclose(wp[0], wp[-1]):
        raise ValueError("a route's waypoints must end where they start")
    return chaikin_closed(wp[:-1], int(route.get("smooth", 0)))


def lap_poses(route: dict, step_m: float) -> np.ndarray:
    """Ground-truth poses [n + 1, 3] of one lap at ``step_m`` spacing, the
    last equal to the first (the lap is closed); headings follow the
    chord to the next pose."""
    poly = route_polygon(route)
    ring = np.concatenate([poly, poly[:1]])
    seg = np.linalg.norm(np.diff(ring, axis=0), axis=1)
    s = np.concatenate([[0.0], np.cumsum(seg)])
    n = max(int(round(s[-1] / step_m)), 3)
    t = np.arange(n + 2) * (s[-1] / n)
    t = np.where(t >= s[-1], t - s[-1], t)
    xy = np.stack([np.interp(t, s, ring[:, i]) for i in (0, 1)], -1)
    xy[n] = xy[0]                               # closed to the last bit
    d = xy[1:] - xy[:-1]
    heading = np.arctan2(d[:, 1], d[:, 0])      # [n + 1]
    return np.concatenate([xy[:n + 1], heading[:, None]], -1)


def world_segments(world: dict, route_xy: np.ndarray,
                   rng: np.random.Generator) -> np.ndarray:
    """Wall segments [K, 4] (x1, y1, x2, y2): the listed walls and boxes,
    and ``pillars.count`` square pillars drawn from the seed, each kept
    ``keep_off_route_m`` off the route."""
    segs = [tuple(w) for w in world.get("walls", [])]

    def box(x0, y0, x1, y1, openings=()):
        walls = [(x0, y0, x1, y0), (x1, y0, x1, y1),
                 (x1, y1, x0, y1), (x0, y1, x0, y0)]
        segs.extend(w for i, w in enumerate(walls) if i not in openings)

    for b in world.get("boxes", []):
        box(*b["corners"], openings=tuple(b.get("openings", ())))
    pil = world.get("pillars")
    if pil:
        placed = 0
        for _ in range(1000 * max(pil["count"], 1)):
            if placed == pil["count"]:
                break
            cx = rng.uniform(*pil["x"])
            cy = rng.uniform(*pil["y"])
            size = rng.uniform(*pil["size"])
            centre = np.array([cx + size / 2, cy + size / 2])
            gap = np.min(np.linalg.norm(route_xy - centre, axis=1))
            if gap < pil["keep_off_route_m"] + size:
                continue
            box(cx, cy, cx + size, cy + size)
            placed += 1
        if placed != pil["count"]:
            raise ValueError("no room for the pillars off the route")
    return np.asarray(segs, np.float64)


def cast(segments, origins, angles, max_range: float, block: int = 64):
    """Exact ranges [S, B] from origins [S, 2] along angles [S, B] (world
    frame), float64 on the device of ``origins``; inf beyond
    ``max_range``. The same solve as the simulator's ``cast_scan``."""
    dev = origins.device
    segs = torch.as_tensor(segments, dtype=torch.float64, device=dev)
    p1 = segs[:, 0:2]
    e = segs[:, 2:4] - p1                                     # [K, 2]
    out = []
    for i in range(0, origins.shape[0], block):
        o = origins[i:i + block]                              # [s, 2]
        a = angles[i:i + block]                               # [s, B]
        dx, dy = torch.cos(a)[..., None], torch.sin(a)[..., None]
        dxe = dx * e[:, 1] - dy * e[:, 0]                     # [s, B, K]
        rel = p1[None] - o[:, None]                           # [s, K, 2]
        t_num = (rel[..., 0] * e[:, 1] - rel[..., 1] * e[:, 0])[:, None]
        u_num = rel[:, None, :, 0] * dy - rel[:, None, :, 1] * dx
        ok_d = dxe.abs() > 1e-12
        safe = torch.where(ok_d, dxe, torch.ones_like(dxe))
        t = t_num / safe
        u = u_num / safe
        ok = ok_d & (u >= 0) & (u <= 1) & (t > 1e-6)
        r = torch.where(ok, t, torch.full_like(t, math.inf)).amin(-1)
        out.append(torch.where(r <= max_range, r,
                               torch.full_like(r, math.inf)))
    return torch.cat(out)


@dataclasses.dataclass
class Lap:
    """One lap of the stream, replayed lap after lap."""

    poses: np.ndarray        # [n, 3] ground truth, float64
    deltas: np.ndarray       # [n, 3] noisy odometry increments into pose k
    points: list             # n float64 arrays [k_i, 3], sensor frame
    segments: np.ndarray     # [K, 4] the world's walls
    hz: float                # scans a second

    @property
    def n(self) -> int:
        return len(self.points)


def make_lap(traffic: dict, sensor: dict, seed: int, device) -> Lap:
    """Ground truth, odometry and scans of one lap, from ``seed``."""
    hz = float(sensor["rate_hz"])
    step = float(traffic["speed_mps"]) / hz
    closed = lap_poses(traffic["route"], step)
    poses = closed[:-1]
    n = len(poses)
    rng = np.random.default_rng(seed)
    segments = world_segments(traffic["world"], poses[:, :2], rng)

    # odometry: the true increment into each pose plus noise in proportion
    # to the distance travelled (delta 0 closes the lap: n - 1 -> 0)
    true = between(np.roll(poses, 1, axis=0), poses)
    dist = np.linalg.norm(true[:, :2], axis=1)
    on = traffic["odometry_noise"]
    noise = rng.standard_normal((n, 3))
    deltas = true.copy()
    deltas[:, 0:2] += noise[:, 0:2] * (on["trans_per_m"] * dist)[:, None]
    deltas[:, 2] = wrap(deltas[:, 2] + noise[:, 2] * on["rot_per_m"] * dist)

    # the lidar: exact ranges on the device, range noise from the seed
    nb = int(sensor["beams"])
    fov = math.radians(float(sensor["fov_deg"]))
    max_range = float(sensor["max_range_m"])
    beam = torch.linspace(-fov / 2, fov / 2, nb, dtype=torch.float64,
                          device=device)
    pt = torch.as_tensor(poses, dtype=torch.float64, device=device)
    ranges = cast(segments, pt[:, :2], beam[None] + pt[:, 2:3], max_range)
    gen = torch.Generator(device=device).manual_seed(seed)
    ranges = ranges + float(traffic["range_noise_m"]) * torch.randn(
        ranges.shape, dtype=torch.float64, device=device, generator=gen)
    ok = torch.isfinite(ranges) & (ranges > 0.0) & (ranges < max_range)
    r = torch.where(ok, ranges, torch.zeros_like(ranges))
    xyz = torch.stack([r * torch.cos(beam), r * torch.sin(beam),
                       torch.zeros_like(r)], -1).cpu().numpy()
    ok = ok.cpu().numpy()
    points = [xyz[k][ok[k]] for k in range(n)]
    return Lap(poses, deltas, points, segments, hz)


def scan_cells(points: list, poses, resolution: float) -> tuple:
    """(hit cells, free cells) a scan marks, on average over scans
    ``points`` (each [k, 3], sensor frame) taken at ``poses`` [S, 3]: one
    hit a beam, and the cells its ray passes between the sensor's cell and
    the hit's (``max(|dx|, |dy|) - 1`` of the integer walk)."""
    hits = free = 0
    for p, (x, y, th) in zip(points, np.asarray(poses, np.float64)):
        c, s = math.cos(th), math.sin(th)
        hx = x + c * p[:, 0] - s * p[:, 1]
        hy = y + s * p[:, 0] + c * p[:, 1]
        sx, sy = (math.floor(v / resolution + 0.5) for v in (x, y))
        n = np.maximum(np.abs(np.floor(hx / resolution + 0.5) - sx),
                       np.abs(np.floor(hy / resolution + 0.5) - sy))
        hits += len(p)
        free += int(np.maximum(n - 1, 0).sum())
    k = max(len(points), 1)
    return hits / k, free / k


class Stream:
    """The endless scan stream: lap position, odometry and time stamp of
    scan ``j`` = 0, 1, 2, ... The odometry starts at the origin and
    integrates the lap's noisy increments for ever."""

    def __init__(self, lap: Lap):
        self.lap = lap
        self.j = 0
        self.odom = (0.0, 0.0, 0.0)

    def next(self):
        k = self.j % self.lap.n
        if self.j > 0:
            self.odom = compose(self.odom, self.lap.deltas[k])
        out = (k, self.odom, self.j / self.lap.hz)
        self.j += 1
        return out
