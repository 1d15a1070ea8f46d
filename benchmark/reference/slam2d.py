"""The check of a Slam2D run against the plain reference.

What the program produced: a pose for every integrated update (read by the
node on the host) and, at the end, its map (hit and visit counts and the
capped distance map). The reference follows the program's published
trajectory (teacher forcing): it builds its own map from the same scans at
the program's poses, and at each sampled update of the window it matches
that scan from the program's prediction (the previous pose composed with
the odometry increment) against the map of the updates before it. So each
sampled pose is judged on its own, and a map or a re-org that went wrong
anywhere before it shows in the match and in the final map.

Numbers, each held to a limit from the configuration's ``check.limits``:

- ``pose_gap_m``, ``pose_gap_rad``: the largest gap between the program's
  pose and the reference's over the sampled updates;
- ``map_counts_differ``: the share of the cells either map visited whose
  hit or visit count differs;
- ``map_dist_differ``: the share of the cells either map puts within the
  distance cap whose capped squared distance differs.

The control (:func:`numbers` with a lower ``dtype``) puts the reference in
the program's place in that precision and is judged the same way.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from reference import plain

BLOCK = 32   # scans a deposit


def sample(record, n: int, seed: int) -> list:
    """Indices of ``n`` timed updates, drawn from the seed (never the
    first update, which has no prediction)."""
    timed = [i for i, u in enumerate(record) if u.timed and i > 0]
    rng = np.random.default_rng([seed, 0x5CA9])
    if len(timed) <= n:
        return timed
    return sorted(rng.choice(timed, size=n, replace=False).tolist())


def pose_of(u, dtype, device):
    """An update's pose (tx, ty, cos, sin) as the program held it where
    the record has it, else from the published (x, y, theta)."""
    if u.raw is not None:
        return torch.tensor(u.raw, dtype=torch.float32,
                            device=device).to(dtype)
    return plain.pose4(u.pose, dtype, device)


def _prediction(prev, odom, dtype, device):
    """The program's predicted pose: the previous pose composed with the
    odometry increment ``prev.odom^-1 * odom`` (float64, then ``dtype``)."""
    po = prev.odom
    c, s = math.cos(po[2]), math.sin(po[2])
    dx, dy = odom[0] - po[0], odom[1] - po[1]
    inc = (c * dx + s * dy, -s * dx + c * dy,
           math.atan2(math.sin(odom[2] - po[2]), math.cos(odom[2] - po[2])))
    return plain.compose(pose_of(prev, dtype, device),
                         plain.pose4(inc, dtype, device))


def _xyr(p) -> tuple:
    st = p.double().cpu().numpy()
    return (st[0], st[1], math.atan2(st[3], st[2]))


def extent(record, spec: plain.MapSpec, reach_m: float):
    """(origin cell (x, y), h, w) of a grid holding every cell the scans
    can touch, with room for the distance cap and interpolation."""
    xy = np.array([u.pose[:2] for u in record])
    margin = reach_m + (spec.radius + 4) * spec.resolution
    lo = np.floor((xy.min(0) - margin) * spec.scale).astype(int)
    hi = np.ceil((xy.max(0) + margin) * spec.scale).astype(int)
    return (int(lo[0]), int(lo[1])), int(hi[1] - lo[1]), int(hi[0] - lo[0])


def replay(lap, record, samples, config, dtype, device):
    """The reference in ``dtype``: its matched pose at each sampled update
    and its final map (counts and capped squared distance)."""
    o = config["options"]
    spec = plain.MapSpec(o["resolution"], o["l2_max"])
    sol = plain.SolveSpec(o["max_iter"])
    beams = max(len(p) for p in lap.points)
    origin, h, w = extent(record, spec, config["sensor"]["max_range_m"])
    grid = plain.Grid(origin, h, w, device)
    matched = {}
    todo = set(samples)
    i = 0
    while i < len(record):
        if i in todo:
            d2 = plain.capped_edt(grid.obstacles(), spec)
            prev, cur = record[i - 1], record[i]
            pts, m = plain.scan(lap.points[cur.scan], beams, dtype, device)
            pose0 = _prediction(prev, cur.odom, dtype, device)
            state, _ = plain.match(d2, origin, pose0, pts, m, spec, sol)
            matched[i] = _xyr(state)
        j = i + 1
        while j < len(record) and j - i < BLOCK and j not in todo:
            j += 1
        block = record[i:j]
        pts, masks = zip(*(plain.scan(lap.points[u.scan], beams, dtype,
                                      device) for u in block))
        poses = torch.stack([pose_of(u, dtype, device) for u in block])
        plain.deposit(grid, poses, torch.stack(pts), torch.stack(masks),
                      spec)
        i = j
    occ, vis = grid.counts()
    d2 = plain.capped_edt(grid.obstacles(), spec)
    return matched, {"origin": origin, "occ": occ.cpu().numpy(),
                     "vis": vis.cpu().numpy(), "d2": d2.cpu().numpy()}


def _embed(m, origin, shape, fill):
    """Map ``m``'s grid ``[y, x]`` placed in a grid of ``shape`` at world
    cell ``origin``; cells of ``m`` outside it are returned apart."""
    out = {k: np.full(shape, fill[k], np.int64) for k in fill}
    ox, oy = m["origin"][0] - origin[0], m["origin"][1] - origin[1]
    hh, ww = m["occ"].shape
    ys = slice(max(oy, 0), min(oy + hh, shape[0]))
    xs = slice(max(ox, 0), min(ox + ww, shape[1]))
    src = (slice(ys.start - oy, ys.stop - oy), slice(xs.start - ox,
                                                      xs.stop - ox))
    lost = 0
    for k in fill:
        out[k][ys, xs] = m[k][src]
        inside = np.zeros(m[k].shape, bool)
        inside[src] = True
        lost += int(np.count_nonzero((m[k] != fill[k]) & ~inside))
    return out, lost


def compare_maps(got, want, max_sq: int) -> dict:
    """Shares of differing cells between two decoded maps."""
    fill = {"occ": 0, "vis": 0, "d2": max_sq}
    g, lost = _embed(got, want["origin"], want["occ"].shape, fill)
    seen = (g["vis"] > 0) | (want["vis"] > 0)
    counts = ((g["occ"] != want["occ"]) | (g["vis"] != want["vis"])) & seen
    near = (g["d2"] < max_sq) | (want["d2"] < max_sq)
    dist = (g["d2"] != want["d2"]) & near
    return {"map_counts_differ":
            (int(counts.sum()) + lost) / max(int(seen.sum()), 1),
            "map_dist_differ": (int(dist.sum()) + lost) / max(int(near.sum()),
                                                              1)}


def pose_gaps(got: dict, want: dict) -> dict:
    """Largest translation and rotation gaps over the sampled updates."""
    gm = gr = 0.0
    for i, w in want.items():
        g = got[i]
        gm = max(gm, math.hypot(g[0] - w[0], g[1] - w[1]))
        gr = max(gr, abs(math.atan2(math.sin(g[2] - w[2]),
                                    math.cos(g[2] - w[2]))))
    return {"pose_gap_m": gm, "pose_gap_rad": gr}


def numbers(lap, record, outputs, config, seed, device,
            dtype=torch.float32) -> dict:
    """The check's numbers for the program's run, or, with a ``dtype``
    below float32, for the control put in the program's place."""
    o = config["options"]
    max_sq = plain.MapSpec(o["resolution"], o["l2_max"]).max_sq
    samples = sample(record, config["check"]["samples"], seed)
    ref_poses, ref_map = replay(lap, record, samples, config, torch.float32,
                                device)
    if dtype == torch.float32:
        got_poses = {i: _xyr(pose_of(record[i], torch.float64, "cpu"))
                     for i in samples}
        got_map = outputs["map"]
    else:
        got_poses, got_map = replay(lap, record, samples, config, dtype,
                                    device)
    return {**pose_gaps(got_poses, ref_poses),
            **compare_maps(got_map, ref_map, max_sq)}
