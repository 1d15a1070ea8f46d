"""Plain LaMa mapping and scan matching on one dense world grid.

Written from the reference's description, in plain PyTorch, with no patch
pool, window, re-org or kernel: the semantics the port must keep.

- Cells: ``w2m(p) = floor(p * scale + 0.5)`` (world origin at cell 0);
  interpolation floors (``floor(p * scale)`` and its fraction).
- A scan at pose ``T`` (``tx, ty, cos, sin``) marks each beam's end cell
  once as hit and visited, and each cell its ray passes (the integer walk
  of src/sdm/map.cpp ``computeRay``: cells ``t = 1 .. n - 1`` of ``n =
  max |delta|``, axis ``j`` advanced ``(2 t |d_j| + n) // (2 n)`` cells)
  once as visited. Counts are uint16 values (clipped at 65535).
- Occupancy is the frequency model: a cell is an obstacle iff
  ``4 * hits > visits`` (probability above 0.25).
- The distance map is the exact squared cell distance to the nearest
  obstacle, capped at ``ceil(l2_max * scale) ** 2``; a cell reads
  ``sqrt(d2) * resolution`` metres, ``max_dist`` off the grid.
- The scan match is Gauss-Newton IRLS on ``r_i = d(T * p_i)`` with the
  4-cell bilinear value and gradient (dynamic_distance_map.cpp), Jacobian
  row ``[gx, gy, gy * x - gx * y]``, Cauchy weights ``1 / (1 + r^2 /
  c^2)``, the step ``T' = exp(h) * T``; it stops when ``max |J'Wr| <
  eps1`` or ``max |h| < eps2`` (no step taken), when a step does not lower
  ``chi2`` (the step is counted and not applied), or after ``max_iter``
  steps (src/nlls/solver.cpp, gauss_newton.cpp).

Every float operation runs in ``dtype``: float32 for the reference, a
lower precision for the control. Imports only torch and numpy.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

COUNT_MAX = 65535


@dataclasses.dataclass(frozen=True)
class MapSpec:
    resolution: float = 0.05
    l2_max: float = 0.5

    @property
    def scale(self) -> float:
        return 1.0 / self.resolution

    @property
    def radius(self) -> int:
        return math.ceil(self.l2_max * self.scale)

    @property
    def max_sq(self) -> int:
        return self.radius * self.radius

    @property
    def max_dist(self) -> float:
        return math.sqrt(self.max_sq) * self.resolution


class Grid:
    """Dense hit and visit counts ``[h, w]`` (``[y, x]``) whose cell [0, 0]
    is world cell ``origin`` (x, y)."""

    def __init__(self, origin, h: int, w: int, device):
        self.origin = (int(origin[0]), int(origin[1]))
        self.occ = torch.zeros((h, w), dtype=torch.int64, device=device)
        self.vis = torch.zeros((h, w), dtype=torch.int64, device=device)

    @property
    def shape(self):
        return tuple(self.occ.shape)

    def counts(self):
        return (self.occ.clamp(max=COUNT_MAX), self.vis.clamp(max=COUNT_MAX))

    def obstacles(self):
        occ, vis = self.counts()
        return 4 * occ > vis


def scan(points, beams: int, dtype, device):
    """A scan's points ``[k, 3]`` (float64, base frame) as ``[beams, 2]``
    in ``dtype`` and its mask ``[beams]``, as the sensor hands them over
    (padded, rounded to float32 first)."""
    p = np.zeros((beams, 2), np.float32)
    m = np.zeros(beams, bool)
    p[:len(points)] = points[:, :2].astype(np.float32)
    m[:len(points)] = True
    return (torch.as_tensor(p, device=device).to(dtype),
            torch.as_tensor(m, device=device))


def pose4(xyr, dtype, device):
    """(tx, ty, cos, sin) of (x, y, theta) poses ``[..., 3]``."""
    p = torch.as_tensor(np.asarray(xyr, np.float64), device=device)
    return torch.stack([p[..., 0], p[..., 1], torch.cos(p[..., 2]),
                        torch.sin(p[..., 2])], -1).to(dtype)


def apply(pose, pts):
    """Transform points ``[..., B, 2]`` by poses ``[..., 4]``."""
    tx, ty, c, s = (pose[..., k, None] for k in range(4))
    x, y = pts[..., 0], pts[..., 1]
    return torch.stack([tx + c * x - s * y, ty + s * x + c * y], -1)


def compose(a, b):
    ca, sa, cb, sb = a[..., 2], a[..., 3], b[..., 2], b[..., 3]
    return torch.stack([a[..., 0] + ca * b[..., 0] - sa * b[..., 1],
                        a[..., 1] + sa * b[..., 0] + ca * b[..., 1],
                        ca * cb - sa * sb, sa * cb + ca * sb], -1)


def exp(h):
    """SE(2) exponential of a twist (v1, v2, omega)."""
    v1, v2, w = h[..., 0], h[..., 1], h[..., 2]
    small = torch.abs(w) < 1e-4
    safe = torch.where(small, torch.ones_like(w), w)
    sinc = torch.where(small, 1.0 - w * w / 6.0, torch.sin(safe) / safe)
    cosc = torch.where(small, w / 2.0 - w * w * w / 24.0,
                       (1.0 - torch.cos(safe)) / safe)
    return torch.stack([sinc * v1 - cosc * v2, cosc * v1 + sinc * v2,
                        torch.cos(w), torch.sin(w)], -1)


def w2m(xy, spec: MapSpec):
    """World -> cell, rounding half up; int64."""
    s = torch.as_tensor(spec.scale, dtype=xy.dtype)
    return torch.floor(xy * s + 0.5).to(torch.int64)


def deposit(grid: Grid, poses, pts, mask, spec: MapSpec) -> None:
    """Add scans to ``grid``: poses ``[S, 4]``, points ``[S, B, 2]``
    (base frame), mask ``[S, B]``; the sensor sits at the base."""
    dev = grid.occ.device
    h, w = grid.shape
    ox, oy = grid.origin
    start = w2m(poses[:, None, :2], spec).expand(-1, pts.shape[1], -1)
    hit = w2m(apply(poses, pts), spec)                       # [S, B, 2]
    d = hit - start
    ad = d.abs()
    n = ad.amax(-1)                                          # [S, B]
    n_safe = n.clamp(min=1)
    t_max = int(n.max()) if n.numel() else 0
    t = torch.arange(1, max(t_max, 1), device=dev)           # 1 .. n-1
    c = torch.div(2 * t[:, None] * ad[..., None, :] + n_safe[..., None, None],
                  2 * n_safe[..., None, None], rounding_mode="floor")
    free = start[..., None, :] + torch.sign(d)[..., None, :] * c
    free_ok = mask[..., None] & (t <= n[..., None] - 1)

    def add(arr, cells, ok):
        lx = cells[..., 0] - ox
        ly = cells[..., 1] - oy
        inside = ok & (lx >= 0) & (lx < w) & (ly >= 0) & (ly < h)
        flat = (ly * w + lx)[inside]
        arr.view(-1).index_add_(0, flat, torch.ones_like(flat))

    add(grid.occ, hit, mask)
    add(grid.vis, hit, mask)
    add(grid.vis, free, free_ok)


def capped_edt(obst, spec: MapSpec):
    """Exact squared distance to the nearest obstacle, capped at
    ``spec.max_sq``: a column pass and a row pass over offsets up to the
    radius (an obstacle farther along either axis lies past the cap)."""
    r, cap = spec.radius, spec.max_sq
    big = cap + 1
    h, w = obst.shape
    src = torch.where(obst, 0, big).to(torch.int64)
    col = torch.full((h + 2 * r, w), big, dtype=torch.int64,
                     device=obst.device)
    col[r:r + h] = src
    g = torch.full((h, w), big, dtype=torch.int64, device=obst.device)
    for dy in range(-r, r + 1):
        g = torch.minimum(g, torch.where(col[r + dy:r + dy + h] == 0,
                                         dy * dy, big))
    row = torch.full((h, w + 2 * r), big, dtype=torch.int64,
                     device=obst.device)
    row[:, r:r + w] = g
    out = torch.full((h, w), big, dtype=torch.int64, device=obst.device)
    for dx in range(-r, r + 1):
        out = torch.minimum(out, row[:, r + dx:r + dx + w] + dx * dx)
    return out.clamp(max=cap)


def interp(d2, origin, xy, spec: MapSpec):
    """Distance (metres) and gradient at world points ``xy [B, 2]`` from
    the squared-distance grid ``d2`` whose cell [0, 0] is ``origin``."""
    dt = xy.dtype
    mf = xy * torch.as_tensor(spec.scale, dtype=dt)
    fl = torch.floor(mf)
    mu = mf - fl
    cell = fl.to(torch.int64)
    lx = cell[:, 0] - origin[0]
    ly = cell[:, 1] - origin[1]
    h, w = d2.shape
    md = torch.as_tensor(spec.max_dist, dtype=dt, device=xy.device)
    res = torch.as_tensor(spec.resolution, dtype=dt)

    def corner(y, x):
        ok = (x >= 0) & (x < w) & (y >= 0) & (y < h)
        v = d2[y.clamp(0, h - 1), x.clamp(0, w - 1)]
        return torch.where(ok, torch.sqrt(v.to(dt)) * res, md)

    v00, v10 = corner(ly, lx), corner(ly, lx + 1)
    v01, v11 = corner(ly + 1, lx), corner(ly + 1, lx + 1)
    mux, muy = mu[:, 0], mu[:, 1]
    mix, miy = 1.0 - mux, 1.0 - muy
    dist = v00 * mix * miy + v10 * miy * mux + v01 * mix * muy + v11 * mux * muy
    scale = torch.as_tensor(spec.scale, dtype=dt)
    gx = -((v00 - v10) * miy + (v01 - v11) * muy) * scale
    gy = -((v00 - v01) * mix + (v10 - v11) * mux) * scale
    return dist, gx, gy


@dataclasses.dataclass(frozen=True)
class SolveSpec:
    max_iter: int = 100
    eps1: float = 1e-4
    eps2: float = 1e-4
    cauchy: float = 0.15


def _weighted(d2, origin, pose, pts, fm, spec, sol):
    hits = apply(pose, pts)
    dist, gx, gy = interp(d2, origin, hits, spec)
    r = dist * fm
    gx, gy = gx * fm, gy * fm
    jw = gy * hits[:, 0] - gx * hits[:, 1]
    wt = 1.0 / (1.0 + r * r / (sol.cauchy * sol.cauchy))
    sw = torch.sqrt(wt)
    r = r * sw
    J = torch.stack([gx, gy, jw], -1) * sw[:, None]
    return r, J, torch.sum(r * r)


def _solve3(A, g):
    """h with A h = -g for a symmetric 3 x 3 ``A`` (adjugate)."""
    a, b, c = A[0, 0], A[0, 1], A[0, 2]
    d, e, f = A[1, 1], A[1, 2], A[2, 2]
    co00, co01, co02 = d * f - e * e, c * e - b * f, b * e - c * d
    co11, co12, co22 = a * f - c * c, b * c - a * e, a * d - b * b
    det = a * co00 + b * co01 + c * co02
    inv = torch.where(det.abs() > 1e-30, 1.0 / det, torch.zeros_like(det))
    return -torch.stack([co00 * g[0] + co01 * g[1] + co02 * g[2],
                         co01 * g[0] + co11 * g[1] + co12 * g[2],
                         co02 * g[0] + co12 * g[1] + co22 * g[2]]) * inv


def match(d2, origin, pose0, pts, mask, spec: MapSpec, sol: SolveSpec):
    """The scan match from ``pose0 [4]``: (pose [4], steps taken)."""
    fm = mask.to(pose0.dtype)
    state = pose0
    r, J, chi2 = _weighted(d2, origin, state, pts, fm, spec, sol)
    it = 0
    while it < sol.max_iter:
        A = (J[:, :, None] * J[:, None, :]).sum(0)
        g = (J * r[:, None]).sum(0)
        if float(g.abs().max()) < sol.eps1:
            break
        h = _solve3(A, g)
        if float(h.abs().max()) < sol.eps2:
            break
        it += 1
        cand = compose(exp(h), state)
        nr, nJ, nchi2 = _weighted(d2, origin, cand, pts, fm, spec, sol)
        if not float(chi2 - nchi2) > 0.0:
            break
        state, r, J, chi2 = cand, nr, nJ, nchi2
    return state, it
