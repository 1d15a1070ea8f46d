"""Distance field: capped exact EDT and bilinear interpolation.

reference: src/sdm/dynamic_distance_map.cpp — the incremental distance
transform is replaced by an exact dense recompute over the active window
(:func:`edt2d`, kernel B3), capped at ``max_sqdist`` like the reference
(.cpp:140-153). Interpolation reproduces the reference formulas:
floor-discretised coords, 4-cell bilinear value and gradient scaled by
-scale (.cpp:66-93).

Resident windows hold *squared cell distances* in a narrow integer type
(``DistanceConfig.sq_dtype``); each interpolation corner converts to meters
with the same ``sqrt(d2) * resolution`` arithmetic the float map uses, so
results equal the float-grid path.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch

from ..ops import edt_pallas, select4
from . import pool as pool_mod
from .geometry import MapGeometry, f32


@dataclasses.dataclass(frozen=True)
class DistanceConfig:
    """Static parameters of a distance map."""

    geometry: MapGeometry = MapGeometry()
    l2_max: float = 0.5   # meters (setMaxDistance, .cpp:149)

    @property
    def max_sqdist(self) -> int:
        # reference: max_sqdist = ceil(distance * scale)^2 (.cpp:151-153)
        r = math.ceil(self.l2_max * self.geometry.scale)
        return r * r

    @property
    def radius_cells(self) -> int:
        return math.ceil(self.l2_max * self.geometry.scale)

    @property
    def max_dist(self) -> float:
        # distance() for invalid cells: sqrt(max_sqdist) * resolution
        return math.sqrt(self.max_sqdist) * self.geometry.resolution

    @property
    def sq_dtype(self):
        """Narrowest dtype for squared-distance grids."""
        if self.max_sqdist <= 127:
            return torch.int8
        if self.max_sqdist <= 255:
            return torch.uint8
        return torch.int16 if self.max_sqdist <= 32767 else torch.int32

    def dist_to_sq(self, dist):
        """f32 meters -> capped squared cell distance (exact: stored meters
        are sqrt(k)*res for integer k <= max_sqdist, and the f32 round trip
        recovers k)."""
        d = dist * f32(self.geometry.scale)
        d2 = torch.round(d * d)
        return torch.clamp(d2, 0, self.max_sqdist).to(self.sq_dtype)

    def sq_to_dist(self, d2):
        """Squared cell distance -> f32 meters."""
        return torch.sqrt(d2.to(torch.float32)) * f32(self.geometry.resolution)


def edt2d(obstacle, max_sqdist: int, radius: int):
    """Exact capped squared EDT of a bool grid [H, W] -> int32 [H, W]
    (kernel B3 on CUDA tensors)."""
    return edt_pallas.edt2d(obstacle, max_sqdist, radius)


def _bilinear(v00, v10, v01, v11, mu, scale: float):
    """The reference's 2D interpolation + analytic gradient.

    v10 is the (+1, 0) neighbour, v01 the (0, +1) neighbour.
    """
    mux, muy = mu[..., 0], mu[..., 1]
    mix, miy = 1.0 - mux, 1.0 - muy
    dist = (v00 * mix * miy + v10 * miy * mux +
            v01 * mix * muy + v11 * mux * muy)
    gx = -((v00 - v10) * miy + (v01 - v11) * muy) * scale
    gy = -((v00 - v01) * mix + (v10 - v11) * mux) * scale
    return dist, torch.stack([gx, gy], dim=-1)


def _interp_window_sq(grid, org_cell, geo: MapGeometry, world_xy, max_dist):
    """Interpolated distance + gradient from an integer squared-distance
    window ``grid`` [H, W] ([y, x]) whose cell (0, 0) is ``org_cell``.

    Cells outside the window read ``max_dist`` (like unallocated patches,
    .cpp:140-143). The four corners come from kernel B2 (select4).
    """
    mi, mu = geo.w2m_frac(world_xy)                  # int cell (x, y), frac
    loc = mi - org_cell.to(torch.int32)              # [..., 2] (lx, ly)
    h, w = grid.shape
    lx = loc[..., 0]                                 # views: B2 reads
    ly = loc[..., 1]                                 # them in place
    v = select4.select4_sq(grid, ly, lx)             # i32[4, B]
    md = f32(max_dist)
    res = f32(geo.resolution)
    inx0 = (lx >= 0) & (lx < w)
    inx1 = (lx + 1 >= 0) & (lx + 1 < w)
    iny0 = (ly >= 0) & (ly < h)
    iny1 = (ly + 1 >= 0) & (ly + 1 < h)

    def corner(s, ok):
        return torch.where(ok, torch.sqrt(s.to(torch.float32)) * res, md)

    v00 = corner(v[0], inx0 & iny0)
    v10 = corner(v[1], inx1 & iny0)
    v01 = corner(v[2], inx0 & iny1)
    v11 = corner(v[3], inx1 & iny1)
    return _bilinear(v00, v10, v01, v11, mu, f32(geo.scale))


def interp_window(grid, org_cell, geo: MapGeometry, world_xy, max_dist):
    """Interpolated distance + gradient from a dense window ``grid`` [H, W]
    ([y, x]) whose cell (0, 0) is ``org_cell``; cells outside it read
    ``max_dist``.

    Integer grids hold capped squared cell distances (B2 selects their
    corners); float grids hold meters and their four corners are one plain
    gather (the JAX package selected them with one-hot matrix products,
    which give the same values).
    """
    if not grid.dtype.is_floating_point:
        return _interp_window_sq(grid, org_cell, geo, world_xy, max_dist)
    mi, mu = geo.w2m_frac(world_xy)                  # int cell (x, y), frac
    loc = mi - org_cell.to(torch.int32)              # [..., 2] (lx, ly)
    h, w = grid.shape
    lx, ly = loc[..., 0], loc[..., 1]
    y0 = ly.clamp(0, h - 1).long() * w
    y1 = (ly + 1).clamp(0, h - 1).long() * w
    x0 = lx.clamp(0, w - 1).long()
    x1 = (lx + 1).clamp(0, w - 1).long()
    v = grid.reshape(-1)[torch.stack([y0 + x0, y0 + x1, y1 + x0, y1 + x1])]
    md = f32(max_dist)
    inx0 = (lx >= 0) & (lx < w)
    inx1 = (lx + 1 >= 0) & (lx + 1 < w)
    iny0 = (ly >= 0) & (ly < h)
    iny1 = (ly + 1 >= 0) & (ly + 1 < h)
    v00 = torch.where(inx0 & iny0, v[0], md)
    v10 = torch.where(inx1 & iny0, v[1], md)
    v01 = torch.where(inx0 & iny1, v[2], md)
    v11 = torch.where(inx1 & iny1, v[3], md)
    return _bilinear(v00, v10, v01, v11, mu, f32(geo.scale))


def cell_distance(table, dist, geo: MapGeometry, cells, max_dist):
    """Nearest-cell distance straight from the patch pool (.cpp:140):
    cells int32 [..., 2] -> f32 [...]; missing patches read ``max_dist``."""
    slots, idx = pool_mod.locate(table, geo, cells, dist.shape[0] - 1)
    return torch.where(slots >= 0, dist[idx], f32(max_dist))


def interp_pool(table, dist, geo: MapGeometry, world_xy, max_dist):
    """Interpolated distance + gradient straight from the patch pool, where
    no dense window exists (global localisation hypotheses spread over the
    whole map, loc2d.cpp:249-286). The four corners take one table probe."""
    mi, mu = geo.w2m_frac(world_xy)
    corners = torch.tensor([[0, 0], [1, 0], [0, 1], [1, 1]],
                           dtype=torch.int32, device=mi.device)
    v = cell_distance(table, dist, geo, mi[..., None, :] + corners, max_dist)
    return _bilinear(v[..., 0], v[..., 1], v[..., 2], v[..., 3], mu,
                     f32(geo.scale))


class DistanceMapState(NamedTuple):
    """A standalone pool-backed distance map: the fixed map Loc2D reads
    (loc2d.h:103-104).

    ``obstacle`` is derived, as in the JAX package's ``SlamMapState``: a
    cell is an obstacle iff its stored distance is exactly 0 (the port's
    ``SlamMapState`` keeps no obstacle array of its own).
    """

    table: pool_mod.PatchTable
    obstacle: torch.Tensor   # bool [P+1, L, L]
    dist: torch.Tensor       # f32 [P+1, L, L] meters


def distance_map_init(cfg: DistanceConfig, capacity: int,
                      device=None) -> DistanceMapState:
    """An empty standalone distance map: no patches, every cell at
    ``cfg.max_dist`` and no obstacle."""
    length = cfg.geometry.patch_length
    return DistanceMapState(
        table=pool_mod.table_init(capacity, device=device),
        obstacle=torch.zeros((capacity + 1, length, length), dtype=torch.bool,
                             device=device),
        dist=torch.full((capacity + 1, length, length), cfg.max_dist,
                        dtype=torch.float32, device=device),
    )
