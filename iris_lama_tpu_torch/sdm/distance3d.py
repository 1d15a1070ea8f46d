"""3D dynamic distance map: incremental windowed updates, trilinear reads.

reference: src/sdm/dynamic_distance_map.cpp — the 3D branch of the
Lau/Sprunk/Burgard incremental DT (26-neighbourhood wavefronts, :41-46;
trilinear interpolation with analytic gradient, :95-138). As in the JAX
package, the raise/lower priority queues become an exact windowed
recompute over dirty patches:

* :func:`add_obstacles3` / :func:`remove_obstacles3` flip obstacle bits and
  mark dirty (allocating) every patch of the ``(2*halo+1)^3`` patch cube
  around each changed cell;
* :func:`update3` recomputes each dirty patch's capped squared distances
  with one separable EDT over the patch and a halo window of ``halo``
  patches a side (any obstacle within R of a centre cell lies inside it),
  narrowed to the cells that can reach the patch;
* :func:`distance3` — trilinear distance and its analytic gradient.

:func:`update3` drains the dirty slots in ascending slot order, at most
``max_dirty`` of them a call (the overflow keeps its dirty bit), and
recomputes them in chunks of at most ``UPDATE_CHUNK_CELLS`` window cells,
so memory stays bounded at any ``max_dirty``; the chunks give the same
values as one batch.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch

from . import pool as pool_mod
from .geometry import f32
from .occupancy3d import (PKEY3_BITS, MapGeometry3, _device, envelope,
                          erode_z, insert_unique_keys, locate3)

# window cells recomputed at once by update3 (int32: 128 MiB a tensor)
UPDATE_CHUNK_CELLS = 1 << 25


@dataclasses.dataclass(frozen=True)
class Distance3Config:
    geometry: MapGeometry3 = MapGeometry3()
    l2_max: float = 0.5

    @property
    def radius_cells(self) -> int:
        return math.ceil(self.l2_max * self.geometry.scale)

    @property
    def max_sqdist(self) -> int:
        return self.radius_cells ** 2

    @property
    def max_dist(self) -> float:
        return math.sqrt(self.max_sqdist) * self.geometry.resolution

    @property
    def halo_patches(self) -> int:
        length = self.geometry.patch_length
        return (self.radius_cells + length - 1) // length


class Distance3State(NamedTuple):
    table: pool_mod.PatchTable
    obstacle: torch.Tensor   # bool [P+1, L, L, L] ([z, y, x] in a patch)
    sqdist: torch.Tensor     # int32 [P+1, L, L, L], capped
    dirty: torch.Tensor      # bool [P+1]


def distance3_init(cfg: Distance3Config, capacity: int,
                   device=None) -> Distance3State:
    dev = _device(device)
    length = cfg.geometry.patch_length
    shape = (capacity + 1, length, length, length)
    return Distance3State(
        table=pool_mod.table_init(capacity, device=dev),
        obstacle=torch.zeros(shape, dtype=torch.bool, device=dev),
        sqdist=torch.full(shape, cfg.max_sqdist, dtype=torch.int32,
                          device=dev),
        dirty=torch.zeros((capacity + 1,), dtype=torch.bool, device=dev))


def _key_parts(keys):
    mask = (1 << PKEY3_BITS) - 1
    return keys >> (2 * PKEY3_BITS), (keys >> PKEY3_BITS) & mask, keys & mask


def _cube(halo: int):
    return [(dx, dy, dz)
            for dx in range(-halo, halo + 1)
            for dy in range(-halo, halo + 1)
            for dz in range(-halo, halo + 1)]


def _mark(state: Distance3State, cfg: Distance3Config, cells, value: bool):
    """Set/clear the obstacle bits at ``cells`` [N, 3] (map cells) and
    allocate and dirty the patch cube each change can influence."""
    geo = cfg.geometry
    trash = state.obstacle.shape[0] - 1
    length = geo.patch_length
    cells = cells.to(torch.int32)
    offs = torch.as_tensor(_cube(cfg.halo_patches), dtype=torch.int32,
                           device=cells.device) * length       # [C, 3]
    keys = geo.m2p(cells[None, :, :] + offs[:, None, :])       # [C, N]
    table, slots_u = insert_unique_keys(state.table, keys)
    dirty = state.dirty.clone()
    dirty[torch.where(slots_u >= 0, slots_u, trash).long()] = True
    _, idx = locate3(table, geo, cells, trash)
    obstacle = state.obstacle.clone()
    obstacle[idx] = value
    obstacle[trash] = False
    dirty[trash] = False
    return Distance3State(table, obstacle, state.sqdist, dirty)


def add_obstacles3(state, cfg, cells):
    """addObstacle batch (dynamic_distance_map.cpp:212-226)."""
    return _mark(state, cfg, cells, True)


def remove_obstacles3(state, cfg, cells):
    """removeObstacle batch (dynamic_distance_map.cpp:228-242)."""
    return _mark(state, cfg, cells, False)


def dirty_slots(state: Distance3State):
    """int64 [n]: the allocated dirty slots, ascending (one host read)."""
    capacity = state.obstacle.shape[0] - 1
    do = state.dirty[:capacity] & pool_mod.active_slot_mask(state.table)
    return torch.nonzero(do).reshape(-1)


def _recompute(state: Distance3State, cfg: Distance3Config, keys):
    """The capped squared distances [n, L, L, L] of the patches ``keys``.

    The JAX package runs :func:`occupancy3d.edt3d` over each patch's whole
    window of ``(2*halo+1)^3`` patches and keeps the centre. Only cells
    within R of the centre can reach it, so this builds the window's
    centre +- R (``L + 2R`` cells a side) and narrows each pass to what
    the next one reads: the z erosion over all of it, the y envelope at
    the centre's z, the x envelope at the centre's z and y. Every centre
    cell takes its minimum over the same values: the same result."""
    length = cfg.geometry.patch_length
    halo = cfg.halo_patches
    r = cfg.radius_cells
    lo, n = halo * length - r, length + 2 * r
    trash = state.obstacle.shape[0] - 1
    px, py, pz = _key_parts(keys)
    win = torch.zeros((keys.shape[0], n, n, n), dtype=torch.bool,
                      device=keys.device)
    for dx, dy, dz in _cube(halo):
        spans = [_clip((d + halo) * length - lo, length, n)
                 for d in (dz, dy, dx)]
        if any(s is None for s in spans):
            continue
        nkey = (((px + dx) << (2 * PKEY3_BITS))
                | ((py + dy) << PKEY3_BITS) | (pz + dz))
        s = pool_mod.table_lookup(state.table, nkey)
        block = state.obstacle[torch.where(s >= 0, s, trash).long()]
        (za, zb, z0), (ya, yb, y0), (xa, xb, x0) = spans
        win[:, z0:z0 + zb - za, y0:y0 + yb - ya, x0:x0 + xb - xa] = \
            block[:, za:zb, ya:yb, xa:xb]
    g = erode_z(win, r)[:, r:r + length]
    h = envelope(g * g, -2, r)[:, :, r:r + length]
    d2 = envelope(h, -1, r)[..., r:r + length]
    return torch.clamp(d2, max=cfg.max_sqdist)


def _clip(start: int, length: int, n: int):
    """(first, end) of a block's cells inside ``[0, n)`` and where they go,
    for a block of ``length`` cells at ``start``; None if none are."""
    a, b = max(0, -start), min(length, n - start)
    return (a, b, start + a) if b > a else None


def update3(state: Distance3State, cfg: Distance3Config,
            max_dirty: int | None = None) -> Distance3State:
    """Recompute the dirty patches (the ``update()`` queue drain,
    dynamic_distance_map.cpp:160-197, as an exact windowed EDT).

    The first ``max_dirty`` allocated dirty slots in ascending order
    (``None``: all of them) are recomputed and cleared; the overflow keeps
    its dirty bit for the next call, as the JAX package's
    ``nonzero(size=max_dirty)`` drain does."""
    capacity = state.obstacle.shape[0] - 1
    trash = capacity
    limit = capacity if max_dirty is None else min(max_dirty, capacity)
    slots = dirty_slots(state)[:limit]
    keys_by_slot = pool_mod.active_keys(state.table)[0]
    n = cfg.geometry.patch_length + 2 * cfg.radius_cells
    chunk = max(1, UPDATE_CHUNK_CELLS // n ** 3)
    sqdist = state.sqdist.clone()
    for i in range(0, slots.shape[0], chunk):
        part = slots[i:i + chunk]
        sqdist[part] = _recompute(state, cfg, keys_by_slot[part])
    sqdist[trash] = cfg.max_sqdist
    dirty = state.dirty.clone()
    dirty[slots] = False
    dirty[trash] = False
    return Distance3State(state.table, state.obstacle, sqdist, dirty)


def distance3(state: Distance3State, cfg: Distance3Config, world_xyz):
    """Trilinear interpolated distance (meters) and its analytic gradient
    (dynamic_distance_map.cpp:95-138). world_xyz: [..., 3]."""
    geo = cfg.geometry
    trash = state.obstacle.shape[0] - 1
    mf = world_xyz.to(torch.float32) * f32(geo.scale)
    fl = torch.floor(mf)
    mi = fl.to(torch.int32) + geo.cell_offset
    mu = mf - fl                                        # [..., 3] (x, y, z)
    res = f32(geo.resolution)

    def cell_val(cells):
        slots, idx = locate3(state.table, geo, cells, trash)
        sq = torch.where(slots >= 0, state.sqdist[idx], cfg.max_sqdist)
        return torch.sqrt(sq.to(torch.float32)) * res

    v = {}
    for i in (0, 1):
        for j in (0, 1):
            for k in (0, 1):
                off = torch.tensor([i, j, k], dtype=torch.int32,
                                   device=mi.device)
                v[i, j, k] = cell_val(mi + off)
    mx, my, mz = mu[..., 0], mu[..., 1], mu[..., 2]
    ix, iy, iz = 1.0 - mx, 1.0 - my, 1.0 - mz
    dist = (v[0, 0, 0] * ix * iy * iz + v[1, 0, 0] * mx * iy * iz
            + v[0, 1, 0] * ix * my * iz + v[1, 1, 0] * mx * my * iz
            + v[0, 0, 1] * ix * iy * mz + v[1, 0, 1] * mx * iy * mz
            + v[0, 1, 1] * ix * my * mz + v[1, 1, 1] * mx * my * mz)
    scale = f32(geo.scale)
    gx = ((v[1, 0, 0] - v[0, 0, 0]) * iy * iz
          + (v[1, 1, 0] - v[0, 1, 0]) * my * iz
          + (v[1, 0, 1] - v[0, 0, 1]) * iy * mz
          + (v[1, 1, 1] - v[0, 1, 1]) * my * mz) * scale
    gy = ((v[0, 1, 0] - v[0, 0, 0]) * ix * iz
          + (v[1, 1, 0] - v[1, 0, 0]) * mx * iz
          + (v[0, 1, 1] - v[0, 0, 1]) * ix * mz
          + (v[1, 1, 1] - v[1, 0, 1]) * mx * mz) * scale
    gz = ((v[0, 0, 1] - v[0, 0, 0]) * ix * iy
          + (v[1, 0, 1] - v[1, 0, 0]) * mx * iy
          + (v[0, 1, 1] - v[0, 1, 0]) * ix * my
          + (v[1, 1, 1] - v[1, 1, 0]) * mx * my) * scale
    return dist, torch.stack([gx, gy, gz], dim=-1)
