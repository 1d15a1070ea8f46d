"""3D occupancy maps and the exact capped 3D distance transform.

reference: every Map subclass accepts ``is3d`` (map.h:308; 3D volumes,
the 3D ray walk map.cpp:198-258, the 3D DT neighbourhood
dynamic_distance_map.cpp:41-46). No reference algorithm consumes 3D
occupancy; this is the storage/query/update layer:

* a 3D patch pool ``[P+1, L, L, L]`` (cells ``[z, y, x]`` within a patch)
  with 10-bit-an-axis packed patch keys (the scheme of ``sdm/tsdf.py``);
* simple, frequency and probabilistic cells in 3D;
* batched point-cloud integration with the closed-form ray walk
  (``sdm/raycast.py`` works in any dimension);
* :func:`edt3d`, the exact capped squared 3D EDT by separable passes.

Patch allocation follows the JAX package: the sorted unique keys of a
call, at most 4,096 of them (the smallest; the rest are never allocated
and their cells land on the trash slot), are inserted one after the other
(:func:`pool.table_insert_ordered` gives that table in vectorised
rounds). Frequency counts are uint16 held in int32, each sum taken mod
2**16 as the JAX package's uint16 scatter-add wraps.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from . import pool as pool_mod
from .geometry import f32
from .occupancy import U16_MASK, probabilistic_saturate, scatter_sum
from .raycast import ray_cells

PKEY3_BITS = 10
CENTER_PATCH3 = 1 << (PKEY3_BITS - 1)
UNIQUE_CAP = 4096     # patches a call may allocate (the JAX unique's size)
_BIG = 1 << 20


@dataclasses.dataclass(frozen=True)
class MapGeometry3:
    """3D analogue of MapGeometry (the same integer-offset trick)."""

    resolution: float = 0.05
    log2dim: int = 4

    @property
    def patch_length(self) -> int:
        return 1 << self.log2dim

    @property
    def scale(self) -> float:
        return 1.0 / self.resolution

    @property
    def cell_offset(self) -> int:
        return CENTER_PATCH3 * self.patch_length

    def w2m(self, world):
        mf = world.to(torch.float32) * f32(self.scale)
        return torch.floor(mf + 0.5).to(torch.int32) + self.cell_offset

    def m2w(self, cells):
        rel = cells.to(torch.int32) - self.cell_offset
        return rel.to(torch.float32) * f32(self.resolution)

    def m2p(self, cells):
        p = cells.to(torch.int32) >> self.log2dim
        return ((p[..., 0] << (2 * PKEY3_BITS)) | (p[..., 1] << PKEY3_BITS)
                | p[..., 2])

    def m2local(self, cells):
        return cells.to(torch.int32) & (self.patch_length - 1)


class Frequency3State(NamedTuple):
    table: pool_mod.PatchTable
    occupied: torch.Tensor   # int32 [P+1, L, L, L] (uint16 values)
    visited: torch.Tensor


class Simple3State(NamedTuple):
    table: pool_mod.PatchTable
    cells: torch.Tensor      # int8


class Probabilistic3State(NamedTuple):
    table: pool_mod.PatchTable
    logodds: torch.Tensor    # f32
    touched: torch.Tensor    # bool


def _zeros(geo, dtype, capacity, device):
    length = geo.patch_length
    return torch.zeros((capacity + 1, length, length, length), dtype=dtype,
                       device=device)


def _device(device):
    from ..algos.slam2d import resolve_device
    return resolve_device(device)


def frequency3_init(geo: MapGeometry3, capacity: int = 4096, device=None):
    dev = _device(device)
    return Frequency3State(pool_mod.table_init(capacity, device=dev),
                           _zeros(geo, torch.int32, capacity, dev),
                           _zeros(geo, torch.int32, capacity, dev))


def simple3_init(geo: MapGeometry3, capacity: int = 4096, device=None):
    dev = _device(device)
    return Simple3State(pool_mod.table_init(capacity, device=dev),
                        _zeros(geo, torch.int8, capacity, dev))


def probabilistic3_init(geo: MapGeometry3, capacity: int = 4096,
                        device=None):
    dev = _device(device)
    return Probabilistic3State(pool_mod.table_init(capacity, device=dev),
                               _zeros(geo, torch.float32, capacity, dev),
                               _zeros(geo, torch.bool, capacity, dev))


def locate3(table, geo, cells, trash: int):
    """(slots int32 [...], -1 = missing; index tuple (slot, z, y, x) into a
    ``[P+1, L, L, L]`` array), a missing patch's cells on ``trash``.
    ``geo``: a MapGeometry3 or a TSDFConfig (their ``m2p``, ``m2local``)."""
    slots = pool_mod.table_lookup(table, geo.m2p(cells))
    loc = geo.m2local(cells).long()
    safe = torch.where(slots >= 0, slots, trash).long()
    return slots, (safe, loc[..., 2], loc[..., 1], loc[..., 0])


def insert_unique_keys(table, keys):
    """Allocate the patches of ``keys`` (int32, any shape; negative keys
    count among the unique values and are skipped) as the JAX package
    does: the sorted unique keys, the first ``UNIQUE_CAP`` of them, one
    after the other. Returns (table, their slots)."""
    uniq = torch.unique(keys.reshape(-1))[:UNIQUE_CAP]
    return pool_mod.table_insert_ordered(table, uniq)


def _locate_alloc(table, geo, cells, trash: int):
    table, _ = insert_unique_keys(table, geo.m2p(cells))
    slots, idx = locate3(table, geo, cells, trash)
    return table, slots, idx


def _add_u16(counts, shape, idx, more, trash: int):
    """``counts`` plus ``more`` summed at ``idx``, mod 2**16 (int32 sums
    wrap mod 2**32, which keeps them mod 2**16); trash slot cleared."""
    out = (counts + scatter_sum(shape, idx, more, torch.int32)) & U16_MASK
    out[trash] = 0
    return out


# ---------------------------------------------------------------------------
# Frequency 3D: batched scan integration with the 3D ray walk
# ---------------------------------------------------------------------------

def frequency3_insert_scan(state: Frequency3State, geo: MapGeometry3,
                           points, mask, origin, max_steps: int):
    """Rasterize a 3D cloud: hits mark occupied, rays mark free (the
    Slam2D map update lifted to 3D; end-state equivalent). Every cell of
    the ``[B, max_steps + 1]`` stream allocates its patch, masked or not,
    as in the JAX package."""
    trash = state.occupied.shape[0] - 1
    hits = geo.w2m(points)                                   # [B, 3]
    start = geo.w2m(origin).expand(hits.shape)
    frees, fmask = ray_cells(start, hits, max_steps)         # [B, T, 3]
    fmask = fmask & mask[:, None]
    all_cells = torch.cat([hits[:, None, :], frees], dim=1)
    m = mask[:, None].to(torch.int32)
    all_occ = torch.cat([m, torch.zeros_like(fmask, dtype=torch.int32)], 1)
    all_vis = torch.cat([m, fmask.to(torch.int32)], 1)
    table, _, idx = _locate_alloc(state.table, geo, all_cells, trash)
    shape = state.occupied.shape
    return Frequency3State(
        table, _add_u16(state.occupied, shape, idx, all_occ, trash),
        _add_u16(state.visited, shape, idx, all_vis, trash))


def _counts3(state: Frequency3State, geo, cells):
    slots, idx = locate3(state.table, geo, cells,
                         state.occupied.shape[0] - 1)
    return slots, state.occupied[idx], state.visited[idx]


def frequency3_is_occupied(state, geo, cells):
    slots, occ, vis = _counts3(state, geo, cells)
    return torch.where(slots >= 0, 4 * occ > vis, False)


def frequency3_is_free(state, geo, cells):
    slots, occ, vis = _counts3(state, geo, cells)
    return torch.where(slots >= 0, (vis > 0) & (4 * occ < vis), False)


# ---------------------------------------------------------------------------
# Simple / probabilistic 3D setters (the per-cell semantics of 2D)
# ---------------------------------------------------------------------------

def simple3_set(state: Simple3State, geo, cells, value):
    trash = state.cells.shape[0] - 1
    table, _, idx = _locate_alloc(state.table, geo, cells, trash)
    out = state.cells.clone()
    out[idx] = torch.as_tensor(value, dtype=torch.int8,
                               device=out.device).expand(idx[0].shape)
    return Simple3State(table, out)


def simple3_query(state: Simple3State, geo, cells):
    """-> int8 values (0 for unallocated)."""
    slots, idx = locate3(state.table, geo, cells, state.cells.shape[0] - 1)
    return torch.where(slots >= 0, state.cells[idx],
                       torch.zeros((), dtype=torch.int8,
                                   device=slots.device))


def probabilistic3_apply(state: Probabilistic3State, geo, cells, hits,
                         misses):
    """Per-cell hit/miss counts (duplicates summed, exact in any order)
    through the per-visit clamped update of
    :func:`occupancy.probabilistic_saturate`."""
    trash = state.logodds.shape[0] - 1
    table, _, idx = _locate_alloc(state.table, geo, cells, trash)
    shape = state.logodds.shape
    hcount = scatter_sum(shape, idx, hits, torch.float32)
    mcount = scatter_sum(shape, idx, misses, torch.float32)
    lo = probabilistic_saturate(state.logodds, hcount, mcount)
    written = scatter_sum(shape, idx, (hits > 0) | (misses > 0), torch.int32)
    touched = state.touched | (written > 0)
    lo[trash] = 0.0
    touched[trash] = False
    return Probabilistic3State(table, lo, touched)


# ---------------------------------------------------------------------------
# Exact capped 3D EDT (separable passes)
# ---------------------------------------------------------------------------

def edt3d(obstacle, max_sqdist: int, radius: int):
    """Exact capped squared EDT of bool grids ``[..., Z, Y, X]`` -> int32.

    Separable: g = 1D distance along z (log-doubling erosion, clipped at
    R + 1), then h = min_dy dy^2 + g^2, then d2 = min_dx dx^2 + h, capped.
    The JAX package pads each shifted copy with the cap; values at or
    above the cap end as the cap either way, so the shifts here update
    the overlapping slices in place.
    """
    g = erode_z(obstacle, radius)
    h = envelope(g * g, -2, radius)
    return torch.clamp(envelope(h, -1, radius), max=max_sqdist)


def erode_z(obstacle, radius: int):
    """int32 distance along z (axis -3) to the nearest obstacle, clipped at
    ``radius + 1``: log-doubling erosion (shifts 1, 2, 4, ... <= R)."""
    g = torch.where(obstacle, 0, _BIG).to(torch.int32)
    nz = g.shape[-3]
    shift = 1
    while shift <= radius:
        nxt = g.clone()
        if shift < nz:
            up = g[..., shift:, :, :] + shift
            down = g[..., :-shift, :, :] + shift
            nxt[..., :-shift, :, :] = torch.minimum(nxt[..., :-shift, :, :],
                                                    up)
            nxt[..., shift:, :, :] = torch.minimum(nxt[..., shift:, :, :],
                                                   down)
        g = nxt
        shift <<= 1
    return torch.clamp(g, max=radius + 1)


def envelope(sq, dim: int, radius: int):
    """min over |d| <= radius of sq shifted by d along ``dim``, plus d^2."""
    out = sq.clone()
    n = sq.shape[dim]
    for d in range(1, min(radius, n - 1) + 1):
        lo = sq.narrow(dim, d, n - d) + d * d
        hi = sq.narrow(dim, 0, n - d) + d * d
        a = out.narrow(dim, 0, n - d)
        a.copy_(torch.minimum(a, lo))
        b = out.narrow(dim, d, n - d)
        b.copy_(torch.minimum(b, hi))
    return out
