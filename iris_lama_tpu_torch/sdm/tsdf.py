"""Truncated signed distance field (3D): the reference's
TruncatedSignedDistanceMap.

reference: include/lama/sdm/truncated_signed_distance_map.h,
src/sdm/truncated_signed_distance_map.cpp — Voxblox-style integration
along truncated rays (:160-208), a weighted running average per voxel
(:203-205), trilinear distance and gradient (:59-155), marching-cubes
meshing (:219-273).

Design, as in the JAX package:
* a 3D patch pool ``[P+1, L, L, L]``, patch keys 10 bits an axis;
* one cloud integrates in one batch: the hit cells deduplicated by the
  reference's spatial hash (KeySet, :146-151; a stable sort keeps the
  first point of each hash, so colliding hashes merge distinct cells, as
  there), closed-form ray cells, and two scatter-adds. The sequential
  running average telescopes to sums of ``w_i`` and ``w_i * d_i``;
* meshing runs on the host (:mod:`marching_cubes`).

The hash multiplies uint32 values that wrap; torch has no uint32
arithmetic, so it is computed in int64 and masked to 32 bits. The float
sums (``index_add_``; atomics on the card) depend on the order of
summation: distances and weights agree with the JAX package's within a
tolerance, the tables and the observed set exactly.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import numpy as np
import torch

from . import pool as pool_mod
from .geometry import f32
from .occupancy import scatter_sum
from .occupancy3d import (CENTER_PATCH3, PKEY3_BITS, _device,
                          insert_unique_keys, locate3)
from .raycast import ray_cells

_U32 = 0xFFFFFFFF
_HASH = (73856093, 19349663, 83492791)


@dataclasses.dataclass(frozen=True)
class TSDFConfig:
    """The reference constructor's defaults
    (truncated_signed_distance_map.cpp:36-44)."""

    resolution: float = 0.05
    log2dim: int = 4                  # 16^3 patches
    truncate_size: float = 0.15
    maximum_weight: float = 10000.0
    capacity: int = 8192
    max_beams: int = 1024

    @property
    def patch_length(self) -> int:
        return 1 << self.log2dim

    @property
    def scale(self) -> float:
        return 1.0 / self.resolution

    @property
    def cell_offset(self) -> int:
        return CENTER_PATCH3 * self.patch_length

    @property
    def epsilon(self) -> float:
        return self.resolution        # (.cpp:42)

    @property
    def delta(self) -> float:
        return 4 * self.resolution    # (.cpp:43)

    @property
    def ray_steps(self) -> int:
        return int(math.ceil(2 * self.truncate_size * self.scale)) + 3

    # ---- coordinates ----
    def w2m(self, world):
        mf = world.to(torch.float32) * f32(self.scale)
        return torch.floor(mf + 0.5).to(torch.int32) + self.cell_offset

    def w2m_frac(self, world):
        mf = world.to(torch.float32) * f32(self.scale)
        fl = torch.floor(mf)
        return fl.to(torch.int32) + self.cell_offset, mf - fl

    def m2w(self, cells):
        rel = cells.to(torch.int32) - self.cell_offset
        return rel.to(torch.float32) * f32(self.resolution)

    def m2p(self, cells):
        p = cells.to(torch.int32) >> self.log2dim
        return ((p[..., 0] << (2 * PKEY3_BITS)) | (p[..., 1] << PKEY3_BITS)
                | p[..., 2])

    def m2local(self, cells):
        return cells.to(torch.int32) & (self.patch_length - 1)


class TSDFState(NamedTuple):
    table: pool_mod.PatchTable
    dist: torch.Tensor     # f32 [P+1, L, L, L]; default truncate_size
    weight: torch.Tensor   # f32 [P+1, L, L, L]; 0 = unobserved


def tsdf_init(cfg: TSDFConfig, device=None) -> TSDFState:
    dev = _device(device)
    length = cfg.patch_length
    shape = (cfg.capacity + 1, length, length, length)
    return TSDFState(
        table=pool_mod.table_init(cfg.capacity, device=dev),
        dist=torch.full(shape, f32(cfg.truncate_size), dtype=torch.float32,
                        device=dev),
        weight=torch.zeros(shape, dtype=torch.float32, device=dev))


def cell_hash(cells):
    """The reference's KeySet hash of int32 cells [..., 3]: the uint32
    products (mod 2**32) XORed, as int64 values in [0, 2**32)."""
    c = cells.to(torch.int64) & _U32
    h0, h1, h2 = ((c[..., i] * m) & _U32 for i, m in enumerate(_HASH))
    return h0 ^ h1 ^ h2


def first_of_hash(h):
    """bool mask: the first entry (in index order) of each hash value."""
    order = torch.argsort(h, stable=True)
    sh = h[order]
    first = torch.ones_like(sh, dtype=torch.bool)
    first[1:] = sh[1:] != sh[:-1]
    out = torch.zeros_like(first)
    out[order] = first
    return out


def _sum3(v):
    """Sum over the last axis of 3, in a fixed order: ``torch.sum`` may
    reduce in another order on the card, and an ulp in a ray's length can
    move its end cell."""
    return (v[..., 0] + v[..., 1]) + v[..., 2]


def insert_point_cloud(state: TSDFState, cfg: TSDFConfig, points, mask,
                       origin):
    """Integrate one cloud (insertPointCloud, .cpp:140-157, and integrate,
    :160-208). points f32 [B, 3] in the world frame; origin f32 [3].
    Returns (state, the number of points integrated: a tensor)."""
    trash = state.dist.shape[0] - 1
    hits = points.to(torch.float32)
    origin = origin.to(torch.float32)
    bmask = mask & first_of_hash(cell_hash(cfg.w2m(hits)))

    # the ray segment hit -/+ truncation (the reference compares the
    # SQUARED norm with truncate_size, .cpp:166; kept)
    dvec = hits - origin[None, :]
    sqn = _sum3(dvec * dvec)
    dirn = dvec / torch.clamp(torch.sqrt(sqn), min=1e-12)[:, None]
    truncate = torch.clamp(sqn, max=f32(cfg.truncate_size))
    start = cfg.w2m(hits - dirn * truncate[:, None])
    end = cfg.w2m(hits + dirn * f32(cfg.truncate_size))
    cells, cmask = ray_cells(start, end, cfg.ray_steps)       # [B, T, 3]
    cmask = cmask & bmask[:, None]

    # per-voxel SDF and weight (Voxblox weights, .cpp:178-199)
    centers = cfg.m2w(cells)
    vch = hits[:, None, :] - centers
    d = torch.sqrt(_sum3(vch * vch)) * torch.sign(
        _sum3(vch * dvec[:, None, :]))
    inv_sqn = 1.0 / torch.clamp(sqn, min=1e-12)
    inv_dle = f32(1.0 / (cfg.delta - cfg.epsilon))
    delta, eps = f32(cfg.delta), f32(cfg.epsilon)
    w = torch.where(d < -delta, 0.0,
                    torch.where(d <= -eps,
                                (d + delta) * inv_sqn[:, None] * inv_dle,
                                inv_sqn[:, None].expand(d.shape)))
    w = w * cmask.to(torch.float32)

    # allocate the touched patches (masked cells count as key -1)
    keys = torch.where(cmask, cfg.m2p(cells), -1)
    table, _ = insert_unique_keys(state.table, keys)

    # scatter the telescoped running average
    _, idx = locate3(table, cfg, cells, trash)
    shape = state.weight.shape
    wsum = scatter_sum(shape, idx, w, torch.float32)
    wdsum = scatter_sum(shape, idx, w * d, torch.float32)
    w_old = state.weight
    denom = torch.clamp(w_old + wsum, min=1e-12)
    seen = wsum > 0
    new_dist = torch.where(seen, (w_old * state.dist + wdsum) / denom,
                           state.dist)
    new_weight = torch.where(
        seen, torch.clamp(w_old + wsum, max=f32(cfg.maximum_weight)), w_old)
    new_dist[trash] = f32(cfg.truncate_size)
    new_weight[trash] = 0.0
    return TSDFState(table, new_dist, new_weight), bmask.sum()


def distance_interp(state: TSDFState, cfg: TSDFConfig, world):
    """Trilinear distance and gradient (.cpp:85-155). world f32 [..., 3]."""
    trash = state.dist.shape[0] - 1
    mi, mu = cfg.w2m_frac(world)
    trunc = f32(cfg.truncate_size)

    def read(dx, dy, dz):
        off = torch.tensor([dx, dy, dz], dtype=torch.int32, device=mi.device)
        slots, idx = locate3(state.table, cfg, mi + off, trash)
        ok = (slots >= 0) & (state.weight[idx] > 0.0)
        return torch.where(ok, state.dist[idx], trunc)

    v = [read(0, 0, 0), read(1, 0, 0), read(0, 1, 0), read(1, 1, 0),
         read(0, 0, 1), read(1, 0, 1), read(0, 1, 1), read(1, 1, 1)]
    mux, muy, muz = mu[..., 0], mu[..., 1], mu[..., 2]
    mix, miy, miz = 1 - mux, 1 - muy, 1 - muz
    dist = (v[0] * mix * miy * miz + v[1] * mux * miy * miz
            + v[2] * mix * muy * miz + v[3] * mux * muy * miz
            + v[4] * mix * miy * muz + v[5] * mux * miy * muz
            + v[6] * mix * muy * muz + v[7] * mux * muy * muz)
    s = f32(cfg.scale)
    a = (v[0] - v[1]) * miy + (v[2] - v[3]) * muy
    b = (v[4] - v[5]) * miy + (v[6] - v[7]) * muy
    gx = -(a * miz + b * muz) * s
    a = (v[0] - v[2]) * mix + (v[1] - v[3]) * mux
    b = (v[4] - v[6]) * mix + (v[5] - v[7]) * mux
    gy = -(a * miz + b * muz) * s
    a = (v[0] - v[4]) * mix + (v[1] - v[5]) * mux
    b = (v[2] - v[6]) * mix + (v[3] - v[7]) * mux
    gz = -(a * miy + b * muy) * s
    return dist, torch.stack([gx, gy, gz], dim=-1)


def to_mesh(state: TSDFState, cfg: TSDFConfig):
    """The isosurface mesh (toMesh, .cpp:219-273), on the host: the
    allocated patches copied once, then marching cubes on their dense
    bounding box. Returns (vertices f64 [V, 3], triangles i64 [T, 3])."""
    from .marching_cubes import marching_cubes_dense

    keys, amask = pool_mod.active_keys(state.table)
    slots_t = torch.nonzero(amask).reshape(-1)
    if slots_t.numel() == 0:
        return np.zeros((0, 3)), np.zeros((0, 3), np.int64)
    keys = keys[slots_t].cpu().numpy().astype(np.int64)
    dist = state.dist[slots_t].cpu().numpy()
    obs = state.weight[slots_t].cpu().numpy() > 0
    length = cfg.patch_length
    m = (1 << PKEY3_BITS) - 1
    px, py, pz = keys >> (2 * PKEY3_BITS), (keys >> PKEY3_BITS) & m, keys & m
    ox, oy, oz = px.min(), py.min(), pz.min()
    nx, ny, nz = px.max() - ox + 1, py.max() - oy + 1, pz.max() - oz + 1
    sdf = np.full((nz * length, ny * length, nx * length),
                  np.float32(cfg.truncate_size), np.float32)
    seen = np.zeros(sdf.shape, bool)
    for i, (x, y, z) in enumerate(zip(px - ox, py - oy, pz - oz)):
        sl = np.s_[z * length:(z + 1) * length,
                   y * length:(y + 1) * length,
                   x * length:(x + 1) * length]
        sdf[sl] = dist[i]
        seen[sl] = obs[i]
    origin_cells = np.array([ox << cfg.log2dim, oy << cfg.log2dim,
                             oz << cfg.log2dim]) - cfg.cell_offset
    return marching_cubes_dense(sdf, seen, origin_cells * cfg.resolution,
                                cfg.resolution)
