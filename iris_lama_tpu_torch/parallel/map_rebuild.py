"""Map rebuild: every key-pose scan deposited at once, then one exact EDT.

reference: GraphSlam2D::generateOccupancyMap re-rasterizes every key-pose
cloud after a pose-graph optimization (src/graph_slam2d.cpp:131-164) — a
sequential per-scan loop in the reference, and a batch job here. Hit and
visit counts are additive and order-independent, so all scans' hit and
free-space streams go into one dense count-grid pair in one memset and one
launch of kernel B1 (``ops/scatter_matmul.deposit_pair``), and the
``4*occ > vis`` obstacle mask from the totals equals the reference's
sequential end state exactly (frequency_occupancy_map.cpp:40-44). The
distance field is one launch of kernel B3 (``sdm/distance.edt2d``) over the
whole grid.

With a process group (``mesh``, the JAX package's device mesh) the
rebuild is split over the ranks, as the JAX package's sharded branch is:

1. **Rasterize — split over scans.** Each rank deposits its share of the
   scans (the scan count padded to a multiple of the ranks with masked-out
   scans) into a dense global count-grid pair with one launch of B1's
   pair, and one sum all-reduce merges the counts: integer sums, so the
   totals equal the one-device rebuild's.
2. **Distance field — split over row strips.** The grid's rows (padded
   to a multiple of the ranks with obstacle-free rows, exact no-ops for
   the capped EDT) split into strips; each rank fetches ``radius`` rows
   from each neighbouring strip (:func:`edt_strips`; the edge strips get
   obstacle-free halos), runs B3 on its strip with the halos, and an
   all-gather assembles the field: bit-equal to the one-device EDT.

Spans (``utils/trace.py``): ``lama.rebuild`` (rasterize and EDT) and
``lama.rebuild.pack`` (the grids read, site ``rebuild``, and packed).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from ..ops import scatter_matmul
from ..sdm import mapping as mapping_mod
from ..sdm import pool as pool_mod
from ..sdm.distance import edt2d
from ..sdm.geometry import MapGeometry, f32
from ..sdm.raycast import ray_cells
from ..utils.trace import host_read, span
from . import group as group_mod


class DenseRebuild(NamedTuple):
    """Dense rebuild products on a patch-aligned global grid."""

    org_cell: torch.Tensor   # int32 [2] (x, y) cell coords of grid origin
    occ: torch.Tensor        # int32 [H, W] hit counts
    vis: torch.Tensor        # int32 [H, W] visit counts
    dist: torch.Tensor       # f32 [H, W] meters


def grid_bounds(cfg, geo: MapGeometry, poses_np: np.ndarray):
    """Patch-aligned (org_cell, H, W) covering every scan's reach (host
    numpy): both sides are multiples of the patch length, so the dense grid
    packs directly into pool patches."""
    reach = (int(np.ceil(cfg.max_range * geo.scale))
             + cfg.distance.radius_cells + 2)
    cells = geo.np_w2m(poses_np[:, :2].astype(np.float64))
    lo = cells.min(0) - reach
    hi = cells.max(0) + reach
    length = geo.patch_length
    lo = (lo // length) * length
    nx = int(np.ceil((hi[0] - lo[0] + 1) / length))
    ny = int(np.ceil((hi[1] - lo[1] + 1) / length))
    return lo.astype(np.int64), ny * length, nx * length


def _scan_cells(cfg, poses, points, masks, origins, org_cell, h: int,
                w: int):
    """Window-free beam rasterization of S scans: the grid-local hit
    streams [S * B] and free-space streams [S * B * T] (scan-major, then
    beam-major), masked-out cells at the sentinel row ``h`` (the same
    geometry as sdm/mapping.update_maps; the JAX package writes ``h`` into
    both coordinates, which the deposit drops all the same)."""
    geo = cfg.geometry
    g = mapping_mod.beam_geometry(cfg, poses, points, masks, origins)
    mhit = geo.w2m(g.hit_xy)                                   # [S, B, 2]
    mstart = geo.w2m(g.start_xy)
    free_cells, free_mask = ray_cells(mstart.reshape(-1, 2),
                                      mhit.reshape(-1, 2), cfg.ray_steps)
    free_mask = free_mask & g.valid.reshape(-1)[:, None]
    org = org_cell.to(torch.int32)
    hit_loc = mhit.reshape(-1, 2) - org
    free_loc = free_cells - org

    def in_grid(loc):
        return ((loc[..., 0] >= 0) & (loc[..., 0] < w) &
                (loc[..., 1] >= 0) & (loc[..., 1] < h))

    hit_ok = (g.valid & g.mark_hit).reshape(-1) & in_grid(hit_loc)
    free_ok = free_mask & in_grid(free_loc)

    def stream(loc, ok):
        return (torch.where(ok, loc[..., 1], h).reshape(-1),
                torch.where(ok, loc[..., 0], h).reshape(-1))

    return stream(hit_loc, hit_ok), stream(free_loc, free_ok)


def rasterize_scans(cfg, poses, points, masks, origins, org_cell, h: int,
                    w: int):
    """Deposit ALL scans into one dense [h, w] count-grid pair: one launch
    of B1's pair on CUDA tensors.

    poses f32 [S, 4]; points f32 [S, B, 3]; masks bool [S, B]; origins f32
    [S, 3]. Returns (occ int32 [h, w], vis int32 [h, w]).
    """
    (hy, hx), (fy, fx) = _scan_cells(cfg, poses, points, masks, origins,
                                     org_cell, h, w)
    return scatter_matmul.deposit_pair(hy, hx, fy, fx, h, w)


def edt_strips(obst, max_sqdist: int, radius: int, group):
    """Exact capped EDT of a bool grid split into row strips over the
    group's ranks: ``obst`` is this rank's [h_local, W] strip, at least
    ``radius`` rows tall. The vertical pass needs ``radius`` rows from each
    neighbouring strip (one halo exchange), after which everything is
    strip-local. Returns this rank's rows of the unsharded ``edt2d``."""
    if radius == 0:
        return edt2d(obst, max_sqdist, radius)
    above, below = group_mod.halo_exchange(obst, radius, group)
    d2 = edt2d(torch.cat([above, obst, below]), max_sqdist, radius)
    return d2[radius:radius + obst.shape[0]]


def rebuild_dense(cfg, poses, points, masks, origins, org_cell, h: int,
                  w: int, mesh=None) -> DenseRebuild:
    """Full rebuild on the inputs' device: counts, obstacle mask and exact
    distance field. With ``mesh`` (a process group; every rank passes the
    same scans) the scans split over the ranks for the rasterize and the
    grid's rows for the EDT; every rank returns the whole result, equal to
    the one-device rebuild's."""
    with span("lama.rebuild"):
        return _rebuild_dense(cfg, poses, points, masks, origins, org_cell,
                              h, w, mesh)


def _rebuild_dense(cfg, poses, points, masks, origins, org_cell, h: int,
                   w: int, mesh) -> DenseRebuild:
    dcfg = cfg.distance
    dev = poses.device
    org = torch.as_tensor(np.asarray(org_cell), dtype=torch.int32,
                          device=dev)
    if mesh is None:
        occ, vis = rasterize_scans(cfg, poses, points, masks, origins, org,
                                   h, w)
        d2 = edt2d((4 * occ) > vis, dcfg.max_sqdist, dcfg.radius_cells)
    else:
        nd = group_mod.size(mesh)
        pad = (-poses.shape[0]) % nd
        if pad:
            # padded scans: masks all False -> sentinel-only streams
            poses = torch.cat([poses, poses[-1:].expand(pad, -1)])
            points = torch.cat([points, points[-1:].expand(pad, -1, -1)])
            masks = torch.cat([masks, masks.new_zeros((pad,)
                                                      + masks.shape[1:])])
            origins = torch.cat([origins, origins[-1:].expand(pad, -1)])
        sl = group_mod.rows(poses.shape[0], mesh)
        occ, vis = rasterize_scans(cfg, poses[sl], points[sl], masks[sl],
                                   origins[sl], org, h, w)
        occ = group_mod.all_sum(occ, mesh)
        vis = group_mod.all_sum(vis, mesh)
        obst = (4 * occ) > vis
        hpad = (-h) % nd
        if hpad:
            obst = torch.cat([obst, obst.new_zeros((hpad, w))])
        if (h + hpad) // nd < dcfg.radius_cells:
            raise ValueError(f"rebuild_dense: strips of {(h + hpad) // nd} "
                             f"rows are shorter than the EDT radius "
                             f"{dcfg.radius_cells}")
        strip = obst[group_mod.rows(h + hpad, mesh)]
        d2 = group_mod.all_gather_cat(edt_strips(
            strip, dcfg.max_sqdist, dcfg.radius_cells, mesh), mesh)[:h]
    dist = torch.sqrt(d2.to(torch.float32)) * f32(cfg.geometry.resolution)
    return DenseRebuild(org, occ, vis, dist)


def dense_to_state(cfg, dense: DenseRebuild) -> mapping_mod.SlamMapState:
    """Pack a dense rebuild into a pool-backed SlamMapState on the rebuild's
    device (host path, as in the JAX package: rebuilds are rare offline
    events). The pool's capacity is ``cfg.capacity``, doubled until every
    patch with content fits."""
    with span("lama.rebuild.pack"):
        return _dense_to_state(cfg, dense)


def _dense_to_state(cfg, dense: DenseRebuild) -> mapping_mod.SlamMapState:
    geo = cfg.geometry
    length = geo.patch_length
    dev = dense.occ.device
    occ, vis, dist, org = (host_read(t, "rebuild", numpy=True) for t in
                           (dense.occ, dense.vis, dense.dist,
                            dense.org_cell))
    h, w = occ.shape
    ny, nx = h // length, w // length
    d2_max = cfg.distance.max_dist

    keys, blocks = [], []
    for py in range(ny):
        for px in range(nx):
            sl = np.s_[py * length:(py + 1) * length,
                       px * length:(px + 1) * length]
            if (vis[sl] > 0).any() or (dist[sl] < d2_max - 1e-9).any():
                anchor = org + np.array([px * length, py * length])
                key = (int(anchor[0]) >> geo.log2dim << 15) | \
                    (int(anchor[1]) >> geo.log2dim)
                keys.append(key)
                blocks.append((occ[sl], vis[sl], dist[sl]))

    cap = max(cfg.capacity, 1)
    while cap < len(keys) + 1:
        cap *= 2
    state = mapping_mod.slam_map_init(dataclasses.replace(cfg, capacity=cap),
                                      "cpu")
    if keys:
        table, slots = pool_mod.table_insert(
            state.table, torch.as_tensor(np.asarray(keys, np.int32)))
        o_arr, v_arr, d_arr = state.occupied, state.visited, state.dist
        for s_, (bo, bv, bd) in zip(slots.tolist(), blocks):
            o_arr[s_] = torch.as_tensor(np.minimum(bo, mapping_mod.COUNT_MAX))
            v_arr[s_] = torch.as_tensor(np.minimum(bv, mapping_mod.COUNT_MAX))
            d_arr[s_] = torch.as_tensor(bd)
        state = mapping_mod.SlamMapState(table, o_arr, v_arr, d_arr)
    return mapping_mod.SlamMapState(
        pool_mod.PatchTable(*(t.to(dev) for t in state.table)),
        state.occupied.to(dev), state.visited.to(dev), state.dist.to(dev))
