"""Fused SLAM map: occupancy + obstacle mask + distance field.

The (occupancy map, dynamic distance map) pair of LaMa's SLAM
(src/slam2d.cpp:247-321 ``updateMaps``) as one patch table shared by all
cell arrays. Per scan, on a dense window:

1. beam endpoints + truncation (slam2d.cpp:267-300 semantics, 3D norms);
2. closed-form raycast (sdm/raycast.py);
3. hit and visit counts deposited into the window (kernel B1, both in one
   launch);
4. occupancy end state: the frequency model adds the counts, obstacle iff
   ``4*occ > vis`` (LaMa's prob > 0.25, frequency_occupancy_map.cpp:38-44);
   the probabilistic model updates f32 log-odds with per-visit clamping
   (``occupancy.probabilistic_saturate``), obstacle iff log-odds > 0;
5. exact capped EDT of the window (kernel B3), merged on the interior.

Two ways to hold the map between scans. :func:`update_maps` gathers a
window from the pool per scan, applies the scan and writes back only the
patches that changed, allocating patches that gained content (the
pool-per-scan path). The resident sliding window keeps dense (occ, vis,
dist) grids as the primary map state and exchanges them with the pool only
on re-orgs (:func:`resident_flush`, :func:`resident_gather`,
:func:`resident_scroll`). A transient map (slam2d.cpp:323-373) drops, every
scan, the patches whose box misses the scan's expanded bounding box:
:func:`prune_transient_pool` deletes pool patches,
:func:`resident_transient_reset` resets resident-window patches.

Count dtype: the reference's cells hold uint16 hit/visit counts. PyTorch's
uint16 lacks the arithmetic and ``index_put`` this code needs, so the
port holds every count (pool and resident grids) in int32, clipped at
65535 exactly where the JAX package clips; values equal the JAX uint16
counts and :mod:`..utils.state` converts at the boundary.

In-place updates: :func:`resident_update`, :func:`update_maps` and the
re-org and pruning functions write the grids and pool cell arrays in place
(no copy of the pool per scan); the table tensors are rebuilt.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch

from ..core import lie
from ..ops import scatter_matmul
from ..utils.trace import host_read
from . import pool as pool_mod
from . import window as win_mod
from .occupancy import probabilistic_saturate
from .distance import DistanceConfig, edt2d
from .geometry import MapGeometry, PKEY_BITS, f32
from .raycast import ray_cells

COUNT_DTYPE = torch.int32   # uint16 counts held in int32 (module docstring)
COUNT_MAX = 65535


@dataclasses.dataclass(frozen=True)
class MappingConfig:
    """Static per-map parameters (map fields of Slam2D::Options,
    slam2d.h:91-125)."""

    geometry: MapGeometry = MapGeometry()
    l2_max: float = 0.5
    truncated_ray: float = 0.0
    truncated_range: float = 0.0
    max_range: float = 10.0     # beams beyond this are dropped by the driver
    pose_slack: float = 2.0     # window margin for match-vs-predict motion
    capacity: int = 4096        # patch pool capacity
    resident_extra_patches: int = 0   # extra patch rings of wander headroom
    occ_model: str = "frequency"   # "frequency" | "probabilistic"
    transient: bool = False     # prune patches outside the scan AABB
    transient_expand: float = 2.0  # slam2d.cpp:335-340; lidar odometry 1x
    max_removals: int = 160     # per-scan prune budget (rest removed later)

    @property
    def distance(self) -> DistanceConfig:
        return DistanceConfig(self.geometry, self.l2_max)

    @property
    def window_patches(self) -> int:
        """Side (patches) of the pool-backed per-scan window."""
        geo = self.geometry
        half_cells = ((self.max_range + self.pose_slack) * geo.scale
                      + self.distance.radius_cells)
        return 2 * (int(math.ceil(half_cells / geo.patch_length)) + 1)

    @property
    def window_cells(self) -> int:
        return self.window_patches * self.geometry.patch_length

    @property
    def ray_steps(self) -> int:
        """Per-beam cell budget T of the raycast."""
        reach = self.max_range
        if self.truncated_range > 0.0:
            reach = min(reach, self.truncated_range)
        if self.truncated_ray > 0.0:
            reach = min(reach, self.truncated_ray)
        return int(math.ceil(reach * self.geometry.scale)) + 2

    @property
    def resident_margin_cells(self) -> int:
        """Safe-zone margin of a resident window: an update anchored at
        window-local pose cell ``lp`` is exact iff ``lp`` lies in
        ``[margin, W - margin)`` per axis (ceil(max_range*scale) + 2R + 2
        + ceil(pose_slack*scale))."""
        geo = self.geometry
        r = self.distance.radius_cells
        b = int(math.ceil(self.pose_slack * geo.scale))
        return int(math.ceil(self.max_range * geo.scale)) + 2 * r + 2 + b

    @property
    def resident_window_patches(self) -> int:
        length = self.geometry.patch_length
        need = 2 * (self.resident_margin_cells + length + length // 2 - 1)
        return (need + length - 1) // length + 2 * self.resident_extra_patches

    @property
    def resident_window_cells(self) -> int:
        return self.resident_window_patches * self.geometry.patch_length

    @property
    def sq_dtype(self):
        return self.distance.sq_dtype

    def dist_to_sq(self, dist):
        return self.distance.dist_to_sq(dist)

    def sq_to_dist(self, d2):
        return self.distance.sq_to_dist(d2)

    @property
    def match_window_cells(self) -> int:
        """Side of the scan-match sub-window: half-width reach + slack + 3
        (w2m rounding + the bilinear +1 neighbour), rounded up to 8."""
        geo = self.geometry
        half = (int(math.ceil(self.max_range * geo.scale))
                + int(math.ceil(self.pose_slack * geo.scale)) + 3)
        return min((2 * half + 7) // 8 * 8, self.resident_window_cells)

    @property
    def resident_update_cells(self) -> int:
        """Side of the exact update sub-window centred at the pose cell:
        half-width reach + 2R, rounded up to 8."""
        geo = self.geometry
        half = (int(math.ceil(self.max_range * geo.scale)) + 2
                + 2 * self.distance.radius_cells)
        return min((2 * half + 7) // 8 * 8, self.resident_window_cells)


class SlamMapState(NamedTuple):
    """Shared-table fused map: int32 counts (uint16 values), f32 meters.

    ``occupied`` holds hit counts for ``occ_model="frequency"`` and f32
    log-odds for ``"probabilistic"`` (``visited`` still counts visits, the
    unknown test of probabilistic_occupancy_map.cpp:38-59).
    """

    table: pool_mod.PatchTable
    occupied: torch.Tensor   # int32 counts | f32 log-odds [P+1, L, L]
    visited: torch.Tensor    # int32 [P+1, L, L]
    dist: torch.Tensor       # f32 [P+1, L, L] meters


def occ_dtype(cfg: MappingConfig):
    """dtype of ``occupied``: int32 counts or f32 log-odds."""
    if cfg.occ_model == "frequency":
        return COUNT_DTYPE
    if cfg.occ_model == "probabilistic":
        return torch.float32
    raise ValueError(f"occ_model {cfg.occ_model!r}: expected 'frequency' "
                     "or 'probabilistic'")


def slam_map_init(cfg: MappingConfig, device=None) -> SlamMapState:
    length = cfg.geometry.patch_length
    p1 = cfg.capacity + 1
    return SlamMapState(
        table=pool_mod.table_init(cfg.capacity, device=device),
        occupied=torch.zeros((p1, length, length), dtype=occ_dtype(cfg),
                             device=device),
        visited=torch.zeros((p1, length, length), dtype=COUNT_DTYPE,
                            device=device),
        dist=torch.full((p1, length, length), cfg.distance.max_dist,
                        dtype=torch.float32, device=device),
    )


class ScanGeometry(NamedTuple):
    """Per-beam world-space geometry after truncation."""

    start_xy: torch.Tensor   # f32[B, 2] ray start (world)
    hit_xy: torch.Tensor     # f32[B, 2] endpoint (world)
    mark_hit: torch.Tensor   # bool[B] mark an obstacle at the endpoint?
    valid: torch.Tensor      # bool[B]


def beam_geometry(cfg: MappingConfig, pose, points, mask,
                  origin) -> ScanGeometry:
    """Transform + truncate beams (slam2d.cpp:267-300).

    pose: SE(2) [..., 4] (leading dims: particles); points f32[B, 3] in
    the base frame; origin f32[3] sensor origin in the base frame. Norms
    are 3D like the reference's. Outputs carry the pose's leading dims
    before the beam axis. Scans of their own take points [S, B, 3], masks
    [S, B] and origins [S, 3] with poses [S, 4].
    """
    pose_b = pose[..., None, :]
    hit_xy = lie.se2_apply(pose_b, points[..., :2])
    hit_z = points[..., 2]
    start_xy = lie.se2_apply(pose_b, origin[..., None, :2]).expand_as(hit_xy)
    start_z = origin[..., None, 2].expand_as(hit_z)
    ab_xy = hit_xy - start_xy
    ab_z = hit_z - start_z
    ray_len = torch.sqrt(torch.sum(ab_xy * ab_xy, -1) + ab_z * ab_z)
    safe_len = torch.clamp(ray_len, min=1e-12)
    mark_hit = mask
    if cfg.truncated_range > 0.0:
        over = ray_len > cfg.truncated_range
        scalef = torch.where(over, cfg.truncated_range / safe_len, 1.0)
        hit_xy = start_xy + ab_xy * scalef[..., None]
        mark_hit = mark_hit & ~over
    if cfg.truncated_ray > 0.0:
        over = mark_hit & (ray_len > cfg.truncated_ray)
        scalef = torch.where(over, cfg.truncated_ray / safe_len, 0.0)
        start_xy = torch.where(over[..., None],
                               hit_xy - ab_xy * scalef[..., None], start_xy)
    return ScanGeometry(start_xy, hit_xy, mark_hit, mask)


class DepositIndices(NamedTuple):
    """Window-local deposit streams of one scan (invalid: ly == w)."""

    hit_ly: torch.Tensor    # int32 [B]
    hit_lx: torch.Tensor
    free_ly: torch.Tensor   # int32 [B*T], beam-major
    free_lx: torch.Tensor


def deposit_indices(cfg: MappingConfig, pose, points, mask, origin,
                    org_cell, w: int) -> DepositIndices:
    """Beams -> window-local hit and free-space cell streams for the
    [w, w] window at ``org_cell`` (raycast + in-window masks). A batch of
    poses [P, 4] with origins [P, 2] gives streams [P, N]."""
    geo = cfg.geometry
    g = beam_geometry(cfg, pose, points, mask, origin)
    mhit = geo.w2m(g.hit_xy)                          # [..., B, 2]
    mstart = geo.w2m(g.start_xy)
    lead = mhit.shape[:-1]                            # [..., B]
    free_cells, free_mask = ray_cells(mstart.reshape(-1, 2),
                                      mhit.reshape(-1, 2), cfg.ray_steps)
    free_cells = free_cells.reshape(*lead, cfg.ray_steps, 2)
    free_mask = free_mask.reshape(*lead, cfg.ray_steps) & g.valid[:, None]
    org = org_cell.to(torch.int32)
    hit_loc = mhit - org[..., None, :]                # [x, y] -> row y, col x
    free_loc = free_cells - org[..., None, None, :]

    def in_win(loc):
        return ((loc[..., 0] >= 0) & (loc[..., 0] < w) &
                (loc[..., 1] >= 0) & (loc[..., 1] < w))

    hit_ok = g.valid & g.mark_hit & in_win(hit_loc)
    free_ok = free_mask & in_win(free_loc)

    def stream(loc, ok):
        return (torch.where(ok, loc[..., 1], w).reshape(*lead[:-1], -1),
                torch.where(ok, loc[..., 0], w).reshape(*lead[:-1], -1))

    return DepositIndices(*stream(hit_loc, hit_ok), *stream(free_loc, free_ok))


class WindowScan(NamedTuple):
    """Result of applying one scan to a dense window."""

    occ_new: torch.Tensor      # int32 counts | f32 log-odds [W, W]
    vis_new: torch.Tensor      # int32 [W, W]
    dist_merged: torch.Tensor  # dist_old's dtype [W, W]
    occ_add: torch.Tensor      # int32 [W, W]
    vis_add: torch.Tensor      # int32 [W, W]
    d2: torch.Tensor           # int32 [W, W] fresh capped sqdist
    interior: torch.Tensor     # bool [W, W] cells whose EDT is authoritative
    n_cells: torch.Tensor      # int []: processed-cell count


def scan_window_compute(cfg: MappingConfig, pose, points, mask, origin,
                        org_cell, occ_w, vis_w, dist_old) -> WindowScan:
    """Window math of one scan: raycast -> counts -> occupancy end state ->
    exact windowed EDT -> interior merge, on dense [W, W] grids holding the
    map at ``org_cell``. ``dist_old`` is a squared-distance grid
    (cfg.sq_dtype, the resident path) or f32 meters (the pool-per-scan
    path); ``dist_merged`` keeps its domain. Poses [P, 4], origins [P, 2]
    and grids [P, W, W] apply the scan once per particle."""
    dcfg = cfg.distance
    radius = dcfg.radius_cells
    w = dist_old.shape[-1]
    idx = deposit_indices(cfg, pose, points, mask, origin, org_cell, w)
    occ_add, vis_add = scatter_matmul.deposit_pair(
        idx.hit_ly, idx.hit_lx, idx.free_ly, idx.free_lx, w, w)
    vis_new = torch.clamp(vis_w.to(torch.int32) + vis_add, max=COUNT_MAX)
    if cfg.occ_model == "frequency":
        occ_new = torch.clamp(occ_w.to(torch.int32) + occ_add, max=COUNT_MAX)
        # prob > 0.25  <=>  4*occ > vis (frequency_occupancy_map.cpp:40-44)
        obst_new = (4 * occ_new) > vis_new
    else:
        # log-odds with per-visit clamping (probabilistic_occupancy_map.cpp:
        # 51-59, 82-107); occ_thresh_ = 0 log-odds (:60)
        occ_new = probabilistic_saturate(occ_w, occ_add, vis_add - occ_add)
        obst_new = occ_new > 0.0
    d2 = edt2d(obst_new, dcfg.max_sqdist, radius)
    ar = torch.arange(w, device=d2.device)
    inner = (ar >= radius) & (ar < w - radius)
    interior = inner[:, None] & inner[None, :]
    if dist_old.dtype.is_floating_point:
        dist_new = (torch.sqrt(d2.to(torch.float32))
                    * f32(cfg.geometry.resolution))
    else:
        dist_new = d2.to(dist_old.dtype)
    dist_merged = torch.where(interior, dist_new, dist_old)
    n_cells = ((idx.free_ly < w).sum(-1) + (idx.hit_ly < w).sum(-1))
    return WindowScan(occ_new, vis_new, dist_merged, occ_add, vis_add, d2,
                      interior, n_cells)


def update_maps(state: SlamMapState, cfg: MappingConfig, pose, points, mask,
                origin, org_cell=None, window=None):
    """Apply one scan to the pool (the pool-per-scan path). Returns
    (state, info): ``processed_cells``, ``num_patches`` and ``overflow``
    as device tensors.

    One table probe and three window gathers at ``org_cell`` (default: the
    ``cfg.window_patches`` window centred at the pose), or the matcher's
    ``window=(slots, f32 dist grid)`` gathered there already; the scan
    applied to the window; patches that gained content allocated in the
    table (content: counts, or an interior distance below the cap); then
    only the patches whose counts (occupancy, visits) or distances changed
    are written back, in place. A transient map then prunes the pool
    (:func:`transient_keep_aabb`, :func:`prune_transient_pool`).
    """
    geo = cfg.geometry
    length = geo.patch_length
    wp = cfg.window_patches
    dcfg = cfg.distance
    if org_cell is None:
        org_cell = win_mod.window_org(geo, geo.w2m(pose[:2]), wp)
    keys = win_mod.window_patch_keys(geo, org_cell, wp)
    if window is None:
        slots = pool_mod.table_lookup(state.table, keys)
        dist_old = None
    else:
        slots, dist_old = window
    occ_w, _ = win_mod.gather_window(state.table, state.occupied, keys, 0,
                                     slots=slots)
    vis_w, _ = win_mod.gather_window(state.table, state.visited, keys, 0,
                                     slots=slots)
    if dist_old is None:
        dist_old, _ = win_mod.gather_window(state.table, state.dist, keys,
                                            dcfg.max_dist, slots=slots)
    sc = scan_window_compute(cfg, pose, points, mask, origin, org_cell,
                             occ_w, vis_w, dist_old)

    counts_changed = (sc.occ_add + sc.vis_add) > 0
    content = counts_changed | (sc.interior & (sc.d2 < dcfg.max_sqdist))
    content_patch = content.reshape(wp, length, wp, length).any(3).any(1)
    need_new = content_patch & (slots < 0)
    cand = torch.where(need_new, keys, -1).reshape(-1)
    table, new_slots = pool_mod.table_insert_unique(state.table, cand)
    slots = torch.where(need_new, new_slots.reshape(wp, wp), slots)

    win_mod.scatter_window(state.occupied, slots, sc.occ_new,
                           write_mask=counts_changed)
    win_mod.scatter_window(state.visited, slots, sc.vis_new,
                           write_mask=counts_changed)
    win_mod.scatter_window(state.dist, slots, sc.dist_merged,
                           write_mask=sc.dist_merged != dist_old)
    state = SlamMapState(table, state.occupied, state.visited, state.dist)
    if cfg.transient:
        g = beam_geometry(cfg, pose, points, mask, origin)
        state = prune_transient_pool(state, cfg,
                                     *transient_keep_aabb(cfg, pose, g))
    info = {"processed_cells": sc.n_cells,
            "num_patches": state.table.num_patches(),
            "overflow": state.table.overflow}
    return state, info


# ---------------------------------------------------------------------------
# Transient maps
# ---------------------------------------------------------------------------

def transient_keep_aabb(cfg: MappingConfig, pose, g: ScanGeometry):
    """The box a transient map keeps (slam2d.cpp:329-343): the valid
    endpoints' bounds made symmetric about the pose, scaled by
    ``cfg.transient_expand`` (2 for Slam2D, 1 for LidarOdometry2D), grown
    by twice the distance range. Returns (centre [2], half extent [2]),
    world coordinates."""
    big = 1e30
    m = g.valid[:, None]
    mn = torch.where(m, g.hit_xy, big).amin(0)
    mx = torch.where(m, g.hit_xy, -big).amax(0)
    c = pose[:2]
    half = torch.maximum(c - mn, mx - c) * cfg.transient_expand
    return c, half + 2.0 * cfg.distance.max_dist


def _separated(a_center, a_half, b_center, b_half):
    """bool [...]: boxes (b_center [..., 2], b_half [2]) that miss the
    keep box (a_center, a_half) on some axis."""
    sep = torch.abs(a_center - b_center)
    return ~torch.all(sep <= a_half + b_half, dim=-1)


def _patch_boxes(geo: MapGeometry, anchors):
    """World (centre [..., 2], half extent [..., 2]) of the patches anchored
    at cells ``anchors`` [..., 2]."""
    ws = geo.m2w(anchors)
    we = geo.m2w(anchors + geo.patch_length)
    return 0.5 * (ws + we), 0.5 * (we - ws)


def prune_transient_pool(state: SlamMapState, cfg: MappingConfig,
                         a_center, a_half) -> SlamMapState:
    """Delete the pool patches whose box misses the keep box
    (slam2d.cpp:345-371), at most ``cfg.max_removals`` a call: the
    candidates of the lowest slots, the rest left for later calls. Freed
    slots get the default content (0, 0, max distance) in place. No host
    read: the fixed-size candidate list is the ``max_removals`` smallest
    of ``where(remove, slot, P)``."""
    keys, active = pool_mod.active_keys(state.table)
    b_center, b_half = _patch_boxes(cfg.geometry,
                                    cfg.geometry.p2anchor(keys))
    remove = active & _separated(a_center, a_half, b_center, b_half)
    p = remove.shape[0]
    slot = torch.arange(p, dtype=torch.int32, device=remove.device)
    cand = torch.sort(torch.where(remove, slot, p)).values
    k = cfg.max_removals
    if k > p:
        cand = torch.cat([cand, cand.new_full((k - p,), p)])
    cand = cand[:k]
    rm_keys = torch.where(cand < p, keys[torch.clamp(cand, max=p - 1).long()],
                          pool_mod.EMPTY)
    table, freed = pool_mod.table_remove_vec(state.table, rm_keys)
    trash = state.dist.shape[0] - 1
    ok = (freed >= 0)[:, None, None]
    target = torch.where(freed >= 0, freed, trash).long()
    for arr, default in ((state.occupied, 0), (state.visited, 0),
                         (state.dist, cfg.distance.max_dist)):
        arr[target] = torch.where(ok, torch.as_tensor(default,
                                                      dtype=arr.dtype,
                                                      device=arr.device),
                                  arr[trash])
    return SlamMapState(table, state.occupied, state.visited, state.dist)


def resident_transient_reset(cfg: MappingConfig, org, occ, vis, dist,
                             a_center, a_half):
    """Transient pruning of resident grids, IN PLACE: the window patches
    whose box misses the keep box get the default content (0, 0, the
    capped distance), the resident form of the pool path's deletion
    (slam2d.cpp:345-371). Returns (occ, vis, dist)."""
    geo = cfg.geometry
    length = geo.patch_length
    wp = occ.shape[-1] // length
    ar = torch.arange(wp, dtype=torch.int32, device=occ.device) * length
    anchors = torch.stack([(org[0] + ar)[None, :].expand(wp, wp),
                           (org[1] + ar)[:, None].expand(wp, wp)], -1)
    drop = _separated(a_center, a_half, *_patch_boxes(geo, anchors))
    drop = drop.repeat_interleave(length, 0).repeat_interleave(length, 1)
    if dist.dtype.is_floating_point:
        default = cfg.distance.max_dist
    else:
        default = cfg.distance.max_sqdist
    occ.masked_fill_(drop, 0)
    vis.masked_fill_(drop, 0)
    dist.masked_fill_(drop, default)
    return occ, vis, dist


# ---------------------------------------------------------------------------
# Resident sliding window
# ---------------------------------------------------------------------------

def resident_safe(cfg: MappingConfig, org, pose_cell):
    """bool: is an update anchored at ``pose_cell`` exact in the resident
    window at ``org``?"""
    m = cfg.resident_margin_cells
    w = cfg.resident_window_cells
    lp = pose_cell.to(torch.int32) - org
    return torch.all((lp >= m) & (lp < w - m), dim=-1)


def resident_org(cfg: MappingConfig, anchor_cell):
    """Patch-aligned resident-window origin centred at ``anchor_cell``."""
    return win_mod.window_org(cfg.geometry, anchor_cell,
                              cfg.resident_window_patches)


def _block_index(grid, y0, x0, h: int, w: int):
    """Index of the [h, w] blocks at offsets (``y0``, ``x0``): 0-dim
    offsets for a grid [H, W], offsets [P] for grids [P, H, W]."""
    rows = y0[..., None] + torch.arange(h, device=grid.device)
    cols = x0[..., None] + torch.arange(w, device=grid.device)
    if grid.dim() == 2:
        return rows[:, None], cols[None, :]
    p = torch.arange(grid.shape[0], device=grid.device)[:, None, None]
    return p, rows[:, :, None], cols[:, None, :]


def dyn_slice(grid, y0, x0, h: int, w: int):
    """grid[..., y0:y0+h, x0:x0+w] for tensor offsets (a gather: no host
    read of the offsets); one offset per particle for grids [P, H, W]."""
    return grid[_block_index(grid, y0, x0, h, w)]


def dyn_update(grid, block, y0, x0):
    """grid[..., y0:y0+h, x0:x0+w] = block IN PLACE, for tensor offsets."""
    h, w = block.shape[-2:]
    grid[_block_index(grid, y0, x0, h, w)] = block
    return grid


def _sq_pool_gather(state: SlamMapState, cfg: MappingConfig, keys):
    """(occ, vis, dist_sq) dense grids of the pool over patch grid
    ``keys``; the distance converts to the squared domain (an exact
    elementwise bijection, so it commutes with the patch gather)."""
    slots = pool_mod.table_lookup(state.table, keys)
    occ, _ = win_mod.gather_window(state.table, state.occupied, keys, 0,
                                   slots=slots)
    vis, _ = win_mod.gather_window(state.table, state.visited, keys, 0,
                                   slots=slots)
    dist, _ = win_mod.gather_window(state.table, state.dist, keys,
                                    cfg.distance.max_dist, slots=slots)
    return occ, vis, cfg.dist_to_sq(dist)


def resident_gather(state: SlamMapState, cfg: MappingConfig, org):
    """Pull the resident grids (occ, vis, dist_sq) from the pool at
    ``org``."""
    keys = win_mod.window_patch_keys(cfg.geometry, org,
                                     cfg.resident_window_patches)
    return _sq_pool_gather(state, cfg, keys)


def resident_flush(state: SlamMapState, cfg: MappingConfig, org,
                   occ, vis, dist) -> SlamMapState:
    """Write the resident grids back into the pool: patches that gained
    content are allocated, patches in the pool are rewritten wholesale,
    missing no-content patches are dropped."""
    keys = win_mod.window_patch_keys(cfg.geometry, org,
                                     cfg.resident_window_patches)
    return _flush_grids(state, cfg, keys, occ, vis, dist)


def _flush_grids(state: SlamMapState, cfg: MappingConfig, keys,
                 occ, vis, dist) -> SlamMapState:
    """Write dense grids covering patch grid ``keys`` [a, b] (cell grids
    [a*L, b*L], squared-distance ``dist``) back into the pool. A
    transient map deletes the pool patches whose window block holds only
    default content (the blocks a transient reset cleared): their slots
    are freed and the write resets the freed rows."""
    length = cfg.geometry.patch_length
    a, b = keys.shape
    slots = pool_mod.table_lookup(state.table, keys)
    has_dist = dist != cfg.distance.max_sqdist
    content = (occ != 0) | (vis > 0) | has_dist
    content_patch = content.reshape(a, length, b, length).any(3).any(1)
    need_new = content_patch & (slots < 0)
    cand = torch.where(need_new, keys, -1).reshape(-1)
    table, new_slots = pool_mod.table_insert_unique(state.table, cand)
    slots = torch.where(need_new, new_slots.reshape(a, b), slots)
    if cfg.transient:
        stale = (slots >= 0) & ~content_patch
        table, _ = pool_mod.table_remove_vec(
            table, torch.where(stale, keys, -1).reshape(-1))
    win_mod.scatter_window(state.occupied, slots, occ)
    win_mod.scatter_window(state.visited, slots, vis)
    win_mod.scatter_window(state.dist, slots, cfg.sq_to_dist(dist))
    return SlamMapState(table, state.occupied, state.visited, state.dist)


def _host_list(v) -> list:
    return (host_read(v, "reorg_origin") if isinstance(v, torch.Tensor)
            else list(v))


def resident_scroll(state: SlamMapState, cfg: MappingConfig, org,
                    occ, vis, dist, new_org, kp: int):
    """Band ("scroll") re-org: move the resident window from ``org`` to
    ``new_org`` (both patch-aligned, at most ``kp`` patches apart per
    axis), touching only ``kp``-patch edge bands.

    (1) flush the trailing band on each axis, (2) roll the grids so
    surviving cells keep their values, (3) gather the leading bands at the
    new origin and merge only the truly entering cells. Bit-identical to a
    flush + regather of the window. ``org`` and ``new_org`` are [x, y]
    tensors, read to the host once here, or host sequences (a caller that
    scrolls many windows by one shift reads it once).

    Returns (state, occ, vis, dist).
    """
    length = cfg.geometry.patch_length
    log2dim = cfg.geometry.log2dim
    wp = cfg.resident_window_patches
    w = wp * length
    org_p = [int(v) >> log2dim for v in _host_list(org)]
    new_org_p = [int(v) >> log2dim for v in _host_list(new_org)]
    sx = (new_org_p[0] - org_p[0]) * length
    sy = (new_org_p[1] - org_p[1]) * length
    dev = occ.device
    ar = torch.arange(kp, dtype=torch.int32, device=dev)
    aw = torch.arange(wp, dtype=torch.int32, device=dev)
    kl = kp * length

    # 1. flush the trailing (exit-side) bands
    ry0 = 0 if sy > 0 else wp - kp                         # patch row start
    rx0 = 0 if sx > 0 else wp - kp
    row_keys = (((org_p[0] + aw)[None, :] << PKEY_BITS)
                | (org_p[1] + ry0 + ar)[:, None])          # [kp, wp]
    rows = slice(ry0 * length, ry0 * length + kl)
    state = _flush_grids(state, cfg, row_keys, occ[rows], vis[rows],
                         dist[rows])
    col_keys = (((org_p[0] + rx0 + ar)[None, :] << PKEY_BITS)
                | (org_p[1] + aw)[:, None])                # [wp, kp]
    cols = slice(rx0 * length, rx0 * length + kl)
    state = _flush_grids(state, cfg, col_keys, occ[:, cols], vis[:, cols],
                         dist[:, cols])

    # 2. roll surviving content into its new-local position
    occ = torch.roll(occ, shifts=(-sy, -sx), dims=(0, 1))
    vis = torch.roll(vis, shifts=(-sy, -sx), dims=(0, 1))
    dist = torch.roll(dist, shifts=(-sy, -sx), dims=(0, 1))

    # 3. gather + merge the leading (enter-side) bands; a new-local row r
    #    maps to old-local r + sy and enters iff that is outside [0, w)
    ly0 = wp - kp if sy > 0 else 0
    rows_c = ly0 * length + torch.arange(kl, device=dev)
    m_row = ((rows_c >= w - sy) | (rows_c < -sy))[:, None]
    rk = (((new_org_p[0] + aw)[None, :] << PKEY_BITS)
          | (new_org_p[1] + ly0 + ar)[:, None])
    rows = slice(ly0 * length, ly0 * length + kl)
    for g, band in zip((occ, vis, dist), _sq_pool_gather(state, cfg, rk)):
        g[rows] = torch.where(m_row, band.to(g.dtype), g[rows])

    lx0 = wp - kp if sx > 0 else 0
    cols_c = lx0 * length + torch.arange(kl, device=dev)
    m_col = ((cols_c >= w - sx) | (cols_c < -sx))[None, :]
    ck = (((new_org_p[0] + lx0 + ar)[None, :] << PKEY_BITS)
          | (new_org_p[1] + aw)[:, None])
    cols = slice(lx0 * length, lx0 * length + kl)
    for g, band in zip((occ, vis, dist), _sq_pool_gather(state, cfg, ck)):
        g[:, cols] = torch.where(m_col, band.to(g.dtype), g[:, cols])
    return state, occ, vis, dist


def resident_update(cfg: MappingConfig, org, occ, vis, dist, pose,
                    points, mask, origin):
    """Apply one scan to the resident grids IN PLACE (no pool access).

    Returns (occ, vis, dist, processed_cells). The caller has checked
    :func:`resident_safe`. The scan math runs on the exact-update
    sub-window (``cfg.resident_update_cells``) centred at the pose cell;
    cells outside it cannot change, so this equals full-window compute.
    Poses [P, 4] with grids [P, W, W] (one shared ``org``) update every
    particle's grids at once (``_pf_map_phase`` of the JAX package).
    """
    w = dist.shape[-1]
    ws = cfg.resident_update_cells
    if ws >= w:
        sc = scan_window_compute(cfg, pose, points, mask, origin, org,
                                 occ, vis, dist)
        occ.copy_(sc.occ_new)
        vis.copy_(sc.vis_new)
        dist.copy_(sc.dist_merged)
        return occ, vis, dist, sc.n_cells
    lp = cfg.geometry.w2m(pose[..., :2]) - org        # window-local [x, y]
    start = torch.clamp(lp - ws // 2, 0, w - ws)      # [..., 2] = [x, y]
    sy, sx = start[..., 1], start[..., 0]
    sc = scan_window_compute(cfg, pose, points, mask, origin, org + start,
                             dyn_slice(occ, sy, sx, ws, ws),
                             dyn_slice(vis, sy, sx, ws, ws),
                             dyn_slice(dist, sy, sx, ws, ws))
    dyn_update(occ, sc.occ_new, sy, sx)
    dyn_update(vis, sc.vis_new, sy, sx)
    dyn_update(dist, sc.dist_merged, sy, sx)
    return occ, vis, dist, sc.n_cells
