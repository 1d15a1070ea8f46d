"""Pure localisation against fixed prebuilt maps (the reference's Loc2D).

reference: include/lama/loc2d.h, src/loc2d.cpp. Per scan: odometry
prediction -> motion gate -> scan-match solve with covariance
(loc2d.cpp:168-173) -> RMSE; optional Olson sampled-covariance blending
(:199-247) and global localisation — ``gloc_particles`` random free-cell
pose hypotheses scored by residual SSE, the best kept, repeated until the
RMSE drops below ``gloc_thresh`` (:249-286).

The distance map is read through a resident window: the maps are fixed, so
the dense window is gathered from the patch pool only when the predicted
pose leaves its safe zone, and each update slices the pose-centred match
window out of it. The host reads the predicted pose cell once per update
for that check (and the solver's stop flag at its checkpoints); both go
through ``utils.trace.host_read`` (sites ``loc_cell`` and ``irls_stop``).

``match`` picks the scan matcher (the JAX package's environment switches
become this constructor argument):

* ``"generic"`` — float32 meter windows, the generic IRLS solver;
* ``"sq"`` — squared-distance windows (``DistanceConfig.sq_dtype``: int8
  at 5 cm cells and ``l2_max`` 0.5, wider at finer cells), the generic
  solver over B2;
* ``"solve"`` — squared-distance windows, the whole solve in one launch of
  B4;
* ``"fused"`` — squared-distance windows, one launch of B5 per IRLS
  evaluation.

The covariance and RMSE evaluation after the solve reads the same window
(through B2 in the squared-distance modes). A kernel mode raises
ValueError for options it cannot serve (``strategy="lm"``).

Random numbers: one gloc round draws ``uniform (n, 2)`` then
``uniform (n,)``, the order of the JAX package's key stream. They come
from a ``torch.Generator`` on the CPU seeded ``seed if seed else 42`` and
move to the device, so a CPU run and a card run of one seed see the same
draws; a caller may pass its own draw source.

The driver runs on the CUDA device unless constructed with
``device="cpu"``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..core import lie
from ..core.pose import Pose2D
from ..match import match_surface_2d as match_mod
from ..nlls import solver as nlls_solver
from ..nlls.robust import CAUCHY_SCAN
from ..nlls.solver import SolverOptions
from ..sdm import distance as dist_mod
from ..sdm import occupancy as occ_mod
from ..sdm import pool as pool_mod
from ..sdm import window as win_mod
from ..sdm.geometry import MapGeometry, f32
from ..utils.cloud import PointCloudXYZ, beam_bucket, pad_scan
from ..utils.trace import host_read
from .pf_slam2d import DrawSource
from .slam2d import resolve_device

MATCH_MODES = ("generic", "sq", "solve", "fused")
# match mode -> match_surface_2d.solve_window route
_ROUTE = {"generic": "generic", "sq": "generic", "solve": "solve",
          "fused": "fused"}
RESIDENT_EXTRA = 4   # wander rings of the resident window (patches)
# hypotheses scored per pass of global localisation (bounds the memory of
# the pool lookups at ~1 M hits per pass)
GLOC_HITS_PER_PASS = 1 << 20


@dataclasses.dataclass(frozen=True)
class Loc2DOptions:
    """reference: Loc2D::Options (loc2d.h:61-99), with the JAX package's
    defaults."""

    trans_thresh: float = 0.5
    rot_thresh: float = 0.5
    l2_max: float = 1.0
    resolution: float = 0.05
    patch_size: int = 32
    gloc_particles: int = 3000
    gloc_iters: int = 10
    gloc_thresh: float = 0.15
    max_iter: int = 100
    cov_blend: float = 0.0
    strategy: str = "gn"
    max_range: float = 10.0
    max_beams: int = 0

    def solver_options(self) -> SolverOptions:
        return SolverOptions(max_iterations=self.max_iter,
                             strategy=self.strategy, robust=CAUCHY_SCAN)


class LocMaps(NamedTuple):
    """The fixed map inputs (loc2d.h:103-104)."""

    occupancy: occ_mod.SimpleOccupancyState
    distance: dist_mod.DistanceMapState


def maps_from_slam(slam_map, cfg=None) -> LocMaps:
    """Loc2D inputs from a built SLAM map (``sdm.mapping.SlamMapState``;
    the role Map::write/read plays between Slam2D and Loc2D): a cell is
    occupied iff ``4 * occ > vis``, free iff visited and ``4 * occ <
    vis``. ``cfg`` (the map's ``MappingConfig``) is not needed; it stays
    for the JAX package's signature."""
    occ = slam_map.occupied.to(torch.int32)
    vis = slam_map.visited.to(torch.int32)
    occupied = 4 * occ > vis
    free = (vis > 0) & (4 * occ < vis)
    cells = torch.where(occupied, 1, torch.where(free, -1, 0)).to(torch.int8)
    simple = occ_mod.SimpleOccupancyState(slam_map.table, cells)
    dm = dist_mod.DistanceMapState(slam_map.table, slam_map.dist == 0.0,
                                   slam_map.dist)
    return LocMaps(simple, dm)


def map_bounds(table: pool_mod.PatchTable, geo: MapGeometry):
    """World-coordinate bounds (lo, hi) f32 [2] of the allocated patches
    (Map::bounds, src/sdm/map.cpp:139-160)."""
    keys, mask = pool_mod.active_keys(table)
    anchors = geo.p2anchor(keys)
    big = 1 << 30
    lo = torch.where(mask[:, None], anchors, big).amin(0)
    hi = torch.where(mask[:, None], anchors + geo.patch_length, -big).amax(0)
    return geo.m2w(lo), geo.m2w(hi)


def _sse_for_poses(maps: LocMaps, geo, max_dist, points_xy, mask, poses):
    """Masked residual SSE of the scan at each pose hypothesis [K, 4] ->
    [K], read from the pool by interpolation, in passes of at most
    ``GLOC_HITS_PER_PASS`` hits."""
    fm = mask.to(torch.float32)
    per = max(1, GLOC_HITS_PER_PASS // max(points_xy.shape[0], 1))
    out = []
    for k in range(0, poses.shape[0], per):
        hits = lie.se2_apply(poses[k:k + per, None, :], points_xy)
        d, _ = dist_mod.interp_pool(maps.distance.table, maps.distance.dist,
                                    geo, hits, max_dist)
        d = d * fm
        out.append(torch.sum(d * d, dim=-1))
    return torch.cat(out)


def global_localization_kernel(maps: LocMaps, geo: MapGeometry, max_dist,
                               points_xy, mask, n_particles: int, draw):
    """One gloc round (loc2d.cpp:249-286): ``n_particles`` uniform pose
    hypotheses over the map bounds, those off free cells discarded, the
    arg-min SSE pose kept. ``draw(kind, shape)`` gives the uniform draws
    (``[n, 2]`` for x, y, then ``[n]`` for the heading) as f32 tensors on
    the device. Returns (pose [4], sse [])."""
    lo, hi = map_bounds(maps.occupancy.table, geo)
    xy = draw("uniform", (n_particles, 2)) * (hi - lo) + lo
    th = draw("uniform", (n_particles,)) * f32(2 * math.pi) - f32(math.pi)
    free = occ_mod.simple_is_free(maps.occupancy, geo, geo.w2m(xy))
    poses = lie.se2(xy[:, 0], xy[:, 1], th)
    sse = _sse_for_poses(maps, geo, max_dist, points_xy, mask, poses)
    sse = torch.where(free, sse, torch.full_like(sse, math.inf))
    best = torch.argmin(sse)
    return poses[best], sse[best]


def sampling_covariance_kernel(maps: LocMaps, geo, max_dist, points_xy,
                               mask, pose, resolution: float,
                               n_points_step: int):
    """Olson sampled covariance of the xy position (loc2d.cpp:199-247).

    161 xy offsets (the centre and 20 rings of 8 neighbours at multiples
    of the resolution, loc2d.cpp:91-107); at each, the likelihood
    ``l = sum exp(-d^2 / 0.01)^3`` over every ``n_points_step``-th beam,
    with the uninterpolated cell distance (loc2d.cpp:230).
    """
    steps = [(0.0, 0.0)]
    for i in range(1, 21):
        s = i * resolution
        steps += [(s, 0), (0, s), (-s, 0), (0, -s),
                  (s, s), (-s, s), (s, -s), (-s, -s)]
    offsets = torch.as_tensor(np.array(steps, np.float32),
                              device=pose.device)                   # [S, 2]
    pts = points_xy[::n_points_step]
    pmask = mask[::n_points_step].to(torch.float32)
    trans = pose[None, 0:2] + offsets                               # [S, 2]
    poses = torch.cat([trans, pose[None, 2:4].expand(len(steps), 2)], -1)
    cells = geo.w2m(lie.se2_apply(poses[:, None, :], pts))
    d = dist_mod.cell_distance(maps.distance.table, maps.distance.dist, geo,
                               cells, max_dist)
    e = torch.exp(-(d * d) / f32(0.01)) * pmask
    ls = torch.sum(e * e * e, dim=-1)                               # [S]
    s = torch.sum(ls)
    u = torch.sum(trans * ls[:, None], dim=0)
    k = torch.sum(trans[:, :, None] * trans[:, None, :] * ls[:, None, None],
                  dim=0)
    return k / s - u[:, None] * u[None, :] / (s * s)


class Loc2D:
    """Host driver; mirrors the reference public API (loc2d.h:101-160).

    ``match``: one of :data:`MATCH_MODES` (module docstring). ``draws``:
    optional source of the random numbers, called as ``draws("uniform",
    shape)``; it returns an array or tensor of float32.
    """

    TRAJ_CAP = 16384   # device-side trajectory capacity

    def __init__(self, options: Loc2DOptions = Loc2DOptions(),
                 maps: Optional[LocMaps] = None, seed: int = 0,
                 device=None, match: str = "generic",
                 draws: Optional[DrawSource] = None):
        if match not in MATCH_MODES:
            raise ValueError(f"match {match!r}: expected one of "
                             f"{MATCH_MODES}")
        if maps is not None:
            # the maps are the authority on patch storage (the reference
            # reads patch_length from the .smd header, sdm/map.h:95-103)
            length = int(maps.distance.dist.shape[-1])
            if options.patch_size != length:
                options = dataclasses.replace(options, patch_size=length)
        self.device = resolve_device(device)
        self.options = options
        self.match = match
        self.sopts = options.solver_options()
        self._route = _ROUTE[match]
        match_mod.check_kernel_route(self._route, self.sopts)
        self.geo = MapGeometry(options.resolution,
                               int(np.log2(options.patch_size)), False)
        self.dcfg = dist_mod.DistanceConfig(self.geo, options.l2_max)
        self.max_dist = self.dcfg.max_dist
        # window sizing: scan reach + solver travel slack (the margin of
        # MappingConfig.window_patches); the match window side ws, the
        # resident window w_res with RESIDENT_EXTRA rings of wander room
        geo = self.geo
        self._half_cells = int(math.ceil((options.max_range + 2.0) * geo.scale
                                         + self.dcfg.radius_cells))
        wp = 2 * (int(math.ceil(self._half_cells / geo.patch_length)) + 1)
        self._ws = wp * geo.patch_length
        self._wp_res = wp + 2 * RESIDENT_EXTRA
        self._w_res = self._wp_res * geo.patch_length
        self.maps = maps
        self.odom_ = Pose2D()
        self.has_first_scan = False
        self._pose_dev = self._tensor(Pose2D().se2_array())
        self._pose_host: Optional[Pose2D] = Pose2D()
        self._cov_dev = torch.eye(3, device=self.device)
        self._cov_host: Optional[np.ndarray] = np.eye(3)
        self._rmse_dev = torch.zeros((), device=self.device)
        self._rmse_host: Optional[float] = 0.0
        self._traj = torch.zeros((self.TRAJ_CAP, 4), dtype=torch.float32,
                                 device=self.device)
        self._n_updates = 0
        self.do_global_localization = False
        self.gloc_cur_iter = 0
        self._gen = torch.Generator().manual_seed(seed if seed else 42)
        self._draws = draws
        self._max_beams = options.max_beams
        self._win = None            # resident window of the distance map
        self._org = None            # its origin cell [x, y] (host ints)
        self.n_gathers = 0          # resident-window gathers

    def _tensor(self, a, dtype=torch.float32):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                               device=self.device)

    def _draw(self, kind: str, shape: tuple):
        if self._draws is not None:
            return torch.tensor(np.asarray(self._draws(kind, shape)),
                                dtype=torch.float32, device=self.device)
        return torch.rand(shape, generator=self._gen).to(self.device)

    # -- reference API ------------------------------------------------------
    def set_maps(self, maps: LocMaps) -> None:
        self.maps = maps
        self._win = self._org = None   # the next update gathers anew

    def set_prior(self, prior: Pose2D) -> None:
        self._pose_dev = self._tensor(prior.se2_array())
        self._pose_host = prior

    def trigger_global_localization(self) -> None:
        self.do_global_localization = True

    def pose(self) -> Pose2D:
        if self._pose_host is None:
            self._pose_host = Pose2D.from_se2_array(
                self._pose_dev.cpu().numpy())
        return self._pose_host

    def covariance(self) -> np.ndarray:
        if self._cov_host is None:
            self._cov_host = self._cov_dev.cpu().numpy().astype(np.float64)
        return self._cov_host

    def rmse(self) -> float:
        if self._rmse_host is None:
            self._rmse_host = float(self._rmse_dev)
        return self._rmse_host

    def trajectory(self) -> np.ndarray:
        """All matched poses so far, [n, 3] xyr — one device read."""
        n = min(self._n_updates, self.TRAJ_CAP)
        t = self._traj[:n].cpu().numpy()
        return np.stack([t[:, 0], t[:, 1], np.arctan2(t[:, 3], t[:, 2])], -1)

    def _enough_motion(self, odelta: Pose2D) -> bool:
        return not (np.linalg.norm(odelta.xy()) <= self.options.trans_thresh
                    and abs(odelta.rotation()) <= self.options.rot_thresh)

    def update(self, cloud: PointCloudXYZ, odometry: Pose2D,
               timestamp: float = 0.0, force_update: bool = False) -> bool:
        """loc2d.cpp:126-192."""
        if self.maps is None:
            raise RuntimeError("Loc2D needs maps (loc2d.h:103-104)")
        opts = self.options
        if self._max_beams == 0:
            self._max_beams = beam_bucket(len(cloud.points))
        points, mask, _ = pad_scan(cloud, self._max_beams)
        pts = self._tensor(points[:, :2])
        msk = self._tensor(mask, torch.bool)

        if not self.has_first_scan:
            self.odom_ = odometry
            self.has_first_scan = True
            if not force_update:
                return True
            self._rmse_dev = self._rmse_at(self._pose_dev, pts, msk)
            self._rmse_host = None

        odelta = self.odom_ - odometry
        if not force_update and not self._enough_motion(odelta):
            return False
        self.odom_ = odometry

        use_gloc = False
        if self.do_global_localization:
            if self.gloc_cur_iter < opts.gloc_iters:
                self.gloc_cur_iter += 1
                use_gloc = True
            else:
                self.do_global_localization = False
                self.gloc_cur_iter = 0
        self._step(self._tensor(odelta.se2_array()), pts, msk, use_gloc)

        if opts.cov_blend > 0.0:
            n_step = max(int(np.sum(mask)) // 100, 1)
            samp = sampling_covariance_kernel(
                self.maps, self.geo, self.max_dist, pts, msk, self._pose_dev,
                opts.resolution, n_step)
            a = min(max(opts.cov_blend, 0.0), 1.0)
            cov_h = self._cov_dev.cpu().numpy().astype(np.float64)
            cov_h[:2, :2] = (a * samp.cpu().numpy()
                             + (1 - a) * cov_h[:2, :2])
            self._cov_host = cov_h

        # gloc convergence needs the rmse on the host (rare path)
        if self.do_global_localization and self.rmse() < opts.gloc_thresh:
            self.do_global_localization = False
            self.gloc_cur_iter = 0
        return True

    def update_many_prepadded(self, staged, odoms, chunk: int = 32) -> list:
        """Replay a pre-staged log: ``staged`` holds (points_xy f32[B, 2],
        mask bool[B]) tensors on the driver's device, ``odoms`` the
        matching odometry; the motion gate runs per scan as in
        :meth:`update`. Returns the accepted indices. Global localisation
        and covariance blending are served by :meth:`update` only.

        ``chunk`` is the JAX package's dispatch amortisation (accepted
        updates per device program); here each accepted update runs in
        turn, so every ``chunk`` gives the same results.
        """
        if self.maps is None:
            raise RuntimeError("Loc2D needs maps (loc2d.h:103-104)")
        if self.do_global_localization or self.options.cov_blend != 0.0:
            raise ValueError("update_many_prepadded serves neither global "
                             "localisation nor covariance blending; use "
                             "update")
        if chunk < 1:
            raise ValueError(f"chunk {chunk}: expected >= 1")
        if self._max_beams == 0:
            self._max_beams = staged[0][0].shape[0]
        start = 0
        accepted = []
        if not self.has_first_scan:
            self.odom_ = odoms[0]
            self.has_first_scan = True
            start = 1
        for k in range(start, len(staged)):
            odelta = self.odom_ - odoms[k]
            if not self._enough_motion(odelta):
                continue
            self.odom_ = odoms[k]
            pts, msk = staged[k]
            self._step(self._tensor(odelta.se2_array()), pts, msk, False)
            accepted.append(k)
        return accepted

    # -- device steps -------------------------------------------------------
    def _step(self, od, pts, msk, use_gloc: bool) -> None:
        """Predict (loc2d.cpp:149-151), optionally replace the prediction
        by a gloc round's best hypothesis, then match with covariance and
        RMSE and append to the trajectory."""
        pose0 = lie.se2_compose(self._pose_dev, od)
        if use_gloc:
            pose0, _ = global_localization_kernel(
                self.maps, self.geo, self.max_dist, pts, msk,
                self.options.gloc_particles, self._draw)
        state, cov, rmse = self._solve_and_cov(pose0, pts, msk)
        self._traj[min(self._n_updates, self.TRAJ_CAP - 1)] = state
        self._pose_dev = state
        self._cov_dev = cov
        self._rmse_dev = rmse
        self._pose_host = self._cov_host = self._rmse_host = None
        self._n_updates += 1

    def _gather_resident(self, org) -> None:
        """Gather the resident window at origin ``org`` [x, y] (host ints)
        from the pool; squared distances in the squared-distance modes."""
        org_t = torch.tensor(org, dtype=torch.int32, device=self.device)
        keys = win_mod.window_patch_keys(self.geo, org_t, self._wp_res)
        dm = self.maps.distance
        grid, _ = win_mod.gather_window(dm.table, dm.dist, keys,
                                        self.max_dist)
        self._win = grid if self.match == "generic" else \
            self.dcfg.dist_to_sq(grid)
        self._org = list(org)
        self.n_gathers += 1

    def match_window(self, pose0):
        """(window, origin int32 [2]): the match window centred at pose
        ``pose0`` [4], sliced from the resident window, which is gathered
        anew when the pose cell lies outside its safe zone. Reads the pose
        cell on the host (one host read)."""
        geo, ws, w_res = self.geo, self._ws, self._w_res
        cell = host_read(geo.w2m(pose0[:2]), "loc_cell")
        m = self._half_cells
        if self._org is None or not all(
                m <= c - o < w_res - m for c, o in zip(cell, self._org)):
            # a patch-aligned resident window centred at the pose's patch
            self._gather_resident([((c >> geo.log2dim) - self._wp_res // 2)
                                   << geo.log2dim for c in cell])
        start = [min(max(c - o - ws // 2, 0), w_res - ws)
                 for c, o in zip(cell, self._org)]
        sub = self._win[start[1]:start[1] + ws,
                        start[0]:start[0] + ws].contiguous()
        sub_org = torch.tensor([o + s for o, s in zip(self._org, start)],
                               dtype=torch.int32, device=self.device)
        return sub, sub_org

    def _solve_and_cov(self, pose0, pts, msk):
        """The match on the pose-centred match window, then one evaluation
        at the solution shared by covariance and RMSE."""
        geo = self.geo
        sub, sub_org = self.match_window(pose0)
        res = match_mod.solve_window(sub, sub_org, geo, self.max_dist, pts,
                                     msk, pose0, self.sopts,
                                     route=self._route)
        eval_fn = match_mod.make_window_eval(sub, sub_org, geo, self.max_dist,
                                         pts, msk)
        r, J = eval_fn(res.state)
        cov = nlls_solver.covariance_from_eval(r, J, self.sopts.robust)
        n = torch.clamp(msk.sum() - 1, min=1).to(torch.float32)
        return res.state, cov, torch.sqrt(torch.sum(r * r) / n)

    def _rmse_at(self, pose0, pts, msk):
        """RMSE of the scan at ``pose0``, interpolated from the pool (the
        first scan under ``force_update``)."""
        dm = self.maps.distance
        eval_fn = match_mod.make_pool_eval(dm.table, dm.dist, self.geo,
                                       self.max_dist, pts, msk)
        r, _ = eval_fn(pose0)
        n = torch.clamp(msk.sum() - 1, min=1).to(torch.float32)
        return torch.sqrt(torch.sum(r * r) / n)
