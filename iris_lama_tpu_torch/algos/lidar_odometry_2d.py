"""Odometry-free lidar odometry (the reference's LidarOdometry2D).

reference: include/lama/lidar_odometry_2d.h, src/lidar_odometry_2d.cpp —
scan-to-local-map tracking with a probabilistic occupancy map and a 1 m
distance field, rays truncated to the last meter before the hit
(lidar_odometry_2d.cpp:104-113), a transient map (1x box expansion,
:131-182), and a map refresh after 0.1 m / 0.5 rad of estimated motion
(:73-80).

Per scan (the JAX package's ``_make_step.step``): the seed (the last pose,
or with ``motion_prediction`` the last pose moved by the last clamped
step), an f32 distance window gathered from the pool around it, the
generic GN IRLS match with Cauchy(0.15), the refresh gate, and on refresh
``mapping.update_maps`` on the pool. The JAX package decides the gate on
the device (``lax.cond``); here the host reads the flag, one read a scan
(``utils.trace.host_read``, site ``refresh``), and runs the update when
it is set. The pose, the last map-update pose and the trajectory stay on
the device.

The driver runs on the CUDA device unless constructed with
``device="cpu"``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..core import lie
from ..core.pose import Pose2D
from ..match import match_surface_2d as match
from ..nlls import solver as nlls_solver
from ..nlls.robust import CAUCHY_SCAN
from ..sdm import mapping, window as win_mod
from ..sdm.geometry import MapGeometry
from ..utils.cloud import PointCloudXYZ, beam_bucket, pad_scan
from ..utils.trace import host_read
from .slam2d import resolve_device

REFRESH_M = 0.1       # lidar_odometry_2d.cpp:73-80
REFRESH_RAD = 0.5


@dataclasses.dataclass(frozen=True)
class LidarOdometry2DOptions:
    """reference: LidarOdometry2D::Options (lidar_odometry_2d.h:63-68) +
    sizing knobs."""

    resolution: float = 0.05
    max_iter: int = 100
    max_range: float = 10.0
    max_beams: int = 0          # 0 = bucket from the first scan
    capacity: int = 2048
    patch_size: int = 32
    # seed each match at the last pose moved by the last (clamped) step;
    # the reference has no motion prediction (lidar_odometry_2d.cpp:59-81)
    motion_prediction: bool = False

    def mapping_config(self) -> mapping.MappingConfig:
        log2dim = int(np.log2(self.patch_size))
        return mapping.MappingConfig(
            geometry=MapGeometry(self.resolution, log2dim, False),
            l2_max=1.0,                 # setMaxDistance(1.0) (.cpp:45)
            truncated_ray=1.0,          # start = hit - AB/len (.cpp:110-112)
            max_range=self.max_range,
            capacity=self.capacity,
            occ_model="probabilistic",  # (.cpp:46)
            transient=True,
            transient_expand=1.0,       # (.cpp:141-150: no x2)
        )

    def solver_options(self) -> nlls_solver.SolverOptions:
        return nlls_solver.SolverOptions(max_iterations=self.max_iter,
                                         strategy="gn", robust=CAUCHY_SCAN)


def predicted_seed(pose_prev, prev_delta):
    """``pose_prev`` moved by the last step ``prev_delta``, clamped to 0.3 m
    and 0.3 rad (an unclamped diverged step throws the next seed outside
    the local map)."""
    t_norm = torch.sqrt(prev_delta[0] ** 2 + prev_delta[1] ** 2)
    t_scale = torch.clamp(0.3 / torch.clamp(t_norm, min=1e-9), max=1.0)
    ang = torch.clamp(torch.atan2(prev_delta[3], prev_delta[2]), -0.3, 0.3)
    pd = torch.stack([prev_delta[0] * t_scale, prev_delta[1] * t_scale,
                      torch.cos(ang), torch.sin(ang)])
    return lie.se2_compose(pose_prev, pd)


def refresh_due(map_odom, pose):
    """bool []: the estimated motion since the last map update exceeds
    0.1 m or 0.5 rad."""
    delta = lie.se2_compose(lie.se2_inverse(map_odom), pose)
    moved = torch.sqrt(delta[0] ** 2 + delta[1] ** 2)
    turned = torch.abs(torch.atan2(delta[3], delta[2]))
    return (moved > REFRESH_M) | (turned > REFRESH_RAD)


class LidarOdometry2D:
    """Host driver; mirrors the reference API (lidar_odometry_2d.h:50-76)."""

    TRAJ_CAP = 16384   # device-side trajectory capacity

    def __init__(self, options: LidarOdometry2DOptions =
                 LidarOdometry2DOptions(), device=None):
        self.device = resolve_device(device)
        self.options = options
        self.cfg = options.mapping_config()
        self.sopts = options.solver_options()
        self.map = mapping.slam_map_init(self.cfg, self.device)
        self.has_first_scan = False
        self._max_beams = options.max_beams
        identity = Pose2D().se2_array()
        self._pose_dev = self._tensor(identity)
        self._map_odom_dev = self._tensor(identity)
        self._delta_dev = self._tensor(identity)
        self._pose_host: Optional[Pose2D] = Pose2D()
        self._traj = torch.zeros((self.TRAJ_CAP, 4), dtype=torch.float32,
                                 device=self.device)
        self._n_updates = 0
        self.n_refreshes = 0          # map updates after the first scan
        self.last_refresh = True      # the last scan's refresh decision
        self.last_iterations = None   # device int32 of the last match

    def _tensor(self, a, dtype=torch.float32):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=self.device)

    def pose(self) -> Pose2D:
        """Current estimate (reads the device pose when stale)."""
        if self._pose_host is None:
            self._pose_host = Pose2D.from_se2_array(
                self._pose_dev.cpu().numpy())
        return self._pose_host

    def trajectory(self) -> np.ndarray:
        """All matched poses so far, [n, 3] xyr — one device read."""
        n = min(self._n_updates, self.TRAJ_CAP)
        t = self._traj[:n].cpu().numpy()
        return np.stack([t[:, 0], t[:, 1], np.arctan2(t[:, 3], t[:, 2])], -1)

    def update(self, cloud: PointCloudXYZ, timestamp: float = 0.0) -> bool:
        """lidar_odometry_2d.cpp:59-81."""
        if self._max_beams == 0:
            self._max_beams = beam_bucket(len(cloud.points))
        points, mask, origin = pad_scan(cloud, self._max_beams)
        return self.update_prepadded(points, mask, origin, timestamp)

    def update_prepadded(self, points, mask, origin,
                         timestamp: float = 0.0) -> bool:
        """Update from a pre-padded scan: points f32[B, 3], mask bool[B],
        origin f32[3] (tensors on the driver's device, or arrays)."""
        points = torch.as_tensor(points, dtype=torch.float32,
                                 device=self.device)
        mask = torch.as_tensor(mask, dtype=torch.bool, device=self.device)
        origin = torch.as_tensor(origin, dtype=torch.float32,
                                 device=self.device)
        if self._max_beams == 0:
            self._max_beams = points.shape[0]
        if not self.has_first_scan:
            self.map, _ = mapping.update_maps(self.map, self.cfg,
                                              self._pose_dev, points, mask,
                                              origin)
            self._traj[0] = self._pose_dev
            self._n_updates = 1
            self.has_first_scan = True
            return True
        self._step(points, mask, origin)
        return True

    def _step(self, points, mask, origin) -> None:
        cfg, geo = self.cfg, self.cfg.geometry
        pose_prev = self._pose_dev
        seed = (predicted_seed(pose_prev, self._delta_dev)
                if self.options.motion_prediction else pose_prev)
        wp = cfg.window_patches
        org = win_mod.window_org(geo, geo.w2m(seed[:2]), wp)
        keys = win_mod.window_patch_keys(geo, org, wp)
        grid, _ = win_mod.gather_window(self.map.table, self.map.dist, keys,
                                        cfg.distance.max_dist)
        res = match.solve_window(grid, org, geo, cfg.distance.max_dist,
                                 points[:, :2], mask, seed, self.sopts)
        pose = res.state
        if self.options.motion_prediction:
            self._delta_dev = lie.se2_compose(lie.se2_inverse(pose_prev),
                                              pose)
        self.last_refresh = bool(host_read(
            refresh_due(self._map_odom_dev, pose), "refresh"))
        if self.last_refresh:
            self.map, _ = mapping.update_maps(self.map, cfg, pose, points,
                                              mask, origin)
            self._map_odom_dev = pose
            self.n_refreshes += 1
        self._traj[min(self._n_updates, self.TRAJ_CAP - 1)] = pose
        self._pose_dev = pose
        self._pose_host = None
        self.last_iterations = res.iterations
        self._n_updates += 1

    # -- state across processes --------------------------------------------
    def state_dict(self) -> dict:
        """The map, poses and trajectory as numpy arrays (see
        :mod:`..utils.state`)."""
        from ..utils import state
        return state.lo_to_numpy(self)

    def load_state_dict(self, d: dict) -> None:
        from ..utils import state
        state.lo_from_numpy(self, d)
