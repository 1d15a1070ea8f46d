"""Online scan-to-map SLAM (the reference's Slam2D).

reference: include/lama/slam2d.h, src/slam2d.cpp:143-198 (update loop) and
:247-321 (map update). Per accepted scan: odometry prediction -> scan match
(GN + Cauchy(0.15), slam2d.cpp:104-107) against the resident squared-
distance window -> rasterise the scan into the resident grids. The patch
pool is exchanged with the window only on re-orgs, which the host triggers
from odometry travel between scans (a full flush + regather, or a band
"scroll" when the shift fits; transient maps take the full flush); each
step counts the poses that left the window's safe zone (``escaped_count``)
and the re-org trigger tightens on escapes, down to a per-scan safe-zone
check. A transient map (slam2d.cpp:323-373) resets the window patches and
deletes the pool patches outside the scan's expanded box after every scan.

``resident_window=False`` takes the pool-per-scan path instead (the JAX
package's ``_make_step``): each scan gathers an f32 distance window from
the pool, matches on its squared-distance form and applies the scan with
``mapping.update_maps``.

The driver runs on the CUDA device unless constructed with
``device="cpu"``; the pose, trajectory and map stay on the device and the
host reads them only on request (and the IRLS stop flag, the escape
counter and re-org origins at their checkpoints).
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Optional

import numpy as np
import torch

from ..core import lie
from ..core.pose import Pose2D
from ..match import match_surface_2d as match
from ..nlls.robust import CAUCHY_SCAN
from ..nlls.solver import SolverOptions
from ..sdm import mapping, window as win_mod
from ..sdm.geometry import MapGeometry
from ..utils.cloud import PointCloudXYZ, beam_bucket, pad_scan


@dataclasses.dataclass(frozen=True)
class Slam2DOptions:
    """reference: Slam2D::Options (slam2d.h:91-125) + sizing knobs.

    ``use_compression``, ``detailed_summary`` and ``create_summary`` are
    not ported: :class:`Slam2D` raises NotImplementedError for them.
    """

    trans_thresh: float = 0.5
    rot_thresh: float = 0.5
    l2_max: float = 0.5
    truncated_ray: float = 0.0
    truncated_range: float = 0.0
    resolution: float = 0.05
    patch_size: int = 32
    max_iter: int = 100
    strategy: str = "gn"
    transient_map: bool = False
    create_summary: bool = False
    detailed_summary: bool = False
    use_compression: bool = False
    max_range: float = 10.0     # beams beyond this are dropped on host
    max_beams: int = 0          # 0 = bucket from first scan
    capacity: int = 4096        # patch-pool capacity
    pose_slack: float = 2.0
    resident_window: bool = True
    resident_extra_patches: int = 4
    # host-gated re-orgs: the driver triggers flush + regather from
    # odometry travel between scans (conservative slack, _reorg_trigger_m)
    host_reorg: bool = True
    host_reorg_slack: float = 1.0   # odometry drift allowance (m)
    # band re-orgs (mapping.resident_scroll); kp = 0 sizes the band from
    # the wander allowance
    scroll_reorg: bool = True
    scroll_kp: int = 0

    def mapping_config(self) -> mapping.MappingConfig:
        log2dim = int(np.log2(self.patch_size))
        return mapping.MappingConfig(
            geometry=MapGeometry(self.resolution, log2dim, False),
            l2_max=self.l2_max,
            truncated_ray=self.truncated_ray,
            truncated_range=self.truncated_range,
            max_range=self.max_range,
            pose_slack=self.pose_slack,
            capacity=self.capacity,
            transient=self.transient_map,
            transient_expand=2.0,       # slam2d.cpp:335-340
            resident_extra_patches=self.resident_extra_patches,
        )

    def solver_options(self) -> SolverOptions:
        # Cauchy(0.15) hardwired like the reference (slam2d.cpp:106)
        return SolverOptions(max_iterations=self.max_iter,
                             strategy=self.strategy, robust=CAUCHY_SCAN)


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless asked otherwise.
    Raises when CUDA is asked for (the default) and absent — there is no
    silent fall-back to the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available; pass device='cpu' "
                               "to run the plain PyTorch versions")
        # the float32 sums and selections must not run in TF32
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return dev


class Slam2D:
    """Host driver; mirrors the reference public API (slam2d.h:127-176)."""

    TRAJ_CAP = 16384   # device-side trajectory capacity

    def __init__(self, options: Slam2DOptions = Slam2DOptions(),
                 device=None):
        for name in ("use_compression", "detailed_summary", "create_summary"):
            if getattr(options, name):
                raise NotImplementedError(f"Slam2DOptions.{name} is not "
                                          "ported")
        self.device = resolve_device(device)
        self.options = options
        self.cfg = options.mapping_config()
        self.sopts = options.solver_options()
        self._map = mapping.slam_map_init(self.cfg, self.device)
        self.odom_ = Pose2D()
        self.has_first_scan = False
        self._max_beams = options.max_beams
        self._built = False
        self._resident = options.resident_window
        self._res_org = None
        self._res_occ = self._res_vis = self._res_dist = None
        self._res_dirty = False
        self._scroll_kp = 0
        self._pose_dev = self._tensor(Pose2D().se2_array())
        self._pose_host: Optional[Pose2D] = Pose2D()
        self._traj = torch.zeros((self.TRAJ_CAP, 4), dtype=torch.float32,
                                 device=self.device)
        self._n_updates = 0
        self._host_reorg = False
        self._odom_reorg: Optional[Pose2D] = None
        self._esc_dev = torch.zeros((), dtype=torch.int32, device=self.device)
        self.n_reorgs = 0    # re-orgs (full + scroll)
        self.n_scrolls = 0   # of which band scrolls
        self.last_iterations = None   # device int32 of the last match
        self._esc_seen = 0
        self._esc_clean = 0
        self._extra_slack = 0.0

    def _tensor(self, a, dtype=torch.float32):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=self.device)

    # -- reference API ------------------------------------------------------
    @property
    def map(self) -> mapping.SlamMapState:
        """The patch-pool map; flushes the resident grids into the pool
        when they are ahead of it."""
        if self._res_dirty:
            self._map = mapping.resident_flush(
                self._map, self.cfg, self._res_org, self._res_occ,
                self._res_vis, self._res_dist)
            self._res_dirty = False
        return self._map

    def set_prior(self, prior: Pose2D) -> None:
        self._pose_dev = self._tensor(prior.se2_array())
        self._pose_host = prior

    def pose(self) -> Pose2D:
        """Current pose (reads the device pose when stale)."""
        if self._pose_host is None:
            self._pose_host = Pose2D.from_se2_array(
                self._pose_dev.cpu().numpy())
        return self._pose_host

    def trajectory(self) -> np.ndarray:
        """All matched poses so far, [n, 3] xyr — one device read."""
        n = min(self._n_updates, self.TRAJ_CAP)
        t = self._traj[:n].cpu().numpy()
        return np.stack([t[:, 0], t[:, 1], np.arctan2(t[:, 3], t[:, 2])], -1)

    def enough_motion(self, odometry: Pose2D) -> bool:
        """slam2d.cpp:130-141."""
        if not self.has_first_scan:
            return True
        return not self._below_gate(self.odom_ - odometry)

    def _below_gate(self, odelta: Pose2D) -> bool:
        return (np.linalg.norm(odelta.xy()) <= self.options.trans_thresh
                and abs(odelta.rotation()) <= self.options.rot_thresh)

    def escaped_count(self) -> int:
        """Updates whose predicted pose left the resident safe zone before
        a re-org — 0 in a healthy run."""
        return int(self._esc_dev)

    def update(self, cloud: PointCloudXYZ, odometry: Pose2D,
               timestamp: float = 0.0) -> bool:
        """slam2d.cpp:143-198."""
        if self._max_beams == 0:
            self._max_beams = beam_bucket(len(cloud.points))
        points, mask, origin = pad_scan(cloud, self._max_beams)
        return self.update_prepadded(self._tensor(points),
                                     self._tensor(mask, torch.bool),
                                     self._tensor(origin), odometry,
                                     timestamp)

    def update_prepadded(self, points, mask, origin, odometry: Pose2D,
                         timestamp: float = 0.0) -> bool:
        """Update from a pre-padded scan: points f32[B, 3], mask bool[B],
        origin f32[3] (tensors on the driver's device, or arrays)."""
        points = torch.as_tensor(points, dtype=torch.float32,
                                 device=self.device)
        mask = torch.as_tensor(mask, dtype=torch.bool, device=self.device)
        origin = torch.as_tensor(origin, dtype=torch.float32,
                                 device=self.device)
        if not self._built:
            self._max_beams = points.shape[0]
            self._build_programs()
        if not self.has_first_scan:
            self.odom_ = odometry
            self._do_first(points, mask, origin)
            return True
        odelta = self.odom_ - odometry
        if self._below_gate(odelta):
            return False
        self._maybe_reorg(odometry)
        self.odom_ = odometry
        self._do_step(self._tensor(odelta.se2_array()), points, mask, origin)
        return True

    def update_many_prepadded(self, staged, odoms, chunk: int = 32) -> list:
        """Replay a pre-staged log: ``staged`` is a list of (points, mask,
        origin), ``odoms`` the matching odometry. The motion gate and the
        re-orgs run per scan exactly as in :meth:`update`. Returns the
        accepted scan indices.

        ``chunk`` is the JAX package's dispatch amortisation (accepted
        scans per device program); here each accepted scan runs in turn,
        so every ``chunk`` gives the same results.
        """
        if chunk < 1:
            raise ValueError(f"chunk {chunk}: expected >= 1")
        return [k for k in range(len(staged))
                if self.update_prepadded(*staged[k], odoms[k])]

    # -- resident window ----------------------------------------------------
    @property
    def _reorg_trigger_m(self) -> float:
        """Odometry travel between host-gated re-orgs: wander allowance
        minus patch-alignment slop minus the drift slack, in meters."""
        cfg = self.cfg
        cells = (cfg.resident_window_cells // 2 - cfg.resident_margin_cells
                 - cfg.geometry.patch_length)
        return (cells * cfg.geometry.resolution
                - self.options.host_reorg_slack - self._extra_slack)

    def _build_programs(self) -> None:
        self._built = True
        self._host_reorg = (self._resident and self.options.host_reorg
                            and self._reorg_trigger_m >= 0.5)
        self._scroll_kp = 0
        # transient pruning needs the full flush: no band scrolls
        if (self._host_reorg and self.options.scroll_reorg
                and not self.options.transient_map):
            patch_m = (self.cfg.geometry.patch_length
                       * self.cfg.geometry.resolution)
            kp = self.options.scroll_kp or (int(np.ceil(
                (self._reorg_trigger_m + self.options.host_reorg_slack)
                / patch_m)) + 1)
            if kp < self.cfg.resident_window_patches // 2:
                self._scroll_kp = kp

    def _do_first(self, points, mask, origin) -> None:
        cfg = self.cfg
        if self._resident:
            w = cfg.resident_window_cells
            geo = cfg.geometry
            self._res_org = mapping.resident_org(cfg,
                                                 geo.w2m(self._pose_dev[:2]))
            self._res_occ = torch.zeros((w, w), dtype=mapping.COUNT_DTYPE,
                                        device=self.device)
            self._res_vis = torch.zeros_like(self._res_occ)
            self._res_dist = torch.full((w, w), cfg.distance.max_sqdist,
                                        dtype=cfg.sq_dtype,
                                        device=self.device)
            mapping.resident_update(cfg, self._res_org, self._res_occ,
                                    self._res_vis, self._res_dist,
                                    self._pose_dev, points, mask, origin)
            if cfg.transient:
                self._transient_reset(self._pose_dev, points, mask, origin)
            self._res_dirty = True
        else:
            self._map, _ = mapping.update_maps(self._map, cfg,
                                               self._pose_dev, points, mask,
                                               origin)
        self._traj[0] = self._pose_dev
        self._n_updates = 1
        self.has_first_scan = True
        self._odom_reorg = self.odom_   # host-gated re-org anchor

    def _transient_reset(self, pose, points, mask, origin):
        """Reset the resident patches outside the scan's keep box; returns
        the box (centre, half extent)."""
        cfg = self.cfg
        g = mapping.beam_geometry(cfg, pose, points, mask, origin)
        box = mapping.transient_keep_aabb(cfg, pose, g)
        mapping.resident_transient_reset(cfg, self._res_org, self._res_occ,
                                         self._res_vis, self._res_dist, *box)
        return box

    def _reorg_full(self, anchor_cell) -> None:
        """Flush + re-centre at ``anchor_cell`` + regather."""
        cfg = self.cfg
        self._map = mapping.resident_flush(self._map, cfg, self._res_org,
                                           self._res_occ, self._res_vis,
                                           self._res_dist)
        self._res_org = mapping.resident_org(cfg, anchor_cell)
        self._res_occ, self._res_vis, self._res_dist = \
            mapping.resident_gather(self._map, cfg, self._res_org)
        self._res_dirty = False   # pool and window are in sync now

    def _scroll(self, kp: int) -> None:
        """Band re-org towards the current pose, the target origin clamped
        to +-kp patches."""
        cfg = self.cfg
        length = cfg.geometry.patch_length
        target = mapping.resident_org(cfg,
                                      cfg.geometry.w2m(self._pose_dev[:2]))
        new_org = self._res_org + torch.clamp(target - self._res_org,
                                              -kp * length, kp * length)
        (self._map, self._res_occ, self._res_vis,
         self._res_dist) = mapping.resident_scroll(
            self._map, cfg, self._res_org, self._res_occ, self._res_vis,
            self._res_dist, new_org, kp)
        self._res_org = new_org
        # the pool's copies of interior window patches stay stale

    def _maybe_reorg(self, odometry: Pose2D) -> None:
        """Host-gated re-org once odometry has travelled the window's
        wander allowance minus slack since the last re-org."""
        if not self._host_reorg or self._odom_reorg is None:
            return
        d = float(np.linalg.norm((self._odom_reorg - odometry).xy()))
        if d < self._reorg_trigger_m:
            return
        self._harvest_escapes()
        patch_m = (self.cfg.geometry.patch_length
                   * self.cfg.geometry.resolution)
        if (self._scroll_kp
                and d + self.options.host_reorg_slack
                <= self._scroll_kp * patch_m):
            self._scroll(self._scroll_kp)
            self.n_scrolls += 1
        else:
            self._reorg_full(self.cfg.geometry.w2m(self._pose_dev[:2]))
        self._odom_reorg = odometry
        self.n_reorgs += 1

    def _harvest_escapes(self) -> None:
        """Escape guard, read at every re-org: if any update since the
        last check ran with its pose outside the resident safe zone,
        tighten the re-org trigger; once no safe trigger distance remains,
        fall back to a per-scan safe-zone check followed by a re-org."""
        esc = int(self._esc_dev)                 # cumulative counter
        if esc <= self._esc_seen:
            # 4 consecutive clean checks release one tightening step
            self._esc_clean += 1
            if self._esc_clean >= 4 and self._extra_slack > 0:
                self._esc_clean = 0
                self._extra_slack = max(
                    0.0, self._extra_slack
                    - max(self.options.host_reorg_slack, 0.25))
            return
        self._esc_seen = esc
        self._esc_clean = 0
        self._extra_slack += max(self.options.host_reorg_slack, 0.25)
        if self._reorg_trigger_m >= 0.5:
            warnings.warn(
                f"Slam2D host-gated re-org: {esc} update(s) escaped the "
                f"resident safe zone (clipped writes); tightening re-org "
                f"trigger to {self._reorg_trigger_m:.2f} m")
        else:
            warnings.warn(
                f"Slam2D host-gated re-org: {esc} escaped update(s) and no "
                "safe trigger distance left; falling back to the per-scan "
                "safe-zone check")
            self._host_reorg = False

    def _do_step(self, od, points, mask, origin) -> None:
        """Predict, match, map update: ``nopool_step`` of the JAX package
        on the resident path (fallback only: re-org if unsafe), its
        ``_make_step`` on the pool path."""
        pose0 = lie.se2_compose(self._pose_dev, od)
        step = self._resident_step if self._resident else self._pool_step
        pose = step(pose0, points, mask, origin)
        k = min(self._n_updates, self.TRAJ_CAP - 1)
        self._traj[k] = pose
        self._pose_dev = pose
        self._pose_host = None
        self._n_updates += 1

    def _pool_step(self, pose0, points, mask, origin):
        cfg, geo = self.cfg, self.cfg.geometry
        wp = cfg.window_patches
        org = win_mod.window_org(geo, geo.w2m(pose0[:2]), wp)
        keys = win_mod.window_patch_keys(geo, org, wp)
        grid, slots = win_mod.gather_window(self._map.table, self._map.dist,
                                            keys, cfg.distance.max_dist)
        res = match.solve_window(cfg.dist_to_sq(grid), org, geo,
                                 cfg.distance.max_dist, points[:, :2], mask,
                                 pose0, self.sopts)
        self._map, _ = mapping.update_maps(self._map, cfg, res.state, points,
                                           mask, origin, org,
                                           window=(slots, grid))
        self.last_iterations = res.iterations
        return res.state

    def _resident_step(self, pose0, points, mask, origin):
        cfg, geo = self.cfg, self.cfg.geometry
        w_res = cfg.resident_window_cells
        ws_m = cfg.match_window_cells
        p0cell = geo.w2m(pose0[:2])
        safe = mapping.resident_safe(cfg, self._res_org, p0cell)
        if self._host_reorg:
            self._esc_dev += (~safe).to(torch.int32)
        elif not bool(safe):
            self._reorg_full(p0cell)
            self.n_reorgs += 1
        org, dist = self._res_org, self._res_dist
        dist_m, m_org = dist, org
        if ws_m < w_res:
            start = torch.clamp(p0cell - org - ws_m // 2, 0, w_res - ws_m)
            dist_m = mapping.dyn_slice(dist, start[1], start[0], ws_m, ws_m)
            m_org = org + start
        res = match.solve_window(dist_m, m_org, geo, cfg.distance.max_dist,
                                 points[:, :2], mask, pose0, self.sopts)
        mapping.resident_update(cfg, org, self._res_occ, self._res_vis,
                                dist, res.state, points, mask, origin)
        if cfg.transient:
            box = self._transient_reset(res.state, points, mask, origin)
            self._map = mapping.prune_transient_pool(self._map, cfg, *box)
        self._res_dirty = True
        self.last_iterations = res.iterations
        return res.state

    # -- map state across processes ----------------------------------------
    def state_dict(self) -> dict:
        """The map, pose and driver bookkeeping as numpy arrays (see
        :mod:`..utils.state`)."""
        from ..utils import state
        return state.slam_to_numpy(self)

    def load_state_dict(self, d: dict) -> None:
        from ..utils import state
        state.slam_from_numpy(self, d)
