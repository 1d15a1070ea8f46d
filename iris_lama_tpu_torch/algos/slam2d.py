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

The scan match takes ``match_route``, set once from the device and the
options: on the card, GN with the Cauchy (or a unit) cost on the integer
squared-distance window is one launch of kernel B4 (``"solve"``: the whole
IRLS loop, no host read of its stop flag); LM, another robust cost, a
float window and every CPU run take the generic IRLS (``"generic"``).

``resident_window=False`` takes the pool-per-scan path instead (the JAX
package's ``_make_step``): each scan gathers an f32 distance window from
the pool, matches on its squared-distance form and applies the scan with
``mapping.update_maps``.

``use_compression`` (not with ``transient_map``) bounds the device pool
with the host spill tier (``sdm/spill.py``) and runs the pool-per-scan
path: before each accepted update the driver refills the stored patches
the window could touch and, when a host-side upper bound on the pool's
patch count passes high water, reads the count and spills far patches.
``create_summary`` probes every accepted update into :attr:`summary`
(wall time and :meth:`memory_usage`, after a device synchronisation);
``detailed_summary`` also times solving and mapping apart on the resident
path, synchronising at each phase boundary. Neither adds a wait when off.

The driver runs on the CUDA device unless constructed with
``device="cpu"``; the pose, trajectory and map stay on the device and the
host reads them only on request (and the generic IRLS's stop flag, the
escape counter and re-org origins at their checkpoints), each through
``utils.trace.host_read``. The update's layers are spanned (``lama.update``,
``lama.stage``, ``lama.match``, ``lama.map_update``, ``lama.reorg.*``; see
``utils/trace.py``) for a profiler that records.
"""

from __future__ import annotations

import dataclasses
import time
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
from ..utils.summary import PhaseClock, Summary, device_sync
from ..utils.trace import host_read, phase, span


@dataclasses.dataclass(frozen=True)
class Slam2DOptions:
    """reference: Slam2D::Options (slam2d.h:91-125) + sizing knobs.

    ``use_compression`` turns the host spill tier on (``cache_size`` is
    kept for parity with the reference; ``calgorithm`` names the codec:
    ``"lz4"`` or ``"zstd"``); ``create_summary`` and ``detailed_summary``
    fill :attr:`Slam2D.summary` (see the module docstring).
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
    cache_size: int = 100
    calgorithm: str = "lz4"
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

    TRAJ_CAP = 16384   # device-side trajectory ring: update k at row k % cap

    def __init__(self, options: Slam2DOptions = Slam2DOptions(),
                 device=None):
        self.device = resolve_device(device)
        self.options = options
        self.cfg = options.mapping_config()
        self.sopts = options.solver_options()
        # B4 on the card wherever it serves (see the module docstring), as
        # the JAX package takes its whole-solve kernel on the accelerator
        self.match_route = (
            "solve" if self.device.type == "cuda" and match.route_serves(
                "solve", self.sopts, self.cfg.sq_dtype) else "generic")
        self._map = mapping.slam_map_init(self.cfg, self.device)
        self.odom_ = Pose2D()
        self.has_first_scan = False
        self.summary: Optional[Summary] = (
            Summary() if options.create_summary else None)
        self._max_beams = options.max_beams
        self._built = False
        # the spill tier needs the pool per scan: no resident window
        self._resident = (options.resident_window
                          and not options.use_compression)
        self._res_org = None
        self._res_occ = self._res_vis = self._res_dist = None
        self._res_dirty = False
        self._scroll_kp = 0
        self._pose_dev = self._tensor(Pose2D().se2_array())
        self._pose_host: Optional[Pose2D] = Pose2D()
        self._pose_se2: Optional[np.ndarray] = None   # as read, f32 [4]
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
        # host spill tier (use_compression: the reference's LRU
        # compress-on-evict)
        self._spill = None
        if options.use_compression and not options.transient_map:
            from ..sdm.spill import HostSpillStore
            self._spill = HostSpillStore(self.cfg, self.cfg.geometry,
                                         codec=options.calgorithm)
            self._sync_pose: Optional[Pose2D] = None   # pose at last sync
            self._sync_odom: Optional[Pose2D] = None   # odometry then
            self._potential: set = set()   # window keys ever approached
            self._check_at = int(0.85 * options.capacity)

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
        self._pose_se2 = None

    def pose(self) -> Pose2D:
        """Current pose (reads the device pose when stale)."""
        if self._pose_host is None:
            self._pose_host = Pose2D.from_se2_array(self.pose_se2())
        return self._pose_host

    def pose_se2(self) -> np.ndarray:
        """Current pose as Slam2D holds it: f32 (tx, ty, cos, sin),
        read from the device when stale (the read :meth:`pose` makes)."""
        if self._pose_se2 is None:
            self._pose_se2 = host_read(self._pose_dev, "pose", numpy=True)
        return self._pose_se2

    def resident_window(self):
        """(origin cell [2], squared-distance window [w, w]) of the
        resident window as it stands, the tensors themselves; None off the
        resident path or before the first scan."""
        if self._res_dist is None:
            return None
        return self._res_org, self._res_dist

    def trajectory(self) -> np.ndarray:
        """All matched poses so far, [n, 3] xyr — one device read."""
        n = self._n_updates
        t = host_read(self._traj[:min(n, self.TRAJ_CAP)], "trajectory",
                      numpy=True)
        if n > self.TRAJ_CAP:                  # the ring's oldest row first
            t = np.roll(t, -(n % self.TRAJ_CAP), axis=0)
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
        return int(host_read(self._esc_dev, "escapes"))

    def update(self, cloud: PointCloudXYZ, odometry: Pose2D,
               timestamp: float = 0.0) -> bool:
        """slam2d.cpp:143-198."""
        with span("lama.update"):
            with span("lama.stage"):
                if self._max_beams == 0:
                    self._max_beams = beam_bucket(len(cloud.points))
                points, mask, origin = pad_scan(cloud, self._max_beams)
                staged = (self._tensor(points),
                          self._tensor(mask, torch.bool),
                          self._tensor(origin))
            return self._update(*staged, odometry, timestamp)

    def update_prepadded(self, points, mask, origin, odometry: Pose2D,
                         timestamp: float = 0.0) -> bool:
        """Update from a pre-padded scan: points f32[B, 3], mask bool[B],
        origin f32[3] (tensors on the driver's device, or arrays)."""
        with span("lama.update"):
            return self._update(points, mask, origin, odometry, timestamp)

    def _update(self, points, mask, origin, odometry: Pose2D,
                timestamp: float) -> bool:
        t0 = time.perf_counter()
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
            if self.summary is not None:
                dt = self._elapsed(t0)
                self.summary.probe(timestamp, dt, mapping=dt,
                                   memory=self.memory_usage())
            return True
        odelta = self.odom_ - odometry
        if self._below_gate(odelta):
            return False
        if self._spill is not None:
            self._spill_hooks(odometry)     # refill the window, spill far
        self._maybe_reorg(odometry)
        self.odom_ = odometry
        clock = None
        if (self.summary is not None and self.options.detailed_summary
                and self._resident):
            clock = PhaseClock(self.device)
        self._do_step(self._tensor(odelta.se2_array()), points, mask, origin,
                      clock)
        if self.summary is not None:
            dt = self._elapsed(t0)
            phases = (clock.phases if clock is not None
                      else {"solving": dt, "mapping": dt})
            self.summary.probe(timestamp, dt, **phases,
                               memory=self.memory_usage())
        return True

    def _elapsed(self, t0: float) -> float:
        """Seconds since ``t0`` once the device has finished."""
        device_sync(self.device)
        return time.perf_counter() - t0

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
            with span("lama.map_update"):
                mapping.resident_update(cfg, self._res_org, self._res_occ,
                                        self._res_vis, self._res_dist,
                                        self._pose_dev, points, mask, origin)
                if cfg.transient:
                    self._transient_reset(self._pose_dev, points, mask,
                                          origin)
            self._res_dirty = True
        else:
            with span("lama.map_update"):
                self._map, _ = mapping.update_maps(self._map, cfg,
                                                   self._pose_dev, points,
                                                   mask, origin)
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
            with span("lama.reorg.scroll"):
                self._scroll(self._scroll_kp)
            self.n_scrolls += 1
        else:
            with span("lama.reorg.full"):
                self._reorg_full(self.cfg.geometry.w2m(self._pose_dev[:2]))
        self._odom_reorg = odometry
        self.n_reorgs += 1

    def _harvest_escapes(self) -> None:
        """Escape guard, read at every re-org: if any update since the
        last check ran with its pose outside the resident safe zone,
        tighten the re-org trigger; once no safe trigger distance remains,
        fall back to a per-scan safe-zone check followed by a re-org."""
        esc = int(host_read(self._esc_dev, "escapes"))   # cumulative
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

    def _do_step(self, od, points, mask, origin, clock=None) -> None:
        """Predict, match, map update: ``nopool_step`` of the JAX package
        on the resident path (fallback only: re-org if unsafe), its
        ``_make_step`` on the pool path. ``clock`` (resident path) times
        solving and mapping apart."""
        pose0 = lie.se2_compose(self._pose_dev, od)
        if self._resident:
            pose = self._resident_step(pose0, points, mask, origin, clock)
        else:
            pose = self._pool_step(pose0, points, mask, origin)
        self._traj[self._n_updates % self.TRAJ_CAP] = pose
        self._pose_dev = pose
        self._pose_host = self._pose_se2 = None
        self._n_updates += 1

    def _pool_step(self, pose0, points, mask, origin):
        cfg, geo = self.cfg, self.cfg.geometry
        wp = cfg.window_patches
        org = win_mod.window_org(geo, geo.w2m(pose0[:2]), wp)
        keys = win_mod.window_patch_keys(geo, org, wp)
        grid, slots = win_mod.gather_window(self._map.table, self._map.dist,
                                            keys, cfg.distance.max_dist)
        with span("lama.match"):
            res = self._match(cfg.dist_to_sq(grid), org, points, mask, pose0)
        with span("lama.map_update"):
            self._map, _ = mapping.update_maps(self._map, cfg, res.state,
                                               points, mask, origin, org,
                                               window=(slots, grid))
        self.last_iterations = res.iterations
        return res.state

    def _match(self, window, org, points, mask, pose0):
        """The front end's scan match on a squared-distance window whose
        cell (0, 0) is ``org``, from the predicted pose ``pose0``."""
        cfg = self.cfg
        return match.solve_window(window, org, cfg.geometry,
                                  cfg.distance.max_dist, points[:, :2], mask,
                                  pose0, self.sopts, route=self.match_route)

    def _resident_step(self, pose0, points, mask, origin, clock=None):
        cfg, geo = self.cfg, self.cfg.geometry
        w_res = cfg.resident_window_cells
        ws_m = cfg.match_window_cells
        p0cell = geo.w2m(pose0[:2])
        safe = mapping.resident_safe(cfg, self._res_org, p0cell)
        if self._host_reorg:
            self._esc_dev += (~safe).to(torch.int32)
        elif not host_read(safe, "safe_zone"):
            with span("lama.reorg.full"):
                self._reorg_full(p0cell)
            self.n_reorgs += 1
        org, dist = self._res_org, self._res_dist
        dist_m, m_org = dist, org
        if ws_m < w_res:
            start = torch.clamp(p0cell - org - ws_m // 2, 0, w_res - ws_m)
            dist_m = mapping.dyn_slice(dist, start[1], start[0], ws_m, ws_m)
            m_org = org + start
        with phase("lama.match", clock, "solving"):
            res = self._match(dist_m, m_org, points, mask, pose0)
        with phase("lama.map_update", clock, "mapping"):
            mapping.resident_update(cfg, org, self._res_occ, self._res_vis,
                                    dist, res.state, points, mask, origin)
            if cfg.transient:
                box = self._transient_reset(res.state, points, mask, origin)
                self._map = mapping.prune_transient_pool(self._map, cfg,
                                                         *box)
        self._res_dirty = True
        self.last_iterations = res.iterations
        return res.state

    # -- map export and memory ----------------------------------------------
    def full_map(self) -> mapping.SlamMapState:
        """The complete map for IO and export: with patches in the spill
        tier's store, the pool and the store merged into a fresh pool (same
        geometry, a capacity that may exceed ``options.capacity``)."""
        if self._spill is None or not self._spill.store:
            return self.map
        merged, _ = self._spill.merged_map(self.map)
        return merged

    def memory_usage(self) -> int:
        """Bytes of map (Map::memory, src/sdm/map.cpp:115-137): the
        allocated pool patches in the port's cell dtypes, the resident
        grids when present and the spill tier's compressed store. Reads the
        pool's patch count without flushing the resident grids."""
        m = self._map
        cell = sum(a.element_size() for a in (m.occupied, m.visited, m.dist))
        total = (int(host_read(m.table.num_patches(), "memory"))
                 * self.cfg.geometry.patch_length ** 2 * cell)
        if self._resident and self._res_dist is not None:
            total += sum(g.numel() * g.element_size() for g in
                         (self._res_occ, self._res_vis, self._res_dist))
        if self._spill is not None:
            total += self._spill.memory_usage()
        return total

    # -- host spill tier ----------------------------------------------------
    def _approx_pose(self, odometry: Pose2D) -> np.ndarray:
        """Predicted map-frame xy without a device read: the pose at the
        last sync composed with the odometry increment since. Called before
        ``odom_`` advances (the synced pose belongs to the previous
        odometry); the refill margin covers the drift between syncs."""
        if self._sync_pose is None:
            self._sync_now()
        est = self._sync_pose + (self._sync_odom - odometry)
        return np.asarray(est.xy())

    def _sync_now(self) -> None:
        """Pair the current device pose with its odometry (one read)."""
        self._pose_host = Pose2D.from_se2_array(
            host_read(self._pose_dev, "spill", numpy=True))
        self._sync_pose = self._pose_host
        self._sync_odom = self.odom_

    def _spill_hooks(self, odometry: Pose2D) -> None:
        """Refill the upcoming window; spill when the pool nears capacity.

        The pool-pressure check runs off a host-side upper bound (window
        keys ever approached minus keys in the store), so the steady state
        makes no device read."""
        sp = self._spill
        xy = self._approx_pose(odometry)
        if sp.store:
            self._map = sp.refill(self._map, xy)
        self._potential.update(int(k) for k in sp.window_keys_np(xy))
        if len(self._potential) - len(sp.store) > self._check_at:
            self._sync_now()
            xy = self._approx_pose(odometry)
            n_active = int(host_read(self._map.table.num_patches(), "spill"))
            if n_active > sp.high:
                self._map = sp.spill(self._map, xy)
                n_active = int(host_read(self._map.table.num_patches(),
                                         "spill"))
            # next check once the upper bound has grown past high water
            # again (at least 8 keys on: each check costs device reads)
            self._check_at = (len(self._potential) - len(sp.store)
                              + max(sp.high - n_active, 8))

    # -- map state across processes ----------------------------------------
    def state_dict(self) -> dict:
        """The map, pose and driver bookkeeping as numpy arrays (see
        :mod:`..utils.state`)."""
        from ..utils import state
        return state.slam_to_numpy(self)

    def load_state_dict(self, d: dict) -> None:
        from ..utils import state
        state.slam_from_numpy(self, d)
