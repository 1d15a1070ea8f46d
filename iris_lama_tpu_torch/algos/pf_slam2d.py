"""Rao-Blackwellized particle-filter SLAM (the reference's PFSlam2D).

reference: include/lama/pf_slam2d.h, src/pf_slam2d.cpp. Every particle owns
a map. Per odometry packet every particle draws motion noise
(drawFromMotion, :365-391); per accepted scan every particle is scan-matched
on its own squared-distance window — all particles in one launch of kernel
B6 (``ops/gn_batch.py``), which also returns the likelihood's residual SSE
(:393-437) — then the weights are normalised with Neff (:511-535),
systematically resampled when Neff < N/2 (:537-574), and the scan is
rasterised into every particle's resident grids (:439-509).

The particle axis is a leading [N] dimension on every tensor. A particle's
patch pool is exchanged with its resident grids only at re-orgs, which the
host triggers from odometry travel (a full flush + regather, or a band
scroll); each step counts the particles outside the resident safe zone, the
count is read at every re-org, and the trigger tightens on bursts of
escapes, down to a per-update safe-zone check. A resample gathers the
resident grids at once and composes a deferred ``lineage`` for the pools,
which the next re-org settles (the pools stay as they are between re-orgs).

Random numbers: one normal draw ``eps [N, 3]`` per odometry packet and one
uniform ``u`` per accepted update, in the order of the JAX package's key
stream. They come from a ``torch.Generator`` on the CPU seeded by
``options.seed`` and are moved to the device, so a CPU run and a card run of
one seed see the same numbers; a caller may pass its own draw source.

``resident_window=False`` takes the pool-per-update path instead (the
JAX package's ``pf_update_step`` without resident grids): every particle
owns its pool ``[N, P+1, L, L]``, gathered by the resample indices; every
particle is scan-matched on the squared-distance form of a window
gathered from its pool (one B6 launch for all, the same solve and
likelihood as the resident path's, so both paths give the same particles),
and the scan goes into every pool through ``mapping.update_maps``, one
particle after the other.

``use_compression`` (resident path) bounds every particle's pool with the
host spill tier (``sdm/spill.py:PFSpillStore``): before each accepted
update the driver refills the stored patches the resident window could
touch and spills far patches when a host-side upper bound passes high
water. The stores follow the resamples through ``spill_lineage``, which
the re-orgs leave alone; the driver applies it to the stores and resets it
right before it settles the pools. Band scrolls are off under the tier.
``create_summary`` probes every accepted update into :attr:`summary`;
``detailed_summary`` times solving, normalizing, resampling and mapping
apart on the resident path, synchronising at each phase boundary.

The driver runs on the CUDA device unless constructed with
``device="cpu"``; re-orgs and the pool path's map updates loop over the
particles in Python.
"""

from __future__ import annotations

import dataclasses
import time
import warnings
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from ..core import lie
from ..core.pose import Pose2D
from ..nlls.robust import CAUCHY_SCAN
from ..nlls.solver import SolverOptions
from ..ops import gn_batch
from ..sdm import mapping
from ..sdm import window as win_mod
from ..sdm.geometry import MapGeometry, f32
from ..sdm.pool import PatchTable
from ..utils.cloud import PointCloudXYZ, beam_bucket, pad_scan
from ..utils.summary import PhaseClock, Summary, device_sync
from .slam2d import resolve_device

@dataclasses.dataclass(frozen=True)
class PFSlam2DOptions:
    """reference: PFSlam2D::Options (pf_slam2d.h:132-185) + sizing knobs.

    ``use_compression`` turns the per-particle spill tier on (resident
    path; ``cache_size`` is kept for parity, ``calgorithm`` names the
    codec); ``create_summary`` and ``detailed_summary`` fill
    :attr:`PFSlam2D.summary`. A ``reorg_chunk`` other than -1 is not
    ported: :class:`PFSlam2D` raises NotImplementedError for it.
    """

    particles: int = 30
    srr: float = 0.1
    str_: float = 0.2
    stt: float = 0.1
    srt: float = 0.2
    meas_sigma: float = 0.05
    meas_sigma_gain: float = 3.0
    trans_thresh: float = 0.5
    rot_thresh: float = 0.5
    l2_max: float = 0.5
    truncated_ray: float = 0.0
    truncated_range: float = 0.0
    resolution: float = 0.05
    patch_size: int = 32
    max_iter: int = 100
    strategy: str = "gn"
    seed: int = 0               # 0 = seed from the clock
    create_summary: bool = False
    detailed_summary: bool = False
    use_compression: bool = False
    cache_size: int = 100
    calgorithm: str = "lz4"
    max_range: float = 10.0
    max_beams: int = 0          # 0 = bucket from the first scan
    capacity: int = 2048        # patch-pool capacity per particle
    pose_slack: float = 0.5
    resident_window: bool = True
    resident_extra_patches: int = 8
    # host-gated re-orgs: the driver triggers flush + regather (or a band
    # scroll) from odometry travel between updates
    host_reorg: bool = True
    host_reorg_slack: float = 1.5   # odometry drift + particle spread (m)
    # the JAX package's re-org group size (-1 = auto), sized to TPU memory;
    # the port re-orgs one particle at a time and takes only -1
    reorg_chunk: int = -1
    scroll_reorg: bool = True
    scroll_kp: int = 0          # 0 = size the band from the allowance

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
            resident_extra_patches=self.resident_extra_patches,
        )

    def solver_options(self) -> SolverOptions:
        # scanMatch hardwires GN + Cauchy(0.15) (pf_slam2d.cpp:421-426)
        return SolverOptions(max_iterations=self.max_iter, strategy="gn",
                             robust=CAUCHY_SCAN)


class ParticleSet(NamedTuple):
    """All particle state; every tensor has a leading [N] except
    ``res_org``, the resident-window origin the particles share. The pool
    path (``resident_window=False``) has no resident fields (None)."""

    pose: torch.Tensor          # f32 [N, 4] SE(2)
    weight: torch.Tensor        # f32 [N]
    weight_sum: torch.Tensor    # f32 [N]
    normalized: torch.Tensor    # f32 [N]
    maps: mapping.SlamMapState  # pools, tensors [N, ...]
    res_org: Optional[torch.Tensor] = None    # i32 [2]
    res_occ: Optional[torch.Tensor] = None    # i32 [N, W, W] (uint16 values)
    res_vis: Optional[torch.Tensor] = None    # i32 [N, W, W]
    # sq dtype [N, W, W] capped squared distance
    res_dist: Optional[torch.Tensor] = None
    # deferred lineage: particle i's pool is pool ``lineage[i]`` until the
    # next re-org settles it; i32 [N]
    lineage: Optional[torch.Tensor] = None
    # the spill tier's lineage: particle i's host store is store
    # ``spill_lineage[i]``; re-orgs keep it, the driver resets it when it
    # permutes the stores (use_compression only); i32 [N]
    spill_lineage: Optional[torch.Tensor] = None


def particles_init(opts: PFSlam2DOptions, prior_se2,
                   device=None) -> ParticleSet:
    n = opts.particles
    cfg = opts.mapping_config()
    one = mapping.slam_map_init(cfg, device)

    def rep(t):
        return t.unsqueeze(0).repeat((n,) + (1,) * t.dim())

    maps = mapping.SlamMapState(PatchTable(*(rep(t) for t in one.table)),
                                rep(one.occupied), rep(one.visited),
                                rep(one.dist))
    prior = torch.as_tensor(np.asarray(prior_se2), dtype=torch.float32,
                            device=device)
    pset = ParticleSet(
        pose=prior.expand(n, 4).clone(),
        weight=torch.zeros(n, device=device),
        weight_sum=torch.zeros(n, device=device),
        normalized=torch.full((n,), 1.0 / n, device=device),
        maps=maps)
    if not opts.resident_window:
        return pset
    w = cfg.resident_window_cells
    occ = torch.zeros((n, w, w), dtype=mapping.COUNT_DTYPE, device=device)
    if opts.use_compression:
        pset = pset._replace(spill_lineage=torch.arange(
            n, dtype=torch.int32, device=device))
    return pset._replace(
        res_org=mapping.resident_org(cfg, cfg.geometry.w2m(prior[:2])),
        res_occ=occ,
        res_vis=torch.zeros_like(occ),
        res_dist=torch.full((n, w, w), cfg.distance.max_sqdist,
                            dtype=cfg.sq_dtype, device=device),
        lineage=torch.arange(n, dtype=torch.int32, device=device),
    )


# ---------------------------------------------------------------------------
# Device functions
# ---------------------------------------------------------------------------

def draw_from_motion(opts: PFSlam2DOptions, eps, odelta, poses):
    """Per-particle motion noise (pf_slam2d.cpp:365-391): ``eps`` f32
    [N, 3] standard normal draws, ``odelta`` the odometry increment f32
    SE(2) [4], ``poses`` [N, 4]."""
    dx, dy = odelta[0], odelta[1]
    drot = torch.atan2(odelta[3], odelta[2])
    stt, str_ = f32(opts.stt), f32(opts.str_)
    srr, srt = f32(opts.srr), f32(opts.srt)
    sxy = f32(0.3 * opts.stt)
    sig_x = stt * torch.abs(dx) + str_ * torch.abs(drot) + sxy * torch.abs(dy)
    sig_y = stt * torch.abs(dy) + str_ * torch.abs(drot) + sxy * torch.abs(dx)
    sig_r = srr * torch.abs(drot) + srt * torch.sqrt(dx * dx + dy * dy)
    x = dx + eps[:, 0] * sig_x
    y = dy + eps[:, 1] * sig_y
    yaw = drot + eps[:, 2] * sig_r
    two_pi = f32(2 * np.pi)
    yaw = torch.remainder(yaw, two_pi)
    yaw = torch.where(yaw > f32(np.pi), yaw - two_pi, yaw)
    return lie.se2_compose(poses, lie.se2(x, y, yaw, device=poses.device))


def weights_and_resample(opts: PFSlam2DOptions, weight, weight_sum, states,
                         liks, u):
    """Normalise + Neff + systematic resampling (pf_slam2d.cpp:511-574)
    with the uniform draw ``u``. Returns (idx, pose, weight, weight_sum,
    normalized, neff, do_resample); ``idx`` is the identity when no
    resample fires."""
    n = opts.particles
    weight = weight + liks
    weight_sum = weight_sum + liks
    gain = f32(1.0 / (opts.meas_sigma_gain * n))
    nw = torch.exp(gain * (weight - torch.max(weight)))
    nw = nw / torch.sum(nw)
    neff = 1.0 / torch.sum(nw * nw)
    do_resample = neff < n * 0.5
    ar = torch.arange(n, device=weight.device)
    targets = (ar.to(torch.float32) + u) * f32(1.0 / n)
    cumw = torch.cumsum(nw, 0)
    res_idx = torch.searchsorted(cumw, targets, right=True).clamp(0, n - 1)
    idx = torch.where(do_resample, res_idx, ar)
    pose = states[idx]
    weight = torch.where(do_resample, torch.zeros_like(weight), weight[idx])
    return idx, pose, weight, weight_sum[idx], nw, neff, do_resample


def match_windows(opts: PFSlam2DOptions, org, dist, poses):
    """Every particle's scan-match sub-window: the clipped slice of its
    resident grid around its pose cell. Returns (grids [N, S, S], window
    origins i32 [N, 2])."""
    cfg = opts.mapping_config()
    w_res = cfg.resident_window_cells
    ws_m = cfg.match_window_cells
    if ws_m >= w_res:
        return dist, org.expand(dist.shape[0], 2).contiguous()
    lp = cfg.geometry.w2m(poses[:, :2]) - org                # [N, 2] [x, y]
    starts = torch.clamp(lp - ws_m // 2, 0, w_res - ws_m)
    grids = mapping.dyn_slice(dist, starts[:, 1], starts[:, 0], ws_m, ws_m)
    return grids, (org[None, :] + starts).to(torch.int32)


def pool_windows(opts: PFSlam2DOptions, maps: mapping.SlamMapState, poses):
    """Every particle's scan-match window gathered from its own pool (the
    pool-per-scan window at its pose, ``MappingConfig.window_patches``
    patches a side) in the squared-distance form B6 reads (exact: the pool
    holds ``sqrt(k) * res`` meters). Returns (grids [N, W, W], window
    origins i32 [N, 2])."""
    cfg = opts.mapping_config()
    geo, wp = cfg.geometry, cfg.window_patches
    orgs = win_mod.window_org(geo, geo.w2m(poses[:, :2]), wp)
    grids = []
    for i in range(poses.shape[0]):
        pool = _pool(maps, i)
        keys = win_mod.window_patch_keys(geo, orgs[i], wp)
        grid, _ = win_mod.gather_window(pool.table, pool.dist, keys,
                                        cfg.distance.max_dist)
        grids.append(cfg.dist_to_sq(grid))
    return torch.stack(grids), orgs


def match_phase(opts: PFSlam2DOptions, pset: ParticleSet, points, mask):
    """Scan match + likelihood of every particle, one B6 launch, on the
    resident grids' sub-windows or (the pool path) on windows gathered
    from the pools; both read the same distances at every cell the match
    reaches, so both give the same results. The likelihood is ``-SSE /
    meas_sigma`` of the masked residuals at the matched pose (the JAX
    package's CPU path sums ``-d^2 / meas_sigma`` per beam: the same value
    up to rounding). Returns (states [N, 4], liks [N], iterations int32
    [N])."""
    cfg = opts.mapping_config()
    geo, so = cfg.geometry, opts.solver_options()
    if pset.res_org is None:
        grids, orgs = pool_windows(opts, pset.maps, pset.pose)
    else:
        grids, orgs = match_windows(opts, pset.res_org, pset.res_dist,
                                    pset.pose)
    st, it, _, sse = gn_batch.solve_window_sq(
        grids, orgs, pset.pose.contiguous(), points[:, :2].contiguous(),
        mask, max_dist=cfg.distance.max_dist, res=geo.resolution,
        scale=geo.scale, cell_offset=geo.cell_offset,
        cauchy_c=so.robust.param, eps1=so.eps1, eps2=so.eps2,
        max_iter=so.max_iterations, want_lik=True)
    return st, -sse / f32(opts.meas_sigma), it


def update_step(opts: PFSlam2DOptions, pset: ParticleSet, u, points, mask,
                origin, clock=None):
    """One resident PF update on post-motion poses: match -> weights ->
    resample (lineages composed, resident grids gathered by ``idx``) -> map
    update of every particle. The resident grids are updated IN PLACE.
    The caller has checked the safe zone (or triggers re-orgs from
    odometry). ``clock`` (a ``utils.summary.PhaseClock``) times solving,
    normalizing, resampling and mapping apart. Returns (pset, info)."""
    cfg = opts.mapping_config()
    states, liks, iters = match_phase(opts, pset, points, mask)
    _mark(clock, "solving")
    idx, pose, weight, weight_sum, nw, neff, do_resample = \
        weights_and_resample(opts, pset.weight, pset.weight_sum, states,
                             liks, u)
    _mark(clock, "normalizing")
    occ, vis, dist = pset.res_occ, pset.res_vis, pset.res_dist
    for g in (occ, vis, dist):    # in place: one grid's temporary at a time
        g.copy_(g[idx])
    spill_lineage = (None if pset.spill_lineage is None
                     else pset.spill_lineage[idx])
    _mark(clock, "resampling")
    org = pset.res_org
    mapping.resident_update(cfg, org, occ, vis, dist, pose, points, mask,
                            origin)
    _mark(clock, "mapping")
    escaped = torch.sum(~mapping.resident_safe(
        cfg, org, cfg.geometry.w2m(pose[:, :2])))
    new = ParticleSet(pose, weight, weight_sum, nw, pset.maps, org, occ,
                      vis, dist, pset.lineage[idx], spill_lineage)
    info = {"neff": neff, "resampled": do_resample, "escaped": escaped,
            "overflow": torch.max(pset.maps.table.overflow),
            "match_iters_max": torch.max(iters),
            "match_iters_mean": torch.mean(iters.to(torch.float32))}
    return new, info


def _mark(clock, name: str) -> None:
    if clock is not None:
        clock.mark(name)


def pool_update_step(opts: PFSlam2DOptions, pset: ParticleSet, u, points,
                     mask, origin):
    """One PF update of the pool path on post-motion poses: match ->
    weights -> resample (every pool array gathered by ``idx`` in place,
    one temporary of one array at a time) -> ``mapping.update_maps`` into
    every particle's pool, one particle after the other. Returns (pset,
    info)."""
    cfg = opts.mapping_config()
    states, liks, iters = match_phase(opts, pset, points, mask)
    idx, pose, weight, weight_sum, nw, neff, do_resample = \
        weights_and_resample(opts, pset.weight, pset.weight_sum, states,
                             liks, u)
    maps = pset.maps
    for a in (*maps.table, maps.occupied, maps.visited, maps.dist):
        a.copy_(a[idx])
    for i in range(pose.shape[0]):
        m, _ = mapping.update_maps(_pool(maps, i), cfg, pose[i], points,
                                   mask, origin)
        _store_table(maps, i, m.table)
    new = ParticleSet(pose, weight, weight_sum, nw, maps)
    info = {"neff": neff, "resampled": do_resample,
            "overflow": torch.max(maps.table.overflow),
            "match_iters_max": torch.max(iters),
            "match_iters_mean": torch.mean(iters.to(torch.float32))}
    return new, info


def first_step(opts: PFSlam2DOptions, pset: ParticleSet, points, mask,
               origin) -> None:
    """First scan (pf_slam2d.cpp:185-228): every particle holds the same
    map, so particle 0's update is computed once and copied (the resident
    grids, or on the pool path the pools, are updated in place)."""
    cfg = opts.mapping_config()
    if pset.res_org is None:
        m, _ = mapping.update_maps(_pool(pset.maps, 0), cfg, pset.pose[0],
                                   points, mask, origin)
        _store_table(pset.maps, 0, m.table)
        grids = (*pset.maps.table, pset.maps.occupied, pset.maps.visited,
                 pset.maps.dist)
    else:
        mapping.resident_update(cfg, pset.res_org, pset.res_occ[:1],
                                pset.res_vis[:1], pset.res_dist[:1],
                                pset.pose[:1], points, mask, origin)
        grids = (pset.res_occ, pset.res_vis, pset.res_dist)
    for g in grids:
        g[1:] = g[:1]


def _pool(maps: mapping.SlamMapState, i: int) -> mapping.SlamMapState:
    """Particle ``i``'s pool as views (in-place writes land in ``maps``)."""
    return mapping.SlamMapState(PatchTable(*(t[i] for t in maps.table)),
                                maps.occupied[i], maps.visited[i],
                                maps.dist[i])


def _store_table(maps: mapping.SlamMapState, i: int, table) -> None:
    for dst, src in zip(maps.table, table):
        dst[i] = src


def settle(pset: ParticleSet) -> ParticleSet:
    """Realise the deferred pool lineage IN PLACE (each particle's pool
    becomes its own; one temporary of one pool array at a time) and reset
    it to the identity. ``spill_lineage`` is left as it is: only the
    driver resets it, when it permutes the host stores."""
    for a in (*pset.maps.table, pset.maps.occupied, pset.maps.visited,
              pset.maps.dist):
        a.copy_(a[pset.lineage.long()])
    return pset._replace(lineage=torch.arange(
        pset.lineage.shape[0], dtype=torch.int32, device=pset.pose.device))


def _mean_anchor(cfg: mapping.MappingConfig, poses):
    cells = cfg.geometry.w2m(poses[:, :2]).to(torch.float32)
    return torch.mean(cells, dim=0).to(torch.int32)


def reorg(opts: PFSlam2DOptions, pset: ParticleSet) -> ParticleSet:
    """Full re-org: settle the lineage, flush every particle's grids into
    its pool, re-centre on the mean particle cell, regather (the grids are
    rewritten in place)."""
    cfg = opts.mapping_config()
    pset = settle(pset)
    new_org = mapping.resident_org(cfg, _mean_anchor(cfg, pset.pose))
    for i in range(pset.pose.shape[0]):
        m = mapping.resident_flush(_pool(pset.maps, i), cfg, pset.res_org,
                                   pset.res_occ[i], pset.res_vis[i],
                                   pset.res_dist[i])
        _store_table(pset.maps, i, m.table)
        for g, v in zip((pset.res_occ, pset.res_vis, pset.res_dist),
                        mapping.resident_gather(m, cfg, new_org)):
            g[i] = v
    return pset._replace(res_org=new_org)


def scroll(opts: PFSlam2DOptions, pset: ParticleSet, kp: int) -> ParticleSet:
    """Band re-org: settle the lineage, then move every particle's window
    towards the mean particle cell, the target origin clamped to +-kp
    patches; the shift is read to the host once for all particles."""
    cfg = opts.mapping_config()
    pset = settle(pset)
    length = cfg.geometry.patch_length
    target = mapping.resident_org(cfg, _mean_anchor(cfg, pset.pose))
    new_org = pset.res_org + torch.clamp(target - pset.res_org,
                                         -kp * length, kp * length)
    org_h, new_h = pset.res_org.tolist(), new_org.tolist()
    for i in range(pset.pose.shape[0]):
        m, *grids = mapping.resident_scroll(
            _pool(pset.maps, i), cfg, org_h, pset.res_occ[i],
            pset.res_vis[i], pset.res_dist[i], new_h, kp)
        _store_table(pset.maps, i, m.table)
        for g, v in zip((pset.res_occ, pset.res_vis, pset.res_dist), grids):
            g[i] = v
    return pset._replace(res_org=new_org)


# ---------------------------------------------------------------------------
# Host driver
# ---------------------------------------------------------------------------

DrawSource = Callable[[str, tuple], object]


class PFSlam2D:
    """Host driver; mirrors the reference public API (pf_slam2d.h:188-254).

    ``draws``: optional source of the random numbers, called as
    ``draws("normal", (N, 3))`` once per odometry packet and
    ``draws("uniform", ())`` once per accepted update; it returns an array
    or tensor of float32. By default a CPU ``torch.Generator`` seeded by
    ``options.seed`` serves both.
    """

    def __init__(self, options: PFSlam2DOptions = PFSlam2DOptions(),
                 device=None, draws: Optional[DrawSource] = None):
        if options.reorg_chunk != -1:
            raise NotImplementedError("PFSlam2DOptions.reorg_chunk is not "
                                      "ported (re-orgs go one particle at "
                                      "a time)")
        self.device = resolve_device(device)
        self.options = options
        seed = options.seed if options.seed != 0 else int(
            time.time_ns() % (2 ** 31))
        self._gen = torch.Generator().manual_seed(seed)
        self._draws = draws       # None: the generator (no bound method
        # stored on self, so a dropped filter frees its device memory at
        # once rather than at the next cycle collection)
        self.pose_prior = Pose2D()
        self.odom_ = Pose2D()
        self._odom_motion = Pose2D()   # the odometry the poses are at
        self.has_first_scan = False
        self.acc_trans = 0.0
        self.acc_rot = 0.0
        self.pset: Optional[ParticleSet] = None
        self.summary: Optional[Summary] = (
            Summary() if options.create_summary else None)
        self._max_beams = options.max_beams
        self._odelta_queue = []   # motion packets not applied yet
        self._last_info_dev = {}
        self._esc_max = None      # most particles escaped by one update
        self._esc_total = None    # particle-updates escaped in all
        self.n_reorgs = 0         # re-orgs (full + scroll)
        self.n_scrolls = 0        # of which band scrolls
        # host-gated re-orgs: trigger distance from the window's wander
        # allowance; with no safe trigger, the per-update safe-zone check
        self._odom_reorg: Optional[Pose2D] = None
        self._pf_trigger_m = 0.0
        self._pf_trigger0 = 0.0
        self._pf_scroll_m = 0.0   # scroll trigger (0 = no scrolls)
        self._esc_seen = 0        # escape events observed
        self._esc_clean = 0       # consecutive escape-free re-orgs
        self._esc_strikes = 0     # consecutive bursty re-orgs
        if options.host_reorg and options.resident_window:
            cfg = options.mapping_config()
            cells = (cfg.resident_window_cells // 2
                     - cfg.resident_margin_cells - cfg.geometry.patch_length)
            self._pf_trigger_m = (cells * cfg.geometry.resolution
                                  - options.host_reorg_slack)
            self._pf_trigger0 = self._pf_trigger_m
            if self._pf_trigger_m < 0.5:
                self.options = options = dataclasses.replace(
                    options, host_reorg=False)
            elif options.scroll_reorg and not options.use_compression:
                # scrolls fire at the same deadline as full re-orgs; the
                # band must cover the allowance shift plus slack (the spill
                # tier takes full re-orgs only)
                patch_m = cfg.geometry.patch_length * cfg.geometry.resolution
                kp_need = int(np.ceil((self._pf_trigger_m
                                       + options.host_reorg_slack)
                                      / patch_m)) + 1
                wp = cfg.resident_window_patches
                if options.scroll_kp == 0 and kp_need < wp // 2:
                    self.options = options = dataclasses.replace(
                        options, scroll_kp=kp_need)
                if 0 < options.scroll_kp < wp // 2:
                    self._pf_scroll_m = self._pf_trigger_m
        # per-particle spill tier (use_compression: the reference wires the
        # compressor into every particle's maps, src/pf_slam2d.cpp:201-204)
        self._pf_spill = None
        if options.use_compression and options.resident_window:
            from ..sdm.spill import PFSpillStore
            cfg = options.mapping_config()
            self._pf_spill = PFSpillStore(cfg, cfg.geometry,
                                          options.particles,
                                          codec=options.calgorithm)
            self._sync_pose: Optional[Pose2D] = None
            self._sync_odom: Optional[Pose2D] = None
            self._potential: set = set()
            self._check_at = int(0.85 * options.capacity)

    def _generator_draw(self, kind: str, shape: tuple):
        if kind == "normal":
            return torch.randn(shape, generator=self._gen)
        return torch.rand(shape, generator=self._gen)

    def _draw(self, kind: str, shape: tuple):
        src = self._draws or self._generator_draw
        return torch.tensor(np.asarray(src(kind, shape)),
                            dtype=torch.float32, device=self.device)

    def _tensor(self, a, dtype=torch.float32):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=self.device)

    # -- reference API ------------------------------------------------------
    def set_prior(self, prior: Pose2D) -> None:
        self.pose_prior = prior

    def update(self, cloud: PointCloudXYZ, odometry: Pose2D,
               timestamp: float = 0.0) -> bool:
        """pf_slam2d.cpp:178-311."""
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
        t0 = time.perf_counter()
        points = torch.as_tensor(points, dtype=torch.float32,
                                 device=self.device)
        mask = torch.as_tensor(mask, dtype=torch.bool, device=self.device)
        origin = torch.as_tensor(origin, dtype=torch.float32,
                                 device=self.device)
        opts = self.options
        if self._max_beams == 0:
            self._max_beams = points.shape[0]
        if not self.has_first_scan:
            self.odom_ = odometry
            self._odom_motion = odometry
            self._odom_reorg = odometry
            self.pset = particles_init(opts, self.pose_prior.se2_array(),
                                       self.device)
            first_step(opts, self.pset, points, mask, origin)
            self._reset_escapes()
            self.has_first_scan = True
            if self.summary is not None:
                dt = self._elapsed(t0)
                self.summary.probe(timestamp, dt, mapping=dt,
                                   memory=self.memory_usage())
            return True

        # motion for every packet, applied lazily: a re-org between here
        # and the update centres on the poses of the last applied motion
        odelta = self.odom_ - odometry
        self.odom_ = odometry
        self._odelta_queue.append(odelta.se2_array().astype(np.float32))
        self.acc_trans += float(np.linalg.norm(odelta.xy()))
        self.acc_rot += abs(odelta.rotation())
        if (self.acc_trans <= opts.trans_thresh
                and self.acc_rot <= opts.rot_thresh):
            return False
        self.acc_trans = 0.0
        self.acc_rot = 0.0
        if self._pf_spill is not None:
            self._pf_spill_hooks(odometry)    # refill near, spill far
        if opts.host_reorg and opts.resident_window:
            self._pf_maybe_reorg(odometry)
        clock = None
        if (self.summary is not None and opts.detailed_summary
                and opts.resident_window):
            clock = PhaseClock(self.device)
        self._flush_motion()
        self._step(points, mask, origin, clock)
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

    def update_many_prepadded(self, staged, odoms, chunk: int = 8) -> list:
        """Replay a pre-staged log: ``staged`` holds (points, mask, origin)
        per scan, ``odoms`` the matching odometry; each scan goes through
        :meth:`update_prepadded` (motion draws, gate and re-orgs per scan).
        Returns the accepted scan indices.

        ``chunk`` is the JAX package's dispatch amortisation (accepted
        updates per device program); here each update runs in turn, so
        every ``chunk`` gives the same results.
        """
        if chunk < 1:
            raise ValueError(f"chunk {chunk}: expected >= 1")
        return [k for k in range(len(staged))
                if self.update_prepadded(*staged[k], odoms[k])]

    def _flush_motion(self) -> None:
        """Apply the queued motion packets, one normal draw each."""
        n = self.options.particles
        for od in self._odelta_queue:
            self.pset = self.pset._replace(pose=draw_from_motion(
                self.options, self._draw("normal", (n, 3)),
                self._tensor(od), self.pset.pose))
        self._odelta_queue = []
        self._odom_motion = self.odom_

    def _step(self, points, mask, origin, clock=None) -> None:
        opts = self.options
        if not opts.resident_window:
            self.pset, self._last_info_dev = pool_update_step(
                opts, self.pset, self._draw("uniform", ()), points, mask,
                origin)
            return
        if not opts.host_reorg:
            # no safe host trigger: check every particle's cell and re-org
            # before the update when any left the safe zone
            cfg = opts.mapping_config()
            safe = mapping.resident_safe(cfg, self.pset.res_org,
                                         cfg.geometry.w2m(self.pset.pose[:, :2]))
            if not bool(torch.all(safe)):
                self.pset = reorg(opts, self.pset)
                self.n_reorgs += 1
        u = self._draw("uniform", ())
        self.pset, info = update_step(opts, self.pset, u, points, mask,
                                      origin, clock)
        self._esc_max = torch.maximum(self._esc_max, info["escaped"])
        self._esc_total += info["escaped"]
        self._last_info_dev = info

    def _reset_escapes(self) -> None:
        self._esc_max = torch.zeros((), dtype=torch.int64, device=self.device)
        self._esc_total = torch.zeros_like(self._esc_max)

    def escaped_count(self) -> int:
        """Particle-updates that ran outside the resident safe zone — 0 in
        a healthy run (one device read)."""
        return int(self._esc_total) if self._esc_total is not None else 0

    @property
    def _last_info(self) -> dict:
        return {k: float(v) for k, v in self._last_info_dev.items()}

    # -- host-gated re-orgs -------------------------------------------------
    def _pf_effective_trigger(self) -> float:
        if 0 < self._pf_scroll_m < self._pf_trigger_m:
            return self._pf_scroll_m
        return self._pf_trigger_m

    def _pf_maybe_reorg(self, odometry: Pose2D) -> None:
        """A re-org once odometry has travelled the wander allowance minus
        slack since the last one: a band scroll when the band covers the
        travel, else a full flush + regather."""
        if self._odom_reorg is None:
            return
        d = float(np.linalg.norm((self._odom_reorg - odometry).xy()))
        if d < self._pf_effective_trigger():
            return
        esc = int(self._esc_max)
        self._esc_max.zero_()
        self._pf_harvest_escapes(esc)
        cfg = self.options.mapping_config()
        patch_m = cfg.geometry.patch_length * cfg.geometry.resolution
        if (self._pf_scroll_m > 0 and d + self.options.host_reorg_slack
                <= self.options.scroll_kp * patch_m):
            self.pset = scroll(self.options, self.pset,
                               self.options.scroll_kp)
            self.n_scrolls += 1
        else:
            self.pset = reorg(self.options, self.pset)
        self._odom_reorg = odometry
        self.n_reorgs += 1

    def _pf_harvest_escapes(self, esc: int) -> None:
        """Escape guard, given the most particles that one update since the
        last re-org left outside the resident safe zone. A tail of at most
        25% of the particles is tolerated; two bursts above it only
        recentre (the re-org follows); the third tightens the trigger, and
        with no safe trigger left the driver checks the safe zone every
        update. Four clean re-orgs release one tightening step."""
        if esc == 0:
            self._esc_strikes = 0
            self._esc_clean += 1
            if (self._esc_clean >= 4
                    and self._pf_trigger_m < self._pf_trigger0):
                self._esc_clean = 0
                self._pf_trigger_m = min(
                    self._pf_trigger0,
                    self._pf_trigger_m
                    + max(self.options.host_reorg_slack, 0.25))
                if self._pf_scroll_m > 0:
                    self._pf_scroll_m = self._pf_trigger_m
            return
        self._esc_clean = 0
        self._esc_seen += 1
        if esc <= max(1, int(0.25 * self.options.particles)):
            return
        self._esc_strikes += 1
        if self._esc_strikes < 3:
            warnings.warn(
                f"PFSlam2D host-gated re-org: {esc} particle-update(s) "
                f"escaped the resident safe zone (strike "
                f"{self._esc_strikes}/3); recentering")
            return
        self._esc_strikes = 0
        self._pf_trigger_m -= max(self.options.host_reorg_slack, 0.25)
        if self._pf_scroll_m > 0:   # the scroll deadline tracks the trigger
            self._pf_scroll_m = self._pf_trigger_m
        if self._pf_trigger_m >= 0.5:
            warnings.warn(
                f"PFSlam2D host-gated re-org: {esc} particle-update(s) "
                f"escaped the resident safe zone; tightening trigger to "
                f"{self._pf_trigger_m:.2f} m")
        else:
            warnings.warn(
                "PFSlam2D host-gated re-org: escapes persist with no safe "
                "trigger distance left; falling back to the per-update "
                "safe-zone check")
            self.options = dataclasses.replace(self.options,
                                               host_reorg=False)

    # -- accessors (pf_slam2d.h:188-254) ------------------------------------
    def best_particle_idx(self) -> int:
        return int(torch.argmax(self.pset.weight_sum))

    def pose(self) -> Pose2D:
        self._flush_motion()
        i = self.best_particle_idx()
        return Pose2D.from_se2_array(self.pset.pose[i].cpu().numpy())

    def particle_map(self, idx: Optional[int] = None) -> mapping.SlamMapState:
        """One particle's map (the best particle by default) —
        getOccupancyMap/getDistanceMap (pf_slam2d.h:211-225): a copy of its
        pool, with its resident grids flushed in on the resident path."""
        i = self.best_particle_idx() if idx is None else idx
        ps = self.pset
        pool = _pool(ps.maps, i if ps.lineage is None else int(ps.lineage[i]))
        m = mapping.SlamMapState(PatchTable(*(t.clone() for t in pool.table)),
                                 pool.occupied.clone(), pool.visited.clone(),
                                 pool.dist.clone())
        if ps.res_org is None:
            return m
        return mapping.resident_flush(m, self.options.mapping_config(),
                                      ps.res_org, ps.res_occ[i],
                                      ps.res_vis[i], ps.res_dist[i])

    def full_particle_map(self, idx: Optional[int] = None):
        """One particle's complete map (its pool, resident grids and stored
        patches) for IO and export: (SlamMapState, MappingConfig). Without
        the spill tier this is :meth:`particle_map` with the driver's
        config."""
        i = self.best_particle_idx() if idx is None else idx
        m = self.particle_map(i)
        sp = self._pf_spill
        if sp is None or not sp.any_stored():
            return m, self.options.mapping_config()
        si = (int(self.pset.spill_lineage[i])
              if self.pset.spill_lineage is not None else i)
        return sp.merged_map_particle(m, si)

    def memory_usage(self) -> int:
        """Bytes of the allocated pool patches of every particle, in the
        port's cell dtypes, plus the spill tier's compressed store (a blob
        shared by particles counted once). The resident grids are a fixed
        buffer and not counted, as in the JAX package."""
        m = self.pset.maps
        cell = sum(a.element_size() for a in (m.occupied, m.visited, m.dist))
        total = (int(m.table.num_patches().sum())
                 * self.options.patch_size ** 2 * cell)
        if self._pf_spill is not None:
            total += self._pf_spill.memory_usage()
        return total

    # -- per-particle spill tier ---------------------------------------------
    def _pf_sync_now(self) -> None:
        """Pair the best particle's pose with the odometry it is at (one
        read). The queued motion stays queued: applying it here would move
        the anchor of a re-org later in this update, and the filter would
        no longer be the one without the tier (the JAX package applies
        it)."""
        ps = self.pset
        self._sync_pose = Pose2D.from_se2_array(
            ps.pose[torch.argmax(ps.weight_sum)].cpu().numpy())
        self._sync_odom = self._odom_motion
        self._pf_spill.host_reads += 1

    def _pf_approx_pose(self, odometry: Pose2D) -> np.ndarray:
        """Estimated xy without a device read: the best particle's pose at
        the last sync composed with the odometry increment since; the
        refill margin covers the drift and the particles' spread."""
        if self._sync_pose is None:
            self._pf_sync_now()
        est = self._sync_pose + (self._sync_odom - odometry)
        return np.asarray(est.xy())

    def _pf_settle_stores(self) -> None:
        """Apply ``spill_lineage`` to the host stores (one read), settle
        the pools' lineage on the device and reset both."""
        sp = self._pf_spill
        sp.permute(self.pset.spill_lineage.cpu().numpy())
        sp.host_reads += 1
        n = self.options.particles
        self.pset = settle(self.pset)._replace(spill_lineage=torch.arange(
            n, dtype=torch.int32, device=self.device))

    def _pf_spill_hooks(self, odometry: Pose2D) -> None:
        """Refill the stored patches the resident window could touch; spill
        far patches when a particle's pool nears capacity. The steady state
        makes no device read (a host-side upper bound, as in Slam2D)."""
        sp = self._pf_spill
        if sp.any_stored() and self._sync_odom is not None:
            # while stored ground exists the refill margin must absorb the
            # estimate's drift: resync every half margin of travel
            moved = float(np.linalg.norm((self._sync_odom - odometry).xy()))
            if moved > (0.5 * sp.margin * self.options.patch_size
                        * self.options.resolution):
                self._pf_sync_now()
        xy = self._pf_approx_pose(odometry)
        if sp.any_stored() and sp.need_refill(xy):
            self._pf_settle_stores()
            self.pset = self.pset._replace(
                maps=sp.refill_batch(self.pset.maps, xy))
        self._potential.update(int(k) for k in sp.window_keys_np(xy))
        if len(self._potential) - sp.stored_floor() > self._check_at:
            self._pf_sync_now()
            xy = self._pf_approx_pose(odometry)
            n_max = int(self.pset.maps.table.num_patches().max())
            sp.host_reads += 1
            if n_max > sp.high:
                self._pf_settle_stores()
                maps, _ = sp.spill_batch(self.pset.maps, xy)
                self.pset = self.pset._replace(maps=maps)
                n_max = int(self.pset.maps.table.num_patches().max())
                sp.host_reads += 1
            self._check_at = (len(self._potential) - sp.stored_floor()
                              + max(sp.high - n_max, 8))

    def save_occ_image(self, path: str) -> None:
        """saveOccImage (pf_slam2d.cpp:341-346): the best particle's
        occupancy as a PNG."""
        from ..sdm import export
        img = export.occupancy_to_image(self.particle_map(),
                                        self.options.mapping_config().geometry)
        export.export_to_png(img, path)

    # -- state across processes ---------------------------------------------
    def state_dict(self) -> dict:
        """Particle set and driver bookkeeping as numpy arrays (see
        :mod:`..utils.state`)."""
        from ..utils import state
        return state.pf_to_numpy(self)

    def load_state_dict(self, d: dict) -> None:
        from ..utils import state
        state.pf_from_numpy(self, d)
