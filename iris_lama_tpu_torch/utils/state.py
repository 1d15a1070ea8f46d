"""The map state carried across: numpy arrays <-> the port's tensors.

A state dict holds plain numpy arrays, in the JAX package's dtypes:

* ``table_keys``, ``table_slots``, ``table_free_slots``, ``table_n_free``,
  ``table_overflow`` — the pool table (int32);
* ``occupied``, ``visited`` (uint16) and ``dist`` (float32 meters) — the
  pool cell arrays ``[P+1, L, L]``; a probabilistic map's ``occupied``
  holds float32 log-odds;
* ``res_org`` (int32[2]), ``res_occ``, ``res_vis`` (uint16) and
  ``res_dist`` (squared-distance dtype) — the resident window;
* ``pose`` — float32 (tx, ty, cos, sin);
* optional driver bookkeeping: ``odom`` and ``odom_reorg`` (float64 x, y,
  theta), ``n_updates`` and ``escaped``.

A particle filter's state dict (:func:`pf_to_numpy`) holds the same pool and
resident arrays with a leading particle axis ``[N, ...]`` (``res_org`` is
shared), plus ``pose`` [N, 4], ``weight``, ``weight_sum``, ``normalized``
(float32 [N]) and ``lineage`` (int32 [N]) — the pool path
(``resident_window=False``) has no resident arrays and no lineage; its
bookkeeping is ``odom``, ``odom_reorg``, ``acc_trans``, ``acc_rot`` and
``odelta_queue`` (float32 [J, 4], the motion packets not applied yet),
and the port's own driver
state (:data:`PF_DRIVER`, optional on load): ``draw_state`` (uint8, the
draw generator's state, so that a reloaded filter continues the random
stream it was saved in), the re-org trigger ``trigger_m`` and ``scroll_m``
(float64), ``host_reorg`` (bool), the escape ladder's counters and the
escape and re-org counts (int64), and ``odom_motion`` (float64 x, y,
theta: the odometry at which the particle poses stand, before the queued
packets).

A GraphSlam2D state dict (:func:`graph_to_numpy`) holds its front end's
(the Slam2D keys above, plus ``traj``: float32 [n, 4], the matched poses
so far), the key poses (``kp_pose``, ``kp_raw`` float64 x, y, theta [K,
3]; ``kp_points`` float32 [K, B, 3], ``kp_mask`` bool [K, B],
``kp_origin`` float32 [K, 3], ``kp_t`` float64 [K]), the loop ``links``
(int64 [L, 2]), the builder's factors (``prior_idx``, ``bet_i``,
``bet_j`` int64; ``prior_meas``, ``bet_meas`` float32 [., 4];
``prior_sigmas``, ``bet_sigmas`` float32 [., 3]; ``bet_huber`` float64),
``correction`` (float64 x, y, theta), ``accdist``, ``factordist``
(float64), ``factor_queue``, the key gate's register ``last_key``
(float32 (tx, ty, cos, sin), absent before the first sync) and its
counters ``k_synced``, ``k_harvested``, ``since_sync`` (int64), ``prior``
(float64 x, y, theta) and the scans not yet gated (``buf_idx`` int64
[M], ``buf_points``, ``buf_mask``, ``buf_origin``, ``buf_t``).

A LidarOdometry2D state dict (:func:`lo_to_numpy`) holds its map (the
pool arrays above), ``pose``, ``map_odom`` and ``prev_delta`` (float32
(tx, ty, cos, sin)), ``traj`` (float32 [n, 4], the poses so far) and
``n_updates``.

A driver with the host spill tier (``use_compression``) adds its store
and bookkeeping (:func:`spill_to_numpy`): the distinct compressed blobs
concatenated in ``spill_blobs`` (uint8) with ``spill_offsets`` (int64
[B+1]), one entry per stored key — ``spill_keys`` (int32), ``spill_blob``
(int32, the entry's blob) and, for a particle filter, ``spill_particle``
(int32, whose store) — so a blob that particles share stays one blob; the
counters ``cache_hit``, ``cache_miss``, ``spills`` and ``refills``
(int64); the sync bookkeeping ``sync_pose`` and ``sync_odom`` (float64 x,
y, theta; absent before the first sync), ``potential`` (int32, the window
keys ever approached) and ``check_at`` (int64); and for a particle filter
``spill_lineage`` (int32 [N]).

Loc2D's fixed maps carry across as their own dict
(:func:`locmaps_to_numpy`), so that the port and the JAX package localise
on one identical map.

The port holds counts in int32 (sdm/mapping.py); they convert here.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core.pose import Pose2D
from ..sdm import mapping
from ..sdm.pool import PatchTable

TABLE_FIELDS = ("keys", "slots", "free_slots", "n_free", "overflow")


def _np(t) -> np.ndarray:
    """A copy of a tensor's values as numpy (any other array — the JAX
    package's — as numpy reads it). A CPU tensor is copied: the drivers
    update their state in place, and a snapshot must not follow."""
    if isinstance(t, torch.Tensor):
        t = t.detach()
        return t.numpy().copy() if t.device.type == "cpu" else t.cpu().numpy()
    return np.asarray(t)


def _counts_np(t) -> np.ndarray:
    """uint16 counts, or float32 log-odds as they are."""
    a = _np(t)
    return a if a.dtype.kind == "f" else a.astype(np.uint16)


def _counts_dtype(a) -> torch.dtype:
    return (torch.float32 if np.asarray(a).dtype.kind == "f"
            else mapping.COUNT_DTYPE)


def map_to_numpy(state: mapping.SlamMapState) -> dict:
    d = {f"table_{f}": _np(getattr(state.table, f)) for f in TABLE_FIELDS}
    d["occupied"] = _counts_np(state.occupied)
    d["visited"] = _counts_np(state.visited)
    d["dist"] = _np(state.dist)
    return d


def _tensor(a, dtype, device):
    """A tensor copy of array ``a`` (never a view: the port updates its
    state in place)."""
    return torch.tensor(np.asarray(a), device=device).to(dtype)


def map_from_numpy(d: dict, device) -> mapping.SlamMapState:
    def t(a, dtype):
        return _tensor(a, dtype, device)

    table = PatchTable(*(t(d[f"table_{f}"], torch.int32)
                         for f in TABLE_FIELDS))
    return mapping.SlamMapState(table,
                                t(d["occupied"], _counts_dtype(d["occupied"])),
                                t(d["visited"], mapping.COUNT_DTYPE),
                                t(d["dist"], torch.float32))


LOCMAPS_TABLES = ("occupancy", "distance")


def locmaps_to_numpy(maps) -> dict:
    """Loc2D's fixed maps (``algos.loc2d.LocMaps``, or the JAX package's,
    whose arrays numpy reads as they are) as a state dict:
    ``occupancy_table_*`` and ``distance_table_*`` (int32), ``cells``
    (int8), ``obstacle`` (bool) and ``dist`` (float32 meters)."""
    def arr(t):
        return _np(t) if isinstance(t, torch.Tensor) else np.asarray(t)

    d = {}
    for name, part in zip(LOCMAPS_TABLES, maps):
        d.update({f"{name}_table_{f}": arr(getattr(part.table, f))
                  for f in TABLE_FIELDS})
    d["cells"] = arr(maps.occupancy.cells).astype(np.int8)
    d["obstacle"] = arr(maps.distance.obstacle).astype(bool)
    d["dist"] = arr(maps.distance.dist).astype(np.float32)
    return d


def locmaps_from_numpy(d: dict, device):
    """The port's ``LocMaps`` on ``device`` from a state dict of
    :func:`locmaps_to_numpy`."""
    from ..algos.loc2d import LocMaps
    from ..sdm.distance import DistanceMapState
    from ..sdm.occupancy import SimpleOccupancyState

    tables = [PatchTable(*(_tensor(d[f"{name}_table_{f}"], torch.int32,
                                   device) for f in TABLE_FIELDS))
              for name in LOCMAPS_TABLES]
    return LocMaps(
        SimpleOccupancyState(tables[0], _tensor(d["cells"], torch.int8,
                                                device)),
        DistanceMapState(tables[1], _tensor(d["obstacle"], torch.bool, device),
                         _tensor(d["dist"], torch.float32, device)))


def slam_to_numpy(slam) -> dict:
    """Snapshot of a ``Slam2D`` — the port's, or the JAX package's, whose
    state has the same names — (the pool as it stands, without flushing
    the resident window into it)."""
    d = map_to_numpy(slam._map)
    if slam._res_org is not None:
        d["res_org"] = _np(slam._res_org)
        d["res_occ"] = _counts_np(slam._res_occ)
        d["res_vis"] = _counts_np(slam._res_vis)
        d["res_dist"] = _np(slam._res_dist)
    d["pose"] = _np(slam._pose_dev)
    d["odom"] = slam.odom_.xyr()
    if slam._odom_reorg is not None:
        d["odom_reorg"] = slam._odom_reorg.xyr()
    d["n_updates"] = np.int64(slam._n_updates)
    d["escaped"] = np.int32(slam.escaped_count())
    if getattr(slam, "_spill", None) is not None:
        d.update(spill_to_numpy(slam, slam._spill, [slam._spill.store]))
    return d


SPILL_COUNTERS = ("cache_hit", "cache_miss", "spills", "refills")


def spill_to_numpy(driver, store, stores: list) -> dict:
    """The spill tier's store (``stores``: one dict per particle, or one
    for Slam2D), counters and the driver's sync bookkeeping."""
    blobs, index, entries = [], {}, []
    for p, st in enumerate(stores):
        for k in sorted(st):
            b = st[k]
            if id(b) not in index:
                index[id(b)] = len(blobs)
                blobs.append(b)
            entries.append((p, k, index[id(b)]))
    offsets = np.cumsum([0] + [len(b) for b in blobs]).astype(np.int64)
    e = np.asarray(entries, np.int64).reshape(-1, 3)
    d = {"spill_blobs": np.frombuffer(b"".join(blobs), np.uint8).copy(),
         "spill_offsets": offsets, "spill_particle": e[:, 0].astype(np.int32),
         "spill_keys": e[:, 1].astype(np.int32),
         "spill_blob": e[:, 2].astype(np.int32),
         "potential": np.asarray(sorted(driver._potential), np.int32),
         "check_at": np.int64(driver._check_at)}
    d.update({k: np.int64(getattr(store, k)) for k in SPILL_COUNTERS})
    if driver._sync_pose is not None:
        d["sync_pose"] = driver._sync_pose.xyr()
        d["sync_odom"] = driver._sync_odom.xyr()
    return d


def spill_from_numpy(driver, store, d: dict, n_stores: int) -> list:
    """Load :func:`spill_to_numpy`'s keys into ``store`` and ``driver``;
    returns the stores (a list of ``n_stores`` dicts)."""
    raw, off = np.asarray(d["spill_blobs"], np.uint8), d["spill_offsets"]
    blobs = [raw[off[i]:off[i + 1]].tobytes() for i in range(len(off) - 1)]
    stores = [dict() for _ in range(n_stores)]
    for p, k, b in zip(d["spill_particle"], d["spill_keys"],
                       d["spill_blob"]):
        stores[int(p)][int(k)] = blobs[int(b)]
    for k in SPILL_COUNTERS:
        setattr(store, k, int(d[k]))
    driver._potential = set(int(k) for k in d["potential"])
    driver._check_at = int(d["check_at"])
    driver._sync_pose = (Pose2D.from_xyr(d["sync_pose"])
                         if "sync_pose" in d else None)
    driver._sync_odom = (Pose2D.from_xyr(d["sync_odom"])
                         if "sync_odom" in d else None)
    return stores


def _has_spill(driver, store, d: dict) -> bool:
    if "spill_keys" in d and store is None:
        raise ValueError("the state holds a spill store; build the driver "
                         "with use_compression=True")
    return store is not None and "spill_keys" in d


def slam_from_numpy(slam, d: dict) -> None:
    """Load a state dict into a port ``Slam2D`` so that it continues from
    that map and pose (a scan already went into the map)."""
    dev = slam.device
    slam._map = map_from_numpy(d, dev)
    cfg = slam.cfg
    if "res_org" in d:
        slam._res_org = _tensor(d["res_org"], torch.int32, dev)
        slam._res_occ = _tensor(d["res_occ"], mapping.COUNT_DTYPE, dev)
        slam._res_vis = _tensor(d["res_vis"], mapping.COUNT_DTYPE, dev)
        slam._res_dist = _tensor(d["res_dist"], cfg.sq_dtype, dev)
        slam._res_dirty = True
    slam._pose_dev = _tensor(d["pose"], torch.float32, dev)
    slam._pose_host = None
    if not slam._built:
        slam._build_programs()
    slam.has_first_scan = True
    if "odom" in d:
        slam.odom_ = Pose2D.from_xyr(d["odom"])
    slam._odom_reorg = (Pose2D.from_xyr(d["odom_reorg"])
                        if "odom_reorg" in d else slam.odom_)
    n = int(d.get("n_updates", 1))
    slam._n_updates = n
    slam._traj[min(n, slam.TRAJ_CAP) - 1] = slam._pose_dev
    slam._esc_dev.fill_(int(d.get("escaped", 0)))
    slam._esc_seen = int(d.get("escaped", 0))
    if _has_spill(slam, slam._spill, d):
        slam._spill.store = spill_from_numpy(slam, slam._spill, d, 1)[0]


LO_POSES = ("pose", "map_odom", "prev_delta")


def lo_to_numpy(lo) -> dict:
    """Snapshot of a port ``LidarOdometry2D`` after its first scan."""
    d = map_to_numpy(lo.map)
    d.update(pose=_np(lo._pose_dev), map_odom=_np(lo._map_odom_dev),
             prev_delta=_np(lo._delta_dev),
             traj=_np(lo._traj[:min(lo._n_updates, lo.TRAJ_CAP)]),
             n_updates=np.int64(lo._n_updates))
    return d


def lo_from_numpy(lo, d: dict) -> None:
    """Load a state dict into a port ``LidarOdometry2D`` so that it
    continues from that map and pose (a scan already went into the map)."""
    dev = lo.device
    lo.map = map_from_numpy(d, dev)
    lo._pose_dev, lo._map_odom_dev, lo._delta_dev = (
        _tensor(d[k], torch.float32, dev) for k in LO_POSES)
    lo._pose_host = None
    traj = np.asarray(d["traj"], np.float32)
    lo._traj.zero_()
    lo._traj[:len(traj)] = _tensor(traj, torch.float32, dev)
    lo._n_updates = int(d["n_updates"])
    lo.has_first_scan = True


PF_FLOATS = ("pose", "weight", "weight_sum", "normalized")
# the driver's integer counters: state dict key -> PFSlam2D attribute
PF_COUNTERS = {"esc_seen": "_esc_seen", "esc_clean": "_esc_clean",
               "esc_strikes": "_esc_strikes", "n_reorgs": "n_reorgs",
               "n_scrolls": "n_scrolls"}
PF_DRIVER = ("draw_state", "trigger_m", "scroll_m", "host_reorg",
             "escaped_max", "escaped", "odom_motion", *PF_COUNTERS)


def pf_to_numpy(pf) -> dict:
    """Snapshot of a port ``PFSlam2D`` after its first scan (the pools as
    they stand, lineage not settled)."""
    ps = pf.pset
    d = map_to_numpy(ps.maps)
    d.update({k: _np(getattr(ps, k)) for k in PF_FLOATS})
    if ps.res_org is not None:   # the pool path has no resident grids
        d.update(res_org=_np(ps.res_org), res_occ=_counts_np(ps.res_occ),
                 res_vis=_counts_np(ps.res_vis), res_dist=_np(ps.res_dist),
                 lineage=_np(ps.lineage))
    d.update(odom=pf.odom_.xyr(),
             odom_reorg=pf._odom_reorg.xyr(),
             odom_motion=pf._odom_motion.xyr(),
             acc_trans=np.float64(pf.acc_trans),
             acc_rot=np.float64(pf.acc_rot),
             odelta_queue=np.asarray(pf._odelta_queue,
                                     np.float32).reshape(-1, 4),
             draw_state=pf._gen.get_state().numpy(),
             trigger_m=np.float64(pf._pf_trigger_m),
             scroll_m=np.float64(pf._pf_scroll_m),
             host_reorg=np.bool_(pf.options.host_reorg),
             escaped_max=np.int64(int(pf._esc_max)),
             escaped=np.int64(int(pf._esc_total)))
    d.update({k: np.int64(getattr(pf, a)) for k, a in PF_COUNTERS.items()})
    if pf._pf_spill is not None:
        d.update(spill_to_numpy(pf, pf._pf_spill, pf._pf_spill.stores))
        d["spill_lineage"] = _np(ps.spill_lineage)
    return d


def pf_from_numpy(pf, d: dict) -> None:
    """Load a state dict into a port ``PFSlam2D`` so that it continues
    from that particle set (a scan already went into the maps)."""
    from ..algos.pf_slam2d import ParticleSet
    dev = pf.device
    cfg = pf.options.mapping_config()

    def t(k, dtype):
        return _tensor(d[k], dtype, dev)

    pf.pset = ParticleSet(*(t(k, torch.float32) for k in PF_FLOATS),
                          maps=map_from_numpy(d, dev))
    if "res_org" in d:
        pf.pset = pf.pset._replace(
            res_org=t("res_org", torch.int32),
            res_occ=t("res_occ", mapping.COUNT_DTYPE),
            res_vis=t("res_vis", mapping.COUNT_DTYPE),
            res_dist=t("res_dist", cfg.sq_dtype),
            lineage=t("lineage", torch.int32))
    pf.has_first_scan = True
    pf.odom_ = Pose2D.from_xyr(d["odom"])
    pf._odom_reorg = Pose2D.from_xyr(d.get("odom_reorg", d["odom"]))
    pf._odom_motion = Pose2D.from_xyr(d.get("odom_motion", d["odom"]))
    pf.acc_trans = float(d.get("acc_trans", 0.0))
    pf.acc_rot = float(d.get("acc_rot", 0.0))
    pf._odelta_queue = list(np.asarray(d.get("odelta_queue",
                                             np.zeros((0, 4))), np.float32))
    pf._reset_escapes()
    pf._esc_max.fill_(int(d.get("escaped_max", 0)))
    pf._esc_total.fill_(int(d.get("escaped", 0)))
    if "draw_state" in d:
        pf._gen.set_state(torch.from_numpy(
            np.array(d["draw_state"], dtype=np.uint8)))
    pf._pf_trigger_m = float(d.get("trigger_m", pf._pf_trigger_m))
    pf._pf_scroll_m = float(d.get("scroll_m", pf._pf_scroll_m))
    if not d.get("host_reorg", True):
        pf.options = dataclasses.replace(pf.options, host_reorg=False)
    for k, a in PF_COUNTERS.items():
        setattr(pf, a, int(d.get(k, 0)))
    sp = pf._pf_spill
    if _has_spill(pf, sp, d):
        sp.stores = spill_from_numpy(pf, sp, d, pf.options.particles)
    if sp is not None and pf.pset.res_org is not None:
        lin = d.get("spill_lineage", np.arange(pf.options.particles))
        pf.pset = pf.pset._replace(
            spill_lineage=_tensor(lin, torch.int32, dev))


def _poses_np(poses) -> np.ndarray:
    return np.asarray([p.xyr() for p in poses], np.float64).reshape(-1, 3)


def graph_to_numpy(gs) -> dict:
    """Snapshot of a ``GraphSlam2D`` — the port's or the JAX package's — with
    nothing in flight: no scan buffered for the live path, no gate replay,
    verification or coarse job awaiting its harvest (read ``key_poses``
    first: it drains them)."""
    in_flight = {k: len(getattr(gs, k)) for k in (
        "_live_pend", "_keyscan_pending", "_pending", "_coarse_jobs")}
    if any(in_flight.values()):
        raise ValueError(f"graph_to_numpy: work in flight {in_flight}; read "
                         "key_poses first")
    slam = gs.slam
    d = slam_to_numpy(slam)
    d["traj"] = _np(slam._traj[:min(slam._n_updates, slam.TRAJ_CAP)])
    kps = gs._key_poses
    d.update(kp_pose=_poses_np(kp.pose for kp in kps),
             kp_raw=_poses_np(kp.raw_pose for kp in kps),
             kp_t=np.asarray([kp.timestamp for kp in kps], np.float64))
    for k in ("points", "mask", "origin"):
        d[f"kp_{k}"] = np.stack([_np(getattr(kp, k)) for kp in kps]) \
            if kps else np.zeros((0,))
    d["links"] = np.asarray(gs._links, np.int64).reshape(-1, 2)
    b = gs._builder
    d.update(prior_idx=np.asarray([f[0] for f in b.priors], np.int64),
             prior_meas=np.asarray([f[1] for f in b.priors],
                                   np.float32).reshape(-1, 4),
             prior_sigmas=np.asarray([f[2] for f in b.priors],
                                     np.float32).reshape(-1, 3),
             bet_i=np.asarray([f[0] for f in b.betweens], np.int64),
             bet_j=np.asarray([f[1] for f in b.betweens], np.int64),
             bet_meas=np.asarray([f[2] for f in b.betweens],
                                 np.float32).reshape(-1, 4),
             bet_sigmas=np.asarray([f[3] for f in b.betweens],
                                   np.float32).reshape(-1, 3),
             bet_huber=np.asarray([f[4] for f in b.betweens], np.float64))
    d.update(correction=gs.correction.xyr(), accdist=np.float64(gs.accdist),
             factordist=np.float64(gs.factordist),
             factor_queue=np.int64(gs._factor_queue),
             k_synced=np.int64(gs._k_synced),
             k_harvested=np.int64(gs._k_harvested),
             since_sync=np.int64(gs._since_sync), prior=gs._prior.xyr())
    last = getattr(gs, "_last_key", getattr(gs, "_last_key_dev", None))
    if last is not None:
        d["last_key"] = _np(last).astype(np.float32)
    idx = sorted(gs._scan_buf)
    d["buf_idx"] = np.asarray(idx, np.int64)
    for j, k in enumerate(("points", "mask", "origin")):
        d[f"buf_{k}"] = np.stack([_np(gs._scan_buf[i][j]) for i in idx]) \
            if idx else np.zeros((0,))
    d["buf_t"] = np.asarray([gs._scan_buf[i][3] for i in idx], np.float64)
    return d


def graph_from_numpy(gs, d: dict) -> None:
    """Load a state dict into a port ``GraphSlam2D`` so that it continues
    from it."""
    from ..algos.graph_slam2d import KeyPose
    dev = gs.device
    slam = gs.slam
    slam_from_numpy(slam, d)
    traj = np.asarray(d["traj"], np.float32)
    slam._traj.zero_()
    slam._traj[:len(traj)] = _tensor(traj, torch.float32, dev)

    def scan(prefix, i):
        return (_tensor(d[f"{prefix}points"][i], torch.float32, dev),
                _tensor(d[f"{prefix}mask"][i], torch.bool, dev),
                _tensor(d[f"{prefix}origin"][i], torch.float32, dev))

    gs._key_poses = [
        KeyPose(i, Pose2D.from_xyr(d["kp_pose"][i]),
                Pose2D.from_xyr(d["kp_raw"][i]), *scan("kp_", i),
                float(d["kp_t"][i])) for i in range(len(d["kp_pose"]))]
    gs._links = [tuple(int(v) for v in lk) for lk in d["links"]]
    b = type(gs._builder)()
    for i, m, s in zip(d["prior_idx"], d["prior_meas"], d["prior_sigmas"]):
        b.add_prior(int(i), m, s)
    for i, j, m, s, k in zip(d["bet_i"], d["bet_j"], d["bet_meas"],
                             d["bet_sigmas"], d["bet_huber"]):
        b.add_between(int(i), int(j), m, s, huber_k=float(k))
    gs._builder = b
    gs.correction = Pose2D.from_xyr(d["correction"])
    gs.accdist = float(d["accdist"])
    gs.factordist = float(d["factordist"])
    gs._factor_queue = int(d["factor_queue"])
    gs._k_synced = int(d["k_synced"])
    gs._k_harvested = int(d["k_harvested"])
    gs._since_sync = int(d["since_sync"])
    gs._prior = Pose2D.from_xyr(d["prior"])
    gs._last_key = (torch.as_tensor(np.asarray(d["last_key"], np.float32))
                    if "last_key" in d else None)
    gs._scan_buf = {int(k): scan("buf_", i) + (float(d["buf_t"][i]),)
                    for i, k in enumerate(d["buf_idx"])}
    gs._keyscan_pending, gs._pending = [], []
    gs._coarse_jobs, gs._live_pend = [], []
    gs._gate_odom = slam.odom_ if slam.has_first_scan else None
