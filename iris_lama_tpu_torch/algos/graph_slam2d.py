"""Graph SLAM with loop closure (the reference's GraphSlam2D).

reference: include/lama/graph_slam2d.h, src/graph_slam2d.cpp. A transient-map
Slam2D front end (:104-111) + key-pose chain (1 m / 0.5*pi gates, :199-207)
+ loop-closure search and verification (:284-392) + pose-graph optimization
(:394-430) with the correction transform rebased onto the live SLAM pose.

The pieces:
* the front end is the port's resident-window Slam2D with
  ``transient_map=True``;
* key-pose gate (:199-207) — gates on the *matched slam pose* delta like the
  reference. The matched poses land in the front end's trajectory ring
  (update k at row k % ``Slam2D.TRAJ_CAP``);
  once per sync window (``sync_updates`` accepted scans, or one
  ``sync_scans`` slice of a replay) :func:`key_scan` replays the gate over
  up to 64 of them, reading the ring's block in one host read (the one read
  a sync the JAX package makes of its packed result) and gating on the CPU
  in float32;
* the k-d radius search -> pairwise distances on host numpy;
* dual-hypothesis candidate verification (:315-355): for each candidate of
  each key pose, two 1-iteration GN solves, the winner refined with a full
  solve, nearest-cell RMSE, on the window of the transient map as it stands
  at dispatch. The JAX package vmaps the candidates in one program; here a
  Python loop runs over the real candidate rows (the generic solver reads
  its stop flag on the host), and the results are held until the JAX
  package's harvest point, one sync later;
* coarse fallback (:357-392) -> a throwaway dense 0.25 m grid per query
  (four at a time, kernel B3 on ``[4, 116, 116]``) + a full solve, refined
  on the live map;
* minisam LM -> the batched SE(2) factor graph (nlls/factor_graph.py);
* the map rebuild (:131-164) -> parallel/map_rebuild.py (kernels B1 and B3).

Freshness contract (the JAX package's): key-pose creation, loop-closure
factors and the correction transform lag the front end by at most
``sync_updates`` accepted scans. Reads of ``key_poses``/``links`` and the
map/optimize entry points sync first. The sync schedule decides which
scans the factors enter on, so it is kept as it is: one sync per
``sync_updates`` accepted scans on the per-scan path, one ``keys_now`` sync
per ``sync_scans`` slice of a replay, a non-drain round harvests only the
verifications dispatched before it, and the coarse fallback runs for the
closest candidate only.

``stats`` holds host wall seconds and call counts per phase: ``front_end``
(the front end's updates), ``key_scan`` (gate replays and their reads),
``close_loops`` (candidate search and verification, ``correlate`` within
it), ``process_pending`` (harvests; ``coarse`` within it), ``optimize`` and
``rebuild`` (:meth:`GraphSlam2D.generate_occupancy_map`), and ``sync``
around each sync round (``sync_n``: the rounds). The timers read
no device: on the card a phase's time is its host enqueue time plus the
waits of the host reads inside it. Each phase is also the span
``lama.graph.<phase>`` (``utils/trace.py``), with the same boundaries.

Counters (``trace.count``): ``graph.keys`` (key poses created),
``graph.queries`` (candidate searches), ``graph.rows_verified`` ((query,
candidate) rows dispatched), ``graph.coarse_jobs``, ``graph.loops_accepted``,
``graph.optimizes`` and ``graph.publishes`` (map rebuilds). Host reads go
through ``trace.host_read`` at the sites ``key_gate`` (the gate's block),
``verify`` and ``coarse`` (a harvested batch), ``pgo_nodes`` (the optimised
key poses); the LM's stop flag reads at ``pgo_stop``.

``observer``, when set, is handed every event of the key poses, the loop
closure and the pose graph as it happens, in host data GraphSlam2D holds
anyway (see :meth:`GraphSlam2D._note`): a record for a check that follows
the machinery from the outside.

The driver runs on the CUDA device unless constructed with
``device="cpu"``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import time
from typing import List, NamedTuple, Optional

import numpy as np
import torch

from ..core import lie
from ..core.pose import Pose2D
from ..match import match_surface_2d as match
from ..nlls import factor_graph as fg
from ..nlls.robust import RobustCost
from ..nlls.solver import SolverOptions
from ..sdm import distance as dist_mod
from ..sdm import mapping, pool as pool_mod, window as win_mod
from ..sdm.geometry import MapGeometry
from ..utils.cloud import PointCloudXYZ, beam_bucket, pad_scan
from ..utils.trace import count, host_read, span
from .slam2d import Slam2D, Slam2DOptions

HUBER_MATCH = RobustCost("huber", 0.15)   # graph_slam2d.cpp:327, 363

KEY_SCAN_S = 64   # trajectory entries examined per key-gate replay
VERIFY_CHUNK = 32  # (query, candidate) rows a verification batch
COARSE_CHUNK = 4   # coarse jobs a batch


@dataclasses.dataclass(frozen=True)
class GraphSlam2DOptions:
    """reference: GraphSlam2D::Options (graph_slam2d.h:59-87) — the Slam2D
    options plus the loop-closure knobs. The JAX package's environment
    knobs ``IRIS_GRAPH_SYNC`` and ``IRIS_GRAPH_LIVE_CHUNK`` are not ported:
    ``sync_updates`` and ``live_chunk`` take their defaults here."""

    slam: Slam2DOptions = Slam2DOptions(transient_map=True)
    key_pose_distance: float = 1.0
    key_pose_angular_distance: float = 0.5 * math.pi
    key_pose_head_delay: int = 5
    loop_search_max_distance: float = 10.0
    loop_search_min_distance: float = 2.0
    loop_max_candidates: int = 5
    loop_closure_scan_rmse: float = 0.05
    loop_closure_max_candidates: int = 10   # graph_slam2d.h:82
    ignore_n_chain_poses: int = 20
    sync_updates: int = 8    # per-scan path: accepted scans between syncs
    sync_scans: int = 32     # replay: raw scans per front-end slice
    # per-scan path: accepted scans buffered and run as one
    # Slam2D.update_many_prepadded call (1 = each at once)
    live_chunk: int = 1


class KeyPose(NamedTuple):
    """graph_slam2d.h:97-104 (the cloud kept as padded tensors on the
    driver's device)."""

    id: int
    pose: Pose2D            # corrected/global frame
    raw_pose: Pose2D        # live slam frame at creation
    points: torch.Tensor    # f32 [B, 3] base-frame points
    mask: torch.Tensor      # bool [B]
    origin: torch.Tensor    # f32 [3]
    timestamp: float


def key_scan(traj, k0: int, n: int, last_key, kd: float, ka: float):
    """The key-pose gate (graph_slam2d.cpp:199-207) over trajectory rows
    ``k0 .. k0 + n - 1`` (n <= KEY_SCAN_S) from the register ``last_key``
    (f32 [4], the last key's raw pose).

    The block of KEY_SCAN_S rows is read in one host read; its start is
    clamped into the ring as ``lax.dynamic_slice`` clamps it (a start past
    ``len(traj) - KEY_SCAN_S`` reads the ring's last rows, and the reported
    update indices stay ``k0 + i``). Returns (packed f32 [KEY_SCAN_S + 1,
    5], last_key) on the CPU: rows ``i < count`` hold the fired events
    ``[update index, tx, ty, cos, sin]``, unused rows the JAX package's
    fill ``[k0 + KEY_SCAN_S, last row of the block]``, and row
    ``KEY_SCAN_S`` holds ``[count, 0, 0, 0, 0]``.
    """
    cap = traj.shape[0]
    start = min(max(int(k0), 0), cap - KEY_SCAN_S)
    block = torch.from_numpy(host_read(traj[start:start + KEY_SCAN_S],
                                       "key_gate", numpy=True))
    last = torch.as_tensor(last_key, dtype=torch.float32).to("cpu")
    fired = []
    for i in range(min(int(n), KEY_SCAN_S)):
        pose = block[i]
        rel = lie.se2_compose(lie.se2_inverse(last), pose)
        d2 = rel[0] * rel[0] + rel[1] * rel[1]
        ang = torch.abs(torch.atan2(rel[3], rel[2]))
        if bool((d2 >= kd * kd) | (ang >= ka)):
            last = pose
            fired.append(i)
    idx = torch.full((KEY_SCAN_S,), KEY_SCAN_S, dtype=torch.int64)
    idx[:len(fired)] = torch.as_tensor(fired, dtype=torch.int64)
    rows = torch.cat([(k0 + idx).to(torch.float32)[:, None],
                      block[torch.clamp(idx, max=KEY_SCAN_S - 1)]], dim=1)
    count = torch.zeros((1, 5), dtype=torch.float32)
    count[0, 0] = len(fired)
    return torch.cat([rows, count], dim=0), last


def _stack(tensors):
    return torch.stack(list(tensors))


class GraphSlam2D:
    """Host driver; mirrors the reference public API (graph_slam2d.h:106-160)."""

    def __init__(self, options: GraphSlam2DOptions = GraphSlam2DOptions(),
                 device=None):
        self.options = options
        slam_opts = dataclasses.replace(options.slam, transient_map=True)
        self.slam = Slam2D(slam_opts, device=device)
        self.device = self.slam.device
        self._key_poses: List[KeyPose] = []
        self._links: List[tuple] = []
        self.correction = Pose2D()
        self.accdist = 0.0
        self.factordist = 0.0
        self._builder = fg.GraphBuilder()
        self._factor_queue = 0   # factors queued since last optimize
        self._kernels = None
        self._prior = Pose2D()
        # deferred key-pose machinery (see module docstring)
        self._scan_buf: dict = {}       # update index -> (pts, msk, org, t)
        self._k_synced = 0              # updates handed to the key gate
        self._k_harvested = 0           # updates whose key events landed
        self._since_sync = 0
        self._last_key = None           # gate register: last key raw pose
        self._keyscan_pending: List[tuple] = []   # (k0, take)
        # verification batches and coarse jobs awaiting their harvest
        self._pending: List[dict] = []
        self._coarse_jobs: List[tuple] = []
        # phase counters (host wall seconds / call counts)
        self.stats: dict = {}
        # live micro-chunk buffer (Options.live_chunk): accepted scans
        # awaiting their front-end run + the gate's own odometry (slam.odom_
        # lags while scans sit in the buffer)
        self._live_pend: List[tuple] = []
        self._gate_odom = None
        # None, or a callable handed each event of the machinery (_note)
        self.observer = None

    # -- public API ----------------------------------------------------------
    def set_prior(self, prior: Pose2D) -> None:
        self.slam.set_prior(prior)
        self._prior = prior

    def pose(self) -> Pose2D:
        """corrected global pose = correction + slam pose (the correction
        lags by at most sync_updates accepted scans after an optimize)."""
        self._live_flush()
        return self.correction + self.slam.pose()

    def enough_motion(self, odometry: Pose2D) -> bool:
        if self._gate_odom is not None:
            return not self.slam._below_gate(self._gate_odom - odometry)
        return self.slam.enough_motion(odometry)

    @property
    def key_poses(self) -> List[KeyPose]:
        self._live_flush()
        self._sync(drain=True)
        return self._key_poses

    @property
    def links(self) -> List[tuple]:
        self._live_flush()
        self._sync(drain=True)
        return self._links

    def _programs(self):
        if self._kernels is None:
            self._kernels = _make_graph_kernels(
                self.slam.cfg, self.options.key_pose_distance,
                self.options.key_pose_angular_distance)
        return self._kernels

    def _stage(self, points, mask, origin):
        dev = self.device
        return (torch.as_tensor(points, dtype=torch.float32, device=dev),
                torch.as_tensor(mask, dtype=torch.bool, device=dev),
                torch.as_tensor(origin, dtype=torch.float32, device=dev))

    # -- main update (graph_slam2d.cpp:188-283) ------------------------------
    def update(self, cloud: PointCloudXYZ, odometry: Pose2D,
               timestamp: float = 0.0) -> bool:
        if self.slam._max_beams == 0:
            self.slam._max_beams = beam_bucket(len(cloud.points))
        points, mask, origin = pad_scan(cloud, self.slam._max_beams)
        return self.update_prepadded(points, mask, origin, odometry,
                                     timestamp)

    def update_prepadded(self, points, mask, origin, odometry: Pose2D,
                         timestamp: float = 0.0) -> bool:
        """Per-scan path on pre-padded arrays or tensors.

        With ``live_chunk > 1``, accepted scans are buffered and run as one
        ``Slam2D.update_many_prepadded`` call per ``live_chunk`` scans: the
        motion gate is host odometry logic, so acceptance is decided here,
        and every public read flushes the buffer first."""
        staged = self._stage(points, mask, origin)
        lc = self.options.live_chunk
        if lc <= 1 or not self.slam.has_first_scan:
            with self._timed("front_end"):
                did = self.slam.update_prepadded(*staged, odometry,
                                                 timestamp)
            if not did:
                return False
            self._gate_odom = odometry
            self._scan_buf[self.slam._n_updates - 1] = staged + (timestamp,)
            self._since_sync += 1
            if self._since_sync >= self.options.sync_updates:
                self._sync()
            return True
        # host-side motion gate against the last ACCEPTED odometry
        # (slam2d.cpp:167-170)
        if self.slam._below_gate(self._gate_odom - odometry):
            return False
        self._gate_odom = odometry
        self._live_pend.append(staged + (odometry, timestamp))
        if len(self._live_pend) >= lc:
            self._live_flush()
        return True

    def _live_flush(self) -> None:
        """Run the buffered accepted scans through the front end and the
        key-pose bookkeeping they owe."""
        if not self._live_pend:
            return
        pend, self._live_pend = self._live_pend, []
        staged = [p[:3] for p in pend]
        u0 = self.slam._n_updates
        with self._timed("front_end"):
            acc = self.slam.update_many_prepadded(
                staged, [p[3] for p in pend], chunk=len(pend))
        assert len(acc) == len(pend), \
            "live gate diverged from Slam2D's motion gate"
        for j, p in enumerate(pend):
            self._scan_buf[u0 + j] = staged[j] + (p[4],)
            self._since_sync += 1
            if self._since_sync >= self.options.sync_updates:
                self._sync()

    def update_many_prepadded(self, staged, odoms, timestamps=None) -> list:
        """Replay: the front end runs slices of ``sync_scans`` raw scans,
        with one key-gate sync (and its loop-closure batch) per slice.
        ``staged`` holds (points, mask, origin) padded arrays or tensors.
        Returns the accepted scan indices."""
        S = self.options.sync_scans
        accepted = []
        for i in range(0, len(staged), S):
            sl = [self._stage(*s) for s in staged[i:i + S]]
            od = list(odoms[i:i + S])
            u0 = self.slam._n_updates
            with self._timed("front_end"):
                acc = self.slam.update_many_prepadded(sl, od)
            for j, a in enumerate(acc):
                t = timestamps[i + a] if timestamps is not None else 0.0
                self._scan_buf[u0 + j] = sl[a] + (t,)
                accepted.append(i + a)
            self._sync(keys_now=True)
        return accepted

    def _note(self, event: str, **fields) -> None:
        """Hand ``observer`` one event (a name and a dict of fields; no
        device read), when one is set:

        * ``key``: ``id``, ``timestamp``, ``pose`` and ``raw`` (Pose2D,
          the corrected and the slam-frame pose) of a new key pose;
        * ``factor``: ``i``, ``j``, ``measurement`` (f32 [4], as the graph
          holds it) and ``loop`` of a factor added (a prior has i == j);
        * ``dispatch``: ``queries`` (the keys searched), ``accdist`` (the
          distance the search radius grew from) and ``rows``, each
          ``(query, candidate, ref, cand)`` with both poses (Pose2D) in the
          slam frame, in rank order, of a verification dispatched;
        * ``coarse``: ``jobs``, each ``(query, candidate, ref, cand)``, of a
          coarse batch dispatched;
        * ``harvest``: ``kind`` (``"verify"`` or ``"coarse"``), ``pairs``
          (``(query, candidate)`` a row) and ``packed`` (f32 [n, 5]: each
          row's matched state and RMSE) of a batch read;
        * ``optimize``: ``start`` (f32 [n, 4]: the key poses the LM starts
          from) and ``out`` (its result; None when not finite).
        """
        if self.observer is not None:
            self.observer(event, fields)

    def _timed(self, name):
        st = self.stats

        @contextlib.contextmanager
        def cm():
            t0 = time.perf_counter()
            try:
                with span("lama.graph." + name):
                    yield
            finally:
                st[name] = st.get(name, 0.0) + (time.perf_counter() - t0)
                st[name + "_n"] = st.get(name + "_n", 0) + 1
        return cm()

    # -- deferred key-pose sync ---------------------------------------------
    def _sync(self, drain: bool = False, keys_now: bool = False) -> None:
        """One sync round: harvest last round's verification results and
        key-gate replays, create the fired key poses, dispatch their
        loop-closure verification batch, hand this window's updates to the
        key gate, and optimize when the thresholds are met. ``keys_now``
        harvests this window's gate replay at once (a replay slice);
        ``drain=True`` also resolves every verification in flight (public
        reads / optimize entry points)."""
        with self._timed("sync"):
            self._sync_round(drain, keys_now)

    def _sync_round(self, drain: bool, keys_now: bool) -> None:
        self._since_sync = 0
        with self._timed("process_pending"):
            self._process_pending()
        # 1. harvest the gate replays handed over at the PREVIOUS sync
        new_queries = self._harvest_keyscans()
        # 2. hand this window's updates to the gate
        n_new = self.slam._n_updates - self._k_synced
        if n_new > 0:
            if self._last_key is None:
                # key pose 0: the first update's matched pose IS the prior
                # (graph_slam2d.cpp:196-198 first-key special case)
                self._last_key = torch.as_tensor(self._prior.se2_array())
                q = self._create_key(0, self._prior)
                if q is not None:
                    new_queries.append(q)
            while n_new > 0:
                take = min(n_new, KEY_SCAN_S)
                self._keyscan_pending.append((self._k_synced, take))
                self._k_synced += take
                n_new -= take
        if drain or keys_now:
            # a replay harvests at once: a pipelined harvest would delay key
            # poses by a whole sync_scans slice while the transient map moves
            # on (the JAX package measured 11 -> 3 accepted loops)
            new_queries += self._harvest_keyscans()
        if new_queries:
            with self._timed("close_loops"):
                self._dispatch_verification(new_queries)
        if drain:
            with self._timed("process_pending"):
                self._process_pending(drain=True)
        # optimize cadence (cpp:275-279)
        if self._factor_queue > 0 and (self._factor_queue > 5 or
                                       self.factordist > 15.0):
            with self._timed("optimize"):
                self._optimize()

    def _harvest_keyscans(self) -> list:
        """Run every gate replay handed over and create its fired key
        poses. Returns the query ids due for loop-closure verification."""
        _, gate, _ = self._programs()
        cap = self.slam.TRAJ_CAP
        new_queries = []
        while self._keyscan_pending:
            k_lo, take = self._keyscan_pending.pop(0)
            with self._timed("key_scan"):
                # update k sits at ring row k % cap; a block that runs past
                # the ring's end is read as its two pieces joined
                r0, traj = k_lo % cap, self.slam._traj
                if r0 + KEY_SCAN_S > cap:
                    traj = torch.cat([traj[r0:],
                                      traj[:r0 + KEY_SCAN_S - cap]])
                    r0 = 0
                data, self._last_key = gate(traj, r0, take, self._last_key)
                data = data.numpy()
            for row in data[:int(data[-1, 0])]:
                q = self._create_key(k_lo + int(row[0]) - r0,
                                     Pose2D.from_se2_array(row[1:5]))
                if q is not None:
                    new_queries.append(q)
            self._k_harvested = k_lo + take
            self._scan_buf = {k: v for k, v in self._scan_buf.items()
                              if k >= self._k_harvested}
        return new_queries

    def _create_key(self, k_idx: int, raw: Pose2D) -> Optional[int]:
        """Create a key pose for accepted update ``k_idx`` (matched pose
        ``raw`` in the slam frame). Returns the query id whose candidates
        are due for verification (cpp:209-232 + head-delay), or None."""
        opts = self.options
        corrected = self.correction + raw
        points, mask, origin, t = self._scan_buf[k_idx]
        keyid = len(self._key_poses)
        if keyid == 0:
            self._builder.add_prior(0, corrected.se2_array(),
                                    (0.01, 0.01, 0.01))
            factor = (0, 0, self._builder.priors[-1][1])
        else:
            prev = self._key_poses[-1]
            step = float(np.linalg.norm((prev.raw_pose - raw).xy()))
            self.accdist += step
            self.factordist += step
            between = prev.pose - corrected
            self._builder.add_between(keyid - 1, keyid, between.se2_array(),
                                      (0.25, 0.25, 0.15))
            factor = self._builder.betweens[-1][:3]
        self._key_poses.append(KeyPose(keyid, corrected, raw, points, mask,
                                       origin, t))
        count("graph.keys")
        self._note("key", id=keyid, timestamp=t, pose=corrected, raw=raw)
        self._note("factor", i=factor[0], j=factor[1], measurement=factor[2],
                   loop=False)
        if (keyid < opts.key_pose_head_delay or
                keyid < opts.ignore_n_chain_poses):
            return None
        return keyid - opts.key_pose_head_delay

    def _dispatch_verification(self, query_ids) -> None:
        """Candidate search + the dual-hypothesis verification of every
        (query, candidate) row of this sync window, on the map as it stands
        now (slam/raw frame); the results wait for the next harvest, as in
        the JAX package."""
        opts = self.options
        inv_corr = self.correction.inverse()
        rows = []   # (qid, cid, ref_pose_raw, cand_pose_raw), rank order
        accdist = self.accdist
        for qid in query_ids:
            count("graph.queries")
            # adaptive radius (cpp:236-237)
            r = min(self.accdist, 100.0) / 100.0
            radius = (opts.loop_search_max_distance ** r *
                      opts.loop_search_min_distance ** (1.0 - r))
            cands = self._find_candidates(self._key_poses[qid].pose.xy(),
                                          radius, qid)
            ref_pose = inv_corr + self._key_poses[qid].pose
            for cid in cands:
                cand_pose = inv_corr + self._key_poses[cid].pose
                rows.append((qid, cid, ref_pose, cand_pose))
        self._note("dispatch", queries=query_ids, accdist=accdist,
                   rows=rows)
        if not rows:
            return
        correlate, _, _ = self._programs()
        dev = self.device
        for off in range(0, len(rows), VERIFY_CHUNK):
            chunk = rows[off:off + VERIFY_CHUNK]
            count("graph.rows_verified", len(chunk))
            cand_poses = np.stack([c[3].se2_array() for c in chunk])
            hypos = np.stack([Pose2D(c[2].x(), c[2].y(),
                                     c[3].rotation()).se2_array()
                              for c in chunk])
            kps = [self._key_poses[c[1]] for c in chunk]
            with self._timed("correlate"):
                packed = correlate(
                    self.slam.map, torch.as_tensor(cand_poses, device=dev),
                    torch.as_tensor(hypos, device=dev),
                    _stack(kp.points[:, :2] for kp in kps),
                    _stack(kp.mask for kp in kps))
            self._pending.append({"kind": "verify", "dev": packed,
                                  "rows": chunk})

    def _process_pending(self, drain: bool = False) -> None:
        """Harvest verification batches. Acceptance order per query is the
        reference's: fine(0), coarse(0) if fine(0) failed, fine(1),
        fine(2), ... (graph_slam2d.cpp:248-273 with the rank-0-only coarse
        fallback); at most one accepted factor per query (cpp:273). Rank-0
        failures queue a coarse batch whose results resolve on the next
        harvest (at once under ``drain``)."""
        n0 = len(self._pending)   # non-drain: only items dispatched BEFORE
        processed = 0             # this round (fresh coarse waits a round)
        while self._pending and (drain or processed < n0):
            item = self._pending.pop(0)
            processed += 1
            packed = host_read(item["dev"], item["kind"],  # one per batch
                               numpy=True)
            self._note("harvest", kind=item["kind"], packed=packed,
                       pairs=[r[:2] for r in item.get("rows",
                                                      item.get("jobs"))])
            if item["kind"] == "verify":
                per_q: dict = {}
                for i, row in enumerate(item["rows"]):
                    per_q.setdefault(row[0], []).append((i, row))
                for qid, entries in per_q.items():
                    results = [(row[1], packed[i, :4], float(packed[i, 4]),
                                row[2], row[3]) for i, row in entries]
                    self._resolve_query(qid, results)
                self._flush_coarse_jobs()
            else:   # coarse results
                for j, (qid, cid, refp, candp, remaining) in enumerate(
                        item["jobs"]):
                    state, err = packed[j, :4], float(packed[j, 4])
                    if err <= (self.options.loop_closure_scan_rmse * 2.0):
                        self._accept(qid, cid, state, refp)
                        continue
                    for cid2, st2, err2, refp2, _ in remaining:
                        if err2 <= self.options.loop_closure_scan_rmse:
                            self._accept(qid, cid2, st2, refp2)
                            break
        if drain and self._coarse_jobs:
            self._flush_coarse_jobs()
            self._process_pending(drain=True)

    def _resolve_query(self, qid, results) -> None:
        """results: [(cid, state, err, ref_raw, cand_raw)] in rank order."""
        if not results:
            return
        cid, state, err, refp, candp = results[0]
        if err <= self.options.loop_closure_scan_rmse:
            self._accept(qid, cid, state, refp)
            return
        # one more chance, closest candidate only (cpp:255-259): coarse
        # registration; ranks 1+ wait on its outcome (reference order)
        self._coarse_jobs.append((qid, cid, refp, candp, results[1:]))

    def _flush_coarse_jobs(self) -> None:
        if not self._coarse_jobs:
            return
        jobs = self._coarse_jobs
        self._coarse_jobs = []
        count("graph.coarse_jobs", len(jobs))
        self._note("coarse", jobs=[j[:4] for j in jobs])
        _, _, coarse = self._programs()
        dev = self.device
        for off in range(0, len(jobs), COARSE_CHUNK):
            chunk = jobs[off:off + COARSE_CHUNK]
            padded = (chunk + [chunk[0]] * COARSE_CHUNK)[:COARSE_CHUNK]
            refs = [self._key_poses[j[0]] for j in padded]
            cands = [self._key_poses[j[1]] for j in chunk]
            with self._timed("coarse"):
                packed = coarse(
                    self.slam.map,
                    torch.as_tensor(np.stack([j[2].se2_array()
                                              for j in padded]), device=dev),
                    _stack(kp.points[:, :2] for kp in refs),
                    _stack(kp.mask for kp in refs),
                    torch.as_tensor(np.stack([j[3].se2_array()
                                              for j in chunk]), device=dev),
                    _stack(kp.points[:, :2] for kp in cands),
                    _stack(kp.mask for kp in cands))
            self._pending.append({"kind": "coarse", "dev": packed,
                                  "jobs": chunk})

    def _accept(self, qid, cand_id, state, ref_pose) -> None:
        """Add the accepted loop factor (cpp:266-272).

        ``between = matched^-1 * ref`` (cpp:353 with Pose2D operator-):
        both poses live in the snapshot's slam (raw) frame, so the relative
        factor is correction-independent."""
        matched = Pose2D.from_se2_array(np.asarray(state))
        between = matched - ref_pose
        self._builder.add_between(cand_id, qid, between.se2_array(),
                                  (0.5, 0.5, 0.1), huber_k=0.1)
        self._note("factor", i=cand_id, j=qid, loop=True,
                   measurement=self._builder.betweens[-1][2])
        self._links.append((cand_id, qid))
        count("graph.loops_accepted")
        self._factor_queue += 1
        self.factordist = 0.0

    # -- helpers -------------------------------------------------------------
    def _find_candidates(self, query_xy, radius, query_id):
        """nanoflann radius query equivalent (cpp:284-313): brute-force
        distances, excluding the most recent chain poses."""
        n_ignore = self.options.ignore_n_chain_poses
        limit = len(self._key_poses) - n_ignore
        if limit <= 0:
            return []
        xy = np.array([kp.pose.xy() for kp in self._key_poses[:limit]])
        d = np.linalg.norm(xy - np.asarray(query_xy), axis=1)
        order = np.argsort(d)
        sel = [int(i) for i in order if d[i] <= radius and i != query_id]
        return sel[:self.options.loop_max_candidates]

    def optimize_pose_graph(self) -> None:
        """Public optimize entry (cpp:394-430): flush pending key events
        and verifications, then solve unconditionally."""
        self._live_flush()
        self._sync(drain=True)
        self._optimize()

    def _optimize(self) -> None:
        n = len(self._key_poses)
        if n == 0:
            return
        dev = self.device
        graph = self._builder.finalize(dev)
        n_pad = fg.GraphBuilder._bucket(n)
        nodes = np.tile(np.array([0, 0, 1, 0], np.float32), (n_pad, 1))
        for i, kp in enumerate(self._key_poses):
            nodes[i] = kp.pose.se2_array()
        active = np.zeros(n_pad, bool)
        active[:n] = True
        count("graph.optimizes")
        out, _ = fg.optimize(torch.as_tensor(nodes, device=dev), graph,
                             torch.as_tensor(active, device=dev))
        out = host_read(out, "pgo_nodes", numpy=True)
        finite = bool(np.isfinite(out[:n]).all())
        self._note("optimize", start=nodes[:n],
                   out=out[:n] if finite else None)
        if not finite:
            return
        for i in range(n):
            self._key_poses[i] = self._key_poses[i]._replace(
                pose=Pose2D.from_se2_array(out[i]))
        # correction rebase (cpp:416-425): C = B * A^-1; correction = C^-1.
        # The reference anchors on the live slam pose right after creating
        # a key pose; a deferred sync may optimize a few scans later, so
        # the last key's own raw pose is the faithful anchor.
        A = self._key_poses[-1].pose
        B = self._key_poses[-1].raw_pose
        self.correction = A + B.inverse()   # A * B^-1
        self._factor_queue = 0
        self.accdist = 0.0
        self.factordist = 0.0

    # -- map regeneration (cpp:131-186) --------------------------------------
    def generate_occupancy_map(self, mesh=None) -> mapping.SlamMapState:
        """Re-rasterize all key-pose clouds at their optimized poses: every
        scan deposited at once (parallel/map_rebuild.py), on a pool of four
        times the front end's capacity. ``mesh``: a process group over
        which the rebuild is split (every rank calls this on the same
        state and gets the whole map)."""
        from ..parallel import map_rebuild

        self._live_flush()
        self._sync(drain=True)
        cfg = dataclasses.replace(self.slam.cfg,
                                  capacity=4 * self.slam.cfg.capacity)
        if not self._key_poses:
            return mapping.slam_map_init(cfg, self.device)
        count("graph.publishes")
        with self._timed("rebuild"):
            poses = np.asarray([kp.pose.se2_array()
                                for kp in self._key_poses], np.float32)
            org, h, w = map_rebuild.grid_bounds(cfg, cfg.geometry, poses)
            dense = map_rebuild.rebuild_dense(
                cfg, torch.as_tensor(poses, device=self.device),
                _stack(kp.points for kp in self._key_poses),
                _stack(kp.mask for kp in self._key_poses),
                _stack(kp.origin for kp in self._key_poses), org, h, w,
                mesh=mesh)
            return map_rebuild.dense_to_state(cfg, dense)

    def coarse_obstacles(self, resolution: float = 0.1, l2_max: float = 5.0):
        """Every key-pose cloud at its corrected pose as obstacles on one
        dense host grid, patch-aligned with an EDT-radius margin (the input
        of :meth:`generate_coarse_distance_map`). Returns (obstacles bool
        [ny*L, nx*L], origin cell [2], DistanceConfig); (None, None,
        DistanceConfig) without key poses."""
        geo = MapGeometry(resolution, 4, False)
        dcfg = dist_mod.DistanceConfig(geo, l2_max)
        all_pts = []
        for kp in self._key_poses:
            c, s = np.cos(kp.pose.rotation()), np.sin(kp.pose.rotation())
            R = np.array([[c, -s], [s, c]])
            pts = kp.points.cpu().numpy()[kp.mask.cpu().numpy()][:, :2]
            all_pts.append(pts @ R.T + kp.pose.xy())
        if not all_pts:
            return None, None, dcfg
        cells = geo.np_w2m(np.concatenate(all_pts))
        length = geo.patch_length
        r = dcfg.radius_cells
        lo = cells.min(0) - r - length
        hi = cells.max(0) + r + length
        lo = (lo >> geo.log2dim) << geo.log2dim          # patch align
        nx = int(np.ceil((hi[0] - lo[0]) / length)) + 1
        ny = int(np.ceil((hi[1] - lo[1]) / length)) + 1
        obst = np.zeros((ny * length, nx * length), bool)
        obst[cells[:, 1] - lo[1], cells[:, 0] - lo[0]] = True
        return obst, lo, dcfg

    def generate_coarse_distance_map(self, resolution: float = 0.1,
                                     l2_max: float = 5.0):
        """Coarse DDM over all key-pose clouds (cpp:166-186): every cloud
        rasterized as obstacles on a dense grid (host), the exact EDT
        (kernel B3 on the driver's device), and the result packed into a
        standalone pool-backed DistanceMapState (ready for Loc2D-style
        queries). Returns (state, DistanceConfig)."""
        self._live_flush()
        self._sync(drain=True)
        dev = self.device
        obst, lo, dcfg = self.coarse_obstacles(resolution, l2_max)
        geo = dcfg.geometry
        state = dist_mod.distance_map_init(dcfg, capacity=4096)
        if obst is None:
            return _distance_state_to(state, dev), dcfg
        length = geo.patch_length
        ny, nx = obst.shape[0] // length, obst.shape[1] // length
        d2 = dist_mod.edt2d(torch.as_tensor(obst, device=dev),
                            dcfg.max_sqdist, dcfg.radius_cells).cpu().numpy()
        dist = np.sqrt(d2).astype(np.float32) * resolution
        # pack non-trivial patches into the pool
        keys, blocks_d, blocks_o = [], [], []
        for py in range(ny):
            for px in range(nx):
                sl = np.s_[py * length:(py + 1) * length,
                           px * length:(px + 1) * length]
                if (d2[sl] < dcfg.max_sqdist).any():
                    cell = lo + np.array([px * length, py * length])
                    keys.append(int(geo.m2p(torch.as_tensor(cell))))
                    blocks_d.append(dist[sl])
                    blocks_o.append(obst[sl])
        if keys:
            table, slots = pool_mod.table_insert(
                state.table, torch.as_tensor(np.asarray(keys, np.int32)))
            for s_, bd, bo in zip(slots.tolist(), blocks_d, blocks_o):
                state.dist[s_] = torch.as_tensor(bd)
                state.obstacle[s_] = torch.as_tensor(bo)
            state = dist_mod.DistanceMapState(table, state.obstacle,
                                              state.dist)
        return _distance_state_to(state, dev), dcfg

def _distance_state_to(state, dev) -> dist_mod.DistanceMapState:
    return dist_mod.DistanceMapState(
        pool_mod.PatchTable(*(t.to(dev) for t in state.table)),
        state.obstacle.to(dev), state.dist.to(dev))


# the coarse fallback's throwaway field (graph_slam2d.cpp:357-392)
COARSE_RES = 0.25
COARSE_GEO = MapGeometry(COARSE_RES, 5, False)
COARSE_L2 = 2.5
COARSE_R = int(math.ceil(COARSE_L2 / COARSE_RES))


def coarse_side(cfg) -> int:
    """Side (cells) of the coarse fallback's square field."""
    return 2 * int(math.ceil((cfg.max_range + COARSE_L2 + 2.0) / COARSE_RES))


def coarse_obstacles(ref_poses, ref_pts, ref_msks, side: int):
    """The ref clouds (world frame via ``ref_poses`` [P, 4]) as obstacles
    on [P, side, side] grids of COARSE_RES cells centred at each ref pose.
    Returns (obstacles bool [P, side, side], origin cells int32 [P, 2])."""
    p = ref_poses.shape[0]
    hits = lie.se2_apply(ref_poses[:, None, :], ref_pts)
    org = COARSE_GEO.w2m(ref_poses[:, :2]) - side // 2
    loc = COARSE_GEO.w2m(hits) - org[:, None, :]
    ok = (ref_msks & (loc[..., 0] >= 0) & (loc[..., 0] < side) &
          (loc[..., 1] >= 0) & (loc[..., 1] < side))
    flat = (torch.clamp(loc[..., 1], 0, side - 1).long() * side
            + torch.clamp(loc[..., 0], 0, side - 1).long()
            + side * side * torch.arange(p, device=loc.device)[:, None])
    # obst.at[cells].max(ok): a cell is an obstacle iff some ok hit lands
    # there (integer adds: exact in any order)
    counts = torch.zeros(p * side * side, dtype=torch.int32,
                         device=loc.device)
    counts.index_add_(0, flat.reshape(-1), ok.reshape(-1).to(torch.int32))
    return (counts > 0).reshape(p, side, side), org


def _make_graph_kernels(cfg, kd: float, ka: float):
    """The three programs of the loop-closure machinery for one mapping
    config and gate: (correlate_batch, key_gate, coarse_batch)."""
    geo = cfg.geometry
    wp = cfg.window_patches
    max_dist = cfg.distance.max_dist

    def window_for(state, pose):
        org = win_mod.window_org(geo, geo.w2m(pose[:2]), wp)
        keys = win_mod.window_patch_keys(geo, org, wp)
        grid, _ = win_mod.gather_window(state.table, state.dist, keys,
                                        max_dist)
        return grid, org

    def rmse_window(grid, org, pts, msk, state):
        """Nearest-cell RMSE on the window (cells outside read max_dist)."""
        hits = lie.se2_apply(state, pts)
        loc = geo.w2m(hits) - org
        h = grid.shape[0]
        ok = ((loc[:, 0] >= 0) & (loc[:, 0] < h) &
              (loc[:, 1] >= 0) & (loc[:, 1] < h))
        d = torch.where(ok, grid[torch.clamp(loc[:, 1], 0, h - 1).long(),
                                 torch.clamp(loc[:, 0], 0, h - 1).long()],
                        torch.full_like(hits[:, 0], max_dist))
        d = d * msk.to(torch.float32)
        n = torch.clamp(msk.sum(), min=1)
        return torch.sqrt(torch.sum(d * d) / n)

    one_iter = SolverOptions(max_iterations=1, strategy="gn",
                             robust=HUBER_MATCH)
    full = SolverOptions(max_iterations=100, strategy="gn",
                         robust=HUBER_MATCH)

    def correlate(map_state, cand_pose, ref_xy_cand_rot, pts, msk):
        """graph_slam2d.cpp:315-355 dual-hypothesis verification."""
        g0, o0 = window_for(map_state, cand_pose)
        r0 = match.solve_window(g0, o0, geo, max_dist, pts, msk, cand_pose,
                                one_iter)
        e0 = rmse_window(g0, o0, pts, msk, r0.state)
        g1, o1 = window_for(map_state, ref_xy_cand_rot)
        r1 = match.solve_window(g1, o1, geo, max_dist, pts, msk,
                                ref_xy_cand_rot, one_iter)
        e1 = rmse_window(g1, o1, pts, msk, r1.state)
        take0 = e0 < e1
        init = torch.where(take0, r0.state, r1.state)
        grid = torch.where(take0, g0, g1)
        org = torch.where(take0, o0, o1)
        res = match.solve_window(grid, org, geo, max_dist, pts, msk, init,
                                 full)
        err = rmse_window(grid, org, pts, msk, res.state)
        return torch.cat([res.state, err[None]])

    def correlate_batch(map_state, cand_poses, hypos, pts, msks):
        """Every row's verification; packed [K, 5] = state + err (one host
        read at the harvest)."""
        return torch.stack([correlate(map_state, cand_poses[i], hypos[i],
                                      pts[i], msks[i])
                            for i in range(cand_poses.shape[0])])

    def key_gate(traj, k0, n, last_key):
        return key_scan(traj, k0, n, last_key, kd, ka)

    # ---- coarse fallback: throwaway 0.25 m field (cpp:357-392) ----------
    side = coarse_side(cfg)
    cmax = float(COARSE_R * COARSE_RES)

    def coarse_one(map_state, cgrid, org, cand_pose, pts, msk):
        r0 = match.solve_window(cgrid, org, COARSE_GEO, cmax, pts, msk,
                                cand_pose, full)
        # refine on the live map
        g1, o1 = window_for(map_state, r0.state)
        res = match.solve_window(g1, o1, geo, max_dist, pts, msk, r0.state,
                                 full)
        err = rmse_window(g1, o1, pts, msk, res.state)
        return torch.cat([res.state, err[None]])

    def coarse_batch(map_state, ref_poses, ref_pts, ref_msks, cand_poses,
                     ptss, msks):
        """``ref_*`` padded to COARSE_CHUNK rows (one launch of B3 on the
        batch's fields); the jobs are the first ``len(cand_poses)`` rows.
        Packed [n, 5] = state + err."""
        obst, orgs = coarse_obstacles(ref_poses, ref_pts, ref_msks, side)
        d2 = dist_mod.edt2d(obst, COARSE_R * COARSE_R, COARSE_R)
        cgrids = torch.sqrt(d2.to(torch.float32)) * COARSE_RES
        return torch.stack([coarse_one(map_state, cgrids[i], orgs[i],
                                       cand_poses[i], ptss[i], msks[i])
                            for i in range(cand_poses.shape[0])])

    return correlate_batch, key_gate, coarse_batch
