"""The port's ``GraphSlam2D``, driven as a mapping node drives it: every
scan goes to ``update(cloud, odometry, timestamp)``, the node reads the
pose after each integrated update, and every ``publish_every_updates``
integrated updates it publishes the map (``generate_occupancy_map()``,
timed as part of that update).

The check (``benchmark/reference/graph_slam2d.py``) follows the program
from its own state. The node keeps what it needs, all of it small host
data the program hands over anyway, except where a sample is drawn:

- the program's record (``GraphSlam2D.observer``): every key pose, factor,
  verification and coarse batch dispatched, batch harvested and
  optimisation, in order, each tagged with the update it happened in, and
  each publication, with the last one's map;
- at sampled updates of the window, a copy on the card of the front end's
  resident distance window before the update;
- the pool as the verification or the coarse fallback read it: the sync
  round is an update's last step, so after an update that dispatched
  either, the pool is the one they read. Once the window has passed a
  number of such updates drawn from the seed, the node copies it on the
  card between updates, while it still lacks ``verify_samples`` (or
  ``coarse_samples``) copies whose rows decide, and keeps the copies of
  rows that decide (an RMSE within the coarse acceptance, 2 x 0.05 m, by
  the program's own harvest) first.

Once the window has closed, the node asks the program for one more
optimisation (``optimize_pose_graph``, which drains it first), so that the
check judges one even in a window that held none.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from harness import spec
from harness.trace import patch

GRAPH = "iris_lama_tpu_torch.algos.graph_slam2d"
KINDS = ("verify", "coarse")

SPANS = {
    "update": f"{GRAPH}:GraphSlam2D.update",
    # the front end's own match (the verification and the coarse fallback
    # call ``match_surface_2d.solve_window`` too)
    "match": "iris_lama_tpu_torch.algos.slam2d:Slam2D._match",
    "map_update": "iris_lama_tpu_torch.sdm.mapping:resident_update",
    "reorg": "iris_lama_tpu_torch.algos.slam2d:Slam2D._maybe_reorg",
    "close_loops": f"{GRAPH}:GraphSlam2D._dispatch_verification",
    "harvest": f"{GRAPH}:GraphSlam2D._process_pending",
    "find_candidates": f"{GRAPH}:GraphSlam2D._find_candidates",
    "optimize": f"{GRAPH}:GraphSlam2D._optimize",
    "publish": f"{GRAPH}:GraphSlam2D.generate_occupancy_map",
}


def _options(config: dict):
    from iris_lama_tpu_torch.algos.graph_slam2d import GraphSlam2DOptions
    from iris_lama_tpu_torch.algos.slam2d import Slam2DOptions
    slam = Slam2DOptions(**config["front_end"],
                         max_range=float(config["sensor"]["max_range_m"]))
    return GraphSlam2DOptions(slam=slam, **config["options"])


def _draw(seed: int, tag: int, n: int, upto: int) -> set:
    """``n`` distinct integers of ``[0, upto)`` drawn from the seed."""
    rng = np.random.default_rng([seed, tag])
    return set(rng.choice(np.arange(upto), size=min(n, upto),
                          replace=False).tolist())


def _rows(rows) -> list:
    """(query, candidate, ref, cand) rows with the poses as (x, y, theta)."""
    return [(int(q), int(c), tuple(r.xyr()), tuple(p.xyr()))
            for q, c, r, p in rows]


class Node:
    """One robot's mapping node around the program's driver."""

    def __init__(self, config: dict, seed: int, device, prior_xyr):
        from iris_lama_tpu_torch.algos.graph_slam2d import GraphSlam2D
        from iris_lama_tpu_torch.core.pose import Pose2D
        self.Pose2D = Pose2D
        self.opts = _options(config)
        self.g = GraphSlam2D(self.opts, device=device)
        if not hasattr(self.g, "observer"):
            raise RuntimeError("this GraphSlam2D keeps no record of its "
                               "loop closure: the check cannot follow it")
        self.g.set_prior(Pose2D(*prior_xyr))
        self.g.observer = self._on_event
        self.every = int(config["publish_every_updates"])
        check = config["check"]
        # front-end samples: window ordinals
        self.sampled = {o + 1 for o in _draw(seed, 0x6A1, check["samples"],
                                             check["sample_from"] - 1)}
        self.deciding = 2.0 * config["options"]["loop_closure_scan_rmse"]
        rng = np.random.default_rng([seed, 0x6A2])
        self.n_kept = {"verify": check["verify_samples"],
                       "coarse": check["coarse_samples"]}
        self.skip = {k: int(rng.integers(check[k + "_from"])) for k in KINDS}
        self.seen = {k: 0 for k in KINDS}   # window batches with rows
        self.kept = {k: [] for k in KINDS}  # complete samples
        self._to_copy = []                  # samples awaiting their copy
        self._open = []                     # samples awaiting results
        self.journal = []
        self.front = []                # {"ordinal", "org", "d2"}
        self._pre = None               # (ordinal, reorgs, org, d2)
        self._xy = []                  # key positions, as the search sees
        self.n_updates = 0
        self.at = 0                    # the update the program is in
        self.in_window = False
        self.last_raw = None
        self.published = None          # the last publication's map
        self._iters = None             # front-end iterations, traced

    @staticmethod
    def cloud(points: np.ndarray):
        from iris_lama_tpu_torch.utils.cloud import PointCloudXYZ
        return PointCloudXYZ(points)

    def odometry(self, xyr):
        return self.Pose2D(*xyr)

    # -- the node --------------------------------------------------------
    def update(self, cloud, odom, ts) -> bool:
        self.at = self.n_updates
        if not self.g.update(cloud, odom, ts):
            return False
        self.n_updates += 1
        if self._iters is not None:
            self._iters.append(self.g.slam.last_iterations)
        if self.n_updates % self.every == 0:
            self.published = None
            self.published = self.g.generate_occupancy_map()
            self._log("publish", {})
        return True

    def pose(self) -> tuple:
        """The published pose (x, y, theta): ``GraphSlam2D.pose()``, the
        correction on top of the front end's pose, whose one read the node
        also keeps as the program holds it (``tx, ty, cos, sin`` in
        float32) for the check."""
        self.last_raw = tuple(float(v) for v in self.g.slam.pose_se2())
        return tuple(self.g.pose().xyr())

    def reorgs(self) -> int:
        return self.g.slam.n_reorgs

    def observe(self, ordinal: int) -> None:
        """After window update ``ordinal``, between updates: keep the front
        end's window copy made before it (unless the update re-organised
        the window before its match: then the next update is sampled
        instead), copy the window when the next update is sampled, and
        copy the pool for the samples this update dispatched."""
        self.in_window = True
        slam = self.g.slam
        if self._pre is not None:
            pre_ord, reorgs, org, d2 = self._pre
            self._pre = None
            if slam.n_reorgs != reorgs:
                self.sampled.add(ordinal + 1)
            else:
                self.front.append({"ordinal": pre_ord, "org": org, "d2": d2})
        if ordinal + 1 in self.sampled:
            org, d2 = slam.resident_window()
            self._pre = (ordinal + 1, slam.n_reorgs, org.clone(), d2.clone())
        if self._to_copy:
            m = slam.map         # flushed by the dispatch: as it was read
            copy = {"keys": m.table.keys.clone(),
                    "slots": m.table.slots.clone(), "dist": m.dist.clone()}
            for smp in self._to_copy:
                smp["map"] = copy
                self._settle(smp)
            self._to_copy = []

    # -- the program's record ---------------------------------------------
    def _log(self, event: str, rec: dict) -> None:
        rec.update(event=event, at=self.at, window=self.in_window)
        self.journal.append(rec)

    def _on_event(self, event: str, f: dict) -> None:
        if event == "key":
            self._xy.append(f["pose"].xy())
            rec = {"id": f["id"], "ts": f["timestamp"],
                   "pose": tuple(f["pose"].xyr()),
                   "raw": tuple(f["raw"].xyr())}
        elif event == "factor":
            rec = {"i": f["i"], "j": f["j"], "loop": f["loop"],
                   "m": np.array(f["measurement"], np.float64)}
        elif event == "dispatch":
            rec = {"queries": list(f["queries"]), "accdist": f["accdist"],
                   "xy": np.array(self._xy).reshape(-1, 2),
                   "rows": _rows(f["rows"])}
            self._offer("verify", rec["rows"])
        elif event == "coarse":
            rec = {"jobs": _rows(f["jobs"])}
            self._offer("coarse", rec["jobs"])
        elif event == "harvest":
            rec = {"kind": f["kind"], "pairs": list(f["pairs"]),
                   "packed": f["packed"]}
            self._harvest(rec)
        elif event == "optimize":
            out = f["out"]
            rec = {"start": np.array(f["start"]),
                   "out": None if out is None else np.array(out)}
            if out is not None:
                self._xy = list(rec["out"][:, :2].astype(np.float64))
        else:
            return
        self._log(event, rec)

    # -- the pool samples -------------------------------------------------
    def _offer(self, kind: str, rows: list) -> None:
        """A batch of ``kind`` with ``rows`` was dispatched: sample it
        when it is in the window, past the drawn skip, and the kept copies
        do not all decide yet."""
        if not rows or self.in_window is not True:
            return
        self.seen[kind] += 1
        kept = self.kept[kind]
        full = (len(kept) >= self.n_kept[kind]
                and all(s["deciding"] for s in kept))
        if self.seen[kind] <= self.skip[kind] or full:
            return
        smp = {"kind": kind, "rows": rows, "map": None,
               "errs": {(q, c): None for q, c, _, _ in rows}}
        self._to_copy.append(smp)
        self._open.append(smp)

    def _harvest(self, rec: dict) -> None:
        for smp in list(self._open):
            if smp["kind"] != rec["kind"]:
                continue
            for (q, c), row in zip(rec["pairs"], rec["packed"]):
                if (q, c) in smp["errs"]:
                    smp["errs"][(q, c)] = float(row[4])
            self._settle(smp)

    def _settle(self, smp: dict) -> None:
        """Keep a sample once it has its copy and every row's result: in a
        free place, or in the place of a kept one whose rows do not decide
        when its own do; else drop it."""
        errs = list(smp["errs"].values())
        if smp["map"] is None or None in errs:
            return
        self._open.remove(smp)
        smp["deciding"] = min(errs) <= self.deciding
        kept = self.kept[smp["kind"]]
        if len(kept) < self.n_kept[smp["kind"]]:
            kept.append(smp)
            return
        for i, other in enumerate(kept):
            if smp["deciding"] and not other["deciding"]:
                kept[i] = smp
                return

    def start_trace(self) -> None:
        """Keep the front end's iteration counts (device tensors, no host
        read) while the window is traced."""
        self._iters = []

    def stop_trace(self) -> None:
        self._its, self._iters = self._iters, None

    def kernel_calls(self, lap, updates: list) -> dict:
        """B4, the front end's whole match in one launch on Slam2D's
        ``[488, 488]`` int8 sub-window, with the valid beams of
        ``updates``' scans and the evaluations of the traced window's
        matches (their mean: the start and each step's). B1's pair and B3
        are not named: they run here at the front end's, the rebuild's and
        the coarse fallback's shapes, and the reader takes one shape a
        kernel."""
        from harness.traffic import scan_cells
        its = getattr(self, "_its", None)
        if not its or self.g.slam.match_route != "solve":
            return {}
        cfg = self.opts.slam.mapping_config()
        hits, _ = scan_cells([lap.points[u.scan] for u in updates],
                             [u.pose for u in updates],
                             cfg.geometry.resolution)
        evals = 1.0 + sum(int(i.sum()) for i in its) / len(its)
        ws = cfg.match_window_cells
        return {"gn_solve_kernel": {"particles": 1, "h": ws, "w": ws,
                                    "itemsize": 1, "beams": hits,
                                    "evals": evals}}

    def outputs(self) -> dict:
        """What the check follows the program from (see the module
        docstring), on the host, once the window has closed."""
        self.in_window = "after"
        self.at = self.n_updates
        self.g.optimize_pose_graph()
        cfg = self.opts.slam.mapping_config()
        geo = cfg.geometry
        offset = geo.cell_offset
        decode = spec.load_module("drivers", "slam2d").decode_map
        journal, self.journal = self.journal, []
        last = [r for r in journal if r["event"] == "publish"][-1:]
        if last:
            last[0]["map"] = decode(self.published, geo.log2dim, geo.scale,
                                    cfg.distance.max_sqdist)
        self.published = None
        samples = {}
        for kind in KINDS:
            samples[kind] = [
                {"rows": s["rows"], "errs": [s["errs"][r[:2]]
                                             for r in s["rows"]],
                 "map": _decode_dist(s["map"], geo, offset,
                                     cfg.distance.max_sqdist)}
                for s in self.kept[kind]]
        front = [{"ordinal": f["ordinal"],
                  "origin": tuple(int(v) - offset
                                  for v in f["org"].tolist()),
                  "d2": f["d2"].long()}
                 for f in self.front]
        return {"journal": journal, "samples": samples, "front": front}


def _decode_dist(snap: dict, geo, offset: int, max_sq: int) -> dict:
    """A pool copy's capped squared distances as one dense grid ``[y, x]``
    over the patches it holds, with the world cell of grid [0, 0]."""
    import torch
    from iris_lama_tpu_torch.sdm.geometry import PKEY_BITS
    keys = snap["keys"]
    live = keys >= 0
    keys, slots = keys[live].long(), snap["slots"][live].long()
    length = geo.patch_length
    px = (keys >> PKEY_BITS) - (offset >> geo.log2dim)
    py = (keys & ((1 << PKEY_BITS) - 1)) - (offset >> geo.log2dim)
    x0, y0 = int(px.min()), int(py.min())
    hp, wp = int(py.max()) - y0 + 1, int(px.max()) - x0 + 1
    dist = snap["dist"][slots].double() * geo.scale
    d2 = torch.round(dist * dist).clamp(max=max_sq).to(torch.int64)
    grid = torch.full((hp, wp, length, length), max_sq, dtype=torch.int64,
                      device=d2.device)
    grid[py - y0, px - x0] = d2
    return {"origin": (x0 * length, y0 * length),
            "d2": grid.permute(0, 2, 1, 3).reshape(hp * length,
                                                   wp * length)}


# faults planted in the program to show that the check fails them (see
# ``benchmark/calibrate.py``); each returns a function that takes it out
# again

def _loop_dropped(accept):
    state = {"done": False}

    def wrapped(self, *a, **kw):
        if not state["done"]:
            state["done"] = True
            return None          # the first accepted loop factor left out
        return accept(self, *a, **kw)
    return wrapped


def _candidate_skipped(find):
    state = {"done": False}

    def wrapped(self, *a, **kw):
        out = find(self, *a, **kw)
        if out and not state["done"]:
            state["done"] = True
            return out[:-1]      # the farthest candidate left out
        return out
    return wrapped


def _key_moved(create):
    def wrapped(self, k_idx, raw):
        if len(self._key_poses) == 3:    # the fourth key pose
            raw = type(raw)(raw.x() + 0.005, raw.y(), raw.rotation())
        return create(self, k_idx, raw)
    return wrapped


def _one_step(optimize):
    def wrapped(nodes, graph, active, opts=None):
        from iris_lama_tpu_torch.nlls.factor_graph import PGOOptions
        opts = dataclasses.replace(opts or PGOOptions(), max_iterations=1)
        return optimize(nodes, graph, active, opts)
    return wrapped


def _loop_inverted(add_between):
    def wrapped(self, i, j, meas, sigmas, huber_k=0.0):
        if huber_k > 0.0:        # a loop factor, measured the wrong way
            tx, ty, c, s = (float(v) for v in meas)
            meas = np.array([-(c * tx + s * ty), s * tx - c * ty, c, -s],
                            np.float32)
        return add_between(self, i, j, meas, sigmas, huber_k)
    return wrapped


def _coarse_shifted(obstacles):
    def wrapped(*a, **kw):
        obst, org = obstacles(*a, **kw)
        return obst, org + 4     # the coarse field read 1 m off
    return wrapped


FAULTS = {
    "loop_dropped": lambda: patch(f"{GRAPH}:GraphSlam2D._accept",
                                  _loop_dropped),
    "candidate_skipped": lambda: patch(
        f"{GRAPH}:GraphSlam2D._find_candidates", _candidate_skipped),
    "key_moved": lambda: patch(f"{GRAPH}:GraphSlam2D._create_key",
                               _key_moved),
    "lm_one_step": lambda: patch(
        "iris_lama_tpu_torch.nlls.factor_graph:optimize", _one_step),
    "loop_inverted": lambda: patch(
        "iris_lama_tpu_torch.nlls.factor_graph:GraphBuilder.add_between",
        _loop_inverted),
    "coarse_shifted": lambda: patch(f"{GRAPH}:coarse_obstacles",
                                    _coarse_shifted),
}
