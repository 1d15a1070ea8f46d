"""The port's ``PFSlam2D``, driven as iris_lama_ros's ``pf_slam2d_ros``
node drives it: every scan goes to ``update(cloud, odometry, timestamp)``
(the driver's own gate turns most away), and after each integrated update
the node reads ``pose()``, the best particle's.

The filter's random numbers come from its own generator, seeded from the
run's seed (never 0, which would seed it from the clock).

The check follows the filter from its own state (see
``benchmark/reference/pf_slam2d.py``), so this node keeps copies of that
state on the card: after the first scan (the start), and before and after
a few updates of the window drawn from the seed, one of them an update
that re-organises the maps (its copy holds the patch pools too). The
copies are made between updates, after the pose read, and are device-side
clones: no host read.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from harness.trace import patch

# the patch-key packing of the program's maps (sdm/geometry.py): 15 bits an
# axis, the world origin at patch 2**14
KEY_BITS = 15
CENTER_PATCH = 1 << (KEY_BITS - 1)

SPANS = {
    "update": "iris_lama_tpu_torch.algos.pf_slam2d:PFSlam2D.update",
    "match": "iris_lama_tpu_torch.algos.pf_slam2d:match_phase",
    "map_update": "iris_lama_tpu_torch.sdm.mapping:resident_update",
    "reorg": "iris_lama_tpu_torch.algos.pf_slam2d:PFSlam2D._pf_maybe_reorg",
    "motion": "iris_lama_tpu_torch.algos.pf_slam2d:PFSlam2D._flush_motion",
    "resample": "iris_lama_tpu_torch.algos.pf_slam2d:weights_and_resample",
}

B6 = "iris_lama_tpu_torch.ops.gn_batch:solve_window_sq"
REORG_LEAD_M = 0.6     # copy the pools once this near the re-org trigger


def pf_seed(seed: int) -> int:
    """The filter's seed from the run's: never 0."""
    return 1 + seed % (2 ** 62)


def _options(config: dict, seed: int):
    from iris_lama_tpu_torch.algos.pf_slam2d import PFSlam2DOptions
    return PFSlam2DOptions(**config["options"], seed=pf_seed(seed),
                           max_range=float(config["sensor"]["max_range_m"]))


def _clone_state(pset, pools: bool) -> dict:
    snap = {k: getattr(pset, k).clone() for k in
            ("pose", "weight", "weight_sum", "lineage", "res_org",
             "res_occ", "res_vis", "res_dist")}
    if pools:
        snap["table_keys"] = pset.maps.table.keys.clone()
        snap["table_slots"] = pset.maps.table.slots.clone()
        snap["pool_occ"] = pset.maps.occupied.clone()
        snap["pool_vis"] = pset.maps.visited.clone()
        snap["pool_dist"] = pset.maps.dist.clone()
    return snap


def _small(snap: dict) -> dict:
    return {k: snap[k] for k in ("pose", "weight", "weight_sum", "lineage")}


def _judged(a, b, lo, w: int, pools: bool) -> tuple:
    """(y0, x0, h, w) in the region of the cells the check judges after
    the update: the resident window after it, less, where the copy before
    holds no pools, what lay outside the window before it."""
    x0, y0 = b[0], b[1]
    x1, y1 = b[0] + w, b[1] + w
    if not pools:
        x0, y0 = max(x0, a[0]), max(y0, a[1])
        x1, y1 = min(x1, a[0] + w), min(y1, a[1] + w)
    return (y0 - lo[1], x0 - lo[0], y1 - y0, x1 - x0)


def _dense(snap: dict, org, lo, shape, geo, max_sq: int) -> dict:
    """Every particle's counts and capped squared distance ``[N, h, w]``
    over the patch-aligned region at world cell ``lo``: its pool (particle
    ``i``'s is pool ``lineage[i]``) where the copy holds the pools, its
    resident grids (at world cell ``org``) over them."""
    n = snap["pose"].shape[0]
    dev = snap["pose"].device
    h, w = shape
    length = geo.patch_length
    occ = torch.zeros((n, h, w), dtype=torch.int32, device=dev)
    vis = torch.zeros_like(occ)
    d2 = torch.full_like(occ, max_sq)
    if "table_keys" in snap:
        src = snap["lineage"].long()
        keys = snap["table_keys"][src]                     # [n, H]
        slots = snap["table_slots"][src]
        part = torch.arange(n, device=dev)[:, None].expand_as(keys)
        px = (keys >> KEY_BITS) - CENTER_PATCH - lo[0] // length
        py = (keys & ((1 << KEY_BITS) - 1)) - CENTER_PATCH - lo[1] // length
        hp, wp = h // length, w // length
        ok = (keys >= 0) & (px >= 0) & (px < wp) & (py >= 0) & (py < hp)
        i, s_, y, x = (t[ok].long() for t in (part, slots, py, px))
        sp = src[i]
        dist = snap["pool_dist"][sp, s_].double() * geo.scale
        for grid, val in ((occ, snap["pool_occ"][sp, s_]),
                          (vis, snap["pool_vis"][sp, s_]),
                          (d2, torch.round(dist * dist).clamp(max=max_sq))):
            view = grid.view(n, hp, length, wp, length).permute(0, 1, 3, 2, 4)
            view[i, y, x] = val.to(torch.int32)
    wr = snap["res_occ"].shape[-1]
    ys = slice(org[1] - lo[1], org[1] - lo[1] + wr)
    xs = slice(org[0] - lo[0], org[0] - lo[0] + wr)
    occ[:, ys, xs] = snap["res_occ"]
    vis[:, ys, xs] = snap["res_vis"]
    d2[:, ys, xs] = snap["res_dist"].to(torch.int32)
    return {"occ": occ, "vis": vis, "d2": d2}


class Node:
    """One robot's node around the program's driver."""

    def __init__(self, config: dict, seed: int, device, prior_xyr):
        from iris_lama_tpu_torch.algos.pf_slam2d import PFSlam2D
        from iris_lama_tpu_torch.core.pose import Pose2D
        self.Pose2D = Pose2D
        self.opts = _options(config, seed)
        self.pf = PFSlam2D(self.opts, device=device)
        self.pf.set_prior(Pose2D(*prior_xyr))
        check = config["check"]
        rng = np.random.default_rng([seed, 0xF11])
        self.sampled = set(rng.choice(np.arange(1, check["sample_from"]),
                                      size=check["samples"],
                                      replace=False).tolist())
        cfg = self.opts.mapping_config()
        cells = (cfg.resident_window_cells // 2 - cfg.resident_margin_cells
                 - cfg.geometry.patch_length)
        self.trigger_m = cells * cfg.geometry.resolution \
            - self.opts.host_reorg_slack
        self.start = None          # the state after the first scan
        self.samples = []          # {"ordinal", "pre", "post", "reorg"}
        self._pre = None           # (ordinal, copy) awaiting its update
        self._want_reorg = check.get("reorg_samples", 0) > 0
        self._reorgs = 0
        self._reorged = False
        self._odom = None          # odometry of the last integrated update
        self._odom_reorg = None    # odometry of the last re-org's update

    @staticmethod
    def cloud(points: np.ndarray):
        from iris_lama_tpu_torch.utils.cloud import PointCloudXYZ
        return PointCloudXYZ(points)

    def odometry(self, xyr):
        self._last_odom = tuple(xyr)
        return self.Pose2D(*xyr)

    def update(self, cloud, odom, ts) -> bool:
        ok = self.pf.update(cloud, odom, ts)
        if ok:
            self._odom = self._last_odom
            self._reorged = self.pf.n_reorgs != self._reorgs
            self._reorgs = self.pf.n_reorgs
            if self._reorged or self.start is None:
                self._odom_reorg = self._odom
            if self.start is None:
                self.start = _clone_state(self.pf.pset, False)
        return ok

    def pose(self) -> tuple:
        return tuple(self.pf.pose().xyr())

    def reorgs(self) -> int:
        return self.pf.n_reorgs

    def observe(self, ordinal: int) -> None:
        """After window update ``ordinal`` (and its pose read): keep the
        copy after it when it was awaited, and copy the state before the
        next when that one is sampled or may re-organise."""
        pf = self.pf
        reorged = self._reorged
        if self._pre is not None:
            pre_ord, pre, sampled = self._pre
            self._pre = None
            if pre_ord == ordinal and (sampled or reorged):
                self.samples.append({"ordinal": ordinal, "pre": pre,
                                     "post": _clone_state(pf.pset, False),
                                     "reorg": reorged})
                if reorged:
                    self._want_reorg = False
        nxt = ordinal + 1
        travel = math.hypot(self._odom[0] - self._odom_reorg[0],
                            self._odom[1] - self._odom_reorg[1])
        near = self._want_reorg and travel >= self.trigger_m - REORG_LEAD_M
        if nxt in self.sampled or near:
            self._pre = (nxt, _clone_state(pf.pset, near),
                         nxt in self.sampled)

    def kernel_calls(self, lap, updates: list) -> dict:
        """Shapes of one call of each hand-written kernel on this path,
        with the cells and beams that ``updates``' scans need (their
        valid beams, not the padded ones)."""
        from harness.traffic import scan_cells
        cfg = self.opts.mapping_config()
        hits, free = scan_cells([lap.points[u.scan] for u in updates],
                                [u.pose for u in updates],
                                cfg.geometry.resolution)
        p = self.opts.particles
        wu = cfg.resident_update_cells
        ws = cfg.match_window_cells
        calls = {
            "deposit_kernel": {"particles": p, "hits": hits, "free": free,
                               "h": wu, "w": wu},
            "edt_tile": {"particles": p, "h": wu, "w": wu,
                         "radius": cfg.distance.radius_cells},
        }
        evals = self.mean_evals()
        if evals is not None:
            # B6: every particle's window, and the evaluations of the
            # traced window's calls (their mean)
            calls["gn_solve_kernel"] = {"particles": p, "h": ws, "w": ws,
                                        "itemsize": 1, "beams": hits,
                                        "evals": evals}
        return calls

    def start_trace(self) -> None:
        """Keep the iteration counts B6 returns (device tensors, no host
        read) while the window is traced."""
        self._iters = []

        def make(solve):
            def counted(*a, **kw):
                out = solve(*a, **kw)
                self._iters.append(out[1])
                return out
            return counted

        self._untrace = patch(B6, make)

    def stop_trace(self) -> None:
        self._untrace()

    def mean_evals(self):
        """Evaluations of a B6 call in the traced window: each particle's
        start, its steps and its likelihood; None untraced."""
        its = getattr(self, "_iters", None)
        if not its:
            return None
        total = sum(int(it.sum()) for it in its)
        return (total + 2 * self.opts.particles * len(its)) / len(its)

    def outputs(self) -> dict:
        """The copies the check follows the filter from, as dense grids in
        world cells (the world origin at cell (0, 0)), and the filter's
        seed. The copies are dropped as they are decoded."""
        cfg = self.opts.mapping_config()
        geo = cfg.geometry
        length = geo.patch_length
        offset = CENTER_PATCH * length
        max_sq = cfg.distance.max_sqdist
        w = cfg.resident_window_cells
        start, self.start = self.start, None
        org = [int(v) - offset for v in start["res_org"].tolist()]
        out = {"seed": self.opts.seed, "window": w,
               "start": {"origin": tuple(org),
                         "occ": start["res_occ"], "vis": start["res_vis"],
                         "d2": start["res_dist"].to(torch.int32)},
               "samples": []}
        while self.samples:
            smp = self.samples.pop(0)
            pre, post = smp["pre"], smp["post"]
            a = [int(v) - offset for v in pre["res_org"].tolist()]
            b = [int(v) - offset for v in post["res_org"].tolist()]
            lo = (min(a[0], b[0]), min(a[1], b[1]))
            shape = (max(a[1], b[1]) + w - lo[1], max(a[0], b[0]) + w - lo[0])
            out["samples"].append({
                "ordinal": smp["ordinal"], "reorg": smp["reorg"],
                "origin": lo,
                "pre": {**_small(pre), **_dense(pre, a, lo, shape, geo,
                                                max_sq)},
                "post": {**_small(post), **_dense(post, b, lo, shape, geo,
                                                  max_sq),
                         "window": _judged(a, b, lo, w, "table_keys" in pre)}})
        return out


# faults planted in the program to show that the check fails them (see
# ``benchmark/calibrate.py`` and ``benchmark/tests``); each returns a
# function that takes it out again

def _unchanged(_step):
    def step(self, *a, **kw):
        return None          # the update leaves particles and maps as were
    return step


def _half_particles(match_phase):
    def match(opts, pset, points, mask):
        states, liks, iters = match_phase(opts, pset, points, mask)
        h = states.shape[0] // 2
        states = torch.cat([states[:h], pset.pose[h:]])  # half unmatched
        liks = torch.cat([liks[:h],
                          liks[:h].mean().expand(liks.shape[0] - h)])
        return states, liks, iters
    return match


def _altered(match_phase):
    def match(opts, pset, points, mask):
        states, liks, iters = match_phase(opts, pset, points, mask)
        states = states.clone()
        states[:, 0] += 0.005   # every matched pose moved 5 mm where made
        return states, liks, iters
    return match


FAULTS = {
    "state_unchanged": lambda: patch(
        "iris_lama_tpu_torch.algos.pf_slam2d:PFSlam2D._step", _unchanged),
    "half_batch": lambda: patch(
        "iris_lama_tpu_torch.algos.pf_slam2d:match_phase", _half_particles),
    "answer_altered": lambda: patch(
        "iris_lama_tpu_torch.algos.pf_slam2d:match_phase", _altered),
}
