"""The port's ``Slam2D``, driven as iris_lama_ros's ``slam2d_ros`` node
drives it: ``update(cloud, odometry, timestamp)`` with the sensor's
``PointCloudXYZ`` and the odometry ``Pose2D``, then ``pose()``.

The functions wrapped in spans in a traced run (``SPANS``), the shapes of
the hand-written kernels' calls on this path (:meth:`Node.kernel_calls`),
and the program's outputs that the check judges (:meth:`Node.outputs`:
the published poses are kept by the harness; the map comes from the
driver's public ``map``, decoded from its patch pool by :func:`decode_map`).
"""

from __future__ import annotations

import numpy as np

from harness.trace import patch

SPANS = {
    "update": "iris_lama_tpu_torch.algos.slam2d:Slam2D.update",
    "match": "iris_lama_tpu_torch.match.match_surface_2d:solve_window",
    "map_update": "iris_lama_tpu_torch.sdm.mapping:resident_update",
    "reorg": "iris_lama_tpu_torch.algos.slam2d:Slam2D._maybe_reorg",
}

# the patch-key packing of the program's maps (sdm/geometry.py): 15 bits an
# axis, the world origin at patch 2**14
KEY_BITS = 15
CENTER_PATCH = 1 << (KEY_BITS - 1)


def _options(config: dict):
    from iris_lama_tpu_torch.algos.slam2d import Slam2DOptions
    return Slam2DOptions(**config["options"],
                         max_range=float(config["sensor"]["max_range_m"]))


class Node:
    """One robot's node around the program's driver."""

    def __init__(self, config: dict, seed: int, device, prior_xyr):
        from iris_lama_tpu_torch.algos.slam2d import Slam2D
        from iris_lama_tpu_torch.core.pose import Pose2D
        self.Pose2D = Pose2D
        self.opts = _options(config)
        self.slam = Slam2D(self.opts, device=device)
        self.slam.set_prior(Pose2D(*prior_xyr))

    @staticmethod
    def cloud(points: np.ndarray):
        from iris_lama_tpu_torch.utils.cloud import PointCloudXYZ
        return PointCloudXYZ(points)

    def odometry(self, xyr):
        return self.Pose2D(*xyr)

    def update(self, cloud, odom, ts) -> bool:
        return self.slam.update(cloud, odom, ts)

    def pose(self) -> tuple:
        """The published pose (x, y, theta): the one read of the matched
        pose that ``Slam2D.pose()`` makes, kept as the driver holds it
        (``tx, ty, cos, sin`` in float32, whose cosine and sine drift off
        the unit circle by rounding) so that the check rebuilds the map
        at the very poses the program used."""
        raw = self.slam._pose_dev.cpu().numpy()
        self.last_raw = tuple(float(v) for v in raw)
        return tuple(self.Pose2D.from_se2_array(raw).xyr())

    def reorgs(self) -> int:
        return self.slam.n_reorgs

    def kernel_calls(self, lap, updates: list) -> dict:
        """Shapes of one call of each hand-written kernel on this path,
        with the cells and beams that ``updates``' scans need (their
        valid beams, not the padded ones)."""
        from harness.traffic import scan_cells
        cfg = self.opts.mapping_config()
        hits, free = scan_cells([lap.points[u.scan] for u in updates],
                                [u.pose for u in updates],
                                cfg.geometry.resolution)
        wu = cfg.resident_update_cells
        return {
            # B1 pair: the scan's hit and free-cell streams into [2, wu, wu]
            "deposit_kernel": {"particles": 1, "hits": hits, "free": free,
                               "h": wu, "w": wu},
            # B2: four corners a beam, one call an evaluation
            "select4_kernel": {"beams": hits, "itemsize": 1},
            # B3: the update window's capped EDT
            "edt_tile": {"particles": 1, "h": wu, "w": wu,
                         "radius": cfg.distance.radius_cells},
        }

    def outputs(self) -> dict:
        """What the check judges besides the poses: the whole map, and the
        updates that ran outside the resident window's safe zone."""
        cfg = self.opts.mapping_config()
        return {"map": decode_map(self.slam.map, cfg.geometry.log2dim,
                                  cfg.geometry.scale,
                                  cfg.distance.max_sqdist),
                "escaped": self.slam.escaped_count()}


def decode_map(state, log2dim: int, scale: float, max_sqdist: int) -> dict:
    """A patch-pool map (``SlamMapState``: the hash table's keys and slots,
    cell arrays ``[P + 1, L, L]``) as dense host grids ``[y, x]`` over the
    patches it holds: hit and visit counts, the capped squared cell
    distance, and the cell (x, y) of grid [0, 0] with the world origin at
    cell (0, 0)."""
    keys = state.table.keys.cpu().numpy()
    slots = state.table.slots.cpu().numpy()
    live = keys >= 0
    keys, slots = keys[live].astype(np.int64), slots[live].astype(np.int64)
    length = 1 << log2dim
    px = (keys >> KEY_BITS) - CENTER_PATCH
    py = (keys & ((1 << KEY_BITS) - 1)) - CENTER_PATCH
    if len(keys) == 0:
        raise ValueError("the map holds no patch")
    x0, y0 = int(px.min()), int(py.min())
    h = (int(py.max()) - y0 + 1) * length
    w = (int(px.max()) - x0 + 1) * length
    occ = np.zeros((h, w), np.int64)
    vis = np.zeros((h, w), np.int64)
    d2 = np.full((h, w), max_sqdist, np.int64)
    o = state.occupied.cpu().numpy()
    v = state.visited.cpu().numpy()
    dm = state.dist.cpu().numpy().astype(np.float64) * scale
    for kx, ky, s in zip(px - x0, py - y0, slots):
        ys = slice(ky * length, (ky + 1) * length)
        xs = slice(kx * length, (kx + 1) * length)
        occ[ys, xs] = o[s]
        vis[ys, xs] = v[s]
        d2[ys, xs] = np.rint(dm[s] * dm[s])
    return {"origin": (x0 * length, y0 * length), "occ": occ, "vis": vis,
            "d2": np.minimum(d2, max_sqdist)}


# faults planted in the program to show that the check fails them (see
# ``benchmark/calibrate.py`` and ``benchmark/tests``); each returns a
# function that takes it out again

def _unchanged(_step):
    def step(self, *a, **kw):
        return None          # the update returns with pose and map as were
    return step


def _half_beams(pad_scan):
    def pad(cloud, max_beams):
        points, mask, origin = pad_scan(cloud, max_beams)
        mask = mask.copy()
        mask[1::2] = False   # every other beam left out of match and map
        return points, mask, origin
    return pad


def _altered(solve_window):
    def solve(*a, **kw):
        res = solve_window(*a, **kw)
        state = res.state.clone()
        state[0] += 0.005    # the matched pose moved 5 mm where it is made
        return res._replace(state=state)
    return solve


FAULTS = {
    "state_unchanged": lambda: patch(
        "iris_lama_tpu_torch.algos.slam2d:Slam2D._do_step", _unchanged),
    "half_batch": lambda: patch(
        "iris_lama_tpu_torch.algos.slam2d:pad_scan", _half_beams),
    "answer_altered": lambda: patch(
        "iris_lama_tpu_torch.match.match_surface_2d:solve_window", _altered),
}
