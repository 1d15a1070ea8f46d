"""The port's LidarOdometry2D against the JAX package's, on the CPU.

Config of tests/test_lidar_odometry.py::test_transient_map_prunes_patches
(0.1 m cells, 16-cell patches, 6 m beams, 120 beams padded to 128). One JAX
run of 40 scans is shared by the module: poses, refresh decisions and
patch counts per scan, and its state after scan 20.

Tolerances: poses within 1e-4 m / 1e-4 rad (the two sum the normal
equations in other orders, and XLA fuses multiply-adds); refresh decisions
and patch counts equal; from one carried-across state, pool tables,
visits and distances bit-equal and log-odds within 4e-6
(tests/test_torch_transient.py states why).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iris_lama_tpu.algos.lidar_odometry_2d import LidarOdometry2D as JLO
from iris_lama_tpu.algos.lidar_odometry_2d import (
    LidarOdometry2DOptions as JOptions)
from iris_lama_tpu.core.pose import Pose2D as JPose2D
from iris_lama_tpu.utils import simulator as jsim
from iris_lama_tpu.utils.cloud import beam_bucket, pad_scan

from iris_lama_tpu_torch.algos.lidar_odometry_2d import (
    LidarOdometry2D, LidarOdometry2DOptions)
from iris_lama_tpu_torch.core.pose import Pose2D
from iris_lama_tpu_torch.utils import simulator, state as tstate

N_SCANS = 40
AT = 20                # the scan whose state is carried across
OPTS = dict(resolution=0.1, patch_size=16, max_range=6.0, capacity=2048)
POSE_TOL = 1e-4
LO_ATOL = 4e-6
TABLE = ("keys", "slots", "free_slots", "n_free", "overflow")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's CPU paths make many small tensor ops; with the suite's
    workers sharing the cores, intra-op threads only contend. One thread
    for this module, the previous count restored after it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def jax_state(lo) -> dict:
    """The JAX driver's map, poses and trajectory as numpy (the layout of
    iris_lama_tpu_torch.utils.state.lo_to_numpy)."""
    m = lo.map
    d = {f"table_{f}": np.array(getattr(m.table, f)) for f in TABLE}
    d.update(occupied=np.array(m.occupied), visited=np.array(m.visited),
             dist=np.array(m.dist), pose=np.array(lo._pose_dev),
             map_odom=np.array(lo._map_odom_dev),
             prev_delta=np.array(lo._delta_dev),
             traj=np.array(lo._traj[:lo._n_updates]),
             n_updates=np.int64(lo._n_updates))
    return d


def _sim(n_steps=200, seed=13):
    data = jsim.simulate(jsim.SimConfig(
        n_steps=n_steps, seed=seed,
        laser=jsim.LaserSpec(n_beams=120, max_range=6.0)))
    nb = beam_bucket(120)
    return data, [pad_scan(c, nb) for c in data.clouds]


def _jax_run(padded, n, at=None, **kw):
    lo = JLO(JOptions(**OPTS, **kw))
    refresh, patches, snap = [], [], None
    for k in range(n):
        p, m, o = padded[k]
        lo.update_prepadded(jnp.asarray(p), jnp.asarray(m), jnp.asarray(o))
        refresh.append(bool(lo._last_info_dev.get("refresh", True)))
        patches.append(int(lo.map.table.num_patches()))
        if k == at:
            snap = jax_state(lo)
    return lo, refresh, patches, snap


@pytest.fixture(scope="module")
def run():
    data, padded = _sim()
    lo, refresh, patches, snap = _jax_run(padded, N_SCANS, at=AT)
    return dict(data=data, padded=padded, traj=lo.trajectory(),
                refresh=refresh, patches=patches, snap=snap,
                final=jax_state(lo))


def _port_run(padded, n, lo=None, start=0, **kw):
    lo = lo or LidarOdometry2D(LidarOdometry2DOptions(**OPTS, **kw),
                               device="cpu")
    refresh, patches = [], []
    for k in range(start, n):
        assert lo.update_prepadded(*(torch.as_tensor(a) for a in padded[k]))
        refresh.append(lo.last_refresh)
        patches.append(int(lo.map.table.num_patches()))
    return lo, refresh, patches


def _assert_pose_close(a, b):
    assert np.abs(a[:, :2] - b[:, :2]).max() <= POSE_TOL
    assert np.abs(np.angle(np.exp(1j * (a[:, 2] - b[:, 2])))).max() \
        <= POSE_TOL


def _assert_maps_equal(got: dict, want: dict):
    for f in TABLE:
        np.testing.assert_array_equal(got[f"table_{f}"], want[f"table_{f}"],
                                      err_msg=f)
    np.testing.assert_array_equal(got["visited"], want["visited"])
    np.testing.assert_array_equal(got["dist"], want["dist"])
    assert got["occupied"].dtype == np.float32
    np.testing.assert_allclose(got["occupied"], want["occupied"], rtol=0,
                               atol=LO_ATOL)


def test_lidar_odometry_matches_jax(run):
    lo, refresh, patches = _port_run(run["padded"], N_SCANS)
    _assert_pose_close(lo.trajectory(), run["traj"])
    assert refresh == run["refresh"]
    assert patches == run["patches"]
    assert 5 < sum(refresh) < N_SCANS
    assert max(patches) > patches[-1]      # the transient map pruned
    assert lo.n_refreshes == sum(refresh) - 1
    assert int(lo.map.table.overflow) == 0


@pytest.mark.parametrize("at", [AT])
def test_state_carried_across(run, at):
    """Load the JAX driver's state after scan ``at`` into the port and run
    both to the end: poses, refresh decisions, patch counts, and the final
    pool (tables, visits and distances bit-equal)."""
    lo = LidarOdometry2D(LidarOdometry2DOptions(**OPTS), device="cpu")
    lo.load_state_dict(run["snap"])
    _assert_maps_equal(tstate.lo_to_numpy(lo), run["snap"])
    lo, refresh, patches = _port_run(run["padded"], N_SCANS, lo=lo,
                                     start=at + 1)
    assert refresh == run["refresh"][at + 1:]
    assert patches == run["patches"][at + 1:]
    _assert_pose_close(lo.trajectory(), run["traj"])
    got = tstate.lo_to_numpy(lo)
    _assert_maps_equal(got, run["final"])
    for k in ("pose", "map_odom"):
        np.testing.assert_allclose(got[k], run["final"][k], rtol=0,
                                   atol=POSE_TOL)


def test_motion_prediction_matches_jax(run):
    """``motion_prediction=True``: the clamped constant-velocity seed."""
    n = 20
    lo_j, refresh_j, patches_j, _ = _jax_run(run["padded"], n,
                                             motion_prediction=True)
    lo, refresh, patches = _port_run(run["padded"], n,
                                     motion_prediction=True)
    _assert_pose_close(lo.trajectory(), lo_j.trajectory())
    assert refresh == refresh_j and patches == patches_j
    np.testing.assert_allclose(lo._delta_dev.numpy(),
                               np.asarray(lo_j._delta_dev), atol=POSE_TOL)


def test_update_from_clouds_matches_prepadded(run):
    """``update`` pads the cloud on the host and takes the same path."""
    data = run["data"]
    a = LidarOdometry2D(LidarOdometry2DOptions(**OPTS), device="cpu")
    b, _, _ = _port_run(run["padded"], 10)
    for k in range(10):
        assert a.update(data.clouds[k], data.timestamps[k])
    np.testing.assert_array_equal(a.trajectory(), b.trajectory())
    np.testing.assert_array_equal(a.pose().xyr(), b.pose().xyr())


# -- the assertions of tests/test_lidar_odometry.py, on the port ------------

def test_lidar_odometry_tracks_motion():
    # odometry-free tracking needs near-sensor-rate scans: ~6.5 cm between
    # scans, the first 300 scans of the loop
    cfg = simulator.SimConfig(
        n_steps=1200, seed=12,
        laser=simulator.LaserSpec(n_beams=180, max_range=8.0))
    data = simulator.simulate(cfg)
    lo = LidarOdometry2D(LidarOdometry2DOptions(resolution=0.05,
                                                max_range=8.0,
                                                capacity=2048), device="cpu")
    n_run = 300
    est = []
    for k in range(n_run):
        lo.update(data.clouds[k], data.timestamps[k])
        est.append(lo.pose().xyr())
    est = np.asarray(est)
    g0 = Pose2D(*data.poses_gt[0])
    rel_gt = np.asarray([(g0 - Pose2D(*data.poses_gt[k])).xyr()
                         for k in range(n_run)])
    err = np.linalg.norm(est[:, :2] - rel_gt[:, :2], axis=1)
    travel_gt = np.linalg.norm(rel_gt[-1, :2])
    travel_est = np.linalg.norm(est[-1, :2])
    assert err[:60].mean() < 0.5, err[:60].mean()
    assert travel_est > 0.5 * travel_gt, (travel_est, travel_gt)


def test_transient_map_prunes_patches():
    cfg = simulator.SimConfig(
        n_steps=200, seed=13,
        laser=simulator.LaserSpec(n_beams=120, max_range=6.0))
    data = simulator.simulate(cfg)
    lo = LidarOdometry2D(LidarOdometry2DOptions(**OPTS), device="cpu")
    counts = []
    for k in range(cfg.n_steps):
        lo.update(data.clouds[k], data.timestamps[k])
        if k % 25 == 0:
            counts.append(int(lo.map.table.num_patches()))
    assert max(counts) < 800, counts
    assert int(lo.map.table.overflow) == 0


def test_first_scan_and_pose_api():
    """The first scan maps at the identity and refreshes; later scans
    track from it; the relative ground truth of ``JPose2D`` and the port's
    ``Pose2D`` agree."""
    data, padded = _sim(40, 13)
    lo, refresh, _ = _port_run(padded, 3)
    assert refresh[0] and lo.trajectory().shape == (3, 3)
    np.testing.assert_array_equal(lo.trajectory()[0], [0.0, 0.0, 0.0])
    g = JPose2D(*data.poses_gt[0]) - JPose2D(*data.poses_gt[2])
    t = Pose2D(*data.poses_gt[0]) - Pose2D(*data.poses_gt[2])
    np.testing.assert_array_equal(g.xyr(), t.xyr())
