"""The port's Slam2D against the sequential NumPy transliteration of
LaMa's Slam2D (tests/oracle/lama_numpy.py), on the CPU: the JAX package's
head-to-head (tests/oracle/test_head_to_head.py:55-88) at its log and
bounds. Both engines run the same simulated log with the same options;
the trajectory delta between them and each against ground truth must stay
under 60 mm.
"""

import numpy as np
import pytest
import torch

from iris_lama_tpu.utils import simulator

from iris_lama_tpu_torch.algos.slam2d import Slam2D, Slam2DOptions
from iris_lama_tpu_torch.core.pose import Pose2D
from iris_lama_tpu_torch.utils.evaluation import ate_rmse

from oracle.lama_numpy import SE2, Slam2DOracle

N_STEPS = 100
BEAMS = 360
RES = 0.05
BOUND_M = 0.06      # tests/oracle/test_head_to_head.py:83-88


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's CPU paths make many small tensor ops; with the suite's
    workers sharing the cores, intra-op threads only contend. One thread
    for this module, the previous count restored after it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def log():
    return simulator.simulate(simulator.SimConfig(
        n_steps=N_STEPS, seed=3,
        laser=simulator.LaserSpec(n_beams=BEAMS, max_range=10.0)))


@pytest.fixture(scope="module")
def oracle_traj(log):
    oracle = Slam2DOracle(resolution=RES, l2_max=0.5, trans_thresh=0.05,
                          rot_thresh=0.05, max_iter=50)
    g0 = log.poses_gt[0]
    oracle.set_prior(g0[0], g0[1], g0[2])
    traj = []
    for k in range(N_STEPS):
        pts = log.clouds[k].base_frame_points()[:, :2]
        od = log.odometry[k]
        if oracle.update(pts, SE2.from_xyr(od.x(), od.y(), od.rotation())):
            traj.append([oracle.pose.tx, oracle.pose.ty,
                         oracle.pose.rotation()])
    return np.asarray(traj)


def test_head_to_head_trajectory(log, oracle_traj):
    slam = Slam2D(Slam2DOptions(resolution=RES, max_range=10.0,
                                trans_thresh=0.05, rot_thresh=0.05,
                                capacity=4096, max_iter=50), device="cpu")
    g0 = log.poses_gt[0]
    slam.set_prior(Pose2D(g0[0], g0[1], g0[2]))
    gt = [log.poses_gt[k] for k in range(N_STEPS)
          if slam.update(log.clouds[k], log.odometry[k], log.timestamps[k])]
    ours = slam.trajectory()
    assert len(ours) == len(oracle_traj) == len(gt), \
        "engines accepted different update sets"
    ate_cross = ate_rmse(ours, oracle_traj)
    ate_ours = ate_rmse(ours, np.asarray(gt))
    ate_oracle = ate_rmse(oracle_traj, np.asarray(gt))
    assert ate_oracle < BOUND_M, f"oracle diverged: {ate_oracle:.4f} m"
    assert ate_ours < BOUND_M, f"the port diverged: {ate_ours:.4f} m"
    assert ate_cross < BOUND_M, \
        f"engine-to-engine trajectory delta: {ate_cross:.4f} m"
