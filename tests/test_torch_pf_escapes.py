"""PFSlam2D's escapes and re-orgs on the corridor route, the port against
the JAX package, on the CPU.

The spill-tier route of ``chip_smoke.py`` phase 25 (tests/test_pf_spill.py's
corridor, ``SimConfig(n_steps=400, seed=4, world="corridor")``, 720 beams to
10 m, 5 cm cells, bench_pf.py's options, full re-orgs as the tier takes)
at 4 particles, both filters on the JAX package's key stream. Update by
update: the escaped particles of the update and the re-org count. They
must agree while every particle's pose agrees within the PF bounds (1 mm /
1e-3 rad), and a count may part only after the poses have: a corridor
match an ulp decides moves a particle by centimetres, and the escape test
then reads another pose.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iris_lama_tpu.algos import pf_slam2d as jpf
from iris_lama_tpu.core.pose import Pose2D as JPose2D
from iris_lama_tpu.utils import simulator as jsim

from iris_lama_tpu_torch.algos import pf_slam2d as tpf
from iris_lama_tpu_torch.core.pose import Pose2D
from iris_lama_tpu_torch.utils.cloud import beam_bucket, pad_scan

N_UPDATES = 32
XY_BOUND, TH_BOUND = 1e-3, 1e-3
OPTS = dict(particles=4, resolution=0.05, max_range=10.0, trans_thresh=0.25,
            rot_thresh=0.25, capacity=4096, max_iter=50, seed=11,
            scroll_reorg=False)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's CPU paths make many small tensor ops; with the suite's
    workers sharing the cores, intra-op threads only contend. One thread
    for this module, the previous count restored after it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class JaxDraws:
    """The JAX driver's key stream as a draw source for the port."""

    def __init__(self, key):
        self.key = key

    def __call__(self, kind, shape):
        k1, self.key = jax.random.split(self.key)
        if kind == "normal":
            return np.asarray(jax.random.normal(k1, shape))
        return np.asarray(jax.random.uniform(k1))


def _xyth(pose):
    pose = np.asarray(pose)
    return pose[:, :2], np.arctan2(pose[:, 3], pose[:, 2])


def test_escapes_and_reorgs_follow_the_poses():
    data = jsim.simulate(jsim.SimConfig(
        n_steps=400, seed=4, world="corridor",
        laser=jsim.LaserSpec(n_beams=720, max_range=10.0),
        odom_trans_noise=0.005, odom_rot_noise=0.001))
    scans = [pad_scan(c, beam_bucket(720)) for c in data.clouds[:N_UPDATES]]
    j = jpf.PFSlam2D(jpf.PFSlam2DOptions(**OPTS))
    t = tpf.PFSlam2D(tpf.PFSlam2DOptions(**OPTS), device="cpu",
                     draws=JaxDraws(jax.random.PRNGKey(OPTS["seed"])))
    j.set_prior(JPose2D(*data.poses_gt[0]))
    t.set_prior(Pose2D(*data.poses_gt[0]))
    rows = []
    for k in range(N_UPDATES):
        aj = j.update_prepadded(*(jnp.asarray(a) for a in scans[k]),
                                data.odometry[k])
        at = t.update_prepadded(*(torch.as_tensor(a) for a in scans[k]),
                                data.odometry[k])
        assert aj == at, k
        if not k:
            continue
        (xj, thj), (xt, tht) = _xyth(j.pset.pose), _xyth(t.pset.pose)
        dth = np.abs(np.angle(np.exp(1j * (thj - tht))))
        rows.append(dict(
            k=k, same_pose=bool(np.abs(xj - xt).max() <= XY_BOUND
                                and dth.max() <= TH_BOUND),
            counts=((int(j._last_info_dev["escaped"]), j._n_reorgs),
                    (int(t._last_info_dev["escaped"]), t.n_reorgs))))
    parted = next((r["k"] for r in rows if not r["same_pose"]), None)
    split = next((r["k"] for r in rows
                  if r["counts"][0] != r["counts"][1]), None)
    # the counts agree at every update of the stretch where the poses do
    for r in rows:
        if parted is None or r["k"] < parted:
            assert r["counts"][0] == r["counts"][1], r
    assert split is None or (parted is not None and split > parted), \
        (split, parted)
    # the route's first re-orgs fall in the window, on both
    assert rows[-1]["counts"][0][1] >= 2 and rows[-1]["counts"][1][1] >= 2
    # re-orgs are host decisions on odometry alone: equal throughout
    assert all(r["counts"][0][1] == r["counts"][1][1] for r in rows)
