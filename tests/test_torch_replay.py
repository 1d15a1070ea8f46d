"""The replay entry points' ``chunk``, in the port, on the CPU.

``Slam2D.update_many_prepadded(staged, odoms, chunk=32)`` and
``PFSlam2D.update_many_prepadded(staged, odoms, chunk=8)`` take the JAX
package's argument with its defaults (the JAX package's accepted updates
per device program). The port runs each accepted update in turn, so every
chunk gives the same poses and maps: held bit-equal at chunk 8 and 32
against chunk 1, and a chunk below 1 is refused.
"""

import functools

import numpy as np
import pytest
import torch

from iris_lama_tpu_torch.algos.pf_slam2d import PFSlam2D, PFSlam2DOptions
from iris_lama_tpu_torch.algos.slam2d import Slam2D, Slam2DOptions
from iris_lama_tpu_torch.core.pose import Pose2D
from iris_lama_tpu_torch.utils import simulator
from iris_lama_tpu_torch.utils.cloud import beam_bucket, pad_scan


def _slam(data):
    slam = Slam2D(Slam2DOptions(resolution=0.1, patch_size=16, max_range=8.0,
                                trans_thresh=0.2, rot_thresh=0.2,
                                capacity=1024, scroll_kp=5), device="cpu")
    slam.set_prior(Pose2D(*data.poses_gt[0]))
    return slam


def _pf(data):
    pf = PFSlam2D(PFSlam2DOptions(particles=8, resolution=0.1, patch_size=16,
                                  max_range=8.0, capacity=1024,
                                  trans_thresh=0.3, rot_thresh=0.3,
                                  max_iter=30, seed=3,
                                  resident_extra_patches=2,
                                  host_reorg_slack=0.5), device="cpu")
    pf.set_prior(Pose2D(*data.poses_gt[0]))
    return pf


@functools.lru_cache(maxsize=None)
def _data(algo):
    if algo == "slam2d":
        data = simulator.simulate(simulator.SimConfig(
            n_steps=24, seed=6,
            laser=simulator.LaserSpec(n_beams=120, max_range=8.0)))
    else:
        data = simulator.simulate(simulator.SimConfig(
            n_steps=9, seed=2,
            laser=simulator.LaserSpec(n_beams=120, max_range=8.0),
            odom_trans_noise=0.02, odom_rot_noise=0.004))
    staged = [tuple(torch.as_tensor(a) for a in pad_scan(c, beam_bucket(120)))
              for c in data.clouds]
    return data, staged


@functools.lru_cache(maxsize=None)
def _replay(algo, chunk):
    """(accepted, state dict) of one replay at ``chunk``."""
    data, staged = _data(algo)
    drv = _slam(data) if algo == "slam2d" else _pf(data)
    acc = drv.update_many_prepadded(staged, data.odometry, chunk=chunk)
    return acc, drv.state_dict()


@pytest.mark.parametrize("chunk", [8, 32])
@pytest.mark.parametrize("algo", ["slam2d", "pf"])
def test_replay_chunk_changes_nothing(algo, chunk):
    acc1, want = _replay(algo, 1)
    acc, got = _replay(algo, chunk)
    assert acc == acc1 and len(acc) > 5
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(np.asarray(got[k]),
                                      np.asarray(want[k]), err_msg=k)


@pytest.mark.parametrize("algo", ["slam2d", "pf"])
def test_replay_refuses_chunk_below_one(algo):
    data, staged = _data(algo)
    drv = _slam(data) if algo == "slam2d" else _pf(data)
    with pytest.raises(ValueError, match="chunk"):
        drv.update_many_prepadded(staged, data.odometry, chunk=0)
