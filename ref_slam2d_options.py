"""The JAX package's Slam2D on bench.py's workload with each map option
of chip_smoke.py's phase 16: the reference ATE the port's card run is
held to.

    JAX_PLATFORMS=cpu python ref_slam2d_options.py

Prints one JSON line per option: accepted scans and ATE (m), with the
timing of bench.py's pass (two scans, then update_many_prepadded over the
rest). A transient map forgets what lies outside the scan's box
(slam2d.cpp:323-373), so its ATE is not bench.py's (< 12 mm) on this
loop.
"""

import json
import time

import jax.numpy as jnp
import numpy as np

from iris_lama_tpu.algos.slam2d import Slam2D, Slam2DOptions
from iris_lama_tpu.core.pose import Pose2D
from iris_lama_tpu.utils import simulator
from iris_lama_tpu.utils.cloud import beam_bucket, pad_scan
from iris_lama_tpu.utils.evaluation import ate_rmse


def main():
    data = simulator.simulate(simulator.SimConfig(
        n_steps=440, seed=3,
        laser=simulator.LaserSpec(n_beams=720, max_range=10.0)))
    staged = [tuple(jnp.asarray(a) for a in pad_scan(c, beam_bucket(720)))
              for c in data.clouds]
    for kw in (dict(transient_map=True), dict(resident_window=False)):
        slam = Slam2D(Slam2DOptions(resolution=0.05, max_range=10.0,
                                    trans_thresh=0.05, rot_thresh=0.05,
                                    capacity=8192, max_iter=50, **kw))
        slam.set_prior(Pose2D(*data.poses_gt[0]))
        slam.update_prepadded(*staged[0], data.odometry[0])
        slam.update_prepadded(*staged[1], data.odometry[1])
        t0 = time.perf_counter()
        acc = slam.update_many_prepadded(staged[2:], data.odometry[2:])
        gt = np.asarray([data.poses_gt[2 + k] for k in acc])
        print(json.dumps({"options": kw, "updates": len(acc),
                          "ate_m": ate_rmse(slam.trajectory()[-len(gt):],
                                            gt),
                          "seconds": time.perf_counter() - t0}), flush=True)


if __name__ == "__main__":
    main()
