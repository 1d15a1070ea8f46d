"""The JAX package's GraphSlam2D on bench_graph.py's workload and
PGO on bench_pgo.py's graph: the reference figures chip_smoke.py's phases
19 and 20 print beside the port's card run.

    JAX_PLATFORMS=cpu python ref_graph_slam2d.py

Prints one JSON line for the GraphSlam2D replay (SimConfig(n_steps=300,
seed=8), 720 beams padded to 768, 5 cm cells, bench_graph.py's options,
``update_many_prepadded`` on host-staged scans as bench_graph.py runs it;
one pass with the first rep's prior): accepted updates, key poses, loop
closures, optimizes and the key-pose ATE (m); and one for bench_pgo.py's
512-node graph: iterations, chi2 and the mean error of every 16th node.
Times are host seconds on the CPU, not a device's.
"""

import json
import time

import jax
import jax.numpy as jnp
import numpy as np

from iris_lama_tpu.algos.graph_slam2d import GraphSlam2D, GraphSlam2DOptions
from iris_lama_tpu.algos.slam2d import Slam2DOptions
from iris_lama_tpu.core.pose import Pose2D
from iris_lama_tpu.nlls import factor_graph as fg
from iris_lama_tpu.utils import simulator
from iris_lama_tpu.utils.cloud import beam_bucket, pad_scan
from iris_lama_tpu.utils.evaluation import ate_rmse


def graph_run(rep: int = 0) -> dict:
    n_steps = 300
    data = simulator.simulate(simulator.SimConfig(
        n_steps=n_steps, seed=8,
        laser=simulator.LaserSpec(n_beams=720, max_range=10.0),
        odom_trans_noise=0.02, odom_rot_noise=0.004))
    staged = [pad_scan(data.clouds[k], beam_bucket(720))
              for k in range(n_steps)]
    gs = GraphSlam2D(GraphSlam2DOptions(
        slam=Slam2DOptions(resolution=0.05, max_range=10.0,
                           trans_thresh=0.25, rot_thresh=0.25,
                           capacity=4096, transient_map=True),
        ignore_n_chain_poses=10, key_pose_head_delay=3,
        loop_closure_scan_rmse=0.12))
    gs.set_prior(Pose2D(data.poses_gt[0][0] + rep * 1e-4,
                        data.poses_gt[0][1], data.poses_gt[0][2]))
    t0 = time.perf_counter()
    gs.update_many_prepadded(staged, list(data.odometry),
                             timestamps=[float(k) for k in range(n_steps)])
    kps = gs.key_poses
    seconds = time.perf_counter() - t0
    est = np.asarray([kp.pose.xyr() for kp in kps])
    gt = np.asarray([data.poses_gt[int(kp.timestamp)] for kp in kps])
    return {"workload": "bench_graph", "rep": rep,
            "updates": gs.slam._n_updates, "key_poses": len(kps),
            "loop_closures": len(gs.links),
            "optimizes": gs.stats.get("optimize_n", 0),
            "key_pose_ate_m": ate_rmse(est, gt), "cpu_seconds": seconds}


def pgo_graph(n: int = 512, seed: int = 9, loops: int = 32):
    """bench_pgo.py's generator: (builder, initial nodes, active, truth)."""
    rng = np.random.default_rng(seed)
    true = [Pose2D(0, 0, 0)]
    for k in range(n - 1):
        true.append(true[-1] + Pose2D(1.0, 0.02 * np.sin(k / 7), 0.012))
    b = fg.GraphBuilder()
    b.add_prior(0, true[0].se2_array(), (0.01, 0.01, 0.01))
    for i in range(n - 1):
        b.add_between(i, i + 1, (true[i] - true[i + 1]).se2_array(),
                      (0.25, 0.25, 0.15))
    for _ in range(loops):
        i = int(rng.integers(0, n - 60))
        j = int(rng.integers(i + 40, n))
        b.add_between(i, j, (true[i] - true[j]).se2_array(), (0.5, 0.5, 0.1),
                      huber_k=0.1)
    n_pad = fg.GraphBuilder._bucket(n)
    nodes = np.tile(np.array([0, 0, 1, 0], np.float32), (n_pad, 1))
    for i, p in enumerate(true):
        nodes[i] = Pose2D(p.x() + rng.normal(0, 0.3),
                          p.y() + rng.normal(0, 0.3),
                          p.rotation() + rng.normal(0, 0.05)).se2_array()
    active = np.zeros(n_pad, bool)
    active[:n] = True
    return b, nodes, active, true


def pgo_run() -> dict:
    b, nodes, active, true = pgo_graph()
    graph = b.finalize()
    t0 = time.perf_counter()
    out, info = jax.jit(lambda nd: fg.optimize(nd, graph,
                                               jnp.asarray(active)))(
        jnp.asarray(nodes))
    out = np.asarray(out)
    seconds = time.perf_counter() - t0
    err = float(np.mean([np.linalg.norm(
        Pose2D.from_se2_array(out[i]).xy() - true[i].xy())
        for i in range(0, len(true), 16)]))
    return {"workload": "bench_pgo", "nodes": len(true),
            "iterations": int(info["iterations"]),
            "chi2": float(info["chi2"]), "mean_err_m": err,
            "cpu_seconds_with_compile": seconds}


def main():
    print(json.dumps(graph_run()), flush=True)
    print(json.dumps(pgo_run()), flush=True)


if __name__ == "__main__":
    main()
