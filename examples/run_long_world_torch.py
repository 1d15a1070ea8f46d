"""Run every algorithm of the PyTorch/CUDA port on the synthetic
long-corridor figure-8 world, the port's side of
examples/run_long_world.py.

The corridor world (utils/simulator.py:corridor_world): ~550 m of 3 m-wide
corridor in two nested loops, sparse longitudinal texture, large loop
closures. Prints one JSON line per algorithm:
  {"algo", "scans_per_sec", "ate_m" | "final_err_m" | ..., "device", ...}

Usage:
  python examples/run_long_world_torch.py [--steps 3000] [--beams 720]
      [--algos slam2d,graph_slam] [--device cpu]

Runs on the CUDA device unless ``--device cpu``; rates are host-clock
times of work that ends in a device synchronisation.
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=3000)
    ap.add_argument("--beams", type=int, default=720)
    ap.add_argument("--resolution", type=float, default=0.05)
    ap.add_argument(
        "--algos", default="slam2d,graph_slam,pf_slam,loc2d,lidar_odom")
    ap.add_argument("--particles", type=int, default=30)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    ap.add_argument("--seed", type=int, default=1)
    args = ap.parse_args(argv)

    import torch

    from iris_lama_tpu_torch import Pose2D
    from iris_lama_tpu_torch.algos.slam2d import resolve_device
    from iris_lama_tpu_torch.utils import simulator
    from iris_lama_tpu_torch.utils.cloud import beam_bucket, pad_scan
    from iris_lama_tpu_torch.utils.evaluation import ate_rmse

    dev = resolve_device(args.device)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    data = simulator.simulate(simulator.SimConfig(
        n_steps=args.steps, seed=args.seed, world="corridor",
        laser=simulator.LaserSpec(n_beams=args.beams, max_range=10.0),
        odom_trans_noise=0.01, odom_rot_noise=0.002))
    nb = beam_bucket(args.beams)
    staged_np = [pad_scan(data.clouds[k], nb) for k in range(args.steps)]
    staged = [tuple(torch.as_tensor(a, device=dev) for a in t)
              for t in staged_np]
    odoms = list(data.odometry)
    times = [float(k) for k in range(args.steps)]
    device_name = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else "cpu")
    rows = []

    def report(algo, sps, err_name, err, extra=None):
        row = {"algo": algo, "scans_per_sec": round(sps, 2),
               err_name: round(err, 4), "device": device_name,
               **(extra or {})}
        rows.append(row)
        print(json.dumps(row), flush=True)

    algos = args.algos.split(",")
    warm = min(64, args.steps // 4)

    if "slam2d" in algos or "loc2d" in algos:
        from iris_lama_tpu_torch import Slam2D, Slam2DOptions
        opts = Slam2DOptions(resolution=args.resolution, max_range=10.0,
                             trans_thresh=0.25, rot_thresh=0.25,
                             capacity=8192)
        slam = Slam2D(opts, device=dev)
        slam.set_prior(Pose2D(*data.poses_gt[0]))
        acc0 = slam.update_many_prepadded(staged[:warm], odoms[:warm])
        sync()
        t0 = time.perf_counter()
        accepted = slam.update_many_prepadded(staged[warm:], odoms[warm:])
        sync()
        dt = time.perf_counter() - t0
        accepted = acc0 + [warm + a for a in accepted]
        gt = np.asarray([data.poses_gt[k] for k in accepted])
        if "slam2d" in algos:
            report("slam2d", (len(accepted) - len(acc0)) / dt, "ate_m",
                   ate_rmse(slam.trajectory(), gt),
                   {"updates": len(accepted),
                    "patches": int(slam.map.table.num_patches())})

    if "graph_slam" in algos:
        from iris_lama_tpu_torch import (GraphSlam2D, GraphSlam2DOptions,
                                         Slam2DOptions)
        gopts = GraphSlam2DOptions(
            slam=Slam2DOptions(resolution=args.resolution, max_range=10.0,
                               trans_thresh=0.25, rot_thresh=0.25,
                               capacity=4096, transient_map=True),
            key_pose_head_delay=3, ignore_n_chain_poses=15,
            loop_closure_scan_rmse=0.12)
        # two passes: the second is the measurement
        for _ in range(2):
            gs = GraphSlam2D(gopts, device=dev)
            gs.set_prior(Pose2D(*data.poses_gt[0]))
            t0 = time.perf_counter()
            accepted = gs.update_many_prepadded(staged_np, odoms,
                                                timestamps=times)
            kps = gs.key_poses      # the final sync inside the timed region
            sync()
            dt = time.perf_counter() - t0
        kp_est = np.asarray([kp.pose.xyr() for kp in kps])
        kp_gt = np.asarray([data.poses_gt[int(kp.timestamp)] for kp in kps])
        stats = {k: round(v, 2) for k, v in gs.stats.items()
                 if not k.endswith("_n")}
        report("graph_slam", len(accepted) / dt, "ate_m",
               ate_rmse(kp_est, kp_gt),
               {"key_poses": len(kps), "loop_closures": len(gs.links),
                "updates": len(accepted), "phase_s": stats})

    if "pf_slam" in algos:
        from iris_lama_tpu_torch import PFSlam2D, PFSlam2DOptions
        popts = PFSlam2DOptions(particles=args.particles,
                                resolution=args.resolution, max_range=10.0,
                                trans_thresh=0.25, rot_thresh=0.25,
                                capacity=4096, max_iter=50, seed=11)
        pf = PFSlam2D(popts, device=dev)
        pf.set_prior(Pose2D(*data.poses_gt[0]))
        acc0 = pf.update_many_prepadded(staged[:warm], odoms[:warm])
        sync()
        t0 = time.perf_counter()
        accepted = pf.update_many_prepadded(staged[warm:], odoms[warm:])
        sync()
        dt = time.perf_counter() - t0
        accepted = acc0 + [warm + a for a in accepted]
        err = float(np.linalg.norm(
            pf.pose().xy() - data.poses_gt[accepted[-1]][:2]))
        report("pf_slam", (len(accepted) - len(acc0)) / dt,
               "final_err_m", err,
               {"updates": len(accepted), "particles": args.particles})

    if "loc2d" in algos:
        from iris_lama_tpu_torch import Loc2D, Loc2DOptions
        from iris_lama_tpu_torch.algos.loc2d import maps_from_slam
        maps = maps_from_slam(slam.map, slam.cfg)
        loc = Loc2D(Loc2DOptions(resolution=args.resolution, l2_max=0.5,
                                 max_range=10.0, trans_thresh=0.1,
                                 rot_thresh=0.1), maps=maps, device=dev)
        loc.set_prior(Pose2D(*data.poses_gt[0]))
        staged_loc = [(p[:, :2], m) for p, m, _ in staged]
        acc0 = loc.update_many_prepadded(staged_loc[:warm], odoms[:warm])
        sync()
        t0 = time.perf_counter()
        accepted = loc.update_many_prepadded(staged_loc[warm:],
                                             odoms[warm:])
        sync()
        dt = time.perf_counter() - t0
        accepted = acc0 + [warm + a for a in accepted]
        gt = np.asarray([data.poses_gt[k] for k in accepted])
        errs = np.linalg.norm(loc.trajectory()[:, :2] - gt[:, :2], axis=1)
        report("loc2d", (len(accepted) - len(acc0)) / dt, "mean_err_m",
               float(np.mean(errs)), {"updates": len(accepted)})

    if "lidar_odom" in algos:
        from iris_lama_tpu_torch import (LidarOdometry2D,
                                         LidarOdometry2DOptions)
        lo = LidarOdometry2D(LidarOdometry2DOptions(
            resolution=args.resolution, max_range=10.0, capacity=4096),
            device=dev)
        # odometry-free tracking needs near-sensor-rate scans: every scan
        n_run = min(args.steps, 1500)
        lo_warm = min(32, n_run // 4)
        for k in range(lo_warm):
            lo.update_prepadded(*staged[k], times[k])
        sync()
        t0 = time.perf_counter()
        for k in range(lo_warm, n_run):
            lo.update_prepadded(*staged[k], times[k])
        sync()
        dt = time.perf_counter() - t0
        est = lo.trajectory()
        g0 = Pose2D(*data.poses_gt[0])
        rel_gt = np.asarray([(g0 - Pose2D(*data.poses_gt[k])).xyr()
                             for k in range(n_run)])
        err = np.linalg.norm(est[:, :2] - rel_gt[:, :2], axis=1)
        path = max(np.sum(np.linalg.norm(np.diff(rel_gt[:, :2], axis=0),
                                         axis=1)), 1e-9)
        report("lidar_odom", (n_run - lo_warm) / dt, "drift_m_per_100m",
               float(err[-1] / path * 100.0),
               {"scans": n_run, "final_err_m": round(float(err[-1]), 3)})
    return rows


if __name__ == "__main__":
    main()
