"""Run the PyTorch/CUDA port's SLAM on a CARMEN log (Intel Research Lab /
MIT Killian / ACES), the port's side of examples/run_carmen.py.

Usage:
  python examples/run_carmen_torch.py intel.clf --algo slam2d \
      --resolution 0.05 --max-range 10 --out-prefix intel
  python examples/run_carmen_torch.py aces.clf --algo graph_slam
  python examples/run_carmen_torch.py mit.clf --algo pf_slam --particles 30
  python examples/run_carmen_torch.py log.clf --device cpu   # no GPU

Runs on the CUDA device unless ``--device cpu``. Writes: <prefix>_map.png,
<prefix>_traj.txt (x y theta per 50 updates), <prefix>_occ.smd /
<prefix>_dm.smd (reference-compatible maps).
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))


def build_driver(args):
    """The driver the arguments name, on ``args.device``."""
    from iris_lama_tpu_torch import (GraphSlam2D, GraphSlam2DOptions,
                                     LidarOdometry2D, LidarOdometry2DOptions,
                                     PFSlam2D, PFSlam2DOptions, Slam2D,
                                     Slam2DOptions)
    common = dict(resolution=args.resolution, max_range=args.max_range,
                  trans_thresh=args.trans_thresh, rot_thresh=args.rot_thresh,
                  capacity=args.capacity)
    dev = args.device
    if args.algo == "slam2d":
        return Slam2D(Slam2DOptions(**common), device=dev)
    if args.algo == "pf_slam":
        return PFSlam2D(PFSlam2DOptions(particles=args.particles, **common),
                        device=dev)
    if args.algo == "graph_slam":
        return GraphSlam2D(GraphSlam2DOptions(
            slam=Slam2DOptions(transient_map=True, **common)), device=dev)
    return LidarOdometry2D(LidarOdometry2DOptions(
        resolution=args.resolution, max_range=args.max_range,
        capacity=args.capacity), device=dev)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("log")
    ap.add_argument("--algo", default="slam2d",
                    choices=["slam2d", "pf_slam", "graph_slam", "lidar_odom"])
    ap.add_argument("--resolution", type=float, default=0.05)
    ap.add_argument("--max-range", type=float, default=10.0)
    ap.add_argument("--particles", type=int, default=30)
    ap.add_argument("--trans-thresh", type=float, default=0.25)
    ap.add_argument("--rot-thresh", type=float, default=0.25)
    ap.add_argument("--capacity", type=int, default=16384)
    ap.add_argument("--out-prefix", default="out")
    ap.add_argument("--max-scans", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    args = ap.parse_args(argv)

    from iris_lama_tpu_torch.sdm import export as export_mod
    from iris_lama_tpu_torch.sdm import io as sdm_io
    from iris_lama_tpu_torch.utils.dataset import read_carmen_log

    slam = build_driver(args)
    n, n_upd = 0, 0
    traj = []
    t0 = time.perf_counter()
    for rec in read_carmen_log(args.log, max_range=args.max_range):
        n += 1
        if args.algo == "lidar_odom":
            did = slam.update(rec.cloud, rec.timestamp)
        else:
            did = slam.update(rec.cloud, rec.odometry, rec.timestamp)
        if did:
            n_upd += 1
            if n_upd % 50 == 0:
                p = slam.pose()
                traj.append((rec.timestamp, p.x(), p.y(), p.rotation()))
                print(f"scan {n}: pose ({p.x():.2f}, {p.y():.2f}, "
                      f"{p.rotation():.2f})", flush=True)
        if args.max_scans and n >= args.max_scans:
            break
    dt = time.perf_counter() - t0
    print(f"{n} scans, {n_upd} updates in {dt:.1f} s "
          f"({n_upd / max(dt, 1e-9):.1f} updates/s)")

    if args.algo == "pf_slam":
        state = slam.particle_map()
        cfg = slam.options.mapping_config()
    elif args.algo == "graph_slam":
        state = slam.generate_occupancy_map()
        cfg = slam.slam.cfg
    else:
        state, cfg = slam.map, slam.cfg
    img = export_mod.occupancy_to_image(state, cfg.geometry)
    export_mod.export_to_png(img, f"{args.out_prefix}_map.png")
    sdm_io.write_frequency_occupancy(state, cfg.geometry,
                                     f"{args.out_prefix}_occ.smd")
    sdm_io.write_distance_map(state, cfg.geometry, cfg.l2_max,
                              f"{args.out_prefix}_dm.smd")
    with open(f"{args.out_prefix}_traj.txt", "w") as f:
        for ts, x, y, th in traj:
            f.write(f"{ts:.6f} {x:.6f} {y:.6f} {th:.6f}\n")
    print(f"wrote {args.out_prefix}_map.png / _occ.smd / _dm.smd / _traj.txt")
    return {"scans": n, "updates": n_upd, "seconds": dt}


if __name__ == "__main__":
    main()
