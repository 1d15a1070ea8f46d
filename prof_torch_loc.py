#!/usr/bin/env python3
"""Where the time of the port's Loc2D goes on one GPU.

    python3 prof_torch_loc.py [--modes generic,sq,solve,fused]

Builds the bench_loc.py map on the card (Slam2D over SimConfig(n_steps=200,
seed=7, laps=1), 720 beams, 5 cm cells), then for each match mode replays
the log once through Loc2D.update_many_prepadded to warm up and once more
under torch.profiler. The resident-window check and slice, the scan match,
the covariance and the whole solve-and-covariance step are wrapped in
profiler ranges by this script (the port's own spans cover Slam2D and
PFSlam2D only); the
covariance/RMSE evaluation is the step's remainder. Prints one JSON line
per mode: wall time per update (profiler on), host time per range, device
time by kernel name, the device's busy share of the window (kernel time /
wall time), device activities (kernels, memsets, copies) per update and
host reads per update.
"""

import argparse
import json
import os
import sys
import time


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--modes", default="generic,sq,solve,fused")
    args = ap.parse_args()
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from torch.profiler import ProfilerActivity, profile, record_function
    from iris_lama_tpu_torch.utils import devprof
    from iris_lama_tpu_torch.algos import loc2d
    from iris_lama_tpu_torch.algos.slam2d import Slam2D, Slam2DOptions
    from iris_lama_tpu_torch.core.pose import Pose2D
    from iris_lama_tpu_torch.utils import trace
    from iris_lama_tpu_torch.utils import simulator
    from iris_lama_tpu_torch.utils.cloud import beam_bucket, pad_scan

    dev = torch.device("cuda:0")
    data = simulator.simulate(simulator.SimConfig(
        n_steps=200, seed=7, laps=1,
        laser=simulator.LaserSpec(n_beams=720, max_range=10.0)))
    padded = [pad_scan(c, beam_bucket(720)) for c in data.clouds]
    slam = Slam2D(Slam2DOptions(resolution=0.05, max_range=10.0,
                                trans_thresh=0.2, rot_thresh=0.2,
                                capacity=8192), device=dev)
    slam.set_prior(Pose2D(*data.poses_gt[0]))
    slam.update_many_prepadded(
        [tuple(torch.as_tensor(a, device=dev) for a in p) for p in padded],
        data.odometry)
    maps = loc2d.maps_from_slam(slam.map, slam.cfg)
    del slam
    opts = loc2d.Loc2DOptions(resolution=0.05, l2_max=0.5, max_range=10.0,
                              trans_thresh=0.1, rot_thresh=0.1)
    staged = [(torch.as_tensor(np.ascontiguousarray(p[:, :2]), device=dev),
               torch.as_tensor(m, device=dev)) for p, m, _ in padded]

    def ranged(name, fn):
        def wrapper(*a, **kw):
            with record_function(name):
                return fn(*a, **kw)
        return wrapper

    names = ("solve_and_cov", "window", "match", "covariance")
    cls = loc2d.Loc2D
    cls._solve_and_cov = ranged("solve_and_cov", cls._solve_and_cov)
    cls.match_window = ranged("window", cls.match_window)
    loc2d.match_mod.solve_window = ranged("match",
                                          loc2d.match_mod.solve_window)
    loc2d.nlls_solver.covariance_from_eval = ranged(
        "covariance", loc2d.nlls_solver.covariance_from_eval)

    for mode in args.modes.split(","):
        def one_pass():
            loc = cls(opts, maps=maps, device=dev, match=mode)
            loc.set_prior(Pose2D(*data.poses_gt[0]))
            return loc.update_many_prepadded(staged, data.odometry)

        one_pass()
        torch.cuda.synchronize()
        reads = sum(trace.counts().values())
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            n = len(one_pass())
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        reads = sum(trace.counts().values()) - reads
        kernels = sorted(((e.key, devprof.event_us(e), e.count)
                          for e in devprof.cuda_rows(prof)
                          if e.key not in names), key=lambda x: -x[1])
        total_dev_us = sum(x[1] for x in kernels)
        host = {r: 0.0 for r in names}
        for e in prof.events():
            if e.name in names and not str(e.device_type).endswith("CUDA"):
                host[e.name] += e.time_range.elapsed_us() / 1e3 / n
        host["eval_cov_rmse"] = (host["solve_and_cov"] - host["window"]
                                 - host["match"])
        print(json.dumps({
            "device": torch.cuda.get_device_name(0), "mode": mode,
            "updates": n, "wall_ms_per_update": wall * 1e3 / n,
            "host_ms_per_update": host,
            "device_kernel_ms_per_update": total_dev_us / 1e3 / n,
            "device_busy_share": total_dev_us / 1e6 / wall,
            "device_activities_per_update": sum(x[2] for x in kernels) / n,
            "host_reads_per_update": reads / n,
            "top_device_ops": [{"name": x[0][:80],
                                "ms_per_update": x[1] / 1e3 / n,
                                "calls_per_update": x[2] / n}
                               for x in kernels[:12]],
        }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
