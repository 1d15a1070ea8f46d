#!/usr/bin/env python3
"""Where the time of the port's Slam2D goes on one GPU.

    python3 prof_torch_slam2d.py [--scans 120]

Replays the chip_smoke.py / bench.py workload (office world,
SimConfig(n_steps=440, seed=3), 720 beams, 5 cm cells) on the card, warms
up on the first scans, then profiles ``--scans`` scans with
torch.profiler. The scan match, the map update and the re-orgs are wrapped
in profiler ranges by this script (the port carries no instrumentation).
Prints one JSON line: wall time per scan (profiler on), host time per
range and the span of each range on the device timeline, device time by
kernel name, the device's busy share of the window (kernel time / wall
time) and device activities (kernels, memsets) per scan.
"""

import argparse
import json
import os
import sys
import time


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--scans", type=int, default=120)
    ap.add_argument("--warmup", type=int, default=40)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from torch.profiler import ProfilerActivity, profile, record_function
    from iris_lama_tpu_torch.utils import devprof
    from iris_lama_tpu_torch.algos import slam2d
    from iris_lama_tpu_torch.core.pose import Pose2D
    from iris_lama_tpu_torch.utils import simulator
    from iris_lama_tpu_torch.utils.cloud import beam_bucket, pad_scan

    dev = torch.device("cuda:0")
    data = simulator.simulate(simulator.SimConfig(
        n_steps=440, seed=3,
        laser=simulator.LaserSpec(n_beams=720, max_range=10.0)))
    opts = slam2d.Slam2DOptions(resolution=0.05, max_range=10.0,
                                trans_thresh=0.05, rot_thresh=0.05,
                                capacity=8192, max_iter=50)
    staged = [tuple(torch.as_tensor(a, device=dev)
                    for a in pad_scan(c, beam_bucket(720)))
              for c in data.clouds]

    def ranged(name, fn):
        def wrapper(*a, **kw):
            with record_function(name):
                return fn(*a, **kw)
        return wrapper

    slam2d.match.solve_window = ranged("match", slam2d.match.solve_window)
    slam2d.mapping.resident_update = ranged(
        "map_update", slam2d.mapping.resident_update)
    slam2d.Slam2D._maybe_reorg = ranged("reorg", slam2d.Slam2D._maybe_reorg)

    slam = slam2d.Slam2D(opts, device=dev)
    slam.set_prior(Pose2D(*data.poses_gt[0]))
    w = args.warmup
    slam.update_many_prepadded(staged[:w], data.odometry[:w])
    torch.cuda.synchronize()
    end = min(w + args.scans, len(staged))
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        acc = slam.update_many_prepadded(staged[w:end], data.odometry[w:end])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    n = len(acc)
    names = ("match", "map_update", "reorg")

    # device activities (kernels, memsets, copies); the ranges' GPU-side
    # annotation spans are not kernels
    kernels = sorted(((e.key, devprof.event_us(e), e.count)
                      for e in devprof.cuda_rows(prof)
                      if e.key not in names), key=lambda x: -x[1])
    total_dev_us = sum(k[1] for k in kernels)
    ranges = {k: {"host_ms_per_scan": 0.0, "device_span_ms_per_scan": 0.0,
                  "calls": 0} for k in names}
    for e in prof.events():
        if e.name in names:
            side = ("device_span_ms_per_scan"
                    if str(e.device_type).endswith("CUDA")
                    else "host_ms_per_scan")
            ranges[e.name][side] += e.time_range.elapsed_us() / 1e3 / n
            ranges[e.name]["calls"] += side == "host_ms_per_scan"
    launches = sum(k[2] for k in kernels)
    print(json.dumps({
        "device": torch.cuda.get_device_name(0), "scans": n,
        "wall_ms_per_scan": wall * 1e3 / n,
        "device_kernel_ms_per_scan": total_dev_us / 1e3 / n,
        "device_busy_share": total_dev_us / 1e6 / wall,
        "kernel_launches_per_scan": launches / n,
        "ranges": ranges,
        "top_device_ops": [{"name": k[0][:80],
                            "ms_per_scan": k[1] / 1e3 / n,
                            "calls_per_scan": k[2] / n}
                           for k in kernels[:15]],
        "iterations_last": int(slam.last_iterations),
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
