#!/usr/bin/env python3
"""Where the time of the port's PFSlam2D goes on one GPU.

    python3 prof_torch_pf.py [--updates 60] [--warmup 20]

Replays the chip_smoke.py / bench_pf.py workload (SimConfig(n_steps=120,
seed=5), 720 beams, 5 cm cells, 30 particles) on the card, warms up on the
first updates, then profiles ``--updates`` updates with torch.profiler.
The motion draws, the scan match (kernel B6), the weights and resampling,
the map update and the re-orgs are wrapped in profiler ranges by this
script (the port carries no instrumentation). Prints one JSON line: wall
time per update (profiler on), host time per range and the span of each
range on the device timeline, device time by kernel name, the device's
busy share of the window (kernel time / wall time), device activities
(kernels, memsets, copies) per update, and device memory: the particle
set's bytes and the most that one scan allocated on top of what was
allocated before it: the first scan (which allocates the particle set),
updates without and with a re-org.
"""

import argparse
import json
import os
import sys
import time


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--updates", type=int, default=60)
    ap.add_argument("--warmup", type=int, default=20)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from torch.profiler import ProfilerActivity, profile, record_function
    from iris_lama_tpu_torch.utils import devprof
    from iris_lama_tpu_torch.algos import pf_slam2d
    from iris_lama_tpu_torch.core.pose import Pose2D
    from iris_lama_tpu_torch.utils import simulator
    from iris_lama_tpu_torch.utils.cloud import beam_bucket, pad_scan

    dev = torch.device("cuda:0")
    data = simulator.simulate(simulator.SimConfig(
        n_steps=120, seed=5,
        laser=simulator.LaserSpec(n_beams=720, max_range=10.0)))
    opts = pf_slam2d.PFSlam2DOptions(particles=30, resolution=0.05,
                                     max_range=10.0, trans_thresh=0.25,
                                     rot_thresh=0.25, capacity=2048,
                                     max_iter=50, seed=11)
    staged = [tuple(torch.as_tensor(a, device=dev)
                    for a in pad_scan(c, beam_bucket(720)))
              for c in data.clouds]

    def ranged(name, fn):
        def wrapper(*a, **kw):
            with record_function(name):
                return fn(*a, **kw)
        return wrapper

    names = ("motion", "match", "resample", "map_update", "reorg")
    pf_slam2d.match_phase = ranged("match", pf_slam2d.match_phase)
    pf_slam2d.weights_and_resample = ranged(
        "resample", pf_slam2d.weights_and_resample)
    pf_slam2d.mapping.resident_update = ranged(
        "map_update", pf_slam2d.mapping.resident_update)
    cls = pf_slam2d.PFSlam2D
    cls._flush_motion = ranged("motion", cls._flush_motion)
    cls._pf_maybe_reorg = ranged("reorg", cls._pf_maybe_reorg)

    pf = cls(opts, device=dev)
    pf.set_prior(Pose2D(*data.poses_gt[0]))
    peaks = {"first_scan": 0, "update": 0, "reorg_update": 0}

    def step(i):
        """One scan; the most it allocated above what was allocated
        before it goes into ``peaks`` (the window's timing is taken with
        these synchronisations in place)."""
        torch.cuda.synchronize()
        before, reorgs = torch.cuda.memory_allocated(dev), pf.n_reorgs
        torch.cuda.reset_peak_memory_stats(dev)
        acc = pf.update_prepadded(*staged[i], data.odometry[i])
        torch.cuda.synchronize()
        extra = torch.cuda.max_memory_allocated(dev) - before
        key = ("first_scan" if i == 0 else "reorg_update"
               if pf.n_reorgs > reorgs else "update")
        peaks[key] = max(peaks[key], extra)
        return acc

    k, w = 0, 0
    while w < args.warmup:
        w += bool(step(k) and k)
        k += 1
    state_bytes = sum(t.numel() * t.element_size() for t in (
        *pf.pset.maps.table, pf.pset.maps.occupied, pf.pset.maps.visited,
        pf.pset.maps.dist, pf.pset.res_occ, pf.pset.res_vis,
        pf.pset.res_dist))
    torch.cuda.synchronize()
    n = 0
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        while n < args.updates and k < len(staged):
            n += bool(step(k))
            k += 1
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0

    kernels = sorted(((e.key, devprof.event_us(e), e.count)
                      for e in devprof.cuda_rows(prof)
                      if e.key not in names), key=lambda x: -x[1])
    total_dev_us = sum(x[1] for x in kernels)
    ranges = {r: {"host_ms_per_update": 0.0,
                  "device_span_ms_per_update": 0.0, "calls": 0}
              for r in names}
    for e in prof.events():
        if e.name in names:
            side = ("device_span_ms_per_update"
                    if str(e.device_type).endswith("CUDA")
                    else "host_ms_per_update")
            ranges[e.name][side] += e.time_range.elapsed_us() / 1e3 / n
            ranges[e.name]["calls"] += side == "host_ms_per_update"
    launches = sum(x[2] for x in kernels)
    print(json.dumps({
        "device": torch.cuda.get_device_name(0), "updates": n,
        "reorgs": pf.n_reorgs, "scrolls": pf.n_scrolls,
        "wall_ms_per_update": wall * 1e3 / n,
        "device_kernel_ms_per_update": total_dev_us / 1e3 / n,
        "device_busy_share": total_dev_us / 1e6 / wall,
        "device_activities_per_update": launches / n,
        "state_mb": state_bytes / 2 ** 20,
        "peak_extra_mb": {key: v / 2 ** 20 for key, v in peaks.items()},
        "ranges": ranges,
        "top_device_ops": [{"name": x[0][:80],
                            "ms_per_update": x[1] / 1e3 / n,
                            "calls_per_update": x[2] / n}
                           for x in kernels[:15]],
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
