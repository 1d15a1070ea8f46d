#!/usr/bin/env python3
"""Slam2D and PFSlam2D main-path speed, and the device time of the kernels
B3, B4 and B6, of several checkouts, in turns.

    python3 prof_torch_ab.py ROOT [ROOT ...]

Each ROOT is a directory that holds an ``iris_lama_tpu_torch`` package (a
checkout of the repository, or the package unpacked from ``git archive``
of another commit). The roots run one after another, each in a process of
its own, in the order given — list them as parent, change, change, parent
to compare two commits on one card. Each run replays chip_smoke.py's
phase 5 and phase 8 passes (its ``slam_workload``/``slam_pass`` and
``pf_workload``/``pf_pass``, taken from the chip_smoke.py beside this
script whatever the root), three fresh drivers each, and phase 11's
Loc2D pass in the ``generic`` and ``solve`` modes (a warm-up and three
passes each), and prints one JSON line: scans/s and updates/s per pass,
with the accuracy of the first two, and before them
the device µs per call (torch.profiler) of B3 at P = 1 (448 x 448) and
P = 30, B6 (30 x 432 x 432) and B4 at P = 1 (576 x 576) and P = 8 (a scan
each), on the inputs of chip_smoke.py's phases 3, 6 and 9 (its
``b3_mask``, ``pf_kernel_inputs``, ``loc_setup`` and
``loc_kernel_inputs``).
"""

import importlib.util
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))


def kernel_us(torch, dev, cs) -> dict:
    """Device µs per call of B3, B6 and B4 at chip_smoke.py's shapes."""
    from iris_lama_tpu_torch.ops import edt_pallas, gn_batch, gn_solve

    def us(fn, reps):
        return cs.device_ms(torch, fn, reps)[0] * 1e3

    out = {}
    _, opts, _ = cs.slam_workload()
    cfg = opts.mapping_config()
    wu = cfg.resident_update_cells
    r, cap = cfg.distance.radius_cells, cfg.distance.max_sqdist
    m = cs.b3_mask(torch, dev, (wu, wu), 0.01)
    out["b3_p1_us"] = us(lambda: edt_pallas.edt2d(m, cap, r), 300)
    data, opts, padded = cs.pf_workload()
    staged = [tuple(torch.as_tensor(a, device=dev) for a in p)
              for p in padded]
    kin = cs.pf_kernel_inputs(torch, dev, data, opts, staged)
    out["b3_p30_us"] = us(lambda: edt_pallas.edt2d(
        kin["obst"], kin["cap"], kin["radius"]), 100)
    out["b6_us"] = us(lambda: gn_batch.solve_window_sq(
        *kin["b6_args"], **kin["b6_kw"]), 50)
    del kin, staged
    lk = cs.loc_kernel_inputs(torch, dev, cs.loc_setup(torch, dev))
    for label, args in (("p1", lk["b4_args"]), ("p8", lk["b4p_args"])):
        out[f"b4_{label}_us"] = us(lambda: gn_solve.solve_window_sq(
            *args, **lk["b4_kw"]), 100)
    return out


def run_one(root: str) -> dict:
    sys.path.insert(0, root)
    import torch
    import iris_lama_tpu_torch
    pkg = os.path.dirname(iris_lama_tpu_torch.__file__)
    if os.path.dirname(pkg) != os.path.abspath(root):
        raise RuntimeError(f"imported {pkg}, not the package under {root}")
    # this checkout's chip_smoke.py, not the one a root may hold
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)

    dev = torch.device("cuda:0")
    out = {"root": root, "device": torch.cuda.get_device_name(0),
           **kernel_us(torch, dev, cs)}
    for key, workload, one_pass, rate, acc in (
            ("slam", cs.slam_workload, cs.slam_pass, "scans_per_s", "ate_m"),
            ("pf", cs.pf_workload, cs.pf_pass, "updates_per_s",
             "final_err_m")):
        data, opts, padded = workload()
        staged = [tuple(torch.as_tensor(a, device=dev) for a in p)
                  for p in padded]
        passes = [one_pass(torch, dev, data, opts, staged, p)
                  for p in range(3)]
        out[f"{key}_{rate}"] = [p[rate] for p in passes]
        out[f"{key}_{acc}"] = [p[acc] for p in passes]
        del staged
    out.update(loc_rates(torch, dev, cs))
    return out


def loc_rates(torch, dev, cs) -> dict:
    """Loc2D updates/s in the ``generic`` and ``solve`` match modes:
    phase 11's pass (bench_loc.py's log on the map its Slam2D builds), a
    warm-up pass, then three fresh passes each."""
    from iris_lama_tpu_torch.algos import loc2d
    from iris_lama_tpu_torch.core.pose import Pose2D
    lw = cs.loc_setup(torch, dev)
    data, odoms, staged = lw["data"], lw["odoms"], lw["staged"]
    out = {}
    for mode in ("generic", "solve"):
        rates = []
        for rep in (9, 0, 1, 2):
            lc = loc2d.Loc2D(lw["opts"], maps=lw["maps"], device=dev,
                             match=mode)
            lc.set_prior(Pose2D(data.poses_gt[0][0] + rep * 1e-4,
                                data.poses_gt[0][1], data.poses_gt[0][2]))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            acc = lc.update_many_prepadded(staged, odoms)
            torch.cuda.synchronize()
            rates.append(len(acc) / (time.perf_counter() - t0))
        out[f"loc_{mode}_updates_per_s"] = rates[1:]   # the warm-up dropped
    return out


def main() -> int:
    if len(sys.argv) < 2:
        print(__doc__, file=sys.stderr)
        return 2
    if sys.argv[1] == "--one":
        print(json.dumps(run_one(os.path.abspath(sys.argv[2]))), flush=True)
        return 0
    for root in sys.argv[1:]:
        subprocess.run([sys.executable, os.path.abspath(__file__), "--one",
                        root], check=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
