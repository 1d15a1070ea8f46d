#!/usr/bin/env python3
"""Kernel-only device time of B3, B4 and B6 across their work, for several
checkouts in turns.

    python3 prof_torch_kernels.py ROOT [ROOT ...]

Each ROOT holds an ``iris_lama_tpu_torch`` package (as for
prof_torch_ab.py); each runs in a process of its own, in the order given.
Per root, torch.profiler's device µs per call of the kernels alone (the
events whose name holds ``edt`` or ``gn_solve_kernel``, so not the copies
the wrappers make of their operands), on chip_smoke.py's phase 3, 6 and 9
inputs (taken from the chip_smoke.py beside this script):

* B3 at P = 1 (448 x 448) and P = 30;
* B6 (30 x 432 x 432, 768 beams) and B4 (1 x 576 x 576) at max_iter 0, 1,
  2, 4, 8 and 50 without the likelihood, with the evaluations the slowest
  particle makes (its iterations + 1): the slope of µs over evaluations
  is the time of one evaluation, the intercept the solve's fixed cost;
* B6 on the first 256 and 512 of its 768 beams at max_iter 4: how an
  evaluation's time grows with the beams each thread takes.

One JSON line per root.
"""

import importlib.util
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))


def kernel_us(torch, fn, reps: int, match: str) -> float:
    """Device µs per call of the kernels whose name holds ``match``."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = sum(getattr(e, "self_device_time_total",
                     getattr(e, "self_cuda_time_total", 0))
             for e in prof.key_averages()
             if str(e.device_type).endswith("CUDA") and match in e.key)
    return us / reps


def fit(xs, ys) -> tuple:
    """Least-squares line y = a + b x: (a, b)."""
    n = len(xs)
    mx, my = sum(xs) / n, sum(ys) / n
    b = (sum((x - mx) * (y - my) for x, y in zip(xs, ys))
         / sum((x - mx) ** 2 for x in xs))
    return my - b * mx, b


def run_one(root: str) -> dict:
    sys.path.insert(0, root)
    import torch
    import iris_lama_tpu_torch
    pkg = os.path.dirname(iris_lama_tpu_torch.__file__)
    if os.path.dirname(pkg) != os.path.abspath(root):
        raise RuntimeError(f"imported {pkg}, not the package under {root}")
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    from iris_lama_tpu_torch.ops import edt_pallas, gn_batch, gn_solve

    dev = torch.device("cuda:0")
    out = {"root": root, "device": torch.cuda.get_device_name(0)}
    _, opts, _ = cs.slam_workload()
    cfg = opts.mapping_config()
    wu = cfg.resident_update_cells
    r, cap = cfg.distance.radius_cells, cfg.distance.max_sqdist
    m = cs.b3_mask(torch, dev, (wu, wu), 0.01)
    out["b3_p1_us"] = kernel_us(torch, lambda: edt_pallas.edt2d(m, cap, r),
                                300, "edt")
    data, opts, padded = cs.pf_workload()
    staged = [tuple(torch.as_tensor(a, device=dev) for a in p)
              for p in padded]
    kin = cs.pf_kernel_inputs(torch, dev, data, opts, staged)
    out["b3_p30_us"] = kernel_us(torch, lambda: edt_pallas.edt2d(
        kin["obst"], kin["cap"], kin["radius"]), 100, "edt")
    lk = cs.loc_kernel_inputs(torch, dev, cs.loc_setup(torch, dev))
    b6_args = kin["b6_args"]
    b6_kw = dict(kin["b6_kw"], want_lik=False)
    for name, mod, args, kw in (
            ("b6", gn_batch, b6_args, b6_kw),
            ("b4_p1", gn_solve, lk["b4_args"], lk["b4_kw"])):
        rows = []
        for max_iter in (0, 1, 2, 4, 8, 50):
            kwi = dict(kw, max_iter=max_iter)
            it = mod.solve_window_sq(*args, **kwi)[1]
            us = kernel_us(torch, lambda: mod.solve_window_sq(*args, **kwi),
                           50, "gn_solve_kernel")
            rows.append({"max_iter": max_iter, "evals": int(it.max()) + 1,
                         "us": us})
        a, b = fit([x["evals"] for x in rows], [x["us"] for x in rows])
        out[name] = {"rows": rows, "fixed_us": a, "per_eval_us": b}
    beams = []
    for nb in (256, 512, 768):
        args = (*b6_args[:3], b6_args[3][:nb].contiguous(),
                b6_args[4][:nb].contiguous())
        kwi = dict(b6_kw, max_iter=4)
        it = gn_batch.solve_window_sq(*args, **kwi)[1]
        beams.append({"beams": nb, "evals": int(it.max()) + 1,
                      "us": kernel_us(torch, lambda: gn_batch.solve_window_sq(
                          *args, **kwi), 50, "gn_solve_kernel")})
    out["b6_beams"] = beams
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
