#!/usr/bin/env python3
"""Kernel-only device time of B2-B6 and the launch floor, for several
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
  evaluation's time grows with the beams each thread takes;
* B5 (``gn_eval_kernel``) on phase 9's evaluation at the predicted pose
  (576 x 576, 768 beams) with contiguous operands and, where the root's
  wrapper takes them, the strided views of the fused loop; and one whole
  evaluation as ``match_surface_2d._solve_window_fused`` makes it (hits,
  cells, B5) with the operand copies the loop made before this slice and
  without them: device µs and device activities per evaluation;
* B2 (``select4_kernel``) at phase 3's shape (488 x 488, 768 random
  cells) and at phase 9's (576 x 576, the scan's cells at the predicted
  pose), with contiguous indices and, where the root takes them, the
  columns of the [768, 2] cell tensor;
* the launch floor (csrc/floor.cu, where the root has it): an empty kernel
  at the launch shapes of B1-B8;
* the device activities (kernels, copies, fills) per update of one Loc2D
  pass of the bench_loc.py workload in the ``sq`` and ``fused`` modes.

One JSON line per root.
"""

import importlib.util
import json
import os
import subprocess
import sys

import numpy as np

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
    lw = cs.loc_setup(torch, dev)
    lk = dict(cs.loc_kernel_inputs(torch, dev, lw), lw=lw)
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
    out.update(eval_and_select(torch, cs, dev, lk))
    out["loc_launches_per_update"] = loc_launches(torch, cs, dev, lk)
    return out


def eval_and_select(torch, cs, dev, lk) -> dict:
    """B5, one fused evaluation, B2 and the launch floor (module doc)."""
    from iris_lama_tpu_torch.core import lie
    from iris_lama_tpu_torch.ops import _cuda, match_eval, select4
    out = {}
    loc, pose0, sub, sub_org = lk["loc"], lk["pose0"], lk["sub"], \
        lk["sub_org"]
    pts, msk = lk["pts"], lk["msk"]
    geo = loc.geo
    kw = dict(max_dist=loc.max_dist, res=geo.resolution, scale=geo.scale,
              cauchy_c=loc.sopts.robust.param)
    fm = msk.to(torch.float32)
    org = sub_org.to(torch.int32)

    def operands(state, copies):
        hits = lie.se2_apply(state, pts)
        mi, mu = geo.w2m_frac(hits)
        c = mi - org
        ops = (c[..., 1], c[..., 0], mu[..., 0], mu[..., 1], hits[..., 0],
               hits[..., 1])
        return [t.contiguous() for t in ops] if copies else list(ops)

    def takes(fn, *args, **kwa):
        """Whether the root's wrapper takes these operands (an older one
        refuses strided views)."""
        try:
            fn(*args, **kwa)
        except ValueError:
            return False
        torch.cuda.synchronize()
        return True

    b5 = {}
    for layout, copies in (("contiguous", True), ("views", False)):
        ops = operands(pose0, copies)
        if takes(match_eval.gn_eval_sq, sub, *ops, fm, **kw):
            b5[layout] = kernel_us(torch, lambda: match_eval.gn_eval_sq(
                sub, *ops, fm, **kw), 300, "gn_eval_kernel")
    out["b5_us"] = b5
    # one evaluation of the fused loop, as _solve_window_fused makes it
    ev = {}
    for label, copies in (("with_copies", True), ("without_copies", False)):
        def one():
            return match_eval.gn_eval_sq(sub, *operands(pose0, copies), fm,
                                         **kw)
        if takes(one):
            ev[label] = {"us": kernel_us(torch, one, 300, ""),
                         "activities": cs.device_launches(torch, one)}
    out["fused_eval"] = ev
    # B2 at phase 3's and phase 9's shapes
    rng = np.random.default_rng(0)
    wm = 488
    grid = torch.as_tensor(rng.integers(0, 101, (wm, wm)).astype(np.int8),
                           device=dev)
    cells = torch.as_tensor(rng.integers(-3, wm + 3, (768, 2)).astype(
        np.int32), device=dev)
    c9 = operands(pose0, False)
    c9 = torch.stack([c9[1], c9[0]], -1)      # [768, 2] (lx, ly)
    b2 = {}
    for shape, g, c in (("slam2d_488", grid, cells), ("loc2d_576", sub, c9)):
        for layout in ("contiguous", "views"):
            ly, lx = c[:, 1], c[:, 0]
            if layout == "contiguous":
                ly, lx = ly.contiguous(), lx.contiguous()

            def call(g=g, ly=ly, lx=lx):
                return select4.select4_sq(g, ly, lx)

            if takes(call):
                b2[f"{shape}_{layout}"] = kernel_us(torch, call, 1000,
                                                    "select4_kernel")
    out["b2_us"] = b2
    if "floor" in _cuda.SIGNATURES:
        # the launch shapes of chip_smoke.py's kernel phases: B2 (3 x 256),
        # B5 and B4 at P = 1 (1 x 768), B4 at P = 8 (8 x 768), B6 (30 x
        # 768), B3 (98 x 256 at P = 1, 2940 x 256 at 30), B1 (606 x 256 at
        # P = 1 for 155,136 cells; 4224 x 256, its cap, at 30), B7/B8 (170
        # x 256 for 43,281)
        out["floor_us"] = {
            f"{bl}x{th}": cs.launch_floor_ms(torch, dev, bl, th) * 1e3
            for bl, th in ((3, 256), (1, 768), (8, 768), (30, 768),
                           (98, 256), (2940, 256), (606, 256), (4224, 256),
                           (170, 256))}
    return out


def loc_launches(torch, cs, dev, lk) -> dict:
    """Device activities per accepted update of one Loc2D pass of the
    bench_loc.py workload, in the ``sq`` and ``fused`` modes."""
    from iris_lama_tpu_torch.algos import loc2d
    from iris_lama_tpu_torch.core.pose import Pose2D
    lw = lk["lw"]
    out = {}
    for mode in ("sq", "fused"):
        box = []

        def one_pass(mode=mode, box=box):
            lc = loc2d.Loc2D(lw["opts"], maps=lw["maps"], device=dev,
                             match=mode)
            lc.set_prior(Pose2D(*lw["data"].poses_gt[0]))
            box.append(len(lc.update_many_prepadded(lw["staged"],
                                                    lw["odoms"])))

        one_pass()      # warm-up
        box.clear()
        out[mode] = cs.device_launches(torch, one_pass) / box[0]
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
