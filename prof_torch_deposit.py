#!/usr/bin/env python3
"""Device time of B1, the raycast deposit, at the shapes the main paths
send it, for several checkouts in turns.

    python3 prof_torch_deposit.py ROOT [ROOT ...]

Each ROOT holds an ``iris_lama_tpu_torch`` package (as for
prof_torch_ab.py); each runs in a process of its own, in the order given
(parent, change, change, parent to compare two commits on one card). The
inputs are chip_smoke.py's (the one beside this script): the Slam2D scan of
phase 3 (768 beams x 202 steps of free cells, beam-major, and 768 hits, into
the 448 x 448 exact-update window) and the particle set of phase 6 (the
same streams for 30 particles, ``[30, 155,136]`` and ``[30, 768]``).

Per root, torch.profiler's device µs per call (everything the call
launches, and the deposit kernel alone):

* ``deposit_counts`` on the free stream as the main path sends it
  (beam-major), shuffled, with every element a sentinel (loads, no
  atomics), and on the hit stream, at P = 1 and P = 30;
* the map update's two deposits as the parent commit made them: two
  ``deposit_counts`` calls and an add (every root);
* ``deposit_pair`` (hits and free cells in one launch), where the root has
  it, at P = 1 and P = 30;
* the device activities of one ``mapping.scan_window_compute`` at P = 1
  and P = 30 (the map update of a Slam2D scan and of a PF update);
* where the root has ``memset_floor`` (csrc/floor.cu): the launch floor of
  an empty kernel at each deposit launch shape, alone and after the
  cudaMemsetAsync of the count grids, and the memset alone.

One JSON line per root.
"""

import functools
import importlib.util
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))


@functools.lru_cache(maxsize=None)
def devprof():
    """The port's ``utils/devprof.py`` beside this script, loaded by path
    (a root's package may predate it)."""
    spec = importlib.util.spec_from_file_location(
        "devprof", os.path.join(HERE, "iris_lama_tpu_torch", "utils",
                                "devprof.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def us(torch, fn, reps: int, match: str = "") -> float:
    """Device µs per call of the activities whose name holds ``match``."""
    dp = devprof()
    fn()
    return dp.device_us(dp.cuda_rows(dp.profile_calls(fn, reps)),
                        match) / reps


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
    from iris_lama_tpu_torch.core import lie
    from iris_lama_tpu_torch.ops import _cuda, scatter_matmul as sm
    from iris_lama_tpu_torch.sdm import mapping

    dev = torch.device("cuda:0")
    out = {"root": root, "device": torch.cuda.get_device_name(0)}
    has_pair = hasattr(sm, "deposit_pair")

    data, opts, padded = cs.slam_workload()
    cfg = opts.mapping_config()
    wu = cfg.resident_update_cells
    pts, msk, ori = (torch.as_tensor(a, device=dev) for a in padded[0])
    pose = lie.se2(*data.poses_gt[0], device=dev)
    org = cfg.geometry.w2m(pose[:2]) - wu // 2
    idx1 = mapping.deposit_indices(cfg, pose, pts, msk, ori, org, wu)
    pdata, popts, ppadded = cs.pf_workload()
    pstaged = [tuple(torch.as_tensor(a, device=dev) for a in p)
               for p in ppadded]
    kin = cs.pf_kernel_inputs(torch, dev, pdata, popts, pstaged)
    idx30 = mapping.deposit_indices(cfg, kin["poses"], kin["pts"],
                                    kin["msk"], kin["ori"],
                                    kin["pset"].res_org + kin["start"], wu)
    grids = {}
    for label, idx in (("p1", idx1), ("p30", idx30)):
        fly, flx = idx.free_ly, idx.free_lx
        n = fly.shape[-1]
        perm = torch.randperm(n, device=dev)
        valid = fly < wu
        row = {"free_elements": n, "free_valid": int(valid.sum()),
               "hit_valid": int((idx.hit_ly < wu).sum())}
        cases = {"free_beam_ordered": (fly, flx),
                 "free_shuffled": (fly[..., perm].contiguous(),
                                   flx[..., perm].contiguous()),
                 "free_all_sentinel": (torch.full_like(fly, wu), flx),
                 "hit": (idx.hit_ly, idx.hit_lx)}
        for name, (ly, lx) in cases.items():
            def call(ly=ly, lx=lx):
                return sm.deposit_counts(ly, lx, wu, wu)
            row[f"{name}_us"] = us(torch, call, 300)
            row[f"{name}_kernel_us"] = us(torch, call, 300, "deposit")
        def two_calls_and_add():
            occ = sm.deposit_counts(idx.hit_ly, idx.hit_lx, wu, wu)
            return occ, occ + sm.deposit_counts(fly, flx, wu, wu)
        row["two_calls_and_add_us"] = us(torch, two_calls_and_add, 300)
        row["two_calls_and_add_activities"] = cs.device_launches(
            torch, two_calls_and_add)
        if has_pair:
            def pair():
                return sm.deposit_pair(idx.hit_ly, idx.hit_lx, fly, flx, wu,
                                       wu)
            row["pair_us"] = us(torch, pair, 300)
            row["pair_kernel_us"] = us(torch, pair, 300, "deposit")
            row["pair_activities"] = cs.device_launches(torch, pair)
        grids[label] = row
    out["deposit"] = grids

    # the map update's device activities (one scan; one PF update's)
    occ = torch.zeros((wu, wu), dtype=torch.int32, device=dev)
    dist = torch.full((wu, wu), cfg.distance.max_sqdist, dtype=cfg.sq_dtype,
                      device=dev)
    p = kin["poses"].shape[0]
    occ30 = torch.zeros((p, wu, wu), dtype=torch.int32, device=dev)
    dist30 = torch.full((p, wu, wu), cfg.distance.max_sqdist,
                        dtype=cfg.sq_dtype, device=dev)
    out["scan_window_compute_activities"] = {
        "p1": cs.device_launches(torch, lambda: mapping.scan_window_compute(
            cfg, pose, pts, msk, ori, org, occ, occ, dist)),
        "p30": cs.device_launches(torch, lambda: mapping.scan_window_compute(
            cfg, kin["poses"], kin["pts"], kin["msk"], kin["ori"],
            kin["pset"].res_org + kin["start"], occ30, occ30, dist30))}

    if "memset_floor" in _cuda.SIGNATURES["floor"]:
        lib = _cuda.library("floor")
        stream = _cuda.stream_handle(dev)
        buf = torch.empty(2 * p * wu * wu, dtype=torch.int32, device=dev)
        floors = {}
        # the one-element-a-thread grid-stride kernel: 606 and 4,224 (its
        # cap) blocks of 256; the pair's launch shape at P = 1 and 30
        shapes = [(606, 256), (4224, 256)]
        if hasattr(sm, "launch_blocks"):
            nf = idx1.free_ly.shape[-1]
            shapes += [(sm.launch_blocks(q, [768, nf]), sm.THREADS)
                       for q in (1, p)]
        for grids_n in (1, 2, p, 2 * p):
            nbytes = grids_n * wu * wu * 4

            def mem(nbytes=nbytes):
                _cuda.check(lib.memset_floor(buf.data_ptr(), nbytes, 0, 0,
                                             stream), "memset_floor")
            floors[f"memset_{grids_n}_grids"] = us(torch, mem, 1000)
        for bl, th in shapes:
            def empty(bl=bl, th=th):
                _cuda.check(lib.launch_floor(bl, th, stream), "launch_floor")
            floors[f"kernel_{bl}x{th}"] = us(torch, empty, 1000)
            for grids_n in (1, 2, p, 2 * p):
                nbytes = grids_n * wu * wu * 4

                def both(bl=bl, th=th, nbytes=nbytes):
                    _cuda.check(lib.memset_floor(buf.data_ptr(), nbytes, bl,
                                                 th, stream), "memset_floor")
                floors[f"memset_{grids_n}_grids_kernel_{bl}x{th}"] = us(
                    torch, both, 1000)
        out["floor_us"] = floors
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
